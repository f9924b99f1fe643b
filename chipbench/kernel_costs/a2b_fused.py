"""a2b_fused: the whole arithmetic-to-boolean conversion (two chained
Kogge-Stone adders) in one launch."""

LAUNCHER = ("repro_torch.kernels.a2b_fused.ops", "_a2b_launch")
DEVICE_KERNELS = ("a2b_kernel",)
COUNTERS = ("a2b_fused", "a2b_fused_u64")


def cost(xs, alphas, shifts):
    """x and 2 (1 + 2L) alpha words in, the result out (three shares each);
    per share word 2 (10 + 15 L) integer operations."""
    n, levels, w = xs.shape[-1], len(shifts), xs.element_size()
    return n * (12 + 24 * (1 + 2 * levels) + 12) * w // 4, n * 3 * 2 * (10 + 15 * levels)
