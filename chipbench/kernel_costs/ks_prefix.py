"""ks_prefix: every Kogge-Stone level of a comparison or adder in one launch."""

LAUNCHER = ("repro_torch.kernels.ks_prefix.ops", "_ks_prefix_launch")
DEVICE_KERNELS = ("ks_prefix_kernel",)
COUNTERS = ("ks_prefix", "ks_prefix_u64")


def cost(g, p, alphas, shifts):
    """g, p and two alpha words a level in, g out (three shares each); per
    share word and level 15 integer operations."""
    n, levels, w = g.shape[-1], len(shifts), g.element_size()
    return n * (24 + 24 * levels + 12) * w // 4, n * 3 * 15 * levels
