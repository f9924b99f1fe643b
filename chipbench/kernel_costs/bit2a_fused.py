"""bit2a_fused: the bit injection's two dependent ring products in one launch."""

LAUNCHER = ("repro_torch.kernels.a2b_fused.ops", "_bit2a_launch")
DEVICE_KERNELS = ("bit2a_kernel",)
COUNTERS = ("bit2a_fused", "bit2a_fused_u64")


def cost(bs, alphas):
    """b and two alpha words in, the result out (three shares each); per
    share word 19 integer operations."""
    n, w = bs.shape[-1], bs.element_size()
    return n * 48 * w // 4, n * 3 * 19
