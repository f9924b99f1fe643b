"""bitonic_swap: one bitonic sort stage's conditional swap over all columns."""

LAUNCHER = ("repro_torch.kernels.bitonic_stage.ops", "_launch")
DEVICE_KERNELS = ("bitonic_swap_vec4", "bitonic_swap_scalar")
COUNTERS = ("bitonic_swap",)


def cost(mask, own, other, alpha):
    """The mask, own, other and alpha read, the result written (three shares
    each, C columns); per column word 8 integer operations."""
    _, c, n = own.shape
    return 4 * (3 * n + 4 * 3 * c * n), 3 * c * n * 8
