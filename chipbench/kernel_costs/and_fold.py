"""and_fold: the equality circuit's AND tree in one launch."""

LAUNCHER = ("repro_torch.kernels.ks_prefix.ops", "_and_fold_launch")
DEVICE_KERNELS = ("and_fold_kernel",)
COUNTERS = ("and_fold", "and_fold_u64")


def cost(v, alphas, shifts):
    """v and one alpha word a level in, v out (three shares each); per share
    word and level 7 integer operations."""
    n, levels, w = v.shape[-1], len(shifts), v.element_size()
    return n * (12 + 12 * levels + 12) * w // 4, n * 3 * 7 * levels
