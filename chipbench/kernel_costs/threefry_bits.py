"""threefry_bits: the PRF's draws, every key's words in one launch (one per
four keys with host keys)."""

LAUNCHER = ("repro_torch.kernels.threefry.ops", "_launch")
DEVICE_KERNELS = ("threefry_bits_kernel",)
COUNTERS = ("threefry_bits",)

# integer operations a word of threefry-2x32 takes: 20 rounds of add, rotate
# and XOR, five key injections of two adds, the two input words' adds and
# the final XOR
OPS_PER_WORD = 73


def cost(keys, n, device):
    """The R x n words written (the keys are a few bytes); 73 operations a word."""
    r = keys.shape[0]
    return 4 * r * n, OPS_PER_WORD * r * n
