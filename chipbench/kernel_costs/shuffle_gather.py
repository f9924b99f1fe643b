"""shuffle_gather: the row gather of one secure-shuffle hop, every column
(the direct kernel, or the plan and two passes above the L2)."""

LAUNCHER = ("repro_torch.kernels.shuffle_gather.ops", "_hop_launch")
DEVICE_KERNELS = ("gather_direct_kernel", "gather_plan_kernel", "gather_pass1_kernel", "gather_pass2_kernel")
COUNTERS = ("shuffle_gather", "shuffle_plan")


def cost(cols, index):
    """Every word of every (P, N, W) column read and written once and the
    index read once, at 4 bytes a row; no arithmetic."""
    n = index.shape[0]
    planes = cols[0].shape[0]
    words = planes * sum(c.shape[2] for c in cols)
    return (2 * 4 * words + 4) * n, 0
