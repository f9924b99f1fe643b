"""rss_gate: the 1-round RSS multiplication / AND gate."""

LAUNCHER = ("repro_torch.kernels.rss_gate.ops", "_launch")
DEVICE_KERNELS = ("rss_gate_kernel",)
COUNTERS = ("rss_gate", "rss_gate_u64")


def cost(xs, ys, alpha, boolean):
    """x, y and alpha read, z written: three share words each a lane; per
    share word three products (ANDs) and three sums (XORs)."""
    n = xs[0].numel()
    w = xs.element_size()
    return 12 * w * n, 3 * 6 * n
