"""kernels_roofline_pct: the port's CUDA kernels' least time over their
device time in the traced window, in percent. A launch's least time is the
larger of its bytes over the memory bandwidth and its integer operations
over the integer rate (kernel_costs/, peaks.json), counted from its operands
at its Python launch function; the device time is the profiler's. It reads
only where every kernel ran as often as the program launched it: a CUDA
graph's replay runs kernels that no launch function saw."""


def read(rec):
    if rec.device is None:
        return None
    fams = rec.device["families"].values()
    if any(f["events"] != f["launches"] for f in fams):
        return None
    device_s = sum(f["device_s"] for f in fams)
    if device_s <= 0:
        return None
    return 100.0 * sum(f["least_s"] for f in fams) / device_s
