"""peak_mem_gib: the device memory allocated at its peak over the window
(the peak is reset after the warm-up; CUDA-graph pools count), in GiB."""


def read(rec):
    return rec.peak_window_bytes / 2**30
