"""setup_s: seconds from the process's start to the window's start: the
kernels' build where it is not cached, the tables made and shared, and the
warm pass of every query of the mix (with its CUDA-graph captures)."""


def read(rec):
    return rec.setup_s
