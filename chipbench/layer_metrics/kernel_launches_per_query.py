"""kernel_launches_per_query: the port's CUDA kernels (every file of
kernel_costs/) the device ran in the traced part of the window (replays of
CUDA graphs included) over the queries of the rounds it covers."""


def read(rec):
    if rec.device is None or not rec.traced:
        return None
    return sum(f["events"] for f in rec.device["families"].values()) / len(rec.traced)
