"""draw_launches_per_query: the threefry_bits kernels the device ran in the
traced part of the window (replays of CUDA graphs included) over the queries
of the rounds it covers."""


def read(rec):
    if rec.device is None or not rec.traced:
        return None
    return rec.device["families"]["threefry_bits"]["events"] / len(rec.traced)
