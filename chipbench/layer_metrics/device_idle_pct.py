"""device_idle_pct: the share of the traced window in which no kernel,
copy or set ran on the device, in percent."""


def read(rec):
    if rec.device is None or rec.device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.device["busy_s"] / rec.device["window_s"])
