"""engine_share_pct: the engine's node seconds (each node timed after a
synchronise; a stacked pass's seconds shared among its slots) over the
window, in percent. The rest is the service's and the benchmark's host work."""


def read(rec):
    return 100.0 * sum(a.report.total_seconds for a in rec.answers if a.report is not None) / rec.window_s
