"""submit_p95_s: the 95th percentile of every answer's wait in the window,
from the start of its enqueue to the return of its drain (host clock)."""

import statistics


def read(rec):
    waits = [a.t_done - a.t_submit for a in rec.answers]
    if len(waits) < 20:
        return None
    return statistics.quantiles(waits, n=20, method="inclusive")[18]
