"""comm_mb_per_query: the bytes a party sends (the ledger's, summed over
every node of every query of the window) over the queries, in 10^6 bytes."""


def read(rec):
    reports = [a.report for a in rec.answers if a.report is not None]
    if not reports:
        return None
    return sum(r.total_bytes for r in reports) / len(reports) / 1e6
