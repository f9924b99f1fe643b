"""resize_ms_per_query: the seconds of the reports' Resize nodes over the
queries, in milliseconds."""


def read(rec):
    reports = [a.report for a in rec.answers if a.report is not None]
    resizes = [s.seconds for r in reports for s in r.nodes if s.node.startswith("Resize")]
    if not resizes:
        return None
    return 1e3 * sum(resizes) / len(reports)
