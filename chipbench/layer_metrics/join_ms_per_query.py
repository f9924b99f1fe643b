"""join_ms_per_query: the seconds of the reports' Join nodes over the
queries, in milliseconds."""


def read(rec):
    reports = [a.report for a in rec.answers if a.report is not None]
    joins = [s.seconds for r in reports for s in r.nodes if s.node.startswith("Join")]
    if not joins:
        return None
    return 1e3 * sum(joins) / len(reports)
