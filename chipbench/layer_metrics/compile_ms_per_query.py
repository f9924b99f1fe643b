"""compile_ms_per_query: the mean of each answer's SQL compile (through the
plan cache) and accountant seconds, in milliseconds."""


def read(rec):
    got = [a for a in rec.answers if a.report is not None]
    if not got:
        return None
    return 1e3 * sum(a.compile_s + a.accountant_s for a in got) / len(got)
