"""queries_per_s: the queries answered correctly over the window's seconds
(from its start to the end of its last query)."""


def read(rec):
    return len(rec.good) / rec.window_s
