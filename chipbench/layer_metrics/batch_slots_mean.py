"""batch_slots_mean: the mean number of queries of the engine pass each
answer rode in (QueryResult.batch_slots)."""


def read(rec):
    slots = [a.slots for a in rec.answers if a.report is not None]
    return sum(slots) / len(slots) if slots else None
