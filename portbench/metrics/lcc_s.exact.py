"""LCC seconds a query: the LCC phases of each query's `PruneResult.phases`
(each ends in a device sync; the traced run prunes with collect_stats)."""


def read(record):
    qs = [q for q in record["queries"] if "phases" in q]
    if not qs:
        return None
    return sum(s for q in qs for p, s in q["phases"] if p == "LCC") / len(qs)
