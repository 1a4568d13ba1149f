"""NLCC and TDS seconds a query: the non-local phases (cycle, path and TDS
constraints) of each query's `PruneResult.phases`."""


def read(record):
    qs = [q for q in record["queries"] if "phases" in q]
    if not qs:
        return None
    return sum(s for q in qs for p, s in q["phases"]
               if p.startswith("NLCC")) / len(qs)
