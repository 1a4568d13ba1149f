"""LCC sweeps a query: `stats["lcc_iterations"]` of each query's prune."""


def read(record):
    qs = [q for q in record["queries"] if "lcc_iterations" in q]
    if not qs:
        return None
    return sum(q["lcc_iterations"] for q in qs) / len(qs)
