"""Counting seconds a query: the host clock around `count_matches`, which
returns a host integer and so ends in a device sync."""


def read(record):
    qs = [q for q in record["queries"] if "count_s" in q]
    if not qs:
        return None
    return sum(q["count_s"] for q in qs) / len(qs)
