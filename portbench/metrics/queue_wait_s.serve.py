"""Seconds a query waits in the engine's queue: the median of
`QueryResult.wait_s` over the window's queries."""
import statistics


def read(record):
    waits = [q["wait_s"] for q in record["queries"] if "wait_s" in q]
    return statistics.median(waits) if waits else None
