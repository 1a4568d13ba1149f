"""Seconds a batched prune takes: the mean of `stats["batched"]["seconds"]`
over the window's batches."""


def read(record):
    bs = record["batches"]
    return sum(b["seconds"] for b in bs) / len(bs) if bs else None
