"""Queries a batch: the mean batch size of the window's batches."""


def read(record):
    bs = record["batches"]
    return sum(b["B"] for b in bs) / len(bs) if bs else None
