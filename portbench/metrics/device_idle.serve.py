"""Share of the traced window in which no operation ran on the device."""
from portbench import trace


def read(record):
    return trace.idle_share(record.get("trace"))
