"""The share of the traced window in which no kernel of the launch log ran
on the card: 1 - (union of the launches' event-pair intervals) / window.
Host-device copies are not in the launch log, so time the card spends
only copying counts as idle."""
from port_bench import tracing


def read(record):
    if not record["launches"] or record["window_s"] <= 0:
        return None
    return 1.0 - sum(b - a for a, b in tracing.busy(record)) / record["window_s"]
