"""Milliseconds of kernel time a build takes on the card: the launch log's
event pairs (stripe_v2.KERNEL_TIMING) of every DP and walk launch,
summed, per job. Event pairs of launches on the merge threads' streams
may overlap; copies are not in the log."""


def read(record):
    ms = 1e3 * sum(l["end_s"] - l["start_s"] for l in record["launches"] if "." not in l["name"])
    return ms / record["jobs"] if ms > 0 and record["jobs"] else None
