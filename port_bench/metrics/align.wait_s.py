"""Thread-seconds a build's merge threads spend in the program's
`align.wait` spans (ops/batch_align.py: a device leg waiting for its
combined round, with the broker's queue, gather, pack, dispatch, the
kernels and the fetch), per job."""


def read(record):
    s = record["spans"].get("align.wait")
    return s / record["jobs"] if s and record["jobs"] else None
