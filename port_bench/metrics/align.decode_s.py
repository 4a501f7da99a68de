"""Thread-seconds a build spends in the program's `align.decode` spans
(ops/batch_align.py: turning the walk kernels' fetched events into edits
on the host), per job."""


def read(record):
    s = record["spans"].get("align.decode")
    return s / record["jobs"] if s and record["jobs"] else None
