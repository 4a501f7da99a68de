"""Thread-seconds a build spends in the program's `mapper.index` spans
(align/mapper.py: the minimizer index of the block consensuses), per
job."""


def read(record):
    s = record["spans"].get("mapper.index")
    return s / record["jobs"] if s and record["jobs"] else None
