"""Thread-seconds a build spends in the program's `find_matches` spans
(build/merge.py: the mapper's all-vs-all map of block consensuses, with
its index, chaining and the aligner calls it makes), per job."""


def read(record):
    s = record["spans"].get("find_matches")
    return s / record["jobs"] if s and record["jobs"] else None
