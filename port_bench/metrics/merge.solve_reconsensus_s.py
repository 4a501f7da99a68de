"""Thread-seconds a build spends in the program's `solve_promises` and
`reconsensus` spans (build/merge.py: aligning each merged block's nodes
and re-deriving consensuses, aligner calls included), per job."""


def read(record):
    s = record["spans"].get("solve_promises", 0.0) + record["spans"].get("reconsensus", 0.0)
    return s / record["jobs"] if s and record["jobs"] else None
