"""Merge threads busy at once: the thread-seconds inside the program's
`self_merge` spans (build/merge.py, one per self-merge round of a merge)
over the traced window. The build's pool runs `jobs` merges at a time;
time outside merges (guide tree, serialisation) lowers it."""


def read(record):
    s = record["spans"].get("self_merge")
    if not s or record["window_s"] <= 0:
        return None
    return s / record["window_s"]
