"""Seconds a build spends in the program's `build.guide_tree` span
(build/build.py: the guide tree, mash distances, neighbour joining and
balancing, serial before the merge pool starts), per job."""


def read(record):
    s = record["spans"].get("build.guide_tree")
    return s / record["jobs"] if s and record["jobs"] else None
