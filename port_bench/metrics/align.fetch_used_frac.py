"""The share of the bytes the device legs copy off the card that the
decode reads: the aligner's own counter,
`BatchAligner.engine_report()["fetch"]` (`used_bytes`: each problem's
meta row, its event count and its events where they did not overflow,
over `bytes`: every fetched array), reset when the window opens."""


def read(record):
    f = record["engine"].get("fetch")
    if not f or not f.get("bytes"):
        return None
    return f["used_bytes"] / f["bytes"]
