"""The share of the device launches' problems whose Edit the card's decode
gave: the aligner's own counter, `BatchAligner.engine_report()["decode"]`
(`device`: decoded on the card; `host`: through the host's decode of the
walk's events or the host fallback), reset when the window opens. A program
without the counter reports nothing."""


def read(record):
    d = record["engine"].get("decode")
    if not d or not d["device"] + d["host"]:
        return None
    return d["device"] / (d["device"] + d["host"])
