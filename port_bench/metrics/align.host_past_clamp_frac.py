"""The share of the window's DP cells that the host engine took because
their band had widened past the kernels' widest (W > 1023), which only the
host engine widens further: the aligner's own counter,
`BatchAligner.engine_report()["host_reasons"]["past_clamp"]`, over the
cells of both engines, reset when the window opens. A program without the
counter reports nothing."""


def read(record):
    e = record["engine"]
    reasons = e.get("host_reasons")
    total = e["host"]["cells"] + e["device"]["cells"]
    if reasons is None or "past_clamp" not in reasons or not total:
        return None
    return reasons["past_clamp"] / total
