"""The card's share of the window's DP cells: the aligner's own counter,
`BatchAligner.engine_report()["device_cells_frac"]`, reset when the
window opens (cells at the kernels' bands on the card, at the jobs'
widths on the host engine)."""


def read(record):
    return record["engine"].get("device_cells_frac")
