"""The DP kernels' share of their roofline, in %: the least time one H100
needs for the DP work the window's problems need (yardstick.py: each
problem planned onto a launch counted from its rows, query length and
band half-width, at the 16 integer operations a cell of the recurrence
needs with its traceback record on the stripe route, 9 on the checkpoint
route, against the INT32 and HBM peaks, the larger), over the launch log's summed device time of the
`stripe_dp` and `stripe_dp_ckpt` kernels."""
from port_bench import yardstick


def read(record):
    dp_s = sum(l["end_s"] - l["start_s"] for l in record["launches"]
               if l["name"] in ("stripe_dp", "stripe_dp_ckpt"))
    if dp_s <= 0 or not record["dp_problems"]:
        return None
    least, _bound = yardstick.dp_least_seconds(record["dp_problems"])
    return 100.0 * least / dp_s
