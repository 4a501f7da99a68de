"""The yardstick of the kernels' roofline shares: the H100's peaks and the
work a DP problem needs, counted from the problem (its rows, query length
and band half-width), never from the launch that ran it.

Peaks of one NVIDIA H100 SXM5 (80GB HBM3), as the NVIDIA H100 Tensor Core
GPU Architecture whitepaper gives them: 132 SMs, each issuing 64 INT32
operations a clock, at the 1.98 GHz boost clock; 3.35 TB/s of HBM3."""
from __future__ import annotations

H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9
H100_HBM_BYTES_PER_S = 3.35e12

# Integer operations (add, subtract, max, compare, shift, or, table read)
# that one cell of the recurrence needs, whatever kernel computes it. The
# scoring: a substitution from a 16 x 16 table of IUPAC masks, one gap
# cost GO at any length, so a gap's state is a running max:
#   s = T[a_i << 4 | b_j]          2: an or (the row's a_i << 4 is per row), a read
#   M = H[i-1][j-1] + s            1
#   F = max(F[i-1][j], H[i-1][j] - GO)  2
#   N = max(M, F)                  1
#   E = max(E[i][j-1], N[i][j-1] - GO)  2
#   H = max(N, E)                  1
# 9 operations for the score. A traceback needs four bits a cell: F > M,
# E > N, and whether F and E opened here or carried on (F[i-1][j] >=
# H[i-1][j] - GO, likewise for E): 4 compares and 3 shift-adds (one
# instruction each) to pack them, 7 more, and half a byte written. The stripe route keeps that
# record; the checkpoint route keeps none (its walk recomputes windows).
DP_OPS_PER_CELL = {"v2": 16, "ckpt": 9}
DP_BYTES_PER_CELL = {"v2": 0.5, "ckpt": 0}
# the widest band half-width a kernel computes (the aligner clamps wider
# bands to it)
KERNEL_W_CAP = 1023


def dp_cells(rlen: int, qlen: int, W: int) -> int:
    """The cells a banded DP over this problem has to compute: every row
    of the reference, each over the band's 2W + 1 diagonals or the query's
    qlen + 1 columns, whichever is fewer."""
    return rlen * min(2 * min(W, KERNEL_W_CAP) + 1, qlen + 1)


def dp_least_seconds(problems: list) -> tuple:
    """(least seconds, which bound binds) for problems [(ckpt, rlen, qlen,
    W)] on one H100: operations over the INT32 peak or bytes (inputs read
    once, records written once) over the HBM peak, the larger. The work is
    the recurrence's (DP_OPS_PER_CELL), not a kernel's own row step."""
    ops = nbytes = 0
    for ckpt, rlen, qlen, W in problems:
        route = "ckpt" if ckpt else "v2"
        c = dp_cells(rlen, qlen, W)
        ops += c * DP_OPS_PER_CELL[route]
        nbytes += rlen + qlen + c * DP_BYTES_PER_CELL[route]
    t_ops, t_bytes = ops / H100_INT32_OPS_PER_S, nbytes / H100_HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
