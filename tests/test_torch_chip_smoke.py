"""chip_smoke.py's checks and bounds that need no card: the headline's
quality limits (check_quality) and the DP's bound, whose operations a cell
and peaks are the benchmark's yardstick's (port_bench/yardstick.py) beside
chip_smoke's own dependency bound (dp_row_cycles)."""
from __future__ import annotations

import math
import re

import pytest

import chip_smoke
from port_bench import yardstick


@pytest.mark.parametrize("key", [None, "n_blocks", "core_fraction", "pangenome_bp"])
def test_check_quality(key):
    """The reference's figures pass; each figure moved, up or down, to just
    inside its tolerance (relative for blocks and bp, absolute for the core
    fraction) passes, and just past it raises, naming that figure alone."""
    want = chip_smoke.HEADLINE_QUALITY
    chip_smoke.check_quality("test", dict(want))
    if key is None:
        return
    tol = chip_smoke.QUALITY_TOLERANCE[key]
    for sign in (1, -1):
        if key == "core_fraction":
            inside, past = want[key] + sign * 0.99 * tol, want[key] + sign * 1.01 * tol
        else:
            step = math.floor(tol * want[key])
            inside, past = want[key] + sign * step, want[key] + sign * (step + 1)
        chip_smoke.check_quality("test", {**want, key: inside})
        assert chip_smoke.quality_off({**want, key: past}, want) == {key: (past, want[key])}
        with pytest.raises(AssertionError, match=re.escape(f"test: graph quality (got, reference) "
                                                           f"{{'{key}': ({past}, {want[key]})}} lies beyond")):
            chip_smoke.check_quality("test", {**want, key: past})


@pytest.mark.parametrize("route", ["v2", "ckpt"])
def test_dp_bound_reads_the_yardstick(route):
    """The DP's bound on a small problem set: its operation bound is the
    cells at the yardstick's operations a cell over the yardstick's INT32
    peak, its byte bound the bytes over its HBM peak, and its dependency
    bound the longest problem's rows times dp_row_cycles(B), which binds
    at this shape."""
    B = 128
    _ref, _qry, rlen, qlen, _ms, _W = chip_smoke.kernel_inputs(B, 4096, 4, seed=1)
    in_bytes, cells = chip_smoke._dp_work(rlen, qlen, B)
    bound = chip_smoke._dp_bound(in_bytes, cells, rlen, B, route)
    assert cells == int(rlen.sum()) * B
    assert bound["ops_ms"] == cells * yardstick.DP_OPS_PER_CELL[route] / yardstick.H100_INT32_OPS_PER_S * 1e3
    assert bound["bytes_ms"] == in_bytes / yardstick.H100_HBM_BYTES_PER_S * 1e3
    assert bound["bound_ms"] == max(bound["ops_ms"], bound["bytes_ms"]) and bound["bound_by"] == "operations"
    assert bound["dep_bound_ms"] == int(rlen.max()) * chip_smoke.dp_row_cycles(B) / chip_smoke.SM_CLOCK_HZ * 1e3
    assert bound["dep_bound_ms"] > bound["bound_ms"] and bound["binds"] == "dependency"
