"""The decode kernel (csrc/walk.cu:decode_events_kernel) on the launches of
one headline build: its time against its byte bound.

    python3 dev/decode_cuda.py [SEED]

Builds the benchmark's ecoli10 deployment from SEED (default 13) once to
warm up and once with the launch log on (stripe_v2.KERNEL_TIMING) and every
decode's inputs kept, then prints one JSON object: per length tier, the
decode's launches, problems, rows, substitutions, events, summed event-pair
ms and the least time its bytes take at 3.35 TB/s (each byte of ref, qry,
the walk's event slots in use, meta and n_events read once; the head,
substitutions and events written once), beside the DP's and the walk's
summed ms. Run from the repository root, on a card.
"""
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from pangraph_tpu_torch.build.build import build  # noqa: E402
from pangraph_tpu_torch.ops import stripe_v2 as sv  # noqa: E402
from pangraph_tpu_torch.ops.batch_align import BatchAligner  # noqa: E402
from port_bench import generators, harness  # noqa: E402
from port_bench.yardstick import H100_HBM_BYTES_PER_S  # noqa: E402


def main(seed: int) -> dict:
    _m, _w, config, _traffic = harness.load_cell("ecoli10-build")
    args = harness.build_args(config)
    recs = harness.records(generators.make(config["genomes"], seed))
    al = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts, device="cuda")
    build(recs, args, aligner=al).to_json()
    kept = []
    decode = sv.decode_events

    def keep(rows, words, n_events, meta, ref, qry, rlen, qlen):
        out = decode(rows, words, n_events, meta, ref, qry, rlen, qlen)
        kept.append((ref.shape[1], n_events, rlen, qlen, out["totals"], rows.shape[1]))
        return out

    sv.decode_events = keep
    sv.KERNEL_TIMING = []
    try:
        t0 = time.time()
        build(recs, args, aligner=al).to_json()
        torch.cuda.synchronize()
        wall = time.time() - t0
        log = sv.KERNEL_TIMING
    finally:
        sv.decode_events = decode
        sv.KERNEL_TIMING = None
    ms = collections.Counter()
    for name, *_x, start, end, _stream in log:
        ms[name] += start.elapsed_time(end)
    decodes = [entry for entry in log if entry[0] == "decode_events"]
    assert len(decodes) == len(kept), (len(decodes), len(kept))
    tiers = {}
    for (_n, _B, R, m, _dev, start, end, _s), (_R, nev, rlen, qlen, totals, K) in zip(decodes, kept):
        t = tiers.setdefault(tier_of(R), collections.Counter())
        n_sub, n_ev = totals.tolist()
        n = nev.clamp(0, K).long()
        rows = int(rlen.long().sum())
        read = rows + int(qlen.long().sum()) + int(n.sum()) * 8 + m * (16 + 4 + 8)
        wrote = m * sv.DECODE_HEAD * 4 + n_sub * 5 + n_ev * 16
        t.update({"launches": 1, "problems": m, "rows": rows, "subs": n_sub, "events": n_ev,
                  "bytes": read + wrote})
        t["ms"] += start.elapsed_time(end)
    out = {"device": torch.cuda.get_device_name(0), "seed": seed, "build_wall_s": round(wall, 3),
           "kernel_ms": {k: round(v, 3) for k, v in ms.items()}, "decode_by_tier": {}}
    for tier, t in sorted(tiers.items()):
        bound = 1e3 * t["bytes"] / H100_HBM_BYTES_PER_S
        out["decode_by_tier"][tier] = {**{k: int(v) for k, v in t.items() if k != "ms"}, "ms": round(t["ms"], 3),
                                       "bound_ms": round(bound, 4), "bound_share": round(bound / t["ms"], 4)}
    return out


def tier_of(R: int) -> int:
    """The length tier of a launch whose widest ref is R bytes."""
    return next(t for t in BatchAligner.R_TIERS if t >= R)


if __name__ == "__main__":
    print(json.dumps(main(int(sys.argv[1]) if len(sys.argv) > 1 else 13)))
