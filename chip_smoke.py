"""Smoke run of pangraph_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero and prints no result):

1. toolchain: torch, CUDA, nvcc, the card and its power limit;
2. build: the five CUDA kernel sources (csrc/*.cu, one nvcc each, in
   parallel) and the host C++ engine (native/*.cpp), its default build and
   its scalar one (-DSTRIPE_FORCE_SCALAR), from the sources in this
   checkout; then the host engine's two row loops on the reference's 40
   parity jobs (tests/test_native.py:94), which must agree job for job,
   with the row loop the default build selected on this host;
3. kernels against their plain PyTorch versions on the card, on random pairs
   with indels, IUPAC codes, N and shifted bands: the stripe DP and its walk
   at band widths B in {128, 256, 2048} and record rows R in {4096, 10240},
   and at B 384 and 512 at R 4096 (B 256 and 384 are the two sides of the
   DP's switch from a warp to a block a problem), and at B 512, R 10240 on
   pairs with indels of 20-120 bp, so that the walk reads gap runs longer
   than a warp (records and events equal element for element), and the
   checkpoint pair
   at the shapes the long-tier path gives it, (B 128, R 65536),
   (B 1920, R 131072) and (B 2048, R 10240), and at (B 1920, R 10240) on
   two problems, every problem through the kernels, whose events must
   equal the v2 kernels', and at (B 128, R 65536), (B 2048, R 10240) and
   (B 1920, R 10240) (CKPT_PLAIN_SHAPES) every problem's carries against
   the plain DP's, and two problems of each shape (the one with the most
   windows among them) through the plain walk too (carries, events and meta
   equal element for element); at (B 1920, R 131072) the kernels are timed
   and held against the v2 kernels' events only, and band 1920 is held
   against the plain versions on the short tier;
   kernel and plain times are printed, with the checkpoint walk's waves and the device ms of
   its re-derive and walk launches apart, and each walk's dependency bound
   and cycles a dependent read; at every shape of both routes the decode
   of the card walk's events (decode_events) against its plain version on
   the same tensors (the head but its offsets, the totals and each
   problem's substitutions and events equal), timed, with its byte bound;
3b. the checkpoint pair at Mbp scale (B 128, R 2,097,152, 32 problems),
   kernels only: its events must equal the v2 kernels' on the same batch;
   both routes are timed, with their carry and record bytes, and the
   checkpoint walk's re-derive and walk launches apart;
3c. the sketch and chain kernels against their plain versions on the card:
   the sketch on random code batches with N and lowercase (8 and 9 rows of
   150-300 kbp) at (k, w) = (15, 100), (19, 19), (7, 5) and (28, 19) (the
   kernel's 32-bit, 64-bit and (value, position) key paths), dense outputs
   equal element for element; the chain DP on random anchor clouds of 4,100
   and 20,000 anchors, f and parent equal; kernel and plain times printed,
   with the chain's cycles a step and the sketch's SM cycles a window start
   and its bytes and operations bounds;
4. the main path: `build -c -f -j 2 --device cuda --devices 1` through the
   CLI (one device on any host) on the headline pangenome (10 x 4.6 Mbp from make_accessory_pangenome, seed 13),
   with an exact roundtrip, the DP, walk and decode launched, the checkpoint pair
   not launched, and at least half of the DP cells on the device; graph
   quality is printed beside the reference's figures for the same input
   (1156 blocks, core fraction 0.4875, 7,028,975 bp: HEADLINE_QUALITY)
   and must stay within QUALITY_TOLERANCE of them; the kernels' launch log
   (stripe_v2.KERNEL_TIMING) gives each DP and walk kernel's launches and
   summed device ms, per band width B, and a histogram of problems per
   launch for each B; the build runs under torch.profiler (CUDA activity
   only), which adds each kernel's summed kernel-only ms and the card's busy
   share of the wall (kernels, copies and memsets); the aligner's round
   broker's combined rounds, the legs they held and the most legs in one
   round are printed beside the DP and walk launches;
5. the long-tier path: the same build with PANGRAPH_TPU_CKPT_BYTES=32000000,
   which sends the tiers whose per-problem records pass 32 MB (counted as
   the reference counts them) to the checkpoint pair: exact roundtrip, all
   four kernels launched, the same device-share and quality limits; the
   launch log gives the checkpoint walk's device ms in all and split into
   its re-derive and walk launches (`walk_ckpt.rederive`, `walk_ckpt.walk`).
   Neither build launches the sketch or chain kernel: the build sketches and
   chains in host C++, as the reference's does;
6. the sketch and chain path on the headline's genomes: all ten sketched on
   the card in one launch per parameter set, at the mapper's (19, 19) and
   the guide tree's (15, 100), each genome's minimizers equal to the host
   C++ sketch; the mapper's all-vs-all anchors of the ten (90 groups) chained
   in one launch, f and parent equal to the host C++ chain DP for every
   group; then both kernels' outputs held against their plain versions on
   the card on the same inputs (all ten genomes at both parameter sets, all
   90 groups); kernel times, and the chain's cycles a step, beside the host
   engines' times for the same work;
7. the CLI path, through pangraph_tpu_torch.cli.main on phase 4's graph,
   each step's wall on a line of its own: `reconstruct --verify` (exit 0),
   `export gfa` (an S line a block, a P line a genome), `export
   block-consensus` (each record its block's consensus), `export
   core-genome` (ten aligned records of one length), `export
   block-sequences` (a file a block), `schema` (JSON), `simplify` into
   genomes 0-4 and 5-9 (each half verified), then `merge -c --device cuda`
   of the two halves (half B's blocks under fresh ids, since both halves
   keep the core blocks' ids), with the launch counts set to 0 just before
   it: the DP and walk launched, the checkpoint pair, sketch and chain not,
   at least half the DP cells on the device, all ten genomes reconstructed
   exactly; then the same merge with the reference's host-leg budget
   (BatchAligner.NATIVE_CELL_BUDGET = 100,000,000 cells, what
   PANGRAPH_TPU_NATIVE_BUDGET=100000000 sets), which the adaptive split
   routes (check_gate_log: every round's split is the reference's rule
   recomputed from the state logged before it), with the other checks,
   some cells on the host and some on the device, both walls, device
   shares and host cells printed; the merged graph's quality beside phase
   4's (no bound), its launch-log lines, and its MSU and backbone-junction counts through the
   pypangraph facade (through the analysis layer's pandas-free parts where
   pandas is absent);
8. the mesh path: the headline build again with its alignment launches
   split over a mesh (parallel/mesh.py): `build -c -f -j 2 --device cuda
   --devices <cards>` through the CLI where there are two cards or more,
   else build() with the CLI's arguments and a BatchAligner over two
   shards of card 0 (and the CLI's `--devices 2` must exit 1), with the
   launch counts set to 0 just before it: the graph byte-equal to phase
   4's, an exact roundtrip, the DP and walk launched on every shard and
   card (launches and device ms per card from the launch log, launches and
   DP cells per shard from the aligner), the checkpoint pair, sketch and
   chain not, the device cells equal to phase 4's and at least half of
   all cells; the build runs with a broker gather window of MESH_GATHER_S,
   and at least one combined round must hold both merge threads' legs, so
   that the byte-equality holds coalesced rounds against phase 4's; on one
   card, the summed ms in which the two shards' DP launches ran at once
   (the launch log's event pairs on one timeline);
   then one checkpoint-route round on two shards against one
   device on 4 of phase 3's (128, 65536) problems, Edits equal;
9. the cluster path: two worker processes
   (parallel/distributed.launch_local_cluster, a gloo process group, the
   merge tree split through the TCP coordinator, each worker's launches
   over two shards of card 0) on the reference's worker workload (6 x 900
   bp): both graphs equal to a solo build's on the card, the group's sum
   equal to the cluster's 4 shards, 1-5 merges claimed, the DP and walk
   launched in the workers;
11. the gated path: the headline built in this process (build() with
   BuildArgs(circular=True, jobs=2), a BatchAligner on card 0) at
   NATIVE_CELL_BUDGET = 100,000,000 cells, the reference's default, so that
   the adaptive host/device split routes every round; the launch counts
   set to 0 just before it: an exact roundtrip, quality within
   QUALITY_TOLERANCE, the DP and walk launched with launch-log device ms,
   the checkpoint pair, sketch and chain not, some cells on the device (no
   bound on the share: the gate decides it), and every logged round's
   split equal to the reference's rule recomputed from the state logged
   before it (check_gate_log); the engines' rates, the overhead and the
   measured round trip, the rounds by kind, the wall and the device share
   on `phase11.*` lines;
12. the checkpoint route: the headline built as in phase 11, with the
   aligner's record budget cut to CKPT_ROUTE_RECORD_BUDGET bytes, so that
   the groups of the 10,240 tier and up do not fit and the reference's
   measured-rate rule (`_ckpt_competitive`) sends each to the checkpoint
   pair while no checkpoint rate is known or while it beats the host rate,
   else to the host engine; the launch counts set to 0 just before it:
   phase 11's checks, every CKPT_LOG entry recomputed (check_ckpt_log: the
   rate's EMA from the logged observations, each decision from the rates
   it logged), at least one round wholly on the checkpoint route observing
   the rate, at least one group decided by both measured rates, the
   checkpoint DP and walk launched with their launch-log ms, the sketch and
   chain not; the checkpoint rate against the host rate, the decisions by
   answer, the device share and the wall on a `phase12.ckpt_route` line.
   A `[wall]` line gives each phase's wall, and a `[total]` line the
   run's.

Kernel times are CUDA event pairs over TIMED_REPS launches, except the
walk's, the chain's and the sketch's: theirs are kernel-only, from
torch.profiler's kernel records (_kernel_ms), since the walk's and chain's
wrappers wait on the host and the sketch's checks its codes for negative
values (a reduction and a host read) before each launch; the sketch's event
pair through its wrapper, which includes that check, is printed beside.
Where the profiler keeps no launch of a kernel in PROFILE_TRIES sessions,
that time is the event pair instead, a kernel_ms_fallback line says so,
and the kernel's receipt says "timed_by": "profiler, events in some phase".

Before the last line it prints one JSON line of kernel receipts (each of
the six with its launches on its path, the DP's and walk's also on phase
7's merge and phase 11's gated build, the four
alignment kernels' on phase 8's mesh and on phase 12's build, with that
build's launch-log ms, its worst error
against its plain version, its
time and its plain version's, and its bound) and the card's name and power
limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
IUPAC_EXTRA = np.frombuffer(b"NRYSWKMBDHVN", np.uint8)
# (B, R, problems); B 256 and 384 sit on each side of the DP's switch from
# one warp a problem to one block a problem (DP_WARP_MAX_B)
KERNEL_SHAPES = [(128, 4096, 256), (128, 10240, 256), (256, 4096, 128), (256, 10240, 128),
                 (384, 4096, 64), (512, 4096, 32), (2048, 4096, 32), (2048, 10240, 32)]
# and one shape whose pairs take indels of 20-120 bp (balanced, so that they
# stay inside the band), so that the walk reads gap runs longer than a warp
LONG_INDEL_SHAPE = (512, 10240, 32)
LONG_INDELS = {"indel_every": 1000, "balanced": True, "indel_len": (20, 121)}
PLAIN_WALK_PROBLEMS = 16
WALK_K = 256
TIMED_REPS = 5
# the walk and chain kernels' names in a profiler trace (_kernel_ms): their
# times there are kernel-only, since their wrappers synchronize on the host
WALK_KERNEL = "::walk_v2_kernel("
CHAIN_KERNEL = "::chain_kernel("
PROFILE_TRIES = 5  # profiler sessions a _kernel_ms timing may take
# the kernels (their names above) whose time in some phase is an event pair
# because the profiler kept no launch of them (_kernel_ms)
EVENT_TIMED: set = set()
# (B, R, problems): the shapes the long-tier path (phase 5) gives the pair:
# its 65,536 tier at B 128, its 131,072 tier at its widest band, and its
# 10,240 tier at the kernel's widest band; then band 1920 on a short tier,
# where its plain versions take seconds; R is the tier, the problems' rows
# are drawn from the tier's range (R/2 to R)
CKPT_SHAPES = [(128, 65536, 8), (1920, 131072, 4), (2048, 10240, 8), (1920, 10240, 2)]
# the checkpoint walk's plain version takes minutes at these shapes, so it
# runs on this many of each shape's problems: the one with the most windows
# and the first of the others (_plain_ckpt_problems; dev/ckpt_plain_cost.py
# times it against every problem). The plain DP runs on every problem: it
# steps all of them through the longest one's rows at once, so its time
# barely follows their count
PLAIN_CKPT_WALK_PROBLEMS = 2
# the shapes at which the pair is held against its plain versions; at
# (1920, 131072) the plain DP and walk took about 116 s and 92-127 s of
# each run (PERF.md §6-7), so there the kernels are timed and their events
# held against the v2 kernels' only, and band 1920 meets its plain
# versions at (1920, 10240), whose time follows its longest problem's rows
CKPT_PLAIN_SHAPES = {(128, 65536), (2048, 10240), (1920, 10240)}
MBP_SHAPE = (128, 2_097_152, 32)
MBP_K = 2048  # the checkpoint route's event capacity (BatchAligner.CKPT_K_CAP)
CKPT_OVERRIDE_BYTES = "32000000"
# The card's peaks for bound_ms and the DP's integer operations a cell are
# the benchmark's yardstick's (port_bench/yardstick.py: H100_HBM_BYTES_PER_S,
# H100_INT32_OPS_PER_S, DP_OPS_PER_CELL, the recurrence's count at each
# route). The clock and the SMs below turn times into cycles.
SM_CLOCK_HZ = 1.98e9
N_SMS = 132
# The DP's dependency: row i needs all of row i-1, so a problem's rows run
# one after another and a launch takes at least its longest problem's rows
# times the cycles of one row's critical path, at SM_CLOCK_HZ. The path is
# that of the interior form of csrc/stripe_row.cuh's row step, which most
# rows take. Latencies are assumed, not measured: 4 cycles a dependent
# integer operation, 24 a warp shuffle, 30 a warp reduction, 40 a block
# barrier with its shared-memory exchange. LPT = lanes a thread: B / 32 in
# the warp layout (B <= DP_WARP_MAX_B), 4 in the wide one.
DP_WARP_MAX_B = 256
DP_ROW_CYCLES = {  # the path from one row's horizontal-gap prefix to the next row's
    "H = max(NQ, prefix, local prefix): one 3-input max": 4,
    "next row's P: diagonal add, NQ max, subtract the gap open": 3 * 4,
    "the thread totals shifted up one thread: a shuffle and a pick": 24 + 4,
    "warp scan of the thread totals: 3 levels of shuffles, 5 maxes": 3 * 24 + 5 * 4,
    "prefix over the warps below: one max": 4,
}
DP_LANE_CYCLES = 2  # the thread's own prefix of P and its total: a 3-input max per two lanes
DP_ROW_CYCLES_WIDE = {  # added in the wide layout
    "one block barrier with the per-warp exchange": 40,
    "the warps' totals: one warp reduction": 30,
}


def dp_row_cycles(B: int) -> int:
    """Assumed cycles of one DP row's critical path at band width B."""
    lpt = B // 32 if B <= DP_WARP_MAX_B else 4
    wide = sum(DP_ROW_CYCLES_WIDE.values()) if B > DP_WARP_MAX_B else 0
    return sum(DP_ROW_CYCLES.values()) + DP_LANE_CYCLES * lpt + wide


# per walk move, from ops/stripe_v2.py:_Walker.move (csrc/walk_step.cuh)
WALK_OPS_PER_MOVE = 35
# The walks' dependency: each move reads the record that decides the next
# move, so a walk takes at least its record reads times the latency of one
# dependent load (with the move's few dozen operations behind it). Assumed,
# not measured: 300 cycles, about an L2 hit's latency on Hopper as published
# microbenchmarks give it; a load that misses L2 costs more. Problems walk at
# once (one thread or one warp each), so a launch takes at least its
# longest walk's.
DEP_LOAD_CYCLES = 300
# (k, w) of phase 3c's sketch batches; rows per batch; row lengths (bp)
SKETCH_PARAMS = [(15, 100), (19, 19), (7, 5), (28, 19)]
SKETCH_ROWS = (8, 9)
SKETCH_ROW_BP = (150_000, 300_000)
CHAIN_SIZES = (4100, 20000)  # anchors per random cloud (phase 3c)
# (k, w) of phase 6: the mapper's index sketch (align/mapper.py MapperParams)
# and the guide tree's mash sketch (build/tree.py -> mash_distance)
PATH_SKETCH_PARAMS = [(19, 19), (15, 100)]
# Integer operations per k-mer position that the sketch needs, counted from
# ops/sketch_k1.py:sketch_dense_plain as a design that is O(1) a position
# computes it: the codes packed 2 bits a code (their complement and validity
# then cost a few operations a word of 16 codes, not counted), the k-mer
# codes rolled or cut from the packed words, each shift-add group of the mix
# one multiply-add by a constant (x + (x << 3) + (x << 8) is x * 265), and
# the window minimum van Herk / Gil-Werman's. One per add, multiply-add,
# shift, xor, and, or, compare or pick of a 32-bit word: (count, whether
# each acts on the k-mer's 2k-bit word). At k > 16 that word takes two
# 32-bit words, so those count twice; at k <= 16 one, since the mix is exact
# in 32-bit words there (its right shifts act on values already masked to
# 2k <= 32 bits).
SKETCH_OPS = {
    "code: substitute (min with 4), fold into the packed word": (2, False),
    "forward k-mer: shift, or, mask": (3, True),
    "reverse k-mer: shift, shift the complement in, or": (3, True),
    "valid run: compare, add or reset": (2, False),
    "canonical: unsigned compare, equal test, pick": (3, True),
    "Jenkins mix: 4 multiply-adds, 3 shifts, 3 xors, 4 masks": (14, True),
    "sentinel: and": (1, False),
    "sentinel: pick": (1, True),
    "position and strand: shift, or": (2, False),
    "window minimum, 2 running-minimum steps: value compare and value pick": (4, True),
    "window minimum, 2 running-minimum steps: position pick": (2, False),
}


def sketch_ops_per_position(k: int) -> int:
    """SKETCH_OPS summed at k: 65 at k > 16, 37 at k <= 16."""
    return sum(n * (2 if wide and k > 16 else 1) for n, wide in SKETCH_OPS.values())


# the sketch kernel's name in a profiler trace (_kernel_ms)
SKETCH_KERNEL = "::sketch_kernel"
# Integer operations per (anchor, predecessor) pair, from
# ops/chain_k2.py:chain_sets_plain, one per add, compare, min, pick or shift
CHAIN_OPS = {
    "dr, dq: 2 subtracts": 2,
    "dd: subtract, absolute value": 2,
    "gates: 5 compares, 4 ands": 9,
    "alpha: 2 mins": 2,
    "gap: multiply, divide by 100 (multiply-high, shift), floor(log2) (leading zeros, subtract, cap), shift, add": 8,
    "candidate: add, subtract, pick": 3,
    "running best: compare, 2 picks": 3,
}
CHAIN_OPS_PER_PAIR = sum(CHAIN_OPS.values())
# The chain's dependency: f[i] needs f[i-1] through at least an add and a max,
# two dependent integer operations of about 4 cycles each (an assumed
# latency, not measured) at SM_CLOCK_HZ
CHAIN_DEP_CYCLES = 8


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_toolchain(torch) -> dict:
    from pangraph_tpu_torch.ops import cuda_build

    nv = subprocess.run([cuda_build.nvcc(), "--version"], capture_output=True, text=True, check=True)
    info = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nv.stdout.strip().splitlines()[-1],
        "device": torch.cuda.get_device_name(0),
        "smi": smi_line(),
    }
    say("toolchain", **{k: repr(v) for k, v in info.items()})
    return info


# the host engine's row-loop parity: the jobs of the reference's
# tests/test_native.py:94, results compared field by field
ROW_LOOP_SEED = 202
ROW_LOOP_JOBS = 40
NATIVE_FIELDS = ("status", "boundary", "n_ops", "n_subs", "lead_ins")


def native_mutate(ref, n_sub: int, indels: int, rng):
    """A query from `ref` with n_sub substitutions and `indels` indels of
    1-11 bp (the reference's tests/test_native.py recipe)."""
    q = list(ref)
    for _ in range(n_sub):
        i = rng.integers(0, len(q))
        q[i] = ACGT[rng.integers(0, 4)]
    for _ in range(indels):
        i = int(rng.integers(1, max(len(q) - 1, 2)))
        L = int(rng.integers(1, 12))
        if rng.random() < 0.5:
            del q[i : i + L]
        else:
            q[i:i] = list(ACGT[rng.integers(0, 4, L)])
    return np.array(q, np.uint8)


def row_loop_jobs() -> tuple:
    """The reference's 40 row-loop parity jobs (tests/test_native.py:94,
    seed 202): 10-2,000 bp, N in every sixth reference, bands of 2-59 with
    mean shifts of -10 to 9. Returns (refs, qrys, ms, W)."""
    rng = np.random.default_rng(ROW_LOOP_SEED)
    refs, qrys, mss, Ws = [], [], [], []
    for trial in range(ROW_LOOP_JOBS):
        L = int(rng.integers(10, 2000))
        ref = ACGT[rng.integers(0, 4, L)]
        if trial % 6 == 0:
            ii = rng.choice(L, max(1, L // 50), replace=False)
            ref[ii] = ord("N")
        refs.append(ref)
        qrys.append(native_mutate(ref, int(L * 0.04), max(1, L // 200), rng))
        mss.append(int(rng.integers(-10, 10)))
        Ws.append(int(rng.integers(2, 60)))
    return refs, qrys, np.array(mss), np.array(Ws)


def native_results_differ(a: dict, b: dict) -> list:
    """The jobs whose stripe_align_batch_native results differ between two
    calls: any flag or count, or any of their ops or subs."""
    if len(a["status"]) != len(b["status"]):
        raise ValueError("results of different job counts")
    return [s for s in range(len(a["status"]))
            if any(a[k][s] != b[k][s] for k in NATIVE_FIELDS)
            or not np.array_equal(a["ops"][s], b["ops"][s]) or not np.array_equal(a["subs"][s], b["subs"][s])]


def native_row_loop() -> str:
    """The row loop the host engine's default build compiles on this host
    (native/stripe.cpp:34): "avx512" where g++ -march=native defines
    __AVX512F__ and __AVX512BW__, else "scalar"."""
    macros = subprocess.run(["g++", "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
                            capture_output=True, text=True, check=True).stdout.split("\n")
    have = {line.split()[1] for line in macros if line.startswith("#define ")}
    return "avx512" if {"__AVX512F__", "__AVX512BW__"} <= have else "scalar"


def phase_build() -> None:
    """The five CUDA kernel libraries and the host engine's default and
    scalar builds, in parallel; then the host engine's two row loops on the
    reference's 40 parity jobs (row_loop_jobs), which must agree job for
    job, with the row loop the default build selected on this host."""
    import concurrent.futures as cf

    from pangraph_tpu_torch import native
    from pangraph_tpu_torch.align.params import BandedAlignParams
    from pangraph_tpu_torch.graph.seq import IUPAC_MASK
    from pangraph_tpu_torch.ops import cuda_build

    t0 = time.time()
    with cf.ThreadPoolExecutor(max_workers=3) as ex:
        host = ex.submit(native.get_lib)
        scalar = ex.submit(native.get_scalar_lib)
        kernels = ex.submit(cuda_build.build_all)
        libs = kernels.result()
        if host.result() is None or scalar.result() is None:
            raise RuntimeError("the host C++ engine did not build")
    say("build", seconds=round(time.time() - t0, 3), kernels=sorted(libs))
    for src, log in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("ptxas", source=src, info=repr(line.strip()))
    refs, qrys, ms, W = row_loop_jobs()
    t0 = time.time()
    default = native.stripe_align_batch_native(refs, qrys, ms, W, BandedAlignParams(), IUPAC_MASK)
    t1 = time.time()
    forced = native.stripe_align_batch_native(refs, qrys, ms, W, BandedAlignParams(), IUPAC_MASK,
                                              lib=scalar.result())
    t2 = time.time()
    bad = native_results_differ(default, forced)
    say("build.row_loops", default_build=native_row_loop(), jobs=len(refs),
        aligned=int((default["status"] == 0).sum()), differ=json.dumps(bad), default_ms=round((t1 - t0) * 1e3, 3),
        scalar_ms=round((t2 - t1) * 1e3, 3))
    if bad:
        raise AssertionError(f"the host engine's row loops disagree on jobs {bad}")


def _mutate(ref, rng, indel_every: int = 400, balanced: bool = False, indel_len: tuple = (1, 9)):
    """A related query: ~1% substitutions (some IUPAC codes and N) and an
    indel of indel_len[0] to indel_len[1] - 1 bp (1-8 by default) every
    `indel_every` bp on average; with `balanced`, deletions and insertions
    alternate at equal lengths, so that the pair stays near its diagonal
    over Mbp, or, with long indels, inside its band."""
    q = ref.copy()
    n = len(q)
    idx = rng.choice(n, n // 100, replace=False)
    q[idx] = ACGT[rng.integers(0, 4, len(idx))]
    amb = rng.choice(n, max(1, n // 2000), replace=False)
    q[amb] = IUPAC_EXTRA[rng.integers(0, len(IUPAC_EXTRA), len(amb))]
    parts, prev, L = [], 0, 1
    for t, p in enumerate(np.sort(rng.choice(np.arange(1, n - 50), max(1, n // indel_every), replace=False))):
        if p < prev:
            continue
        parts.append(q[prev:p])
        if not (balanced and t % 2):
            L = int(rng.integers(*indel_len))
        if (t % 2 == 0) if balanced else rng.random() < 0.5:
            prev = p + L  # deletion
        else:
            parts.append(ACGT[rng.integers(0, 4, L)])  # insertion
            prev = p
    parts.append(q[prev:])
    return np.concatenate(parts)


def kernel_inputs(B: int, R: int, m: int, seed: int, **mutation):
    rng = np.random.default_rng(seed)
    W = (B - 2) // 2
    refs, qrys, mss = [], [], []
    for _ in range(m):
        n = int(rng.integers(R // 2, R - 64))
        r = ACGT[rng.integers(0, 4, n)]
        r[rng.choice(n, max(1, n // 3000), replace=False)] = ord("N")
        q = _mutate(r, rng, **mutation)[: R - 2]
        refs.append(r)
        qrys.append(q)
        # shifted bands centred on the pair's mean drift, off by up to W/4
        drift = len(q) - len(r)
        mss.append(-(drift // 2) + int(rng.integers(-(W // 4), W // 4 + 1)))
    Q = max(len(q) for q in qrys)
    ref_in = np.zeros((m, R), np.uint8)
    qry_in = np.zeros((m, Q), np.uint8)
    for s in range(m):
        ref_in[s, : len(refs[s])] = refs[s]
        qry_in[s, : len(qrys[s])] = qrys[s]
    rlen = np.array([len(r) for r in refs], np.int32)
    qlen = np.array([len(q) for q in qrys], np.int32)
    ms = np.array(mss, np.int32)
    Wv = np.full(m, W, np.int32)
    return ref_in, qry_in, rlen, qlen, ms, Wv


def _event_ms(torch, fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _trace_events(prof) -> list:
    """The events of a finished torch.profiler session, from its chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]


def _kernel_ms(torch, fn, reps: int, name: str) -> float:
    """Kernel-only device ms a call of fn (one launch of the kernel whose
    name holds `name`), the mean of torch.profiler's kernel records (CUDA
    activity only) over reps calls after a warm-up. Unlike _event_ms, it
    leaves out the host's time between launches, which a launch of a few
    microseconds does not hide. The profiler loses kernel records on an
    H100: the v2 walk's sessions keep 4 of 5, and a sketch or chain session
    after other work on the card has kept none. So a session that kept fewer
    than reps is run again, up to PROFILE_TRIES times, and the mean is over
    the records of the fullest one; each short session is reported on
    stderr. Where none kept a launch, the time is fn's event pair
    (_event_ms, host time between launches included), the kernel joins
    EVENT_TIMED, and a kernel_ms_fallback line says so."""
    fn()
    torch.cuda.synchronize()
    best = []
    for attempt in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = [float(e.get("dur", 0)) for e in _trace_events(prof)
                if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel" and name in str(e.get("name", ""))]
        if len(durs) > reps:
            raise AssertionError(f"the profiler saw {len(durs)} launches of {name} in {reps} calls")
        best = max(best, durs, key=len)
        if len(best) == reps:
            break
        print(f"_kernel_ms: the profiler kept {len(durs)} of {reps} launches of {name} (session {attempt + 1})",
              file=sys.stderr, flush=True)
    if best:
        return sum(best) / len(best) / 1e3
    ms = _event_ms(torch, fn, reps)
    EVENT_TIMED.add(name)
    say("kernel_ms_fallback", kernel=name, sessions=PROFILE_TRIES, event_ms=round(ms, 4))
    return ms


def _host_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over its
    memory rate and the integer operations over its int32 throughput."""
    from port_bench import yardstick

    t_bytes = nbytes / yardstick.H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / yardstick.H100_INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops}


def _dp_bound(nbytes: float, cells: int, rlen, B: int, route: str) -> dict:
    """A DP's bound: `_bound` of its bytes and of its cells at the
    yardstick's operations a cell on `route` ("v2": with a record, "ckpt":
    carries only), beside its dependency bound, the longest problem's rows
    times dp_row_cycles(B); `binds` names the larger."""
    from port_bench import yardstick

    out = _bound(nbytes, cells * yardstick.DP_OPS_PER_CELL[route])
    out["dep_bound_ms"] = int(np.max(rlen, initial=0)) * dp_row_cycles(B) / SM_CLOCK_HZ * 1e3
    out["binds"] = "dependency" if out["dep_bound_ms"] > out["bound_ms"] else out["bound_by"]
    return out


def _dp_work(rlen, qlen, B: int) -> tuple:
    """(input bytes, cells) of a DP over these problems: each sequence byte
    and the four int32 problem vectors read once."""
    return int(rlen.sum()) + int(qlen.sum()) + 16 * len(rlen) + 256, int(rlen.sum()) * B


def _walk_reads(out, rlen, K: int, jump_rows: int = None) -> np.ndarray:
    """A lower bound on each problem's dependent record reads, from its
    events and meta, that any walk design needs: one per gap run (a deletion
    event, an insertion attached to an event, a pending insertion), since a
    run's first cell must be read before its length is known, and, for a
    walk whose match jumps cover at most jump_rows rows (the v2 walk: the
    records' run cap or its segment, whichever is less),
    ceil((rlen - deleted rows) / jump_rows) jumps where the walk reached row
    0. The checkpoint walk's carried runs cross rows without a read, so it
    is given no jump term."""
    words, nev, meta = (t.cpu().numpy() for t in out[1:])
    reads = np.zeros(len(rlen), np.int64)
    for s in range(len(rlen)):
        w = words[s, : min(int(nev[s]), K)].astype(np.int64)
        is_d = w & 3 == 2
        deleted = int(np.where(is_d, w >> 17, 0).sum())
        reads[s] = int(is_d.sum()) + int((((w >> 2) & 0x7FFF) > 0).sum()) + int(meta[s, 3] > 0)
        if jump_rows and not meta[s, 1]:
            reads[s] += -(-(int(rlen[s]) - deleted) // jump_rows)
    return reads


def _walk_bound(out, rlen, K: int, jump_rows: int = None, extra_bytes: int = 0, extra_ops: int = 0,
                dep_cycles: int = 0) -> dict:
    """A walk's bound, counting at least one move per event: per event one
    record read (2 bytes) and its row and word written (8 bytes), per
    problem its four int32 inputs read and n_events and meta written;
    beside it the dependency bound, dep_cycles plus the longest walk's
    record reads (_walk_reads) times DEP_LOAD_CYCLES; `binds` names the
    larger."""
    nev = out[2].cpu().numpy()
    events = int(np.minimum(nev, K).sum())
    b = _bound(events * 10 + len(nev) * 36 + extra_bytes, events * WALK_OPS_PER_MOVE + extra_ops)
    b["reads"] = int(_walk_reads(out, rlen, K, jump_rows).max(initial=0))
    b["dep_bound_ms"] = (dep_cycles + b["reads"] * DEP_LOAD_CYCLES) / SM_CLOCK_HZ * 1e3
    b["binds"] = "dependency" if b["dep_bound_ms"] > b["bound_ms"] else b["bound_by"]
    return b


def _walk_err(out_k, out_p, n: int, K: int) -> int:
    """Summed absolute difference of the first n problems' events, counts
    and meta (0 when they agree)."""
    rows_k, words_k, nev_k, meta_k = (t[:n].cpu().numpy() for t in out_k)
    rows_p, words_p, nev_p, meta_p = (t[:n].cpu().numpy() for t in out_p)
    err = int(np.abs(nev_k - nev_p).max()) + int(np.abs(meta_k - meta_p).max())
    for s in range(n):
        e = min(int(nev_p[s]), K)
        err += int(np.abs(rows_k[s, :e] - rows_p[s, :e]).sum() + np.abs(words_k[s, :e] - words_p[s, :e]).sum())
    return err


def _events_differ(out_a, out_b, K: int) -> tuple:
    """(problems whose events or meta[0,1,3] differ, problems whose meta[2]
    alone differs) between two walks of the same batch."""
    a = [t.cpu().numpy() for t in out_a]
    b = [t.cpu().numpy() for t in out_b]
    bad, bnd = [], []
    for s in range(len(a[2])):
        e = min(int(a[2][s]), K)
        same = (a[2][s] == b[2][s] and np.array_equal(a[0][s, :e], b[0][s, :e])
                and np.array_equal(a[1][s, :e], b[1][s, :e]) and np.array_equal(a[3][s, [0, 1, 3]], b[3][s, [0, 1, 3]]))
        if not same:
            bad.append(s)
        elif a[3][s, 2] != b[3][s, 2]:
            bnd.append(s)
    return bad, bnd


def phase_kernels(torch) -> dict:
    from pangraph_tpu_torch.ops import stripe_v2 as sv

    dev = torch.device("cuda", 0)
    worst = {"stripe_dp": 0, "walk": 0, "decode_events": 0}
    times = {}
    shapes = [(shape, {}) for shape in KERNEL_SHAPES] + [(LONG_INDEL_SHAPE, LONG_INDELS)]
    for shape_i, ((B, R, m), mutation) in enumerate(shapes):
        arrays = kernel_inputs(B, R, m, seed=100 + shape_i, **mutation)
        ref, qry, rlen, qlen, ms, W = (torch.from_numpy(a).to(dev) for a in arrays)
        seg = sv.walk_segment(R, B)

        rec = sv.stripe_dp(ref, qry, rlen, qlen, ms, W, B)
        dp_ms = _event_ms(torch, lambda: sv.stripe_dp(ref, qry, rlen, qlen, ms, W, B), TIMED_REPS)
        plain_dp_ms, rec_plain = _host_ms(torch, lambda: sv.stripe_dp_plain(ref, qry, rlen, qlen, ms, W, B))
        rows_live = torch.arange(R, device=dev)[None, :] < rlen[:, None].long()
        diff = (rec.int() - rec_plain.int()).abs()[rows_live]
        dp_err = int(diff.max()) if diff.numel() else 0
        in_bytes, cells = _dp_work(arrays[2], arrays[3], B)
        dp_bound = _dp_bound(in_bytes + 2 * cells, cells, arrays[2], B, "v2")

        out = sv.walk(rec, rlen, qlen, ms, W, seg, WALK_K)
        n = min(PLAIN_WALK_PROBLEMS, m)
        sub = [t[:n].contiguous() for t in (rec, rlen, qlen, ms, W)]
        walk_full_ms = _kernel_ms(torch, lambda: sv.walk(rec, rlen, qlen, ms, W, seg, WALK_K), TIMED_REPS,
                                  WALK_KERNEL)
        walk_ms = _kernel_ms(torch, lambda: sv.walk(*sub, seg, WALK_K), TIMED_REPS, WALK_KERNEL)
        walk_event_ms = _event_ms(torch, lambda: sv.walk(*sub, seg, WALK_K), TIMED_REPS)
        plain_walk_ms, out_plain = _host_ms(torch, lambda: sv.walk_plain(*sub, seg, WALK_K))
        walk_err = _walk_err(out, out_plain, n, WALK_K)
        nev_k = out[2].cpu().numpy()
        walk_bound = _walk_bound([x[:n] for x in out], arrays[2][:n], WALK_K, min(sv.RUN_CAP, seg))
        reads_all = int(_walk_reads(out, arrays[2], WALK_K, min(sv.RUN_CAP, seg)).max(initial=0))
        # every pair whose events decode must decode to its exact edit
        decoded, exact = _decode_all(sv, arrays, out)
        dec = _decode_check(torch, sv, out, (ref, qry, rlen, qlen))

        worst["stripe_dp"] = max(worst["stripe_dp"], dp_err)
        worst["walk"] = max(worst["walk"], walk_err)
        worst["decode_events"] = max(worst["decode_events"], len(dec["differ"]))
        times[(B, R)] = {"stripe_dp": (dp_ms, plain_dp_ms, dp_bound), "walk": (walk_ms, plain_walk_ms, walk_bound),
                         "decode_events": (dec["ms"], dec["plain_ms"], dec["bound"])}
        say("kernels", B=B, R=R, problems=m, long_indels=bool(mutation), cells=cells, dp_ms=round(dp_ms, 3), plain_dp_ms=round(plain_dp_ms, 1),
            dp_gcells_per_s=round(cells / dp_ms / 1e6, 2), dp_bound_ms=round(dp_bound["bound_ms"], 4),
            dp_bound_by=dp_bound["bound_by"], dp_dep_bound_ms=round(dp_bound["dep_bound_ms"], 4),
            dp_binds=dp_bound["binds"], dp_cycles_per_row=round(dp_ms * 1e-3 * SM_CLOCK_HZ / int(arrays[2].max())),
            dp_max_abs_err=dp_err,
            walk_all_ms=round(walk_full_ms, 4), walk_all_reads_at_least=reads_all,
            walk_all_cycles_per_read=round(walk_full_ms * 1e-3 * SM_CLOCK_HZ / max(reads_all, 1)),
            walk_problems=n, walk_ms=round(walk_ms, 4), walk_event_ms=round(walk_event_ms, 4),
            plain_walk_ms=round(plain_walk_ms, 2), walk_bound_ms=walk_bound["bound_ms"],
            walk_dep_bound_ms=round(walk_bound["dep_bound_ms"], 5), walk_binds=walk_bound["binds"],
            walk_reads_at_least=walk_bound["reads"],
            walk_cycles_per_read=round(walk_ms * 1e-3 * SM_CLOCK_HZ / max(walk_bound["reads"], 1)),
            walk_max_abs_err=walk_err, max_events=int(nev_k.max()), decoded=decoded, exact=exact,
            **_decode_kv(dec))
        if dp_err or walk_err or exact != decoded or dec["differ"]:
            raise AssertionError(f"kernel disagrees with its plain version at B={B} R={R}")
        del rec, rec_plain
        torch.cuda.empty_cache()
    return {"worst": worst, "times": times}


def _rederived_windows(out, rlen, WV: int, K: int) -> int:
    """A lower bound on the windows a checkpoint walk re-derives: each
    problem's top window, and every window in which the walk read a record
    to emit an event (a deletion event at row x reads row x, an insertion
    event at row x reads row x + 1). Windows a walk re-derives without
    emitting there are not counted."""
    rows, words, nev = (t.cpu().numpy() for t in out[:3])
    total = 0
    for s in range(len(rlen)):
        if rlen[s] <= 0:
            continue
        x = rows[s, : min(int(nev[s]), K)].astype(np.int64)
        op = words[s, : len(x)] & 3
        read = np.where(op == 2, x, x + 1)[(op != 2) | (x >= 1)]  # a deletion flushed at row 0 reads nothing
        total += len(set(((read - 1) // WV).tolist()) | {(int(rlen[s]) - 1) // WV})
    return total


def _plain_ckpt_problems(rlen) -> list:
    """The problems the checkpoint walk's plain version runs on: the one
    with the most windows (the longest) and the first of the others."""
    top = int(np.argmax(rlen))
    return [top] + [i for i in range(len(rlen)) if i != top][: PLAIN_CKPT_WALK_PROBLEMS - 1]


def _ckpt_bounds(arrays, B: int, n_windows: int, out, K: int, problems: list) -> tuple:
    """Bounds of the checkpoint DP (over all problems) and walk (over the
    problems listed): the DP's cells and its live carries written once; the
    walk's re-derived windows (their carries and sequence bytes read once,
    their cells recomputed with their records, at the v2 route's operations
    a cell) on top of its events."""
    from pangraph_tpu_torch.ops.stripe_v2 import ckpt_layout
    from port_bench import yardstick

    WV = ckpt_layout(B)
    rlen, qlen = arrays[2], arrays[3]
    in_bytes, cells = _dp_work(rlen, qlen, B)
    live = int((np.minimum(rlen // WV, n_windows - 1) + 1).sum())
    dp = _dp_bound(in_bytes + live * 3 * B * 4, cells, rlen, B, "ckpt")
    sub = [t[problems] for t in out]
    win = _rederived_windows(sub, rlen[problems], WV, K)
    walk = _walk_bound(sub, rlen[problems], K, extra_bytes=win * (3 * B * 4 + 2 * WV + B),
                       extra_ops=win * WV * B * yardstick.DP_OPS_PER_CELL["v2"], dep_cycles=WV * dp_row_cycles(B))
    return dp, walk, win


def _walk_ckpt_parts(torch, sv, args, K: int) -> dict:
    """One more walk_ckpt call under the launch log: its waves, and the
    device ms of its re-derive launches and of its walk launches, each
    summed over the waves."""
    sv.KERNEL_TIMING = []
    try:
        sv.walk_ckpt(*args, K)
        torch.cuda.synchronize()
        log = sv.KERNEL_TIMING
    finally:
        sv.KERNEL_TIMING = None
    ms = {name: sum(start.elapsed_time(end) for n, _B, _R, _m, _dev, start, end, _st in log if n == name)
          for name in ("walk_ckpt.rederive", "walk_ckpt.walk")}
    return {"waves": sum(e[0] == "walk_ckpt.walk" for e in log), "rederive_ms": ms["walk_ckpt.rederive"],
            "walk_ms": ms["walk_ckpt.walk"]}


def phase_ckpt_kernels(torch) -> dict:
    """The checkpoint pair against its plain versions at CKPT_PLAIN_SHAPES,
    and its events against the v2 kernels' at every shape, and their
    decode against the plain decode (_decode_check)."""
    from pangraph_tpu_torch.ops import stripe_v2 as sv

    dev = torch.device("cuda", 0)
    worst = {"stripe_dp_ckpt": 0, "walk_ckpt": 0, "decode_events": 0}
    times = {}
    for shape_i, (B, R, m) in enumerate(CKPT_SHAPES):
        arrays = kernel_inputs(B, R, m, seed=200 + shape_i)
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        WV = sv.ckpt_layout(B)
        n_windows = sv.ckpt_windows(R, B)

        plain = (B, R) in CKPT_PLAIN_SHAPES
        ck = sv.stripe_dp_ckpt(*t, B, R)
        dp_ms = _event_ms(torch, lambda: sv.stripe_dp_ckpt(*t, B, R), TIMED_REPS)
        plain_dp_ms = dp_err = plain_walk_ms = walk_err = None
        if plain:
            plain_dp_ms, ck_plain = _host_ms(torch, lambda: sv.stripe_dp_ckpt_plain(*t, B, R))
            live = torch.arange(n_windows, device=dev)[None, :] * WV <= t[2][:, None].long()
            diff = (ck - ck_plain).abs()[live]
            dp_err = int(diff.max()) if diff.numel() else 0

        sel = _plain_ckpt_problems(arrays[2])
        idx = torch.tensor(sel, device=dev)
        tsel = [x[idx].contiguous() for x in t]
        out = sv.walk_ckpt(ck, *t, WALK_K)
        n = len(sel)
        sub = [ck[idx].contiguous()] + tsel
        walk_all_ms = _event_ms(torch, lambda: sv.walk_ckpt(ck, *t, WALK_K), TIMED_REPS)
        walk_ms = _event_ms(torch, lambda: sv.walk_ckpt(*sub, WALK_K), TIMED_REPS)
        if plain:
            plain_walk_ms, out_plain = _host_ms(
                torch, lambda: sv.walk_ckpt_plain(ck_plain[idx].contiguous(), *tsel, WALK_K))
            walk_err = _walk_err([x[idx] for x in out], out_plain, n, WALK_K)
            del ck_plain
        parts = _walk_ckpt_parts(torch, sv, sub, WALK_K)

        v2 = sv.walk(sv.stripe_dp(*t, B), *t[2:], sv.walk_segment(R, B), WALK_K)
        bad, bnd = _events_differ(out, v2, WALK_K)
        decoded, exact = _decode_all(sv, arrays, out)
        dec = _decode_check(torch, sv, out, t[:4])
        worst["decode_events"] = max(worst["decode_events"], len(dec["differ"]))
        dp_bound, walk_bound, win = _ckpt_bounds(arrays, B, n_windows, out, WALK_K, sel)

        if plain:
            worst["stripe_dp_ckpt"] = max(worst["stripe_dp_ckpt"], dp_err)
            worst["walk_ckpt"] = max(worst["walk_ckpt"], walk_err)
        times[(B, R)] = {"stripe_dp_ckpt": (dp_ms, plain_dp_ms, dp_bound),
                         "walk_ckpt": (walk_ms, plain_walk_ms, walk_bound)}
        cells = int(arrays[2].sum()) * B
        say("ckpt_kernels", B=B, R=R, problems=m, WV=WV, windows=n_windows, cells=cells, held_against_plain=plain,
            dp_ms=round(dp_ms, 3), plain_dp_ms=plain_dp_ms and round(plain_dp_ms, 1),
            dp_gcells_per_s=round(cells / dp_ms / 1e6, 2),
            dp_bound_ms=round(dp_bound["bound_ms"], 4), dp_bound_by=dp_bound["bound_by"],
            dp_dep_bound_ms=round(dp_bound["dep_bound_ms"], 4), dp_binds=dp_bound["binds"],
            dp_cycles_per_row=round(dp_ms * 1e-3 * SM_CLOCK_HZ / int(arrays[2].max())), dp_max_abs_err=dp_err,
            walk_plain_problems=json.dumps(sel if plain else []), walk_all_ms=round(walk_all_ms, 3),
            walk_ms=round(walk_ms, 3), plain_walk_ms=plain_walk_ms and round(plain_walk_ms, 1), walk_waves=parts["waves"],
            walk_rederive_ms=round(parts["rederive_ms"], 3), walk_walk_ms=round(parts["walk_ms"], 3),
            walk_rederived_windows_at_least=win, walk_reads_at_least=walk_bound["reads"],
            walk_walk_cycles_per_read=round(parts["walk_ms"] * 1e-3 * SM_CLOCK_HZ / max(walk_bound["reads"], 1)),
            walk_bound_ms=round(walk_bound["bound_ms"], 4), walk_bound_by=walk_bound["bound_by"],
            walk_dep_bound_ms=round(walk_bound["dep_bound_ms"], 4), walk_binds=walk_bound["binds"],
            walk_max_abs_err=walk_err, max_events=int(out[2].max()), events_differ_from_v2=bad,
            meta2_differs_from_v2=bnd, decoded=decoded, exact=exact, **_decode_kv(dec))
        if dp_err or walk_err or bad or exact != decoded or dec["differ"]:
            raise AssertionError(f"checkpoint kernel disagrees at B={B} R={R}")
        del ck, v2
        torch.cuda.empty_cache()
    return {"worst": worst, "times": times}


def phase_mbp(torch) -> dict:
    """Kernels only, at Mbp scale: the checkpoint route's events against the
    v2 route's (whose kernels phase 3 holds against plain), both timed."""
    from pangraph_tpu_torch.ops import stripe_v2 as sv

    dev = torch.device("cuda", 0)
    B, R, m = MBP_SHAPE
    t0 = time.time()
    arrays = kernel_inputs(B, R, m, seed=300, indel_every=4000, balanced=True)
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    setup_s = time.time() - t0
    n_windows = sv.ckpt_windows(R, B)

    ck = sv.stripe_dp_ckpt(*t, B, R)
    out = sv.walk_ckpt(ck, *t, MBP_K)
    ck_dp_ms = _event_ms(torch, lambda: sv.stripe_dp_ckpt(*t, B, R), 1)
    ck_walk_ms = _event_ms(torch, lambda: sv.walk_ckpt(ck, *t, MBP_K), 1)
    parts = _walk_ckpt_parts(torch, sv, [ck] + t, MBP_K)
    carry_bytes = ck.numel() * 4
    del ck
    rec = sv.stripe_dp(*t, B)
    seg = sv.walk_segment(R, B)
    v2 = sv.walk(rec, *t[2:], seg, MBP_K)
    v2_dp_ms = _event_ms(torch, lambda: sv.stripe_dp(*t, B), 1)
    v2_walk_ms = _event_ms(torch, lambda: sv.walk(rec, *t[2:], seg, MBP_K), 1)
    record_bytes = rec.numel() * 2
    del rec
    torch.cuda.empty_cache()
    bad, bnd = _events_differ(out, v2, MBP_K)
    dp_bound, walk_bound, win = _ckpt_bounds(arrays, B, n_windows, out, MBP_K, list(range(m)))
    cells = int(arrays[2].sum()) * B
    say("mbp", B=B, R=R, problems=m, windows=n_windows, setup_s=round(setup_s, 1), cells=cells,
        max_events=int(out[2].max()), overflow=int((out[2] > MBP_K).sum()),
        ckpt_dp_ms=round(ck_dp_ms, 3), ckpt_walk_ms=round(ck_walk_ms, 3),
        ckpt_walk_waves=parts["waves"], ckpt_walk_rederive_ms=round(parts["rederive_ms"], 3),
        ckpt_walk_walk_ms=round(parts["walk_ms"], 3),
        ckpt_dp_bound_ms=round(dp_bound["bound_ms"], 3), ckpt_walk_bound_ms=round(walk_bound["bound_ms"], 3),
        ckpt_walk_dep_bound_ms=round(walk_bound["dep_bound_ms"], 3),
        walk_rederived_windows_at_least=win, v2_dp_ms=round(v2_dp_ms, 3), v2_walk_ms=round(v2_walk_ms, 3),
        carry_bytes=carry_bytes, record_bytes=record_bytes, events_differ_from_v2=bad, meta2_differs_from_v2=bnd)
    if bad:
        raise AssertionError(f"checkpoint events differ from v2 events at Mbp scale, problems {bad}")
    if int((out[2] > MBP_K).sum()):
        raise AssertionError("event overflow at Mbp scale: raise MBP_K")
    return {"ckpt_dp_ms": ck_dp_ms, "ckpt_walk_ms": ck_walk_ms, "v2_dp_ms": v2_dp_ms, "v2_walk_ms": v2_walk_ms}


def _decode_differ(got: dict, want: dict) -> list:
    """The problems whose decode differs between two decode_events outputs
    of one launch: the head but its offsets (each problem's own on the
    card), or the problem's substitutions or events; all of them where the
    totals differ."""
    got, want = ({k: v.cpu() for k, v in d.items()} for d in (got, want))
    m = got["head"].shape[0]
    if not torch_equal(got["totals"], want["totals"]):
        return list(range(m))
    cols = [0, 1, 2, 3, 5, 7]
    differ = []
    for s, (hg, hw) in enumerate(zip(got["head"].tolist(), want["head"].tolist())):
        same = [hg[c] for c in cols] == [hw[c] for c in cols] and all(
            torch_equal(got[k][hg[a]: hg[a] + hg[n]], want[k][hw[a]: hw[a] + hw[n]])
            for a, n, k in ((4, 5, "sub_pos"), (4, 5, "sub_alt"), (6, 7, "evs")))
        if not same:
            differ.append(s)
    return differ


def torch_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def _decode_bound(walk, t, totals) -> dict:
    """The decode's bound, as dev/decode_cuda.py counts its bytes: ref and
    qry bytes in use, the walk's event slots in use, meta, n_events, rlen
    and qlen read once; the head, substitutions (5 bytes) and events (16
    bytes) written once."""
    from pangraph_tpu_torch.ops import stripe_v2 as sv

    nev, rlen, qlen = walk[2], t[2], t[3]
    K, m = walk[0].shape[1], len(nev)
    n_sub, n_ev = totals.tolist()
    read = int(rlen.long().sum()) + int(qlen.long().sum()) + int(nev.clamp(0, K).long().sum()) * 8 + m * (16 + 4 + 8)
    return _bound(read + m * sv.DECODE_HEAD * 4 + n_sub * 5 + n_ev * 16, 0)


def _decode_check(torch, sv, walk, t) -> dict:
    """decode_events on the card's walk outputs (rows, words, n_events,
    meta) and the batch's (ref, qry, rlen, qlen) tensors, against
    decode_events_plain on the same tensors (_decode_differ); with its
    event-pair ms over TIMED_REPS launches, the plain version's ms and the
    byte bound (_decode_bound)."""
    args = (*walk, *t)
    got = sv.decode_events(*args)
    ms = _event_ms(torch, lambda: sv.decode_events(*args), TIMED_REPS)
    plain_ms, want = _host_ms(torch, lambda: sv.decode_events_plain(*args))
    status = got["head"][:, 0].cpu()
    return {"ms": ms, "plain_ms": plain_ms, "bound": _decode_bound(walk, t, want["totals"].cpu()),
            "differ": _decode_differ(got, want), "ok": int((status == sv.DECODE_OK).sum()),
            "totals": want["totals"].tolist()}


def _decode_kv(dec: dict) -> dict:
    return {"decode_ms": round(dec["ms"], 4), "plain_decode_ms": round(dec["plain_ms"], 2),
            "decode_bound_ms": round(dec["bound"]["bound_ms"], 6), "decode_ok": dec["ok"],
            "decode_subs_events": json.dumps(dec["totals"]), "decode_problems_differ": json.dumps(dec["differ"])}


def _decode_all(sv, arrays, out) -> tuple:
    ref_in, qry_in, rlen, qlen, _ms, _W = arrays
    rows, words, nev, meta = (t.cpu().numpy() for t in out)
    decoded = exact = 0
    for s in range(len(rlen)):
        r, q = ref_in[s, : rlen[s]], qry_in[s, : qlen[s]]
        edit, good = sv.edit_from_events(rows[s], words[s], nev[s], meta[s], r, q)
        if good:
            decoded += 1
            exact += bool(np.array_equal(edit.apply(r), q))
    return decoded, exact


def headline_fasta(path: str) -> int:
    """Write the headline pangenome to `path`; returns its bp."""
    from pangraph_tpu_torch.io.fasta import write_fasta
    from pangraph_tpu_torch.utils.synth import make_accessory_pangenome

    recs = make_accessory_pangenome(n_genomes=10, genome_len=4_600_000, seed=13)
    write_fasta(path, recs)
    return sum(len(r.seq) for r in recs)


def phase_build_path(torch, phase: str, fa: str, env: dict, want: dict, profile: bool = False,
                     out: str = None) -> dict:
    """`build -c -f -j 2 --device cuda` through the CLI on `fa`, with `env`
    set around it, writing the graph JSON to `out` (a temporary file where
    it is None). The launch counts are set to 0 just before and read just
    after; want[name] is True for a kernel that must launch, False for one
    that must not. Prints the aligner's receipts, with the jobs, cells and
    band range per length tier and kernel route (engine_report()'s
    device_tiers). With `profile`, the build runs under torch.profiler (CUDA
    activity only), and each kernel's line gains its summed kernel-only
    time from the profiler's kernel records, beside the launch log's event
    pairs, and a `.device_busy` line gives the card's busy share
    (device_profile). A `.broker` line gives the aligner's combined rounds
    (say_broker)."""
    from pangraph_tpu_torch import cli
    from pangraph_tpu_torch.commands import graph_quality
    from pangraph_tpu_torch.graph.graph import Pangraph
    from pangraph_tpu_torch.ops import chain_k2 as ch
    from pangraph_tpu_torch.ops import sketch_k1 as sk
    from pangraph_tpu_torch.ops import stripe_v2 as sv
    from pangraph_tpu_torch.ops.batch_align import BatchAligner

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = out or os.path.join(tmp, "graph.json")
            BatchAligner.reset_engine_stats()
            for mod in (sv, sk, ch):
                mod.reset_launches()
            sv.KERNEL_TIMING = []
            activities = [torch.profiler.ProfilerActivity.CUDA]
            try:
                with torch.profiler.profile(activities=activities) if profile else contextlib.nullcontext() as prof:
                    t0 = time.time()
                    # --devices 1: the one-device build on any host, which
                    # phase 8's mesh build is held against
                    rc = cli.main(["build", fa, "-c", "-f", "-j", "2", "--device", "cuda", "--devices", "1",
                                   "--no-progress-bar", "-o", out])
                    wall = time.time() - t0
                    torch.cuda.synchronize()
                kernel_log = launch_log_summary(sv.KERNEL_TIMING)
            finally:
                sv.KERNEL_TIMING = None
            device = device_profile(_trace_events(prof), wall) if profile else None
            launches = {**sv.LAUNCHES, **sk.LAUNCHES, **ch.LAUNCHES}
            report = BatchAligner.engine_report()
            if rc != 0:
                raise AssertionError(f"build exited {rc} (with -f a roundtrip mismatch exits non-zero)")
            quality = graph_quality(Pangraph.from_file(out))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    say(phase, env=json.dumps(env), wall_s=round(wall, 3), roundtrip="exact", launches=json.dumps(launches))
    say(f"{phase}.quality", **{k: f"{quality[k]}(reference {v})" for k, v in HEADLINE_QUALITY.items()})
    say(f"{phase}.engines", report=json.dumps(report))
    say_launch_log(phase, kernel_log, device)
    say_broker(phase, report, launches, kernel_log)
    if device is not None:
        say(f"{phase}.device_busy", wall_s=round(wall, 3), busy_ms=round(device["busy_ms"], 3),
            busy_share=round(device["busy_share"], 5),
            other_kernels_ms=round(device["kernels"].get("other_kernels", {}).get("ms", 0.0), 3),
            copies_ms=round(device["kernels"].get("copies", {}).get("ms", 0.0), 3),
            records=sum(d["records"] for d in device["kernels"].values()),
            note="profiled_build_wall_compare_with_the_unprofiled_long_tier_build")
    for name, must in want.items():
        if must and launches[name] <= 0:
            raise AssertionError(f"{phase}: kernel {name} was never launched: {launches}")
        if not must and launches[name] != 0:
            raise AssertionError(f"{phase}: kernel {name} was launched off its path: {launches}")
    if (report["device_cells_frac"] or 0) < 0.5:
        raise AssertionError(f"{phase}: device_cells_frac {report['device_cells_frac']} < 0.5")
    check_quality(phase, quality)
    return {"launches": launches, "report": report, "quality": quality, "wall_s": wall, "kernels": kernel_log,
            "device": device}


# the reference's graph of the headline (BENCH_r05), and how far a graph of
# the kernel route may lie from it (relative for blocks and bp, absolute for
# the core fraction): the kernels band B lanes where the host engine bands
# 2W+2, so edits differ at band edges
HEADLINE_QUALITY = {"n_blocks": 1156, "core_fraction": 0.4875, "pangenome_bp": 7028975}
QUALITY_TOLERANCE = {"n_blocks": 0.01, "core_fraction": 0.01, "pangenome_bp": 0.001}


def quality_off(quality: dict, want: dict) -> dict:
    """The quality figures of `quality` that lie beyond QUALITY_TOLERANCE of
    `want`'s: {name: (got, want)}."""
    off = {}
    for k, tol in QUALITY_TOLERANCE.items():
        if abs(quality[k] - want[k]) / (1 if k == "core_fraction" else want[k]) > tol:
            off[k] = (quality[k], want[k])
    return off


def check_quality(phase: str, quality: dict) -> None:
    """The graph's quality within QUALITY_TOLERANCE of the reference's
    (HEADLINE_QUALITY)."""
    off = quality_off(quality, HEADLINE_QUALITY)
    if off:
        raise AssertionError(f"{phase}: graph quality (got, reference) {off} lies beyond {QUALITY_TOLERANCE}")


def say_broker(phase: str, report: dict, launches: dict, kernel_log: dict) -> dict:
    """A `.broker` line: the aligner's combined rounds, the legs they held
    and the most legs in one (engine_report()["broker"]), beside the DP and
    walk launches and the DP launches of 1-8 problems at B 128."""
    broker = report["broker"]
    small_b128 = kernel_log.get("stripe_dp", {}).get("hist", {}).get("128", {}).get("1-8", 0)
    say(f"{phase}.broker", rounds=broker["rounds"], legs=broker["legs"], max_legs=broker["max_legs"],
        dp_launches=launches["stripe_dp"] + launches["stripe_dp_ckpt"],
        walk_launches=launches["walk"] + launches["walk_ckpt"], dp_launches_b128_1_8_problems=small_b128)
    return broker


def say_launch_log(phase: str, kernel_log: dict, device: dict = None) -> None:
    """One `.dp_device` or `.walk_device` line per kernel of a launch log
    (launch_log_summary), with its kernel-only ms where the run was
    profiled (device_profile)."""
    for name, s in kernel_log.items():
        profiled = {}
        if device is not None:
            d = device["kernels"].get(name, {"records": 0, "ms": 0.0})
            profiled = {"kernel_only_ms": round(d["ms"], 3), "kernel_records": d["records"]}
        say(f"{phase}.{'dp' if name.startswith('stripe_dp') else 'walk'}_device", kernel=name,
            launches=s["launches"], device_ms=round(s["ms"], 3), **profiled,
            by_device=json.dumps({d: [n, round(ms, 3)] for d, (n, ms) in s["by_device"].items()}),
            device_ms_by_B=json.dumps({b: round(v, 3) for b, v in s["ms_by_B"].items()}),
            problems_per_launch_by_B=json.dumps(s["hist"]))


# The path kernels' names in a profiler trace (csrc/stripe_dp.cu and
# csrc/walk.cu; the profiled build launches no checkpoint kernel), by the
# names of stripe_v2.LAUNCHES
PROFILED_KERNELS = {"::stripe_dp_kernel<": "stripe_dp", WALK_KERNEL: "walk"}


def device_profile(events: list, wall_s: float) -> dict:
    """From a torch.profiler trace's events: per path kernel (PROFILED_KERNELS)
    its kernel records and summed kernel-only ms, the same for the other
    kernels together ("other_kernels") and for copies and memsets
    ("copies"); and the card's busy time, the union of all those intervals,
    and its share of wall_s."""
    spans, per = [], {}
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        spans.append((ts, ts + dur))
        name = next((v for k, v in PROFILED_KERNELS.items() if k in str(e.get("name", ""))),
                    "other_kernels" if cat == "kernel" else "copies")
        d = per.setdefault(name, {"records": 0, "ms": 0.0})
        d["records"] += 1
        d["ms"] += dur / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"kernels": per, "busy_ms": busy / 1e3, "busy_share": busy / 1e6 / wall_s}


def launch_log_summary(log: list) -> dict:
    """Per kernel of a build's launch log (stripe_v2.KERNEL_TIMING, read after
    a synchronize): launches, summed device ms, in all, per B and per device
    as {"cuda:i": [launches, ms]} (each launch's own event pair on its
    stream; the merge threads' and shards' streams may overlap, so the sum
    can pass the busy time), and per B a histogram of problems per launch
    as {B: {"1-8": n, "9-32": n, ...}}, the bins split at 8, 32, 132 (the
    card's SMs), 512 and 2048 problems."""
    bins = [(1, 8), (9, 32), (33, 132), (133, 512), (513, 2048), (2049, 1 << 30)]
    out = {}
    for name, B, _R, m, dev, start, end, _stream in log:
        s = out.setdefault(name, {"launches": 0, "ms": 0.0, "hist": {}, "ms_by_B": {}, "by_device": {}})
        ms = start.elapsed_time(end)
        s["launches"] += 1
        s["ms"] += ms
        s["ms_by_B"][str(B)] = s["ms_by_B"].get(str(B), 0.0) + ms
        d = s["by_device"].setdefault(f"cuda:{dev}", [0, 0.0])
        d[0] += 1
        d[1] += ms
        lo, hi = next(b for b in bins if b[0] <= m <= b[1])
        h = s["hist"].setdefault(str(B), {})
        key = f"{lo}-{hi}" if hi < 1 << 30 else f"{lo}+"
        h[key] = h.get(key, 0) + 1
    return out


def _sketch_bound(m: int, L_pad: int, k: int, w: int) -> dict:
    """The sketch's bound: codes read once (4 B each), 12 B written per
    window start, sketch_ops_per_position(k) per k-mer position read."""
    from pangraph_tpu_torch.ops.sketch_k1 import C

    n_out = L_pad - C
    return _bound(4 * m * L_pad + 12 * m * n_out, sketch_ops_per_position(k) * m * (n_out + w - 1))


def _sketch_bound_kv(bound: dict) -> dict:
    """The sketch bound's fields for a phase line: both bounds, which binds."""
    return {"bound_ms": round(bound["bound_ms"], 5), "bytes_bound_ms": round(bound["bytes_ms"], 5),
            "ops_bound_ms": round(bound["ops_ms"], 5), "bound_by": bound["bound_by"]}


def _sketch_cycles(ms: float, windows: int) -> float:
    """SM cycles a window start: the card's SMs times SM_CLOCK_HZ over the
    window starts of one launch of `ms`."""
    return ms * 1e-3 * SM_CLOCK_HZ * N_SMS / windows


def _chain_bound(offsets: np.ndarray, H: int) -> dict:
    """The chain's bound over these sets: r and q read and f and parent
    written once (16 B an anchor, 8 B an offset), CHAIN_OPS_PER_PAIR per
    (anchor, predecessor) pair the sets hold; and its dependency bound, the
    longest set's anchors times CHAIN_DEP_CYCLES."""
    n = np.diff(offsets).astype(np.int64)
    pairs = int(np.where(n <= H, n * (n - 1) // 2, H * (H - 1) // 2 + (n - H) * H).sum())
    out = _bound(16 * int(n.sum()) + 8 * len(offsets), CHAIN_OPS_PER_PAIR * pairs)
    out["dep_bound_ms"] = int(n.max(initial=0)) * CHAIN_DEP_CYCLES / SM_CLOCK_HZ * 1e3
    out["binds"] = "dependency" if out["dep_bound_ms"] > out["bound_ms"] else out["bound_by"]
    out["pairs"] = pairs
    return out


def _anchor_cloud(rng, n: int, L: int, n_chains: int = 3) -> tuple:
    """Anchors sorted by (r, q): a few co-linear chains with drift plus noise
    (tests/test_chain_k2.py's generator)."""
    rs, qs = [], []
    for _ in range(n_chains):
        m = n // (n_chains + 1)
        steps = rng.integers(5, 400, m)
        rs.append(int(rng.integers(0, L // 2)) + np.cumsum(steps))
        qs.append(int(rng.integers(0, L // 2)) + np.cumsum(steps) + np.cumsum(rng.integers(-3, 4, m)))
    m = n - sum(len(x) for x in rs)
    rs.append(rng.integers(0, L, m))
    qs.append(rng.integers(0, L, m))
    r, q = np.concatenate(rs), np.concatenate(qs)
    order = np.lexsort((q, r))
    return r[order].astype(np.int64), q[order].astype(np.int64)


def _sketch_err(got, want) -> int:
    """Largest absolute difference of the (hi, lo, ps) int32 words that the
    reference outputs (0 when the dense sketches agree)."""
    (v, p), (pv, pp) = got, want
    words = [(v >> 32, pv >> 32), (v & 0xFFFFFFFF, pv & 0xFFFFFFFF), (p.long(), pp.long())]
    return max(int((a - b).abs().max()) if a.numel() else 0 for a, b in words)


def _chain_err(got, want) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0 for a, b in zip(got, want))


def _chain_tensors(torch, sets, dev) -> list:
    from pangraph_tpu_torch.ops import chain_k2 as ch

    return [torch.from_numpy(a).to(dev) for a in ch.pack_sets(sets)]


def sketch_batches_3c():
    """Phase 3c's sketch batches: ((k, w), codes) for each of SKETCH_PARAMS
    at each of SKETCH_ROWS rows of SKETCH_ROW_BP bp, N at 4%, odd rows
    lowercase, padded with 4."""
    from pangraph_tpu_torch.graph.seq import TWOBIT
    from pangraph_tpu_torch.ops.sketch_k1 import C

    acgtn = np.frombuffer(b"ACGTNacgtn", np.uint8)
    for i, ((k, w), m) in enumerate((p, m) for p in SKETCH_PARAMS for m in SKETCH_ROWS):
        rng = np.random.default_rng(400 + i)
        lengths = rng.integers(*SKETCH_ROW_BP, m)
        L_pad = (int(lengths.max()) // C + 2) * C
        codes = np.full((m, L_pad), 4, np.int32)
        for row, n in enumerate(lengths):
            codes[row, :n] = TWOBIT[acgtn[rng.choice(5, n, p=[0.24] * 4 + [0.04]) + 5 * (row % 2)]]
        yield (k, w), codes


def sketch_codes(seqs: list, k: int, w: int) -> tuple:
    """The code batch of `seqs` at (k, w), padded as sketch_one pads one
    sequence (the last window's chunk has its successor): (codes, each
    row's window count)."""
    from pangraph_tpu_torch.graph.seq import TWOBIT
    from pangraph_tpu_torch.ops.sketch_k1 import C

    n_w = [len(x) - k - w + 2 for x in seqs]
    L_pad = ((max(n_w) + C - 1) // C + 1) * C
    codes = np.full((len(seqs), L_pad), 4, np.int32)
    for i, x in enumerate(seqs):
        codes[i, : len(x)] = TWOBIT[x]
    return codes, n_w


def phase_sketch_chain_kernels(torch) -> dict:
    """The sketch and chain kernels against their plain versions on the card,
    element for element (phase 3c)."""
    from pangraph_tpu_torch.align.chain import ChainParams
    from pangraph_tpu_torch.ops import chain_k2 as ch
    from pangraph_tpu_torch.ops import sketch_k1 as sk

    dev = torch.device("cuda", 0)
    worst = {"sketch": 0, "chain": 0}
    for (k, w), codes in sketch_batches_3c():
        m, L_pad = codes.shape
        ct = torch.from_numpy(codes).to(dev)
        got = sk.sketch_dense(ct, k, w)
        ms = _kernel_ms(torch, lambda: sk.sketch_dense(ct, k, w), TIMED_REPS, SKETCH_KERNEL)
        event_ms = _event_ms(torch, lambda: sk.sketch_dense(ct, k, w), TIMED_REPS)
        plain_ms, want = _host_ms(torch, lambda: sk.sketch_dense_plain(ct, k, w))
        err = _sketch_err(got, want)
        bound = _sketch_bound(m, L_pad, k, w)
        worst["sketch"] = max(worst["sketch"], err)
        windows = m * (L_pad - sk.C)
        say("sketch_kernel", k=k, w=w, rows=m, L_pad=L_pad, windows=windows, kernel_ms=round(ms, 4),
            event_ms=round(event_ms, 4), cycles_per_window=round(_sketch_cycles(ms, windows), 3),
            plain_ms=round(plain_ms, 2), **_sketch_bound_kv(bound),
            sentinel_windows=int((got[0] == -1).sum()), max_abs_err=err)
        if err:
            raise AssertionError(f"sketch kernel disagrees with its plain version at k={k} w={w} rows={m}")
        del got, want, ct
    cp = ChainParams()
    for n in CHAIN_SIZES:
        sets = [_anchor_cloud(np.random.default_rng(500 + n), n, L=20 * n)]
        t = _chain_tensors(torch, sets, dev)
        args = (cp.k, cp.max_gap, cp.bw, cp.window)
        got = ch.chain_sets(*t, *args)
        ms = _kernel_ms(torch, lambda: ch.chain_sets(*t, *args), TIMED_REPS, CHAIN_KERNEL)
        plain_ms, want = _host_ms(torch, lambda: ch.chain_sets_plain(*t, *args))
        err = _chain_err(got, want)
        bound = _chain_bound(t[2].cpu().numpy(), cp.window)
        worst["chain"] = max(worst["chain"], err)
        say("chain_kernel", anchors=n, ms=round(ms, 4), cycles_per_step=round(ms * 1e-3 * SM_CLOCK_HZ / n),
            keyed=ch.key_path(t[2].cpu(), cp.k, cp.bw, cp.window).tolist(), plain_ms=round(plain_ms, 2),
            bound_ms=round(bound["bound_ms"], 5), bound_by=bound["bound_by"],
            dep_bound_ms=round(bound["dep_bound_ms"], 5), binds=bound["binds"],
            best_f=int(got[0].max()), chained=int((got[1] >= 0).sum()), max_abs_err=err)
        if err:
            raise AssertionError(f"chain kernel disagrees with its plain version at {n} anchors")
    torch.cuda.empty_cache()
    return {"worst": worst}


def _headline_anchor_sets(seqs: list, names: list, p) -> list:
    """The mapper's all-vs-all anchors of `seqs` as map_all_vs_all forms them
    (index, one anchor pass, groups by (query, target, strand) in the
    coordinates they are chained in), each sorted as chain_anchors sorts it."""
    from pangraph_tpu_torch.align.chain import sort_anchors
    from pangraph_tpu_torch.align.mapper import anchor_group, anchor_groups, build_index, collect_anchors_all

    index = build_index(seqs, names, p)
    a_qi, a_rid, a_rpos, a_qpos, a_rel = collect_anchors_all(index, None)
    groups = anchor_groups(a_qi, a_rid, a_rel, len(names))
    sets = []
    for gi in range(len(groups[2]) - 1):
        _qi, _ri, _strand, rpos, q_eff = anchor_group(groups, gi, a_rpos, a_qpos, seqs, p.k)
        sets.append(sort_anchors(rpos, q_eff)[1:])
    return sets


def phase_sketch_chain_path(torch, fa: str) -> dict:
    """Phase 6: the sketch and chain kernels through their entry points on the
    headline's genomes. The launch counts are set to 0 just before and read
    just after; the timing launches come after that."""
    from pangraph_tpu_torch import native
    from pangraph_tpu_torch.align.chain import ChainParams
    from pangraph_tpu_torch.align.mapper import MapperParams
    from pangraph_tpu_torch.graph.seq import TWOBIT, as_seq
    from pangraph_tpu_torch.io.fasta import read_fasta
    from pangraph_tpu_torch.ops import chain_k2 as ch
    from pangraph_tpu_torch.ops import sketch_k1 as sk

    dev = torch.device("cuda", 0)
    t0 = time.time()
    recs = sorted(read_fasta(fa), key=lambda rec: rec.seq_name)
    names = [rec.seq_name for rec in recs]
    seqs = [as_seq(rec.seq) for rec in recs]
    say("sketch_chain_path.input", genomes=len(seqs), bp=sum(len(x) for x in seqs), read_s=round(time.time() - t0, 2))

    sk.reset_launches()
    ch.reset_launches()
    out = {"sketch": {}, "genomes": len(seqs)}
    dense = {}  # (k, w) -> codes and the entry point's (hi, lo, ps)
    for k, w in PATH_SKETCH_PARAMS:
        codes, n_w = sketch_codes(seqs, k, w)
        L_pad = codes.shape[1]
        t0 = time.perf_counter()
        hi, lo, ps = sk.sketch_batch(codes, k, w)
        entry_s = time.perf_counter() - t0
        dense[(k, w)] = (codes, hi, lo, ps)
        native_s, total, bad = 0.0, 0, []
        for i, x in enumerate(seqs):
            got = sk.compact(hi[i], lo[i], ps[i], n_w[i])
            t1 = time.perf_counter()
            vals, pos, strands = native.sketch_native(x, k, w, TWOBIT)
            native_s += time.perf_counter() - t1
            total += len(vals)
            if not (np.array_equal(got.values, vals) and np.array_equal(got.positions, pos)
                    and np.array_equal(got.strands, strands)):
                bad.append(names[i])
        out["sketch"][(k, w)] = {"L_pad": L_pad, "minimizers": total, "native_s": native_s, "entry_s": entry_s}
        say("sketch_chain_path.sketch", k=k, w=w, rows=len(seqs), L_pad=L_pad, minimizers=total,
            entry_point_s=round(entry_s, 3), native_host_s=round(native_s, 3), differ_from_native=bad)
        if bad:
            raise AssertionError(f"sketch on the card differs from the host C++ sketch at k={k} w={w}: {bad}")

    mp = MapperParams()
    cp = ChainParams(k=mp.k, max_gap=mp.max_gap, bw=mp.bw, min_score=mp.min_chain_score, min_anchors=mp.min_anchors)
    t0 = time.time()
    sets = _headline_anchor_sets(seqs, names, mp)
    anchors_s = time.time() - t0
    t = _chain_tensors(torch, sets, dev)
    args = (cp.k, cp.max_gap, cp.bw, cp.window)
    f, parent = ch.chain_sets(*t, *args)
    torch.cuda.synchronize()
    out["launches"] = {**sk.LAUNCHES, **ch.LAUNCHES}
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"sketch_chain_path: a kernel was never launched: {out['launches']}")
    f, parent = f.cpu().numpy(), parent.cpu().numpy()
    offsets = t[2].cpu().numpy()
    native_s, bad = 0.0, []
    for s, (r, q) in enumerate(sets):
        t1 = time.perf_counter()
        nf, npar = native.chain_dp_native(r, q, *args)
        native_s += time.perf_counter() - t1
        if not (np.array_equal(nf, f[offsets[s] : offsets[s + 1]]) and np.array_equal(npar, parent[offsets[s] : offsets[s + 1]])):
            bad.append(s)
    sizes = np.diff(offsets)
    out["chain"] = {"anchors": int(sizes.sum()), "groups": len(sets), "native_s": native_s}
    say("sketch_chain_path.chain", groups=len(sets), anchors=int(sizes.sum()), largest=int(sizes.max()),
        median=int(np.median(sizes)), anchors_s=round(anchors_s, 2), native_host_s=round(native_s, 3),
        chained=int((parent >= 0).sum()), differ_from_native=bad)
    if bad:
        raise AssertionError(f"chain on the card differs from the host C++ chain DP in groups {bad}")

    # the plain versions on the card at the same shapes and on the same
    # inputs, then the kernel times (these launches are not counted above)
    for k, w in PATH_SKETCH_PARAMS:
        codes, hi, lo, ps = dense.pop((k, w))
        ct = torch.from_numpy(codes).to(dev)
        plain_ms, want = _host_ms(torch, lambda: sk.sketch_dense_plain(ct, k, w))
        got = ((torch.from_numpy(hi).long() << 32) | (torch.from_numpy(lo).long() & 0xFFFFFFFF), torch.from_numpy(ps))
        err = _sketch_err(got, tuple(x.cpu() for x in want))
        del want, got
        torch.cuda.empty_cache()
        ms = _kernel_ms(torch, lambda: sk.sketch_dense(ct, k, w), TIMED_REPS, SKETCH_KERNEL)
        event_ms = _event_ms(torch, lambda: sk.sketch_dense(ct, k, w), TIMED_REPS)
        bound = _sketch_bound(*ct.shape, k, w)
        windows = ct.shape[0] * (ct.shape[1] - sk.C)
        out["sketch"][(k, w)].update(ms=ms, plain_ms=plain_ms, bound=bound, err=err)
        say("sketch_chain_path.sketch_time", k=k, w=w, windows=windows, kernel_ms=round(ms, 4),
            event_ms=round(event_ms, 4), cycles_per_window=round(_sketch_cycles(ms, windows), 3),
            share_of_bound=round(bound["bound_ms"] / ms, 4), plain_ms=round(plain_ms, 2),
            max_abs_err=err, **_sketch_bound_kv(bound),
            native_host_ms=round(out["sketch"][(k, w)]["native_s"] * 1e3, 2),
            note="native_host_ms_is_host_CPU_time_on_one_thread_not_a_device_time")
        if err:
            raise AssertionError(f"sketch kernel disagrees with its plain version on the headline at k={k} w={w}")
        del ct
    plain_ms, want = _host_ms(torch, lambda: ch.chain_sets_plain(*t, *args))
    err = _chain_err((torch.from_numpy(f), torch.from_numpy(parent)), [x.cpu() for x in want])
    del want
    torch.cuda.empty_cache()
    ms = _kernel_ms(torch, lambda: ch.chain_sets(*t, *args), TIMED_REPS, CHAIN_KERNEL)
    bound = _chain_bound(offsets, cp.window)
    out["chain"].update(ms=ms, plain_ms=plain_ms, bound=bound, err=err)
    say("sketch_chain_path.chain_time", kernel_ms=round(ms, 4),
        cycles_per_step=round(ms * 1e-3 * SM_CLOCK_HZ / int(sizes.max())),
        keyed_sets=int(ch.key_path(t[2].cpu(), cp.k, cp.bw, cp.window).sum()), plain_ms=round(plain_ms, 2),
        max_abs_err=err,
        bound_ms=round(bound["bound_ms"], 5), bound_by=bound["bound_by"], dep_bound_ms=round(bound["dep_bound_ms"], 5),
        binds=bound["binds"], pairs=bound["pairs"], native_host_ms=round(native_s * 1e3, 2),
        note="native_host_ms_is_host_CPU_time_on_one_thread_not_a_device_time")
    if err:
        raise AssertionError("chain kernel disagrees with its plain version on the headline's groups")
    torch.cuda.empty_cache()
    return out


def _fresh_block_ids(src: str, dst: str) -> int:
    """Copy the graph JSON `src` to `dst` with every block under a new id.
    `simplify` keeps block ids, so two halves simplified from one graph share
    their core blocks' ids, which `merge` refuses (graph_join, as the
    reference's does); the halves' paths and nodes do not clash. Returns the
    number of blocks."""
    from pangraph_tpu_torch.utils.ids import content_id

    with open(src) as f:
        doc = json.load(f)
    new = {int(b): content_id("fresh block id", int(b)) for b in doc["blocks"]}
    doc["blocks"] = {str(new[int(b)]): {**blk, "id": new[int(b)]} for b, blk in doc["blocks"].items()}
    for node in doc["nodes"].values():
        node["block_id"] = new[node["block_id"]]
    with open(dst, "w") as f:
        json.dump(doc, f)
    return len(new)


def _cli_step(phase: str, step: str, argv: list, **kv) -> float:
    """Run one `pangraph_tpu_torch.cli.main` call; fails unless it exits 0.
    Prints the step's wall on a line of its own; returns it."""
    from pangraph_tpu_torch import cli

    t0 = time.time()
    rc = cli.main([str(a) for a in argv])
    wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"{phase}: `{' '.join(map(str, argv))}` exited {rc}")
    say(f"{phase}.{step}", wall_s=round(wall, 3), rc=rc, **kv)
    return wall


def _pandas_free_counts(an, L_thr: int) -> dict:
    """MSU and backbone-junction counts from the analysis layer's parts that
    need no pandas: backbone blocks (core, consensus >= L_thr) from the
    graph, walks filtered to them and their co-traveling mergers
    (topology.find_mergers, as msu.minimal_synteny_units does), and the
    junctions' flanking edges (junctions.path_junction_split, as
    BackboneJunctions does)."""
    from pangraph_tpu_torch.analysis import topology
    from pangraph_tpu_torch.analysis.junctions import JunctionNode, path_junction_split

    g = an.graph
    core = set(g.core_block_ids())
    backbone = {b for b in core if g.blocks[b].consensus_len() >= L_thr}
    walks = topology.pangraph_to_walks(an)
    mergers = topology.find_mergers(topology.filter_walks(walks, backbone.__contains__))
    edges = set()
    for path in g.paths.values():
        obs = [JunctionNode(g.nodes[n].block_id, g.nodes[n].strand == "+", n) for n in path.nodes]
        for j in path_junction_split(topology.Walk(obs, path.circular), backbone.__contains__):
            if j.flanking_edge() is not None:
                edges.add(j.flanking_edge().to_str_id())
    return {"msu": len(set(mergers.values())), "backbone_junctions": len(edges),
            "walk_categories": len(topology.walk_categories(walks))}


def phase_cli_path(torch, fa: str, graph: str, work: str, main_quality: dict) -> dict:
    """Phase 7: the CLI's other subcommands through pangraph_tpu_torch.cli.main
    on phase 4's graph of the headline (`graph`, built from `fa`), each
    output checked, each step's wall printed: reconstruct --verify, the four
    exports, schema, simplify into genomes 0-4 and 5-9 (each half verified),
    then `merge -c --device cuda` of the halves (half B under fresh block
    ids, _fresh_block_ids), with the launch counts set to 0 just before it:
    the DP and walk launched, the checkpoint pair, sketch and chain not, at
    least half the DP cells on the device, all ten genomes reconstructed
    exactly (_merge_run). The same merge again with the reference's host-leg
    budget (MERGE_HOST_LEG_BUDGET cells), which the adaptive split routes:
    the same checks, except that in place of the device share every
    logged round's split must be the gate's rule (check_gate_log), with
    some cells on the device and some on the host. The first merged graph
    goes through the pypangraph facade."""
    from pangraph_tpu_torch.commands import graph_quality
    from pangraph_tpu_torch.graph.graph import Pangraph
    from pangraph_tpu_torch.io.fasta import read_fasta
    from pangraph_tpu_torch import pypangraph

    phase = "cli_path"
    walls = {}
    g = Pangraph.from_file(graph)
    names = [p.name for _, p in sorted(g.paths.items())]
    walls["reconstruct_verify"] = _cli_step(phase, "reconstruct_verify", ["reconstruct", graph, "--verify", fa])

    gfa = os.path.join(work, "graph.gfa")
    walls["export_gfa"] = _cli_step(phase, "export_gfa", ["export", "gfa", graph, "-o", gfa])
    with open(gfa) as f:
        kinds = [line[0] for line in f]
    if kinds.count("S") != len(g.blocks) or kinds.count("P") != len(names):
        raise AssertionError(f"{phase}: GFA has {kinds.count('S')} S and {kinds.count('P')} P lines "
                             f"for {len(g.blocks)} blocks and {len(names)} paths")

    cons = os.path.join(work, "consensus.fa")
    walls["export_block_consensus"] = _cli_step(phase, "export_block_consensus",
                                                ["export", "block-consensus", graph, "-o", cons])
    recs = read_fasta(cons)
    if sorted(int(r.seq_name) for r in recs) != sorted(g.blocks) or any(
            not np.array_equal(r.seq, g.blocks[int(r.seq_name)].consensus) for r in recs):
        raise AssertionError(f"{phase}: block-consensus records differ from the blocks' consensus")

    core = os.path.join(work, "core.fa")
    walls["export_core_genome"] = _cli_step(phase, "export_core_genome",
                                            ["export", "core-genome", graph, "-o", core, "--guide-strain", names[0]])
    core_recs = read_fasta(core, validate=False)
    lens = {len(r.seq) for r in core_recs}
    if len(core_recs) != len(names) or len(lens) != 1:
        raise AssertionError(f"{phase}: core-genome gave {len(core_recs)} records of lengths {sorted(lens)[:4]}")

    blocks_dir = os.path.join(work, "blocks")
    walls["export_block_sequences"] = _cli_step(phase, "export_block_sequences",
                                                ["export", "block-sequences", graph, "-o", blocks_dir])
    if len(os.listdir(blocks_dir)) != len(g.blocks):
        raise AssertionError(f"{phase}: block-sequences wrote {len(os.listdir(blocks_dir))} files "
                             f"for {len(g.blocks)} blocks")

    schema = os.path.join(work, "schema.json")
    walls["schema"] = _cli_step(phase, "schema", ["schema", "-o", schema])
    with open(schema) as f:
        if json.load(f).get("title") != "Pangraph":
            raise AssertionError(f"{phase}: the schema is not the graph's")

    half = len(names) // 2
    halves = []
    for i, part in enumerate((names[:half], names[half:])):
        h = os.path.join(work, f"half_{'ab'[i]}.json")
        walls[f"simplify_{'ab'[i]}"] = _cli_step(phase, f"simplify_{'ab'[i]}",
                                                 ["simplify", graph, "-o", h, "-s", ",".join(part)], genomes=len(part))
        walls[f"verify_half_{'ab'[i]}"] = _cli_step(phase, f"verify_half_{'ab'[i]}", ["reconstruct", h, "--verify", fa])
        halves.append(h)
    fresh = os.path.join(work, "half_b_fresh_ids.json")
    n_fresh = _fresh_block_ids(halves[1], fresh)

    merged = os.path.join(work, "merged.json")
    runs = {}
    for label, budget in (("merge", None), ("merge_host_leg", MERGE_HOST_LEG_BUDGET)):
        out = merged if budget is None else os.path.join(work, "merged_host_leg.json")
        runs[label] = _merge_run(torch, phase, label, [halves[0], fresh], out, budget, n_fresh)
        walls[label] = runs[label]["wall_s"]
        walls[f"verify_{label}"] = _cli_step(phase, f"verify_{label}", ["reconstruct", out, "--verify", fa])
    launches, report, kernel_log = (runs["merge"][k] for k in ("launches", "report", "kernels"))
    host_leg = runs["merge_host_leg"]["report"]
    say(f"{phase}.merge_budgets", budget_env=f"PANGRAPH_TPU_NATIVE_BUDGET={MERGE_HOST_LEG_BUDGET}",
        wall_s=round(walls["merge"], 3), wall_budget_s=round(walls["merge_host_leg"], 3),
        device_cells_frac=report["device_cells_frac"], device_cells_frac_budget=host_leg["device_cells_frac"],
        host_cells=report["host"]["cells"], host_cells_budget=host_leg["host"]["cells"])
    if host_leg["host"]["cells"] <= 0:
        raise AssertionError(f"{phase}: the merge under a host-leg budget ran no cells on the host")
    mg = Pangraph.from_file(merged)
    if sorted(p.name for p in mg.paths.values()) != sorted(names):
        raise AssertionError(f"{phase}: the merged graph holds {len(mg.paths)} of {len(names)} genomes")
    quality = graph_quality(mg)
    say(f"{phase}.merge_quality", **{k: f"{quality[k]}(build {main_quality[k]})" for k in HEADLINE_QUALITY},
        n_core_blocks=quality["n_core_blocks"], note="no_bound_a_merge_of_two_halves_is_not_a_build")

    t0 = time.time()
    try:
        import jsonschema  # noqa: F401
        import pandas  # noqa: F401
        have = True
    except ImportError:
        have = False
    an = pypangraph.Pangraph.from_json(merged, validate=have)
    if have:
        _mergers, msu_paths, msu_len = pypangraph.minimal_synteny_units(an, 500)
        bj = pypangraph.junctions.BackboneJunctions(an, L_thr=500)
        counts = {"msu": len(msu_len), "backbone_junctions": len(bj.edges()), "via": "pandas"}
    else:
        counts = {**_pandas_free_counts(an, 500), "via": "topology_without_pandas"}
    walls["analysis"] = time.time() - t0
    say(f"{phase}.analysis", wall_s=round(walls["analysis"], 3), strains=len(an.strains()), **counts)
    say(phase, wall_s=round(sum(walls.values()), 3), merge_wall_s=round(walls["merge"], 3))
    return {"launches": launches, "report": report, "quality": quality, "walls": walls, "kernels": kernel_log}


# phase 7's second merge: the reference's default NATIVE_CELL_BUDGET
# (pangraph_tpu/ops/batch_align.py), the cells a round's host leg may take
MERGE_HOST_LEG_BUDGET = 100_000_000


def _merge_run(torch, phase: str, label: str, halves: list, out: str, budget, n_fresh: int) -> dict:
    """Phase 7's `merge -c --device cuda` of `halves` into `out`, with the
    launch counts set to 0 just before it, and BatchAligner.NATIVE_CELL_BUDGET
    set to `budget` around it where one is given (what
    PANGRAPH_TPU_NATIVE_BUDGET sets when the class is defined): the DP and
    walk launched, the checkpoint pair, sketch and chain not; at budget 0
    at least half the DP cells on the device; under a budget, which the
    adaptive split routes, every logged round's split the gate's rule
    (check_gate_log) and some cells on the device."""
    from pangraph_tpu_torch.ops import chain_k2 as ch
    from pangraph_tpu_torch.ops import sketch_k1 as sk
    from pangraph_tpu_torch.ops import stripe_v2 as sv
    from pangraph_tpu_torch.ops.batch_align import BatchAligner

    saved = BatchAligner.NATIVE_CELL_BUDGET
    BatchAligner.reset_engine_stats()
    for mod in (sv, sk, ch):
        mod.reset_launches()
    sv.KERNEL_TIMING = []
    try:
        if budget is not None:
            BatchAligner.NATIVE_CELL_BUDGET = budget
        wall = _cli_step(phase, label, ["merge", *halves, "-c", "--device", "cuda", "-o", out],
                         half_b_blocks_renamed=n_fresh, native_cell_budget=BatchAligner.NATIVE_CELL_BUDGET)
        torch.cuda.synchronize()
        kernel_log = launch_log_summary(sv.KERNEL_TIMING)
    finally:
        sv.KERNEL_TIMING = None
        BatchAligner.NATIVE_CELL_BUDGET = saved
    launches = {**sv.LAUNCHES, **sk.LAUNCHES, **ch.LAUNCHES}
    report = BatchAligner.engine_report()
    say(f"{phase}.{label}_launches", launches=json.dumps(launches))
    say(f"{phase}.{label}_engines", report=json.dumps(report))
    say_launch_log(f"{phase}.{label}", kernel_log)
    for name, must in {"stripe_dp": True, "walk": True, "decode_events": True, "stripe_dp_ckpt": False, "walk_ckpt": False,
                       "sketch": False, "chain": False}.items():
        if must and launches[name] <= 0:
            raise AssertionError(f"{phase}: {label} never launched {name}: {launches}")
        if not must and launches[name] != 0:
            raise AssertionError(f"{phase}: {label} launched {name} off its path: {launches}")
    if budget is None and (report["device_cells_frac"] or 0) < 0.5:
        raise AssertionError(f"{phase}: {label} device_cells_frac {report['device_cells_frac']} < 0.5")
    if budget is not None:
        kinds = check_gate_log(f"{phase}.{label}", BatchAligner.GATE_LOG, gate_settings(BatchAligner))
        say_gate(f"{phase}.{label}_gate", report, kinds)
        if report["device"]["cells"] <= 0:
            raise AssertionError(f"{phase}: {label} ran no cells on the device: {report['device']}")
    return {"launches": launches, "report": report, "kernels": kernel_log, "wall_s": wall}


# phase 8's broker gather window (BatchAligner.BROKER_GATHER_S, s): two merge
# threads alternate in the broker (the owner of the round in flight cannot
# submit), so their legs meet only inside the window after a lone leg; at
# the default 8 ms they rarely meet on the headline (phase 4's .broker
# line), at this one often, so that phase 8's byte-equality with phase 4
# holds coalesced rounds against lone ones
MESH_GATHER_S = 0.2

# phase 8's checkpoint-route round: this many of phase 3's (B 128, R 65536)
# problems (kernel_inputs, seed 200), in 58 bp bands (W = 63 with the
# aligner's 5 extra), which 2 shards split 2 and 2
MESH_CKPT_PROBLEMS = 4


def _mesh_build(torch, fa: str, out: str, n_cards: int) -> tuple:
    """Phase 8's build of `fa` into `out`, as phase 4's `build -c -f -j 2
    --device cuda`: through the CLI with `--devices <n_cards>` where there
    are two cards or more, else through build() with the CLI's BuildArgs
    and a BatchAligner over a mesh of two shards of card 0. Returns (how,
    wall s, {stream handle: shard} of that aligner, empty through the CLI);
    a roundtrip mismatch raises."""
    from pangraph_tpu_torch import cli
    from pangraph_tpu_torch.build.build import build
    from pangraph_tpu_torch.io.fasta import read_fasta
    from pangraph_tpu_torch.ops.batch_align import BatchAligner
    from pangraph_tpu_torch.parallel.mesh import make_mesh

    argv = ["build", fa, "-c", "-f", "-j", "2", "--device", "cuda", "--no-progress-bar"]
    t0 = time.time()
    if n_cards >= 2:
        rc = cli.main(argv + ["--devices", str(n_cards), "-o", out])
        if rc != 0:
            raise AssertionError(f"build --devices {n_cards} exited {rc}")
        return f"cli_devices_{n_cards}", time.time() - t0, {}
    args = cli.build_args_of(cli.build_parser().parse_args(argv))
    aligner = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts, device="cuda",
                           mesh=make_mesh(devices=["cuda:0"] * 2))
    build(read_fasta(fa), args, aligner=aligner).to_file(out)  # -f: verify_roundtrip raises on a mismatch
    wall = time.time() - t0
    return "build_api_cuda0_x2", wall, {st.cuda_stream: shard for shard, st in aligner._streams.items()}


def shard_overlap_ms(log: list, base, shard_of: dict, name: str = "stripe_dp") -> float:
    """Summed ms in which shard 0's and shard 1's `name` launches of a launch
    log ran at once: each launch's event pair placed on one timeline by
    `base`, an event recorded on the same card before the run; a launch's
    shard from its stream (`shard_of`)."""
    spans = {0: [], 1: []}
    for n, _B, _R, _m, _dev, start, end, stream in log:
        if n == name and shard_of.get(stream) in spans:
            spans[shard_of[stream]].append((base.elapsed_time(start), base.elapsed_time(end)))
    merged = {}
    for shard, iv in spans.items():
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        merged[shard] = out
    total, i, j = 0.0, 0, 0
    a, b = merged[0], merged[1]
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _mesh_ckpt_round(torch) -> dict:
    """One align round on the checkpoint route (ckpt_paths_bytes=0): a
    2-shard aligner on card 0 against a one-device aligner, on
    MESH_CKPT_PROBLEMS of phase 3's (128, 65536) problems; their Edits must
    be equal and apply exactly. The launch counts are set to 0 just before
    the sharded round and read just after."""
    from pangraph_tpu_torch.align.params import BandedAlignParams, BandParameters
    from pangraph_tpu_torch.ops import stripe_v2 as sv
    from pangraph_tpu_torch.ops.batch_align import AlignJob, BatchAligner
    from pangraph_tpu_torch.parallel.mesh import make_mesh

    ref_in, qry_in, rlen, qlen, ms, _W = kernel_inputs(128, 65536, 8, seed=200)
    jobs = [AlignJob(ref_in[s, : rlen[s]], qry_in[s, : qlen[s]], BandParameters(int(ms[s]), 58))
            for s in range(MESH_CKPT_PROBLEMS)]
    one = BatchAligner(BandedAlignParams(), 5, 4, device="cuda", ckpt_paths_bytes=0).align_many(jobs)
    BatchAligner.reset_engine_stats()
    sv.reset_launches()
    t0 = time.time()
    sharded = BatchAligner(BandedAlignParams(), 5, 4, device="cuda", ckpt_paths_bytes=0,
                           mesh=make_mesh(devices=["cuda:0"] * 2)).align_many(jobs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(sv.LAUNCHES)
    report = BatchAligner.engine_report()
    equal = sum(a == b for a, b in zip(one, sharded))
    exact = sum(bool(np.array_equal(e.apply(j.ref), j.qry)) for e, j in zip(sharded, jobs))
    say("mesh_path.ckpt_round", problems=len(jobs), shards=2, wall_s=round(wall, 3), launches=json.dumps(launches),
        routes=json.dumps(report["device_routes"]), tiers=json.dumps(report["device_tiers"]),
        shard_launches=json.dumps(report["device_shards"]), edits_equal=equal, exact=exact)
    if equal != len(jobs) or exact != len(jobs):
        raise AssertionError(f"mesh_path: the 2-shard checkpoint round's Edits differ from one device's "
                             f"({equal} equal, {exact} exact of {len(jobs)})")
    if (launches["stripe_dp_ckpt"] <= 0 or launches["walk_ckpt"] <= 0 or launches["decode_events"] <= 0
            or launches["stripe_dp"] or launches["walk"]):
        raise AssertionError(f"mesh_path: the checkpoint round launched {launches}")
    if len(report["device_shards"]) != 2:
        raise AssertionError(f"mesh_path: the checkpoint round ran on {report['device_shards']}, not 2 shards")
    return {"launches": launches}


def phase_mesh_path(torch, fa: str, main_graph: str, main_report: dict, work: str) -> dict:
    """Phase 8: the headline build with its launches split over a mesh
    (_mesh_build), with the launch counts set to 0 just before it and read
    just after: the graph byte-equal to phase 4's (`main_graph`), the DP and
    walk launched on every shard, the checkpoint pair, sketch and chain not,
    the device cells equal to phase 4's, at least half of them on the
    device. The build runs with the broker's gather window at MESH_GATHER_S,
    and at least one combined round must hold two merge threads' legs: the
    byte-equality then holds coalesced rounds against phase 4's. On one
    card, the CLI's `--devices 2` must exit 1, and the summed time in which
    the two shards' DP launches ran at once is printed (shard_overlap_ms).
    Then one checkpoint-route round on two shards (_mesh_ckpt_round)."""
    from pangraph_tpu_torch import cli
    from pangraph_tpu_torch.ops import chain_k2 as ch
    from pangraph_tpu_torch.ops import sketch_k1 as sk
    from pangraph_tpu_torch.ops import stripe_v2 as sv
    from pangraph_tpu_torch.ops.batch_align import BatchAligner

    phase = "mesh_path"
    n_cards = torch.cuda.device_count()
    if n_cards == 1:
        refused = os.path.join(work, "refused.json")
        rc = cli.main(["build", fa, "--device", "cuda", "--devices", "2", "--no-progress-bar", "-o", refused])
        say(f"{phase}.cli_refuses", devices=2, cards=n_cards, rc=rc)
        if rc != 1 or os.path.exists(refused):
            raise AssertionError(f"{phase}: build --devices 2 on one card exited {rc}, not 1")
    out = os.path.join(work, "mesh.json")
    torch.cuda.empty_cache()
    BatchAligner.reset_engine_stats()
    for mod in (sv, sk, ch):
        mod.reset_launches()
    sv.KERNEL_TIMING = []
    base = torch.cuda.Event(enable_timing=True)
    base.record()
    gather = BatchAligner.BROKER_GATHER_S
    BatchAligner.BROKER_GATHER_S = MESH_GATHER_S
    try:
        how, wall, shard_of = _mesh_build(torch, fa, out, n_cards)
        torch.cuda.synchronize()
        kernel_log = launch_log_summary(sv.KERNEL_TIMING)
        overlap = shard_overlap_ms(sv.KERNEL_TIMING, base, shard_of) if shard_of else None
    finally:
        sv.KERNEL_TIMING = None
        BatchAligner.BROKER_GATHER_S = gather
    launches = {**sv.LAUNCHES, **sk.LAUNCHES, **ch.LAUNCHES}
    report = BatchAligner.engine_report()
    with open(out, "rb") as f, open(main_graph, "rb") as g:
        same_graph = f.read() == g.read()
    shards = report["device_shards"]
    cells, main_cells = report["device"]["cells"], main_report["device"]["cells"]
    say(phase, how=how, cards=n_cards, wall_s=round(wall, 3), broker_gather_s=MESH_GATHER_S, roundtrip="exact",
        graph_equals_main_path=same_graph,
        launches=json.dumps(launches), device_cells=cells, main_path_device_cells=main_cells,
        device_cells_frac=report["device_cells_frac"])
    say(f"{phase}.shards", **{k.replace(":", "_"): f"{v['launches']}launches/{v['cells']}cells"
                              for k, v in shards.items()})
    say(f"{phase}.shard_overlap", dp_overlap_ms="not_measured_shards_on_separate_cards" if overlap is None
        else round(overlap, 3), dp_device_ms=round(kernel_log.get("stripe_dp", {}).get("ms", 0.0), 3))
    say(f"{phase}.engines", report=json.dumps(report))
    say_launch_log(phase, kernel_log)
    broker = say_broker(phase, report, launches, kernel_log)
    if not same_graph:
        raise AssertionError(f"{phase}: the mesh build's graph differs from phase 4's")
    if broker["max_legs"] < 2:
        raise AssertionError(f"{phase}: no combined round held two merge threads' legs: {broker}")
    for name, must in {"stripe_dp": True, "walk": True, "decode_events": True, "stripe_dp_ckpt": False, "walk_ckpt": False,
                       "sketch": False, "chain": False}.items():
        if must and launches[name] <= 0:
            raise AssertionError(f"{phase}: kernel {name} was never launched: {launches}")
        if not must and launches[name] != 0:
            raise AssertionError(f"{phase}: kernel {name} was launched off its path: {launches}")
    n_shards = max(n_cards, 2)
    if len(shards) != n_shards or any(v["launches"] <= 0 for v in shards.values()):
        raise AssertionError(f"{phase}: not every one of the {n_shards} shards launched: {shards}")
    cards_used = {d for name in ("stripe_dp", "walk") for d in kernel_log[name]["by_device"]}
    if len(cards_used) != n_cards:
        raise AssertionError(f"{phase}: the DP and walk ran on {sorted(cards_used)} of {n_cards} cards")
    if cells != main_cells:
        raise AssertionError(f"{phase}: {cells} device cells, phase 4 had {main_cells}")
    if (report["device_cells_frac"] or 0) < 0.5:
        raise AssertionError(f"{phase}: device_cells_frac {report['device_cells_frac']} < 0.5")
    ckpt = _mesh_ckpt_round(torch)
    return {"launches": launches, "report": report, "wall_s": wall, "kernels": kernel_log,
            "ckpt_launches": ckpt["launches"]}


def phase_cluster(torch, work: str) -> dict:
    """Phase 9: two worker processes through
    distributed.launch_local_cluster(device="cuda", local_shards=2) on the
    reference's worker workload (6 x 900 bp): a gloo process group, the
    merge tree split through the TCP coordinator, each worker's launches
    over two shards of card 0. Both digests equal, and equal to a solo
    build's on the card; the sum over the group equals the cluster's
    shards; 1-5 merges claimed; the DP and walk launched in the workers
    (each worker counts its own launches)."""
    from pangraph_tpu_torch.align.params import AlignmentArgs, BuildArgs
    from pangraph_tpu_torch.build.build import build
    from pangraph_tpu_torch.ops.batch_align import BatchAligner
    from pangraph_tpu_torch.parallel import distributed as dist_mod

    phase = "cluster"
    t0 = time.time()
    results = dist_mod.launch_local_cluster(n_processes=2, device="cuda", local_shards=2, genomes=6, length=900,
                                            timeout_s=300, out_dir=os.path.join(work, "cluster"))
    wall = time.time() - t0
    args = BuildArgs(circular=False, jobs=2, aln_args=AlignmentArgs())
    solo = build(dist_mod._synth_records(seed=3, n=6, L=900), args,
                 aligner=BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts,
                                      device="cuda"))
    solo_digest = dist_mod.graph_digest(solo)
    launches = {k: sum(r["launches"][k] for r in results) for k in results[0]["launches"]}
    claims = sum(r["merges_claimed"] for r in results)
    say(phase, processes=len(results), wall_s=round(wall, 3), digest=results[0]["digest"], solo_digest=solo_digest,
        blocks=results[0]["blocks"], psum=json.dumps([r["psum"] for r in results]),
        global_devices=json.dumps([r["global_devices"] for r in results]), merges_claimed=claims,
        launches=json.dumps(launches), shards=json.dumps([r["shards"] for r in results]))
    if {r["digest"] for r in results} != {solo_digest}:
        raise AssertionError(f"{phase}: the workers' graphs differ from the solo build's")
    if any(r["psum"] != 4.0 or r["global_devices"] != 4 for r in results):
        raise AssertionError(f"{phase}: the group's sum is not the cluster's 4 shards")
    if not 1 <= claims <= 5:
        raise AssertionError(f"{phase}: {claims} merges claimed, not 1-5")
    if launches["stripe_dp"] <= 0 or launches["walk"] <= 0 or launches["decode_events"] <= 0:
        raise AssertionError(f"{phase}: the workers never launched the DP, walk and decode: {launches}")
    return {"launches": launches, "wall_s": wall}


# The adaptive split's settings that its rule reads (BatchAligner's)
GATE_SETTINGS = ("RATE_MIN_CELLS", "DEV_PROBE_CELLS", "DEVICE_MIN_ADVANTAGE", "MIXED_GUARANTEE", "HOST_ALL")


def gate_settings(cls) -> dict:
    return {k: getattr(cls, k) for k in GATE_SETTINGS}


def gate_rule(e: dict, c: dict) -> tuple:
    """The reference's adaptive split (pangraph_tpu/ops/batch_align.py:
    654-714), written again from its source and apart from the port's: from
    a GATE_LOG entry's state before its round (C, h, d, L, budget, starved,
    period, inflight) and the settings `c`, what the gate does: (gate, the
    host leg's budget, starved after, period after)."""
    C, h, d, L, budget, starved, period = (e[k] for k in ("C", "h", "d", "L", "budget", "starved", "period"))
    rmc, every = c["RATE_MIN_CELLS"], c["HOST_ALL"]
    if d is None:
        if e["inflight"]:
            return "probe-wait", every, starved, period
        return "probe", max(budget, C - c["DEV_PROBE_CELLS"]), starved, period
    if not h:
        return "fixed", budget, starved, period
    host_only_wall = C / h
    mixed_wall = (L * d + C) / (d + h)
    if d >= c["DEVICE_MIN_ADVANTAGE"] * h and mixed_wall < host_only_wall * c["MIXED_GUARANTEE"]:
        cap = max(budget, int(h * (L * d + C) / (d + h)))
        if C >= 2 * rmc and C - cap < rmc:
            starved += 1
            if starved >= 8:
                cap, starved = min(cap, C - rmc), 0
        return "open", cap, starved, 8
    starved += 1
    if starved >= period and C >= 2 * rmc:
        return "slice", C - rmc, 0, min(period * 2, 64)
    return "closed", every, starved, period


def check_gate_log(phase: str, log: list, c: dict) -> dict:
    """Every gated round of `log` (BatchAligner.GATE_LOG) against the gate's
    rule (gate_rule) recomputed from the state logged before it: the same
    decision, budget and counters; the host's smallest jobs fill the budget
    (fill <= cap < fill + next); the host cells are that fill plus the wide
    bands, or the whole round where a probe leg was in flight; the device
    cells the rest; per aligner, each round's probe period the previous
    round's, and its starved count the previous one's or 0 (a device-rate
    observation resets it). Returns the rounds by kind."""
    if not log:
        raise AssertionError(f"{phase}: no gated round was logged")
    last = {}
    kinds = {}
    for n, e in enumerate(log):
        want = gate_rule(e, c)
        got = (e["gate"], e["cap"], e["starved_after"], e["period_after"])
        if got != want:
            raise AssertionError(f"{phase}: round {n} did {got}, the rule gives {want}: {e}")
        if not (e["fill"] <= e["cap"] and (e["next"] is None or e["fill"] + e["next"] > e["cap"])):
            raise AssertionError(f"{phase}: round {n}'s host jobs do not fill its budget: {e}")
        whole = e["gate"] == "probe-wait" or e.get("race_lost")
        host = e["C"] if whole else e["fill"] + e["wide"]
        if e["host"] != host or e["dev"] != e["C"] - host:
            raise AssertionError(f"{phase}: round {n}'s split is {e['host']} / {e['dev']}, not {host} / "
                                 f"{e['C'] - host}: {e}")
        prev = last.get(e["aligner"])
        if prev is not None and (e["period"] != prev["period_after"]
                                 or e["starved"] not in (prev["starved_after"], 0)):
            raise AssertionError(f"{phase}: round {n}'s counters do not follow round {prev['n']}'s: {e}")
        last[e["aligner"]] = {**e, "n": n}
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    return kinds


def say_gate(phase: str, report: dict, kinds: dict) -> None:
    """A gate line: the rates (Gcells/s), the overhead and round trip (ms)
    and the gated rounds by kind."""
    g = report["gate"]
    gcells = {k: None if g[k] is None else round(g[k] / 1e9, 4) for k in ("host_rate", "dev_rate")}
    say(phase, h_gcells_per_s=gcells["host_rate"], d_gcells_per_s=gcells["dev_rate"],
        d_over_h=None if None in gcells.values() else round(g["dev_rate"] / g["host_rate"], 4),
        L_ms=None if g["dev_latency_s"] is None else round(g["dev_latency_s"] * 1e3, 4),
        L_floor_ms=round(g["dev_latency_floor_s"] * 1e3, 4),
        rtt_ms=None if g["measured_rtt_s"] is None else round(g["measured_rtt_s"] * 1e3, 4),
        rounds=json.dumps(kinds), device_cells_frac=report["device_cells_frac"])


def ckpt_rule(ckpt_rate, host_rate) -> bool:
    """The reference's checkpoint-route rule (`_ckpt_competitive`,
    pangraph_tpu/ops/batch_align.py:608-618) on a healthy device, written
    again from its source: may a group whose v2 records do not fit take the
    checkpoint pair?"""
    if ckpt_rate is None:
        return True
    return ckpt_rate > (host_rate or 0.0)


def check_ckpt_log(phase: str, log: list, rate_min_cells: int) -> dict:
    """Every entry of `log` (BatchAligner.CKPT_LOG) recomputed: each
    observation's rate is the EMA (weight 0.5) of its aligner's
    observations so far, cells / secs each, from rounds of at least
    rate_min_cells; each decision read its aligner's EMA as it stood and
    gave ckpt_rule's answer for the rates it logged. Returns the
    observations, the decisions, those that both rates decided, and the
    answers by route."""
    ema = {}
    out = {"observed": 0, "decided": 0, "rate_decided": 0, "ckpt": 0, "host": 0}
    for n, e in enumerate(log):
        a = e["aligner"]
        if e["event"] == "observe":
            if e["cells"] < rate_min_cells or e["secs"] <= 0:
                raise AssertionError(f"{phase}: entry {n} observed a round it should not have: {e}")
            obs = e["cells"] / e["secs"]
            want = obs if a not in ema else 0.5 * ema[a] + 0.5 * obs
            if e["ckpt_rate"] != want:
                raise AssertionError(f"{phase}: entry {n}'s checkpoint rate is not the EMA's {want}: {e}")
            ema[a] = want
            out["observed"] += 1
            continue
        if e["ckpt_rate"] != ema.get(a):
            raise AssertionError(f"{phase}: entry {n} read a checkpoint rate that is not the EMA's "
                                 f"{ema.get(a)}: {e}")
        want = ckpt_rule(e["ckpt_rate"], e["host_rate"])
        if e["ckpt"] != want:
            raise AssertionError(f"{phase}: entry {n} answered {e['ckpt']}, the rule gives {want}: {e}")
        out["decided"] += 1
        out["rate_decided"] += e["ckpt_rate"] is not None and e["host_rate"] is not None
        out["ckpt" if want else "host"] += 1
    return out


# phase 11's host-leg budget: the reference's default NATIVE_CELL_BUDGET
GATED_BUDGET = 100_000_000


def _gated_build(torch, phase: str, fa: str, record_budget: int = None) -> dict:
    """The headline (`fa`) built in this process at NATIVE_CELL_BUDGET =
    GATED_BUDGET: build() with BuildArgs(circular=True, jobs=2) and a new
    BatchAligner on card 0 (its record budget set to `record_budget` where
    given), the launch counts set to 0 just before it and read just after.
    Checks an exact roundtrip, quality within QUALITY_TOLERANCE, some
    cells on the device, and every logged round consistent with the gate's
    rule (check_gate_log); prints the build's line, its quality, its launch
    log and its gate line."""
    from pangraph_tpu_torch.align.params import BuildArgs
    from pangraph_tpu_torch.build.build import build, verify_roundtrip
    from pangraph_tpu_torch.commands import graph_quality
    from pangraph_tpu_torch.io.fasta import read_fasta
    from pangraph_tpu_torch.ops import chain_k2 as ch
    from pangraph_tpu_torch.ops import sketch_k1 as sk
    from pangraph_tpu_torch.ops import stripe_v2 as sv
    from pangraph_tpu_torch.ops.batch_align import BatchAligner

    records = read_fasta(fa)
    args = BuildArgs(circular=True, jobs=2)
    aligner = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts, device="cuda")
    if record_budget is not None:
        aligner.budget = record_budget
    saved = BatchAligner.NATIVE_CELL_BUDGET
    BatchAligner.reset_engine_stats()
    for mod in (sv, sk, ch):
        mod.reset_launches()
    sv.KERNEL_TIMING = []
    try:
        BatchAligner.NATIVE_CELL_BUDGET = GATED_BUDGET
        t0 = time.time()
        graph = build(records, args, aligner=aligner)
        wall = time.time() - t0
        torch.cuda.synchronize()
        kernel_log = launch_log_summary(sv.KERNEL_TIMING)
    finally:
        sv.KERNEL_TIMING = None
        BatchAligner.NATIVE_CELL_BUDGET = saved
    launches = {**sv.LAUNCHES, **sk.LAUNCHES, **ch.LAUNCHES}
    report = BatchAligner.engine_report()
    log = list(BatchAligner.GATE_LOG)
    verify_roundtrip(graph, records)
    quality = graph_quality(graph)
    say(phase, native_cell_budget=GATED_BUDGET, record_budget=aligner.budget, wall_s=round(wall, 3),
        roundtrip="exact", device_cells_frac=report["device_cells_frac"], host_cells=report["host"]["cells"],
        device_cells=report["device"]["cells"], gated_rounds=len(log), launches=json.dumps(launches))
    say(f"{phase}.quality", **{k: f"{quality[k]}(reference {v})" for k, v in HEADLINE_QUALITY.items()})
    say(f"{phase}.engines", report=json.dumps(report))
    say_launch_log(phase, kernel_log)
    kinds = check_gate_log(phase, log, gate_settings(BatchAligner))
    say_gate(f"{phase}.gate", report, kinds)
    if report["device"]["cells"] <= 0:
        raise AssertionError(f"{phase}: no cells ran on the device: {report['device']}")
    check_quality(phase, quality)
    return {"launches": launches, "report": report, "wall_s": wall, "kinds": kinds, "kernels": kernel_log}


def check_launched(phase: str, launches: dict, kernel_log: dict, want: dict) -> None:
    """want[name] True: the kernel launched and its launches are in the
    launch log; False: it never launched."""
    for name, must in want.items():
        if must and (launches[name] <= 0 or name not in kernel_log):
            raise AssertionError(f"{phase}: kernel {name} was not launched and timed: {launches}")
        if not must and launches[name] != 0:
            raise AssertionError(f"{phase}: kernel {name} was launched off its path: {launches}")


def phase_gated_path(torch, fa: str) -> dict:
    """Phase 11: the headline built at the reference's default host-leg
    budget, so that the adaptive split routes every round (_gated_build):
    the DP and walk launched with launch-log ms, the checkpoint pair,
    sketch and chain not."""
    out = _gated_build(torch, "phase11", fa)
    check_launched("phase11", out["launches"], out["kernels"],
                   {"stripe_dp": True, "walk": True, "decode_events": True, "stripe_dp_ckpt": False, "walk_ckpt": False,
                    "sketch": False, "chain": False})
    return out


# phase 12's record budget: under 4 * 8 * 10,240 * 128 * 2 bytes, so that
# the v2 records of a minimum group of 8 problems (R_cap * B * 2 bytes each)
# pass a launch's quarter of it from the 10,240 tier at B 128 up, and the
# 4,096 tier's at B 384 and up: those groups reach the measured-rate rule
CKPT_ROUTE_RECORD_BUDGET = 4 * 8 * 10240 * 128 * 2 - 4


def phase_ckpt_route(torch, fa: str, record_budget: int = CKPT_ROUTE_RECORD_BUDGET) -> dict:
    """Phase 12: the headline built as in phase 11 (_gated_build), with the
    aligner's record budget set to `record_budget`, so that the long tiers'
    groups do not fit and the reference's measured-rate rule sends each
    to the checkpoint pair or to the host engine. Every CKPT_LOG entry is
    recomputed (check_ckpt_log); at least one round wholly on the
    checkpoint route must observe the checkpoint rate, at least one later
    group must be decided by both measured rates, and the checkpoint DP and
    walk must launch, with their launch-log ms; the sketch and chain must
    not. Prints the checkpoint rate against the host rate, the decisions
    by answer, the device share and the wall."""
    from pangraph_tpu_torch.ops.batch_align import BatchAligner

    phase = "phase12"
    out = _gated_build(torch, phase, fa, record_budget)
    counts = check_ckpt_log(phase, list(BatchAligner.CKPT_LOG), BatchAligner.RATE_MIN_CELLS)
    g = out["report"]["gate"]
    gcells = {k: None if g[k] is None else round(g[k] / 1e9, 4) for k in ("ckpt_rate", "host_rate")}
    say(f"{phase}.ckpt_route", ckpt_gcells_per_s=gcells["ckpt_rate"], h_gcells_per_s=gcells["host_rate"],
        ckpt_over_h=None if None in gcells.values() else round(g["ckpt_rate"] / g["host_rate"], 4),
        observed=counts["observed"], decided=counts["decided"], rate_decided=counts["rate_decided"],
        to_ckpt=counts["ckpt"], to_host=counts["host"], device_cells_frac=out["report"]["device_cells_frac"],
        device_routes=json.dumps(out["report"]["device_routes"]), wall_s=round(out["wall_s"], 3))
    if counts["observed"] < 1:
        raise AssertionError(f"{phase}: no round wholly on the checkpoint route observed its rate: {counts}")
    if counts["rate_decided"] < 1:
        raise AssertionError(f"{phase}: no group was decided by the two measured rates: {counts}")
    check_launched(phase, out["launches"], out["kernels"],
                   {"stripe_dp_ckpt": True, "walk_ckpt": True, "decode_events": True, "sketch": False, "chain": False})
    return {**out, "ckpt": counts}


KERNEL_FILES = {
    "stripe_dp": ("pangraph_tpu_torch/csrc/stripe_dp.cu", "pangraph_tpu/ops/stripe_v2.py:201"),
    "walk": ("pangraph_tpu_torch/csrc/walk.cu", "pangraph_tpu/ops/stripe_v2.py:452"),
    "stripe_dp_ckpt": ("pangraph_tpu_torch/csrc/stripe_dp.cu", "pangraph_tpu/ops/stripe_v2.py:332"),
    "walk_ckpt": ("pangraph_tpu_torch/csrc/walk_ckpt.cu", "pangraph_tpu/ops/stripe_v2.py:647"),
    "sketch": ("pangraph_tpu_torch/csrc/sketch.cu", "pangraph_tpu/ops/sketch_k1.py:153"),
    "chain": ("pangraph_tpu_torch/csrc/chain.cu", "pangraph_tpu/ops/chain_k2.py:76"),
}


def _timed_by(name: str) -> str:
    """How a kernel's times were taken: "events" (event pairs: the DPs and
    the checkpoint walk), "profiler" (kernel records, _kernel_ms), or
    "profiler, events in some phase" where the profiler kept no launch of
    it in some timing of this run and that one is an event pair (the
    kernel_ms_fallback lines say which)."""
    profiled = {"walk": WALK_KERNEL, "sketch": SKETCH_KERNEL, "chain": CHAIN_KERNEL}
    if name not in profiled:
        return "events"
    return "profiler, events in some phase" if profiled[name] in EVENT_TIMED else "profiler"


def receipts(kern: dict, ckpt: dict, main_path: dict, long_tier: dict, sc: dict, sc_path: dict,
             cli_path: dict, mesh_path: dict, gated: dict, route: dict) -> dict:
    """One entry per kernel: launches on its own path (the DP and walk on
    the headline's default path, on phase 7's merge as `merge_launches`,
    and on phase 11's gated build as `gated_launches`; the checkpoint pair
    on the long-tier path, the sketch
    and chain on phase 6; the four alignment kernels on phase 8's mesh as
    `mesh_launches` and on phase 12's build as `ckpt_route_launches`, with
    that build's launch-log ms as `ckpt_route_device_ms`), worst error
    against its plain version
    over every shape it was held at, and its times and bound at one shape
    where both were timed (for the sketch and chain, phase 6's own; the two
    DP modes and the chain also carry their dependency bound and which bound
    binds). The decode's row gives its launches on each of those paths; its
    max_abs_err counts the problems whose decode differed from the plain
    version's at any shape of either route."""
    rows = []
    for name, (shape, phase, path) in {
        "stripe_dp": ((128, 10240), kern, main_path),
        "walk": ((128, 10240), kern, main_path),
        "stripe_dp_ckpt": ((128, 65536), ckpt, long_tier),
        "walk_ckpt": ((128, 65536), ckpt, long_tier),
    }.items():
        ms, plain_ms, bound = phase["times"][shape][name]
        source, replaces = KERNEL_FILES[name]
        problems = {(b, r): n for b, r, n in KERNEL_SHAPES + CKPT_SHAPES}[shape]
        if name == "walk":
            problems = min(problems, PLAIN_WALK_PROBLEMS)
        elif name == "walk_ckpt":
            problems = min(problems, PLAIN_CKPT_WALK_PROBLEMS)
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path["launches"][name], "max_abs_err": phase["worst"][name],
            "ms": round(ms, 4), "plain_ms": round(plain_ms, 2),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": None,
            "shape": f"B={shape[0]} R={shape[1]} problems={problems}", "timed_by": _timed_by(name),
        })
        if "dep_bound_ms" in bound:
            rows[-1].update(dep_bound_ms=bound["dep_bound_ms"], binds=bound["binds"])
        rows[-1]["ckpt_route_launches"] = route["launches"][name]
        rows[-1]["ckpt_route_device_ms"] = round(route["kernels"].get(name, {"ms": 0.0})["ms"], 3)
        if path is main_path:
            rows[-1]["merge_launches"] = cli_path["launches"][name]
            rows[-1]["gated_launches"] = gated["launches"][name]
            rows[-1]["mesh_launches"] = mesh_path["launches"][name]
        else:
            rows[-1]["mesh_launches"] = mesh_path["ckpt_launches"][name]
    shape = (128, 10240)
    ms, plain_ms, bound = kern["times"][shape]["decode_events"]
    rows.append({
        "name": "decode_events", "route": "cuda", "source": "pangraph_tpu_torch/csrc/walk.cu",
        "replaces": "none: port-only, the reference decodes on the host (pangraph_tpu/ops/stripe_v2.py:1099)",
        "launches": main_path["launches"]["decode_events"],
        "max_abs_err": max(kern["worst"]["decode_events"], ckpt["worst"]["decode_events"]),
        "ms": round(ms, 4), "plain_ms": round(plain_ms, 2), "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None,
        "shape": f"B={shape[0]} R={shape[1]} problems={dict(((b, r), n) for b, r, n in KERNEL_SHAPES)[shape]}",
        "timed_by": "events", "long_tier_launches": long_tier["launches"]["decode_events"],
        "ckpt_route_launches": route["launches"]["decode_events"],
        "ckpt_route_device_ms": round(route["kernels"].get("decode_events", {"ms": 0.0})["ms"], 3),
        "merge_launches": cli_path["launches"]["decode_events"],
        "gated_launches": gated["launches"]["decode_events"], "mesh_launches": mesh_path["launches"]["decode_events"],
        "mesh_ckpt_launches": mesh_path["ckpt_launches"]["decode_events"],
    })
    sketch_path = sc_path["sketch"][(19, 19)]
    for name, path, worst, shape in (
        ("sketch", sketch_path, max([sc["worst"]["sketch"]] + [x["err"] for x in sc_path["sketch"].values()]),
         f"{sc_path['genomes']} headline genomes, k=19 w=19, L_pad={sketch_path['L_pad']}"),
        ("chain", sc_path["chain"], max(sc["worst"]["chain"], sc_path["chain"]["err"]),
         f"{sc_path['chain']['groups']} headline anchor groups, {sc_path['chain']['anchors']} anchors"),
    ):
        source, replaces = KERNEL_FILES[name]
        bound = path["bound"]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sc_path["launches"][name], "max_abs_err": worst,
            "ms": round(path["ms"], 4), "plain_ms": round(path["plain_ms"], 2),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": None, "shape": shape,
            "timed_by": _timed_by(name),
        })
        if name == "chain":
            rows[-1].update(dep_bound_ms=bound["dep_bound_ms"], binds=bound["binds"])
    return {"kernels": rows}


def main() -> int:
    t_start = time.time()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        import pangraph_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 1
    v2 = {"stripe_dp": True, "walk": True, "decode_events": True, "sketch": False, "chain": False}

    def timed(name: str, fn, *a, **k):
        """Run one phase and print its wall on a line of its own."""
        t0 = time.time()
        out = fn(*a, **k)
        say("wall", of=name, wall_s=round(time.time() - t0, 3))
        return out

    try:
        info = timed("toolchain", phase_toolchain, torch)
        timed("build", phase_build)
        kern = timed("kernels", phase_kernels, torch)
        ckpt = timed("ckpt_kernels", phase_ckpt_kernels, torch)
        timed("mbp", phase_mbp, torch)
        sc = timed("sketch_chain_kernels", phase_sketch_chain_kernels, torch)
        with tempfile.TemporaryDirectory() as tmp:
            fa = os.path.join(tmp, "headline.fa")
            timed("headline", lambda: say("headline", input_bp=headline_fasta(fa)))
            graph = os.path.join(tmp, "headline.json")
            main_path = timed("main_path", phase_build_path, torch, "main_path", fa, {},
                              {**v2, "stripe_dp_ckpt": False, "walk_ckpt": False}, profile=True, out=graph)
            long_tier = timed("long_tier", phase_build_path, torch, "long_tier", fa,
                              {"PANGRAPH_TPU_CKPT_BYTES": CKPT_OVERRIDE_BYTES},
                              {**v2, "stripe_dp_ckpt": True, "walk_ckpt": True})
            sc_path = timed("sketch_chain_path", phase_sketch_chain_path, torch, fa)
            cli_path = timed("cli_path", phase_cli_path, torch, fa, graph, tmp, main_path["quality"])
            mesh_path = timed("mesh_path", phase_mesh_path, torch, fa, graph, main_path["report"], tmp)
            timed("cluster", phase_cluster, torch, tmp)
            gated = timed("phase11", phase_gated_path, torch, fa)
            route = timed("phase12", phase_ckpt_route, torch, fa)
    except Exception as e:  # any failed phase fails the run, with its cause
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say("total", wall_s=round(time.time() - t_start, 3))
    print(info["smi"])
    print(json.dumps(receipts(kern, ckpt, main_path, long_tier, sc, sc_path, cli_path, mesh_path, gated, route)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
