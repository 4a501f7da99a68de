"""The anchor-chain DP as a CUDA kernel, its plain PyTorch version, and its
numpy entry point.

The reference runs it as a Pallas kernel (pangraph_tpu/ops/chain_k2.py),
minimap2's mm_chain_dp over anchors sorted by (r, q):

    f[i] = max(k, max_{h < H} f[i-1-h] + min(dr, dq, k) - (dd*k // 100 + (ilog2(dd) >> 1)))

with dr = r[i] - r[j], dq = q[i] - q[j], dd = |dr - dq| for j = i-1-h, a
predecessor counting only where dr > 0, dq > 0, dr <= max_gap,
dq <= max_gap and dd <= bw. `parent[i]` is j of the smallest h with the
strictly greatest candidate, where that candidate beats k; else -1.
ilog2 is the reference kernel's 10-step ladder, min(floor(log2 max(dd, 1)),
10); the host engines take the true log2, and the two agree for dd < 4096.
Coordinates and scores are int32, as in the reference kernel, which offsets
each anchor set by its smallest coordinate. The build does not call it: it
chains in host C++ (`align/chain.py:chain_anchors`).

`chain_sets` takes a ragged batch of anchor sets, int32 r and q
concatenated with int64 offsets [n_sets + 1], and returns f and parent
(an index within the set) as int32. On a CUDA tensor it launches
csrc/chain.cu (replacing pangraph_tpu/ops/chain_k2.py:_chain_kernel), one
block per set, all sets in one launch, each set in the kernel's keyed loop
where `key_path` allows it and in its two-reduction loop elsewhere; on a
CPU tensor it runs `chain_sets_plain`. `chain_dp` is the numpy
counterpart of `chain_dp_pallas`, one set.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from pangraph_tpu_torch.ops import cuda_build

MAX_H = 1024  # the reference kernel's carry is one 1024-anchor tile: H beyond it is wrong there
COORD_LIMIT = 1 << 30
_INT32_MIN = -(1 << 31)
# The kernel's keyed loop packs 32 * (f - k) and the lane into one int32
# key (csrc/chain.cu): it holds one predecessor a lane, and 32 * f must stay
# below 2^31
KEY_H = 32
KEY_F_LIMIT = 1 << 26

LAUNCHES = {"chain": 0}  # one is added where the kernel is launched, and nowhere else
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        LAUNCHES["chain"] = 0


def pack_sets(sets) -> tuple:
    """[(r, q), ...] int64 anchor sets, each sorted by (r, q), to the int32
    ragged batch `chain_sets` takes: (r32, q32, offsets). Each set is offset
    by its smallest coordinate, as the reference does; a set whose offset
    coordinates reach 2^30 raises ValueError."""
    rs, qs, offsets = [], [], [0]
    for r, q in sets:
        r = np.asarray(r, dtype=np.int64)
        q = np.asarray(q, dtype=np.int64)
        if len(r) != len(q):
            raise ValueError("r and q must have the same length")
        if len(r):
            base = min(int(r.min()), int(q.min()))
            if int(r.max()) - base >= COORD_LIMIT or int(q.max()) - base >= COORD_LIMIT:
                raise ValueError("anchor coordinates exceed the kernel's int32 range")
            rs.append((r - base).astype(np.int32))
            qs.append((q - base).astype(np.int32))
        offsets.append(offsets[-1] + len(r))
    empty = np.zeros(0, np.int32)
    return (np.concatenate(rs) if rs else empty, np.concatenate(qs) if qs else empty,
            np.array(offsets, dtype=np.int64))


def _check_sets(r, q, offsets, H: int) -> None:
    if not 1 <= H <= MAX_H:
        raise ValueError(f"H={H} must be in [1, {MAX_H}]")
    for name, t, dtype in (("r", r, torch.int32), ("q", q, torch.int32), ("offsets", offsets, torch.int64)):
        if t.dim() != 1 or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, expected {r.device}")
    if q.shape != r.shape or len(offsets) < 1:
        raise ValueError("r and q must have one shape, and offsets at least one entry")
    o = offsets.cpu()
    if int(o[0]) != 0 or int(o[-1]) != r.shape[0] or bool((o[1:] < o[:-1]).any()):
        raise ValueError("offsets must rise from 0 to len(r)")


def _ilog2(dd: torch.Tensor) -> torch.Tensor:
    """floor(log2 dd) for dd >= 1, capped at 10: the reference's ladder."""
    out = torch.zeros_like(dd)
    for t in range(1, 11):
        out += (dd >= (1 << t)).to(dd.dtype)
    return out


def chain_sets_plain(r, q, offsets, k: int, max_gap: int, bw: int, H: int):
    """Plain PyTorch version of the chain kernel; same inputs and outputs as
    `chain_sets`. The candidates of every (anchor, h) are computed at once;
    the recurrence then runs one anchor at a time, vectorized over h and over
    the sets (padded to the longest)."""
    dev = r.device
    o = offsets.cpu().long()
    n = o[1:] - o[:-1]
    S, N = len(n), r.shape[0]
    n_max = int(n.max()) if S else 0
    if n_max == 0:
        return torch.empty(0, dtype=torch.int32, device=dev), torch.empty(0, dtype=torch.int32, device=dev)
    t = torch.arange(n_max, device=dev)
    live = t[None, :] < n.to(dev)[:, None]
    flat = (o[:-1].to(dev)[:, None] + t[None, :]).clamp(max=N - 1)
    R, Q = r[flat], q[flat]  # [S, n_max]
    hs = torch.arange(H, device=dev)
    j = t[:, None] - 1 - hs[None, :]  # [n_max, H]
    jc = j.clamp(min=0)
    dr = R[:, :, None] - R[:, jc]
    dq = Q[:, :, None] - Q[:, jc]
    dd = (dr - dq).abs()
    ok = (j >= 0) & (dr > 0) & (dq > 0) & (dr <= max_gap) & (dq <= max_gap) & (dd <= bw)
    alpha = torch.minimum(torch.minimum(dr, dq), torch.tensor(k, dtype=torch.int32, device=dev))
    gap = torch.div(dd * k, 100, rounding_mode="floor") + (_ilog2(dd.clamp(min=1)) >> 1)
    contrib = torch.where(ok, alpha - gap, 0)
    del dr, dq, dd, alpha, gap
    F = torch.full((S, n_max), k, dtype=torch.int32, device=dev)
    best_h = torch.zeros((S, n_max), dtype=torch.int64, device=dev)
    kk = torch.tensor(k, dtype=torch.int32, device=dev)
    neg = torch.tensor(_INT32_MIN, dtype=torch.int32, device=dev)
    for i in range(n_max):
        cand = torch.where(ok[:, i], F.index_select(1, jc[i]) + contrib[:, i], neg)  # [S, H]
        h = cand.argmax(1)  # the first maximum: the smallest h
        F[:, i] = torch.maximum(cand.gather(1, h[:, None])[:, 0], kk)
        best_h[:, i] = h
    # the best candidate beat k exactly where f rose above k
    P = torch.where(F > k, (t[None, :] - 1 - best_h).to(torch.int32), -1)
    return F[live], P[live]


def key_path(offsets, k: int, bw: int, H: int) -> torch.Tensor:
    """Per set of a ragged batch (offsets [n_sets + 1], int64 on the CPU),
    1 where the chain kernel may take its keyed loop and 0 where it takes
    its two-reduction loop, as a uint8 tensor [n_sets] on the CPU. The keyed
    loop needs H <= KEY_H and scores that fit its key: k >= 0 and
    k * n < KEY_F_LIMIT, since every candidate adds at most k and so
    f <= k * n; and k * bw < 2^31, so that dd * k does not wrap and no gap
    is negative."""
    n = (offsets[1:] - offsets[:-1]).long()
    if H > KEY_H or k < 0 or k * max(bw, 0) >= 1 << 31:
        return torch.zeros(len(n), dtype=torch.uint8)
    return (n * k < KEY_F_LIMIT).to(torch.uint8)


def chain_sets(r, q, offsets, k: int, max_gap: int, bw: int, H: int):
    """Chain DP over a ragged batch of anchor sets (see the module
    docstring): (f, parent) int32, parent an index within its set or -1.
    Kernel on CUDA tensors, plain version on CPU tensors."""
    if r.device.type == "cpu":
        _check_sets(r, q, offsets, H)
        return chain_sets_plain(r, q, offsets, k, max_gap, bw, H)
    return chain_sets_cuda(r, q, offsets, k, max_gap, bw, H)


def chain_sets_cuda(r, q, offsets, k: int, max_gap: int, bw: int, H: int):
    """Launch the chain kernel (see `chain_sets`); CUDA tensors only."""
    if r.device.type != "cuda":
        raise ValueError(f"the chain kernel runs on CUDA tensors, not {r.device}")
    _check_sets(r, q, offsets, H)
    N, S = r.shape[0], len(offsets) - 1
    f = torch.empty(N, dtype=torch.int32, device=r.device)
    parent = torch.empty(N, dtype=torch.int32, device=r.device)
    if N == 0:
        return f, parent
    keyed = key_path(offsets.cpu(), k, bw, H).to(r.device)
    lib = cuda_build.lib("chain.cu")
    p = cuda_build.ptr
    with torch.cuda.device(r.device):
        rc = lib.chain_launch(p(r), p(q), p(offsets), p(keyed), S, k, max_gap, bw, H, p(f), p(parent),
                              cuda_build.stream(r.device))
    if rc != 0:
        raise RuntimeError(f"chain kernel launch failed: CUDA error {rc}")
    with _LAUNCH_LOCK:
        LAUNCHES["chain"] += 1
    return f, parent


def chain_dp(r: np.ndarray, q: np.ndarray, k: int, max_gap: int, bw: int, H: int, device="cuda"):
    """(f, parent) int64 for one anchor set sorted by (r, q), the counterpart
    of `chain_dp_pallas`. Runs on `device` (the card unless the caller asks
    for the CPU)."""
    dev = cuda_build.device_of(device)
    if len(r) == 0:
        return np.zeros(0, np.int64), np.full(0, -1, np.int64)
    r32, q32, offsets = pack_sets([(r, q)])
    f, parent = chain_sets(*(torch.from_numpy(a).to(dev) for a in (r32, q32, offsets)), k, max_gap, bw, H)
    return f.cpu().numpy().astype(np.int64), parent.cpu().numpy().astype(np.int64)
