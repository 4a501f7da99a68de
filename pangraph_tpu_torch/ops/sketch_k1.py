"""The minimizer sketch as a CUDA kernel, its plain PyTorch version, and its
numpy entry points.

The reference runs it as a Pallas kernel (pangraph_tpu/ops/sketch_k1.py):
for every window start of a batch of 2-bit code rows it computes the
minimum, leftmost on ties, of w canonical k-mer hashes (Jenkins' invertible
64-bit mix under a 2k-bit mask; an invalid code clears the k-mer, a
palindrome is skipped) with that k-mer's `pos << 1 | strand`. The result is
dense, one entry per window start, and the host compacts it as
`sketch_numpy` does. The build does not call it: its sketch runs in host C++
(`align/minimizer.py:sketch`); this is the device path for callers that want
the sketch beside batched device work.

`sketch_dense` takes an int32 code tensor [m, L_pad] (TWOBIT codes, 4 and up
invalid; L_pad a multiple of C and at least 2C) and returns the minimum's
value as int64 (the uint64 bits; the sentinel 0xFFFF_FFFF_FFFF_FFFF is -1)
and `pos << 1 | strand` as int32, both [m, L_pad - C], for window starts
[0, L_pad - C). On a CUDA tensor it launches csrc/sketch.cu (replacing
pangraph_tpu/ops/sketch_k1.py:_sketch_kernel), which reads the codes in
16-byte loads and so refuses a tensor that is not 16-byte aligned (torch
allocates aligned); on a CPU tensor it runs `sketch_dense_plain`. `sketch_batch` and `sketch_one` are the numpy
counterparts of `sketch_pallas_batch` and `sketch_pallas`: `sketch_batch`
splits the value into the reference's (hi, lo) int32 words.

torch has no unsigned 64-bit type, so the plain version works on int64 with
the reference's emulation rules carried to 64-bit words: a logical right
shift is an arithmetic shift and a mask, an unsigned compare flips the sign
bit of both sides first. Then k up to 32 works, and the sentinel, -1 as a
signed word, loses every unsigned compare as it must.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from pangraph_tpu_torch.align.minimizer import Minimizers
from pangraph_tpu_torch.graph.seq import TWOBIT, as_seq
from pangraph_tpu_torch.ops import cuda_build

C = 512  # window starts per chunk: the unit of the dense output, as in the reference
MAX_ROWS = 65535  # the kernel's grid rows

LAUNCHES = {"sketch": 0}  # one is added where the kernel is launched, and nowhere else
_LAUNCH_LOCK = threading.Lock()

_SIGN = -(1 << 63)


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        LAUNCHES["sketch"] = 0


def check_halo(k: int, w: int) -> None:
    """Refuse the (k, w) the reference refuses: its window start chunk and
    the next one must hold every code a chunk's windows read."""
    if not 1 <= k <= 32 or w < 1:
        raise ValueError(f"k={k} must be in [1, 32] and w={w} at least 1")
    w_pad = ((w - 1 + (k - 1) + 127) // 128) * 128
    if C + w_pad + k - 1 > 2 * C:
        raise ValueError(f"w={w}, k={k} halo exceeds one chunk (C={C})")


def _check_codes(codes: torch.Tensor, k: int, w: int) -> None:
    if codes.dim() != 2 or codes.dtype != torch.int32 or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous int32 tensor [m, L_pad]")
    m, L_pad = codes.shape
    if L_pad % C or L_pad < 2 * C:
        raise ValueError(f"L_pad={L_pad} must be a multiple of {C} and at least {2 * C}")
    check_halo(k, w)
    if m > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per call, got {m}")
    if codes.numel() and int(codes.min()) < 0:
        raise ValueError("codes must be TWOBIT codes (0-3 valid, 4 and up invalid), not negative")


def _mask(k: int) -> int:
    """The 2k-bit mask as a signed 64-bit word (-1 at k = 32)."""
    m = (1 << (2 * k)) - 1
    return m - (1 << 64) if m >= 1 << 63 else m


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b on int64 words."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 words by 1 <= s <= 63."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def jenkins_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Jenkins' invertible mix under the 2k-bit mask (the reference's
    distance/mash/hash.rs:3-12) on int64 words holding uint64 bits."""
    m = _mask(k)
    x = (~x + (x << 21)) & m
    x = x ^ _lsr(x, 24)
    x = (x + (x << 3) + (x << 8)) & m
    x = x ^ _lsr(x, 14)
    x = (x + (x << 2) + (x << 4)) & m
    x = x ^ _lsr(x, 28)
    return (x + (x << 31)) & m


def sketch_dense_plain(codes: torch.Tensor, k: int, w: int):
    """Plain PyTorch version of the sketch kernel; same inputs and outputs as
    `sketch_dense`. Vectorized over rows and positions: k shifted ORs build
    both strands' codes, the window minimum is the reference's offset
    doubling (strict less keeps the left candidate, so ties go leftmost)."""
    m, L_pad = codes.shape
    n_out = L_pad - C
    npos = n_out + w - 1  # k-mer positions the windows read
    valid = codes < 4
    b = torch.where(valid, codes, 0).long()
    fwd = torch.zeros((m, npos), dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    ok = torch.ones((m, npos), dtype=torch.bool, device=codes.device)
    for j in range(k):
        bj = b[:, j : j + npos]
        fwd |= bj << (2 * (k - 1 - j))
        rev |= (3 ^ bj) << (2 * j)
        ok &= valid[:, j : j + npos]
    is_rev = ult(rev, fwd)
    good = ok & (rev != fwd)  # a palindrome has no strand: skipped
    val = torch.where(good, jenkins_plain(torch.where(is_rev, rev, fwd), k), -1)
    pos = torch.arange(npos, dtype=torch.int64, device=codes.device)
    ps = (((pos << 1) | is_rev.long()) & 0xFFFFFFFF).to(torch.int32)  # int32 bits, as the reference's
    span = 1
    while span < w:
        step = min(span, w - span)
        take = ult(val[:, step:], val[:, :-step])
        val = torch.where(take, val[:, step:], val[:, :-step])
        ps = torch.where(take, ps[:, step:], ps[:, :-step])
        span += step
    return val.contiguous(), ps.contiguous()


def sketch_dense(codes: torch.Tensor, k: int, w: int):
    """Dense sketch of a code batch (see the module docstring): (value int64,
    pos << 1 | strand int32), each [m, L_pad - C]. Kernel on a CUDA tensor,
    plain version on a CPU tensor."""
    if codes.device.type == "cpu":
        _check_codes(codes, k, w)
        return sketch_dense_plain(codes, k, w)
    return sketch_dense_cuda(codes, k, w)


def sketch_dense_cuda(codes: torch.Tensor, k: int, w: int):
    """Launch the sketch kernel (see `sketch_dense`); CUDA tensors only."""
    if codes.device.type != "cuda":
        raise ValueError(f"the sketch kernel runs on CUDA tensors, not {codes.device}")
    _check_codes(codes, k, w)
    if codes.data_ptr() % 16:
        raise ValueError("the sketch kernel reads codes in 16-byte loads: codes must be 16-byte aligned")
    m, L_pad = codes.shape
    val = torch.empty((m, L_pad - C), dtype=torch.int64, device=codes.device)
    ps = torch.empty((m, L_pad - C), dtype=torch.int32, device=codes.device)
    if m == 0:
        return val, ps
    lib = cuda_build.lib("sketch.cu")
    with torch.cuda.device(codes.device):
        rc = lib.sketch_launch(cuda_build.ptr(codes), L_pad, m, k, w, cuda_build.ptr(val), cuda_build.ptr(ps),
                               cuda_build.stream(codes.device))
    if rc != 0:
        raise RuntimeError(f"sketch kernel launch failed: CUDA error {rc}")
    with _LAUNCH_LOCK:
        LAUNCHES["sketch"] += 1
    return val, ps


def sketch_batch(codes: np.ndarray, k: int, w: int, device="cuda"):
    """Dense sketch of an (m, L_pad) int32 code batch, the counterpart of
    `sketch_pallas_batch`: (min_hi, min_lo, pos << 1 | strand) int32 arrays
    of shape (m, L_pad - C) covering window starts [0, L_pad - C). Runs on
    `device` (the card unless the caller asks for the CPU)."""
    dev = cuda_build.device_of(device)
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    val, ps = sketch_dense(torch.from_numpy(codes).to(dev), k, w)
    v = val.cpu().numpy().view(np.uint64)
    hi = (v >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return hi, lo, ps.cpu().numpy()


SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def compact(hi: np.ndarray, lo: np.ndarray, ps: np.ndarray, n_w: int) -> Minimizers:
    """One row's dense sketch to its minimizers, as `sketch_pallas` compacts:
    the first n_w window starts, sentinel windows dropped, and of each run of
    windows with the same minimizer position the first kept."""
    vals = (hi[:n_w].view(np.uint32).astype(np.uint64) << np.uint64(32)) | lo[:n_w].view(np.uint32).astype(np.uint64)
    ps_u = ps[:n_w].view(np.uint32)
    pos = (ps_u >> 1).astype(np.int64)
    strand = (ps_u & 1).astype(np.uint8)
    keep = vals != SENTINEL
    keep &= np.concatenate(([True], np.diff(pos) != 0))
    return Minimizers(values=vals[keep], positions=pos[keep], strands=strand[keep])


def sketch_one(seq, k: int, w: int, device="cuda") -> Minimizers:
    """Minimizer sketch of one sequence, the counterpart of `sketch_pallas`:
    equal to `sketch_numpy` (values, positions, strands)."""
    device = cuda_build.device_of(device)
    seq = as_seq(seq)
    n = len(seq) - k + 1  # k-mer positions
    n_w = n - w + 1  # windows
    if n <= 0 or n_w <= 0:
        return Minimizers(np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint8))
    # pad so that the last window's chunk has its successor, as the reference does
    L_pad = ((n_w + C - 1) // C + 1) * C
    codes = np.full((1, L_pad), 4, dtype=np.int32)
    codes[0, : len(seq)] = TWOBIT[seq]
    hi, lo, ps = sketch_batch(codes, k, w, device)
    return compact(hi[0], lo[0], ps[0], n_w)
