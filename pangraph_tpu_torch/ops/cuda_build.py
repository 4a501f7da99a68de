"""Build and load the CUDA kernels of `pangraph_tpu_torch/csrc/`.

Each `.cu` source exports a plain C launcher and includes no PyTorch header,
so `nvcc` builds it in seconds into a shared library that ctypes loads. The
sources compile in parallel, one `nvcc` each, for sm_90a (Hopper), into
BUILD_DIR beside the package (listed in .gitignore); a library's file name
carries a hash of its source and of the headers in csrc/ (the DP's row step
and the walk's move are shared headers), so an edited source or header is
rebuilt and an unchanged one is not. Nothing is compiled at import: the first launch, or
an explicit `build_all()`, builds. `ptr`, `stream` and `device_of` are what
the kernels' wrappers hand to a launcher and how their numpy entry points
pick a device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "_build", "kernels")
SOURCES = ("stripe_dp.cu", "walk.cu", "walk_ckpt.cu", "sketch.cu", "chain.cu")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_LOG: dict = {}  # source -> nvcc/ptxas output of the build done in this process

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_ARGTYPES = {
    # ref, ref_stride, qry, qry_stride, rlen, qlen, ms, W, iupac, rec, rec_rows, B, m, stream
    "stripe_dp_launch": [_P, _I64, _P, _I64, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _P],
    # rec, rec_rows, B, rlen, qlen, ms, W, seg, K, rows, words, n_events, meta, m, stream
    "walk_launch": [_P, _I64, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P],
    # rows, words, n_events, meta, K, ref, ref_stride, qry, qry_stride, rlen, qlen, head, totals,
    # sub_pos, sub_alt, evs, m, stream
    "decode_events_launch": [_P, _P, _P, _P, _I, _P, _I64, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    # ref, ref_stride, qry, qry_stride, rlen, qlen, ms, W, iupac, ckpt, n_windows, WV, B, m, stream
    "stripe_dp_ckpt_launch": [_P, _I64, _P, _I64, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # ref, ref_stride, qry, qry_stride, rlen, qlen, ms, W, iupac, ckpt, n_windows, WV, B,
    # scratch, S, p_lo, p_hi, w_lo, w_hi, stream
    "walk_ckpt_rederive_launch": [_P, _I64, _P, _I64, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _P, _I, _I, _I, _I, _I, _P],
    # rlen, qlen, ms, W, ckpt, n_windows, WV, B, scratch, S, p_lo, p_hi, w_lo, w_hi, state,
    # first, last, K, rows, words, n_events, meta, stream
    "walk_ckpt_walk_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P,
                              _I, _I, _I, _P, _P, _P, _P, _P],
    # codes, L_pad, m, k, w, val, ps, stream
    "sketch_launch": [_P, _I64, _I, _I, _I, _P, _P, _P],
    # r, q, offsets, keyed, n_sets, k, max_gap, bw, H, f, parent, stream
    "chain_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
}


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, for a launcher's last argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def device_of(device) -> torch.device:
    """`device` as a torch.device; a CUDA device where there is none raises
    (a numpy entry point never falls back to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: no CUDA device is available (pass device='cpu')")
    return dev


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")
    return path


def _so_path(src: str) -> str:
    h = hashlib.blake2b(" ".join(NVCC_FLAGS).encode(), digest_size=8)
    for name in [src] + sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{os.path.splitext(src)[0]}_{h.hexdigest()}.so")


def _load(so: str):
    lib = ctypes.CDLL(so)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def build_all() -> dict:
    """Compile every source that has no library yet (all at once) and load
    them all. Returns {source: library}. Raises RuntimeError with nvcc's
    output if a build fails."""
    with _LOCK:
        todo = [s for s in SOURCES if s not in _LIBS and not os.path.exists(_so_path(s))]
        if todo:
            os.makedirs(BUILD_DIR, exist_ok=True)
            exe = nvcc()
            procs = []
            for src in todo:
                so = _so_path(src)
                tmp = f"{so}.tmp{os.getpid()}"
                cmd = [exe, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
                procs.append((src, so, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            failed = []
            for src, so, tmp, proc in procs:
                out, _ = proc.communicate()
                BUILD_LOG[src] = out
                if proc.returncode != 0:
                    failed.append(f"{src}:\n{out}")
                else:
                    os.replace(tmp, so)
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for src in SOURCES:
            if src not in _LIBS:
                _LIBS[src] = _load(_so_path(src))
        return dict(_LIBS)


def lib(src: str):
    """The loaded library built from csrc/<src>, building it if needed."""
    got = _LIBS.get(src)
    return got if got is not None else build_all()[src]
