"""What the port (pangraph_tpu_torch) must never do: import JAX or the JAX
package, fall back silently when CUDA is missing, or hand CPU tensors to a
CUDA kernel."""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_port_modules_import_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pangraph_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'pangraph_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'pangraph_tpu' or k.startswith('pangraph_tpu.'))\n"
        "print(len(mods), 'pangraph_tpu_torch.parallel.mesh' in mods,\n"
        "      'pangraph_tpu_torch.parallel.distributed' in mods, bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, mesh, distributed, bad = out.stdout.strip().split(" ", 3)
    assert int(n) >= 57 and mesh == distributed == "True" and bad == "[]"


def test_device_cuda_without_cuda_exits_1(tmp_path, monkeypatch, capsys):
    from pangraph_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = tmp_path / "in.fa"
    fa.write_text(">a\nACGTACGTACGT\n>b\nACGTACGTACGT\n")
    assert main(["build", str(fa), "--device", "cuda", "-o", str(tmp_path / "g.json")]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "no CUDA device" in err[0]
    assert not (tmp_path / "g.json").exists()


@pytest.mark.parametrize("device_flag", [["--device", "cuda"], []], ids=["device-cuda", "default"])
def test_merge_device_cuda_without_cuda_exits_1(tmp_path, monkeypatch, capsys, device_flag):
    """`merge` aligns on the card unless told otherwise: without one it exits
    1 before it reads a graph, and does not merge on the CPU."""
    import pangraph_tpu_torch.build.merge as merge_mod
    from pangraph_tpu_torch.cli import main

    def no_merge(*a, **k):
        raise AssertionError("merged without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(merge_mod, "merge_graphs", no_merge)
    out = tmp_path / "m.json"
    assert main(["merge", str(tmp_path / "a.json"), str(tmp_path / "b.json"), *device_flag, "-o", str(out)]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "no CUDA device" in err[0]
    assert not out.exists()


def test_cuda_mesh_without_cuda_raises(monkeypatch):
    """A mesh on `cuda` without a card raises; it never becomes a CPU mesh."""
    from pangraph_tpu_torch.ops.batch_align import BatchAligner
    from pangraph_tpu_torch.parallel.distributed import local_mesh
    from pangraph_tpu_torch.parallel.mesh import make_mesh, make_mesh_aligner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: make_mesh(device="cuda"), lambda: make_mesh(2),
                 lambda: make_mesh(devices=["cuda:0"] * 2), lambda: local_mesh("cuda", 2),
                 lambda: make_mesh_aligner(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(ValueError, match="needs device='cpu'"):
        BatchAligner(device="cuda", mesh=make_mesh(2, device="cpu"))


def _problem(device="cpu"):
    ref = torch.full((2, 8), ord("A"), dtype=torch.uint8, device=device)
    vec = torch.tensor([8, 8], dtype=torch.int32, device=device)
    return ref, ref.clone(), vec, vec.clone(), torch.zeros(2, dtype=torch.int32, device=device), vec.clone()


def test_cuda_launchers_refuse_cpu_tensors():
    from pangraph_tpu_torch.ops import stripe_v2 as sv

    before = dict(sv.LAUNCHES)
    ref, qry, rlen, qlen, ms, W = _problem()
    with pytest.raises(ValueError, match="CUDA tensors"):
        sv.stripe_dp_cuda(ref, qry, rlen, qlen, ms, W, 128)
    rec = torch.zeros((2, 8, 128), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sv.walk_cuda(rec, rlen, qlen, ms, W, 1024, 64)
    # the plain versions run for CPU tensors and count no launch
    sv.walk(sv.stripe_dp(ref, qry, rlen, qlen, ms, W, 128), rlen, qlen, ms, W, 1024, 64)
    assert sv.LAUNCHES == before


@pytest.mark.parametrize(
    "bad",
    ["dtype", "device", "shape", "band", "bounds"],
)
def test_wrappers_reject_bad_inputs(bad):
    from pangraph_tpu_torch.ops import stripe_v2 as sv

    ref, qry, rlen, qlen, ms, W = _problem()
    B = 128
    if bad == "dtype":
        rlen = rlen.long()
    elif bad == "device":
        ref = ref.to("meta")
    elif bad == "shape":
        qry = qry[:1]
    elif bad == "band":
        B = 200
    else:
        rlen = torch.tensor([9, 8], dtype=torch.int32)
    with pytest.raises(ValueError):
        sv.stripe_dp(ref, qry, rlen, qlen, ms, W, B)


@pytest.mark.parametrize("bad", ["dtype", "shape", "band", "bounds", "negative", "K", "R_cap"])
def test_batch_entries_check_host_arrays(bad):
    """stripe_align and stripe_align_ckpt check their host arrays before the
    upload (their CUDA launches skip the wrappers' reads of device values),
    and refuse what the wrappers refuse."""
    from pangraph_tpu_torch.ops import stripe_v2 as sv

    ref, qry, rlen, qlen, ms, W = (t.numpy() for t in _problem())
    B, K, R_cap = 128, 64, 4096
    if bad == "dtype":
        rlen = rlen.astype(np.int64)
    elif bad == "shape":
        qry = qry[:1]
    elif bad == "band":
        B = 200
    elif bad == "bounds":
        rlen = np.array([9, 8], np.int32)
    elif bad == "negative":
        qlen = np.array([8, -1], np.int32)
    elif bad == "K":
        K = 0
    else:
        R_cap = 4
    with pytest.raises(ValueError):
        sv.stripe_align_ckpt(ref, qry, rlen, qlen, ms, W, B, K, R_cap, "cpu")
    if bad != "R_cap":
        with pytest.raises(ValueError):
            sv.stripe_align(ref, qry, rlen, qlen, ms, W, B, K, 1024, "cpu")


def test_native_build_lands_outside_the_package():
    from pangraph_tpu_torch import native

    pkg = pathlib.Path(native.__file__).resolve().parent.parent
    build_dir = pathlib.Path(native.BUILD_DIR).resolve()
    assert pkg not in build_dir.parents
    if native.get_lib() is not None:
        assert any(p.suffix == ".so" for p in build_dir.iterdir())
    assert not any(p.suffix == ".so" for p in pkg.rglob("*.so"))


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA, and from a directory holding nothing but the script,
    chip_smoke.py exits non-zero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_bytes((ROOT / "chip_smoke.py").read_bytes())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True, text=True,
                             timeout=120, env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_sketch_and_chain_entry_points_need_cuda_by_default(monkeypatch):
    """Without a card, the numpy entry points of the sketch and chain kernels
    raise on their default device and never run the plain versions."""
    import numpy as np

    from pangraph_tpu_torch.ops import chain_k2 as ch
    from pangraph_tpu_torch.ops import sketch_k1 as sk

    def plain(*_a, **_k):
        raise AssertionError("a plain version ran")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sk, "sketch_dense_plain", plain)
    monkeypatch.setattr(ch, "chain_sets_plain", plain)
    before = (dict(sk.LAUNCHES), dict(ch.LAUNCHES))
    seq = np.frombuffer(b"ACGTTGCAAC" * 20, np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sk.sketch_one(seq, 19, 19)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sk.sketch_batch(np.zeros((1, 1024), np.int32), 19, 19)
    r = np.arange(0, 1000, 50, dtype=np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ch.chain_dp(r, r, 19, 10_000, 1_000, 32)
    assert (sk.LAUNCHES, ch.LAUNCHES) == before


def test_sketch_and_chain_launchers_refuse_cpu_tensors():
    from pangraph_tpu_torch.ops import chain_k2 as ch
    from pangraph_tpu_torch.ops import sketch_k1 as sk

    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.sketch_dense_cuda(torch.full((1, 1024), 4, dtype=torch.int32), 19, 19)
    r = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ch.chain_sets_cuda(r, r, torch.tensor([0, 4]), 19, 10_000, 1_000, 32)


@pytest.mark.parametrize("bad", ["dtype", "shape", "negative", "offsets", "H"])
def test_sketch_and_chain_wrappers_reject_bad_inputs(bad):
    from pangraph_tpu_torch.ops import chain_k2 as ch
    from pangraph_tpu_torch.ops import sketch_k1 as sk

    codes = torch.full((2, 1024), 4, dtype=torch.int32)
    r = torch.arange(0, 400, 100, dtype=torch.int32)
    offsets, H = torch.tensor([0, 4]), 32
    if bad == "dtype":
        codes, r = codes.long(), r.long()
    elif bad == "shape":
        codes = codes[:, :1000]
        r = r[:, None]
    elif bad == "negative":
        codes[1, 7] = -1
        offsets = torch.tensor([0, 5])
    elif bad == "offsets":
        codes = codes.t()
        offsets = torch.tensor([0, 3, 2, 4])
    else:
        codes = codes[:, :512]
        H = 0
    with pytest.raises(ValueError):
        sk.sketch_dense(codes, 19, 19)
    with pytest.raises(ValueError):
        ch.chain_sets(r, r, offsets, 19, 10_000, 1_000, H)
