"""Several devices for one aligner: a round's launches split over a mesh.

The port's counterpart of pangraph_tpu/parallel/mesh.py. The reference
shards a bucket batch's job axis over a `jax.sharding.Mesh` with shard_map,
and runs no collective in that loop. Here a `Mesh` is the list of devices
along the one "jobs" axis, and `BatchAligner(..., mesh=...)` splits each
planned launch's problems over them (`shard_jobs`): each shard runs the
same kernels on its own problems, on its own device and stream, and the
results are gathered by job index on the host.

A mesh may name one device more than once (`["cpu"] * 8`,
`["cuda:0"] * 2`): the counterpart of the reference's virtual host devices
(`xla_force_host_platform_device_count`), for tests on the CPU and for a
machine with one card. Shards on one device share its memory budget.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """Devices along the one "jobs" axis; shard s runs on devices[s]."""

    devices: tuple

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a mesh's devices must be of one type: {[str(d) for d in self.devices]}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type


def resolve_device(d) -> torch.device:
    """`d` as a torch.device with an index for CUDA ("cuda" is the current
    card); a CUDA device where there is none raises."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {str(d)!r}: no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int = None, device: str = "cuda", devices=None) -> Mesh:
    """A mesh of the first `n_devices` CUDA cards (all of them where None),
    or, with device="cpu", of `n_devices` CPU shards (one where None).
    `devices` names the devices instead, and may repeat one."""
    if devices is not None:
        return Mesh(tuple(resolve_device(d) for d in devices))
    if device == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1))
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda'): no CUDA device is available")
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def shard_jobs(mesh: Mesh, idxs: list) -> list:
    """Split one launch's problem indices over the mesh: shard s takes
    idxs[s::n], so that each shard gets some of the launch's longest
    problems (a launch comes sorted longest first, and a DP launch costs its
    longest problem's rows). Returns [(shard, indices)] for the shards that
    got any."""
    n = mesh.size
    return [(s, idxs[s::n]) for s in range(min(n, len(idxs)))]


def make_mesh_aligner(n_devices: int = None, params=None, extra_band_width: int = 5, max_attempts: int = 4,
                      device: str = "cuda"):
    """A BatchAligner whose launches are split over a mesh of `n_devices`
    (make_mesh)."""
    from pangraph_tpu_torch.ops.batch_align import BatchAligner

    mesh = make_mesh(n_devices, device=device)
    return BatchAligner(params, extra_band_width, max_attempts, device=device, mesh=mesh)
