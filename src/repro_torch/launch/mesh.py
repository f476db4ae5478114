"""Meshes of the port (port of the reference `launch/mesh.py`).

Functions, not module constants: importing this module touches no device
and joins no process group. A mesh spans the default process group
(`distributed.sharding.init_decode_ctx` joins or reuses it: ``nccl`` for a
CUDA device, ``gloo`` for the CPU; a world of one needs no rendezvous), its
ranks in row-major order over the axes. A mesh with a "model" axis makes its
per-axis process groups when it is built (`Mesh.group`), so every rank
builds the same meshes in the same order. Training runs on any (data ×
model) mesh: FSDP over the data axes and, for the dense families, tensor,
sequence and context parallelism over "model", for the MoE family its
experts or their d_ff too, for the SSD and the RG-LRU their heads or
channels (`runtime.steps.ShardedTrainStep`; the enc-dec family refuses a
model axis above 1).
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.distributed.sharding import BACKEND, DecodeCtx, Mesh, init_decode_ctx
from repro_torch.kernels.common import resolve_device


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` on the default process group, which
    must hold exactly prod(shape) ranks (a world of one is joined here when
    no group exists)."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} over {tuple(axes)} needs "
                         f"{math.prod(shape)} ranks; this world has {world}")
    if not dist.is_initialized():
        return Mesh(dict(zip(axes, shape)), init_decode_ctx(device))
    backend = BACKEND[resolve_device(device).type]
    if dist.get_backend() != backend:
        raise RuntimeError(f"this process's group runs {dist.get_backend()}; a mesh on "
                           f"{device} needs {backend}")
    return Mesh(dict(zip(axes, shape)),
                DecodeCtx(dist.group.WORLD, dist.get_rank(), world, backend))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """Single pod: (16, 16) = ("data", "model"), 256 ranks. Multi-pod:
    (2, 16, 16) = ("pod", "data", "model"), 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_local_mesh(device="cuda") -> Mesh:
    """Every rank of the process group as (1, N) ("data", "model"), the
    reference's local mesh (N = 1 for a process with no group)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((1, world), ("data", "model"), device)


def make_data_mesh(device="cuda") -> Mesh:
    """Every rank of the process group on the data axis, (N, 1) ("data",
    "model"): `launch.train`'s layout without ``--local``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((world, 1), ("data", "model"), device)
