"""Decode context of a sharded decode state, and its collectives.

Counterpart of the reference `models/blocks.py::DecodeCtx` (the ``(axis,
mesh)`` pair of a shard_map island), of the block-ownership rule of
`core/cache.py::local_block_range` and of the row split of `cache_pspec`.
Every rank of the group runs the whole dense model on replicated
activations; only the decode caches are split: a paged pool by its
physical block dim (rank i owns global block ids ``[i·P/n, (i+1)·P/n)``),
a contiguous cache or a ring by its rows (`local_row_range`).

``jax.lax.pmin``/``pmax``/``psum`` become `torch.distributed.all_reduce`
with ``MIN``/``MAX``/``SUM`` over the context's group, and the halo's
``jax.lax.ppermute`` to both sequence neighbours one ``all_gather`` of
every rank's two edges (`neighbour_edges`). `COLLECTIVES` counts what was
issued, by kind, and `analysis.collectives.TRACE` records each one's result
and wire bytes over the group. The backend follows
the device: ``nccl`` for CUDA tensors, ``gloo`` for CPU tensors; a tensor
on the other kind of device raises — one backend never stands in for the
other. All-reduce gives every rank the same bits, so replicated values
(bounds, histograms, logits) stay identical across ranks.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.analysis.collectives import TRACE
from repro_torch.kernels.common import resolve_device

BACKEND = {"cuda": "nccl", "cpu": "gloo"}

COLLECTIVES: Counter = Counter()    # collectives issued: "all_reduce", "all_gather"


class DecodeCtx(NamedTuple):
    """How decode attention is distributed: the process group the pool's
    block dim is split over, this process's rank in it and its size."""
    group: Any
    rank: int
    world_size: int
    backend: str


def init_decode_ctx(device="cuda", rank: int = 0, world_size: int = 1,
                    store=None) -> DecodeCtx:
    """Join (or reuse) the default process group for the pool shards.

    A world of one needs no rendezvous: it runs over an in-memory
    `HashStore`. More ranks pass a shared ``store`` (a `FileStore` on one
    host, a `TCPStore` across hosts). The backend is ``nccl`` on a CUDA
    device and ``gloo`` on the CPU; raises when it is missing or when the
    process already belongs to a group of another backend or size."""
    dev = resolve_device(device)
    backend = BACKEND[dev.type]
    available = {"nccl": dist.is_nccl_available, "gloo": dist.is_gloo_available}
    if not dist.is_available() or not available[backend]():
        raise RuntimeError(f"torch.distributed backend {backend!r} (for {dev.type} "
                           "tensors) is not available in this PyTorch build")
    if store is None and world_size != 1:
        raise ValueError("a world of more than one rank needs a shared store")
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_rank(), dist.get_world_size())
        if have != (backend, rank, world_size):
            raise RuntimeError(f"this process already joined a process group "
                               f"(backend, rank, world) = {have}; asked for "
                               f"{(backend, rank, world_size)}")
    else:
        store = dist.HashStore() if store is None else store
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    return DecodeCtx(dist.group.WORLD, rank, world_size, backend)


def _check_backend(x: torch.Tensor, ctx: DecodeCtx) -> None:
    if BACKEND[x.device.type] != ctx.backend:
        raise RuntimeError(f"a {x.device.type} tensor cannot be reduced over the "
                           f"{ctx.backend} group of this DecodeCtx")


def _all_reduce(x: torch.Tensor, op, ctx: DecodeCtx) -> torch.Tensor:
    _check_backend(x, ctx)
    dist.all_reduce(x, op=op, group=ctx.group)
    COLLECTIVES["all_reduce"] += 1
    TRACE.record("all-reduce", x.numel() * x.element_size(), ctx.world_size)
    return x


def pmin(x: torch.Tensor, ctx: DecodeCtx) -> torch.Tensor:
    """Elementwise min across the ranks; reduces ``x`` in place."""
    return _all_reduce(x, dist.ReduceOp.MIN, ctx)


def pmax(x: torch.Tensor, ctx: DecodeCtx) -> torch.Tensor:
    """Elementwise max across the ranks; reduces ``x`` in place."""
    return _all_reduce(x, dist.ReduceOp.MAX, ctx)


def psum(x: torch.Tensor, ctx: DecodeCtx) -> torch.Tensor:
    """Elementwise sum across the ranks; reduces ``x`` in place."""
    return _all_reduce(x, dist.ReduceOp.SUM, ctx)


def neighbour_edges(tail: torch.Tensor, head: torch.Tensor,
                    ctx: DecodeCtx) -> tuple[torch.Tensor, torch.Tensor]:
    """The two cyclic shifts of the reference's halo (``ppermute`` over
    i → i+1 and i → i-1): rank r gets rank r-1's ``tail`` and rank r+1's
    ``head`` (indices mod the world size), two tensors of one shape and
    dtype. One ``all_gather`` of every rank's pair; a world of one is its
    own neighbour and sends nothing (no self-send over nccl)."""
    n = ctx.world_size
    if n == 1:
        return tail, head
    _check_backend(tail, ctx)
    pair = torch.stack([tail, head])
    every = pair.new_empty((n * 2,) + tail.shape)         # rank-major: (tail, head) each
    dist.all_gather_into_tensor(every, pair, group=ctx.group)
    COLLECTIVES["all_gather"] += 1
    TRACE.record("all-gather", every.numel() * every.element_size(), n)
    return every[2 * ((ctx.rank - 1) % n)], every[2 * ((ctx.rank + 1) % n) + 1]


def local_row_range(rows: int, ctx: DecodeCtx) -> tuple[int, int]:
    """This rank's row range ``(lo, hi)`` of a contiguous cache (or a
    ring) of ``rows`` rows split evenly across the ranks (the reference's
    `cache_pspec`: the sequence dim over the decode axis)."""
    if rows % ctx.world_size:
        raise ValueError(f"a cache of {rows} rows does not split evenly across "
                         f"{ctx.world_size} ranks")
    n_local = rows // ctx.world_size
    return ctx.rank * n_local, (ctx.rank + 1) * n_local


def local_block_range(num_blocks: int, ctx: DecodeCtx) -> tuple[int, int]:
    """This rank's global physical-block id range ``(lo, hi)`` of a pool of
    ``num_blocks`` blocks split evenly across the ranks."""
    if num_blocks % ctx.world_size:
        raise ValueError(f"num_blocks {num_blocks} does not split evenly across "
                         f"{ctx.world_size} ranks")
    p_local = num_blocks // ctx.world_size
    return ctx.rank * p_local, (ctx.rank + 1) * p_local
