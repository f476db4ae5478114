"""Sharding of the port over `torch.distributed` process groups: the decode
context of a sharded decode state and its collectives; the training half's
parameter rules, meshes and the data axis's collectives.

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

The training half ports the reference's parameter rules. A spec is plain
data: a tuple with one entry per dim, each an axis name, a tuple of names
or None. `Mesh` is the counterpart of ``jax.sharding.Mesh``: axis names,
their sizes and this process's coordinates over a process group (rank r
at the row-major position r, jax's device order). `fit_spec`,
`param_rules` and `param_specs` are the reference's, rule for rule
(`param_specs` takes the port's tree, one dict per layer, or a ``{path:
shape}`` mapping, whose stacked leaves get the spec shifted right as in the
reference). `shard` cuts this rank's block out of a whole tensor,
`gather` puts the blocks of every rank back together (one
``all_gather``), and `all_gather_dim` / `reduce_scatter_dim` are the data
axis's collectives of the sharded train step (`runtime.steps`). The
``constrain*`` hints change no value: each rank already holds its rows of
the batch, and the model axis above 1 (GSPMD's tensor and sequence
parallelism) raises.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.analysis.collectives import TRACE
from repro_torch.kernels.common import resolve_device

BACKEND = {"cuda": "nccl", "cpu": "gloo"}

COLLECTIVES: Counter = Counter()    # issued: "all_reduce", "all_gather", "reduce_scatter"


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


# ---------------------------------------------------------------------------
# Training: meshes and specs
# ---------------------------------------------------------------------------

MODEL_AXIS_ITEM = "ROADMAP A.8's model axis (tensor and sequence parallelism in training)"


class P(tuple):
    """A spec: one entry per dim (an axis name, a tuple of names, or None);
    the counterpart of ``jax.sharding.PartitionSpec``. A tuple (it compares
    equal to the plain tuple of its entries), of its own type so that a tree
    of specs tells its leaves from its containers."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):          # pickled as its entries
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """Axis names, their sizes (``shape``: name → size, in axis order) and
    this process's ``coords`` (name → index) over the process group ``ctx``
    (group, rank, world size, backend), whose ranks fill the mesh in
    row-major order. `launch.mesh` builds one."""

    def __init__(self, shape: dict, ctx: DecodeCtx):
        if math.prod(shape.values()) != ctx.world_size:
            raise ValueError(f"a mesh of shape {dict(shape)} needs "
                             f"{math.prod(shape.values())} ranks; the process group has "
                             f"{ctx.world_size}")
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.ctx = ctx
        self.coords = self.coords_of(ctx.rank)

    def coords_of(self, rank: int) -> dict:
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.ctx.rank} of {self.ctx.world_size})"


@dataclass(frozen=True)
class ShardingCtx:
    mesh: Any
    dp: Any                      # batch axes: ("data",), ("pod", "data"), or None
    tp: str = "model"            # tensor/sequence axis
    strategy: str = "tp"         # arch attn_strategy
    moe_strategy: str = "ep"     # "ep" experts over model | "tp" FF over model
    fsdp_axes: Any = None        # param-shard axes; defaults to dp (() → no FSDP)
    mode: str = "train"          # "decode": the serving rules (weights resident)
    wide2d: Any = None           # decode: axes of the 2nd weight dim of huge layers

    @property
    def fsdp(self):
        if self.fsdp_axes is not None:
            return self.fsdp_axes or None
        return self.dp


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: how one tensor is laid out over the ranks (a leaf
    of a tree of shardings, not a container)."""
    mesh: Mesh
    spec: P


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, axes) -> int:
    n = 1
    for a in _axes(axes):
        n *= mesh.shape[a]
    return n


def fit_spec(mesh, spec, shape) -> tuple:
    """Drop per-dimension axes that don't divide the dim size; a 1-tuple
    group becomes the bare axis name and an empty group None (the
    reference's canonical form)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, size in zip(dims, shape):
        if isinstance(d, (tuple, list)):
            d = d[0] if len(d) == 1 else (tuple(d) or None)
        if d is None:
            out.append(None)
        elif size % _axis_size(mesh, d) == 0 and size > 0:
            out.append(d)
        else:
            out.append(None)
    return P(*out)


def decode_param_rules(ctx: ShardingCtx) -> list[tuple[str, tuple]]:
    """The serving layout: every weight resident-sharded, activations move
    (the reference's rules, entry for entry)."""
    m = ctx.tp
    w2 = ctx.wide2d
    attn_in = P(None, m, None) if ctx.strategy == "tp" else P(m, None, None)
    return [
        (r".*attn/wq$", attn_in),
        (r".*attn/wk$", attn_in),
        (r".*attn/wv$", attn_in),
        (r".*attn/wo$", P(m, None)),
        (r".*attn/(q_norm|k_norm)/scale$", P(None)),
        (r".*(glu|dense)/w_gate$", P(None, m)),
        (r".*(glu|dense)/w_up$", P(None, m)),
        (r".*(glu|dense)/w_down$", P(m, None)),
        (r".*moe/router$", P(None, None)),
        (r".*moe/w_gate$", P(m, None, w2)),
        (r".*moe/w_up$", P(m, None, w2)),
        (r".*moe/w_down$", P(m, w2, None)),
        (r".*ssd/w_x$", P(None, m)),
        (r".*ssd/w_(B|C|dt)$", P(None, None)),
        (r".*ssd/w_out$", P(m, None)),
        (r".*ssd/z_gate$", P(None, m)),
        (r".*ssd/conv_w$", P(None, None)),
        (r".*ssd/norm/scale$", P(m)),
        (r".*rglru/w_x$", P(None, m)),
        (r".*rglru/w_gate_out$", P(None, m)),
        (r".*rglru/w_out$", P(m, None)),
        (r".*rglru/w_(r|i)$", P(m, None)),
        (r".*rglru/conv_w$", P(None, m)),
        (r".*rglru/lam$", P(m)),
        (r".*embed/tok$", P(m, None)),
        (r".*embed/head$", P(None, m)),
        (r".*projector$", P(None, None)),
        (r".*", P()),
    ]


def param_rules(ctx: ShardingCtx) -> list[tuple[str, tuple]]:
    """(path regex, spec), first match wins; paths are "/"-joined keys.
    FSDP over ``ctx.fsdp`` and tensor parallelism over ``ctx.tp``."""
    if ctx.mode == "decode":
        return decode_param_rules(ctx)
    f = ctx.fsdp
    m = ctx.tp
    attn_heads = m if ctx.strategy == "tp" else None   # CP: replicate the head dim
    return [
        (r".*attn/wq$", P(f, attn_heads, None)),
        (r".*attn/wk$", P(f, attn_heads, None)),
        (r".*attn/wv$", P(f, attn_heads, None)),
        (r".*attn/wo$", P(attn_heads, f) if ctx.strategy == "tp" else P(f, None)),
        (r".*attn/(q_norm|k_norm)/scale$", P(None)),
        (r".*(glu|dense)/w_gate$", P(f, m)),
        (r".*(glu|dense)/w_up$", P(f, m)),
        (r".*(glu|dense)/w_down$", P(m, f)),
        (r".*moe/router$", P(f, None)),
        (r".*moe/w_gate$", P(m, f, None) if ctx.moe_strategy == "ep" else P(None, f, m)),
        (r".*moe/w_up$", P(m, f, None) if ctx.moe_strategy == "ep" else P(None, f, m)),
        (r".*moe/w_down$", P(m, None, f) if ctx.moe_strategy == "ep" else P(None, m, f)),
        (r".*ssd/w_x$", P(f, m)),
        (r".*ssd/w_(B|C|dt)$", P(f, None)),
        (r".*ssd/w_out$", P(m, f)),
        (r".*ssd/z_gate$", P(f, m)),
        (r".*ssd/conv_w$", P(None, None)),
        (r".*ssd/norm/scale$", P(m)),
        (r".*rglru/w_x$", P(f, m)),
        (r".*rglru/w_gate_out$", P(f, m)),
        (r".*rglru/w_out$", P(m, f)),
        (r".*rglru/w_(r|i)$", P(m, None)),
        (r".*rglru/conv_w$", P(None, m)),
        (r".*rglru/lam$", P(m)),
        (r".*embed/tok$", P(m, None)),
        (r".*embed/head$", P(None, m)),
        (r".*projector$", P(None, None)),
        (r".*", P()),
    ]


def path_of(keypath) -> str:
    """A leaf's path: its keys joined with "/" (`runtime.tree.leaves`
    names the port's leaves so)."""
    return "/".join(str(k) for k in keypath)


def param_specs(ctx: ShardingCtx, params: Any) -> Any:
    """Specs for a parameter tree (a tree of the same structure) or for a
    ``{path: shape}`` mapping (``{path: spec}``). A leaf with more dims than
    its rule's spec (the reference's leaves stacked over periods or layers)
    gets the spec shifted right, its leading dims unsharded."""
    rules = [(re.compile(rx), sp) for rx, sp in param_rules(ctx)]

    def assign(path: str, shape) -> tuple:
        shape = tuple(shape)
        for rx, sp in rules:
            if rx.match(path):
                extra = len(shape) - len(sp)
                if extra > 0:
                    sp = P(*([None] * extra + list(sp)))
                return fit_spec(ctx.mesh, sp, shape)
        return P()

    if isinstance(params, dict) and params and all(
            isinstance(v, (tuple, list, torch.Size)) and all(isinstance(d, int) for d in v)
            for v in params.values()):
        return {path: assign(path, shape) for path, shape in params.items()}
    from repro_torch.runtime.tree import leaves, tree_map
    paths = iter(path for path, _ in leaves(params))
    return tree_map(lambda t: assign(next(paths), t.shape), params)


def named(ctx: ShardingCtx, spec_tree: Any) -> Any:
    """A tree of `NamedSharding` on ``ctx.mesh`` for a tree of specs."""
    if isinstance(spec_tree, P):
        return NamedSharding(ctx.mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(ctx, v) for k, v in spec_tree.items()}
    out = [named(ctx, v) for v in spec_tree]
    return type(spec_tree)(*out) if hasattr(spec_tree, "_fields") else type(spec_tree)(out)


# ---------------------------------------------------------------------------
# Training: placing tensors on the mesh, and the data axis's collectives
# ---------------------------------------------------------------------------

def _block(mesh: Mesh, spec, shape, coords) -> tuple:
    """The slices of the block of a tensor of ``shape`` under ``spec`` that
    the rank at ``coords`` holds; a dim its axes do not divide raises."""
    out = []
    for d, size in zip(list(spec) + [None] * (len(shape) - len(spec)), shape):
        n, i = 1, 0
        for a in _axes(d):
            n, i = n * mesh.shape[a], i * mesh.shape[a] + coords[a]
        if size % n:
            raise ValueError(f"a dim of {size} does not split evenly over the mesh axes "
                             f"{_axes(d)} ({n} ways)")
        out.append(slice(i * (size // n), (i + 1) * (size // n)))
    return tuple(out)


def local_block(mesh: Mesh, spec, shape) -> tuple:
    """The slices of this rank's block of a tensor (or array) of ``shape``
    under ``spec``."""
    return _block(mesh, spec, tuple(shape), mesh.coords)


def local_shape(mesh: Mesh, spec, shape) -> tuple:
    """The shape of this rank's block of a tensor of ``shape``."""
    return tuple(s.stop - s.start for s in local_block(mesh, spec, shape))


def shard(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``: a
    contiguous copy (the whole tensor may be freed)."""
    return x[local_block(mesh, spec, x.shape)].clone(memory_format=torch.contiguous_format)


def gather(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` under ``spec``: one
    ``all_gather`` over the mesh's group, none where the spec splits
    nothing."""
    counts = [_axis_size(mesh, d) for d in spec] + [1] * (x.dim() - len(spec))
    if math.prod(counts) == 1:
        return x
    ctx = mesh.ctx
    _check_backend(x, ctx)
    every = x.new_empty((ctx.world_size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(every, x.contiguous(), group=ctx.group)
    COLLECTIVES["all_gather"] += 1
    TRACE.record("all-gather", every.numel() * every.element_size(), ctx.world_size)
    every = every.view((ctx.world_size,) + tuple(x.shape))
    shape = tuple(n * size for n, size in zip(counts, x.shape))
    out = x.new_empty(shape)
    for r in range(ctx.world_size):
        out[_block(mesh, spec, shape, mesh.coords_of(r))] = every[r]
    return out


def barrier(ctx: DecodeCtx) -> None:
    """Every rank of the group waits for the others (an all-reduce of one
    element on the backend's device)."""
    if ctx.world_size > 1:
        dev = torch.device("cuda", torch.cuda.current_device()) if ctx.backend == "nccl" \
            else torch.device("cpu")
        dist.all_reduce(torch.zeros(1, device=dev), group=ctx.group)


def all_gather_dim(x: torch.Tensor, dim: int, ctx: DecodeCtx) -> torch.Tensor:
    """The whole of a tensor split evenly along ``dim`` over the group's
    ranks, rank r holding the r-th part ``x``: one
    ``all_gather_into_tensor``; contiguous, as a tensor made whole."""
    _check_backend(x, ctx)
    part = x.movedim(dim, 0).contiguous()
    out = part.new_empty((ctx.world_size * part.shape[0],) + tuple(part.shape[1:]))
    dist.all_gather_into_tensor(out, part, group=ctx.group)
    COLLECTIVES["all_gather"] += 1
    TRACE.record("all-gather", out.numel() * out.element_size(), ctx.world_size)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, ctx: DecodeCtx) -> torch.Tensor:
    """The sum over the group's ranks of ``x``, this rank's r-th part along
    ``dim``: one ``reduce_scatter_tensor``."""
    _check_backend(x, ctx)
    n = ctx.world_size
    part = x.movedim(dim, 0).contiguous()
    if part.shape[0] % n:
        raise ValueError(f"a dim of {part.shape[0]} does not split evenly over {n} ranks")
    out = part.new_empty((part.shape[0] // n,) + tuple(part.shape[1:]))
    dist.reduce_scatter_tensor(out, part, op=dist.ReduceOp.SUM, group=ctx.group)
    COLLECTIVES["reduce_scatter"] += 1
    TRACE.record("reduce-scatter", out.numel() * out.element_size(), n)
    return out.movedim(0, dim).contiguous()


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------

_ACTIVE: list[tuple[ShardingCtx, int | None]] = []


class activation_sharding:
    """Context manager installing the ambient `ShardingCtx` that
    `constrain` reads, with the rows of the batch this rank holds
    (``local_batch``; None: not checked)."""

    def __init__(self, ctx: ShardingCtx, local_batch: int | None = None):
        self.ctx = ctx
        self.local_batch = local_batch

    def __enter__(self):
        _ACTIVE.append((self.ctx, self.local_batch))
        return self.ctx

    def __exit__(self, *exc):
        _ACTIVE.pop()


def current_ctx() -> ShardingCtx | None:
    return _ACTIVE[-1][0] if _ACTIVE else None


def constrain(x: torch.Tensor, *dims) -> torch.Tensor:
    """The reference's sharding hint with symbolic dims "dp" | "tp" | None:
    ``x`` itself. Each rank already holds its rows of the batch, so a "dp"
    leading dim must be the local batch; a "tp" dim on a model axis above 1
    raises (that layout is not ported)."""
    if not _ACTIVE:
        return x
    ctx, local_batch = _ACTIVE[-1]
    if "tp" in dims and _axis_size(ctx.mesh, ctx.tp) > 1:
        raise NotImplementedError(f"a {ctx.tp!r} axis of {_axis_size(ctx.mesh, ctx.tp)} in "
                                  f"training: {MODEL_AXIS_ITEM} is not ported")
    if dims and dims[0] == "dp" and local_batch is not None and x.shape[0] != local_batch:
        raise ValueError(f"a batch dim of {x.shape[0]} where this rank holds {local_batch} "
                         "rows")
    return x


def constrain_residual(h: torch.Tensor) -> torch.Tensor:
    """Residual stream: batch over the data axes, sequence over model."""
    return constrain(h, "dp", "tp", None)


def constrain_qkv(q, k, v):
    """Attention entry: TP shards heads, CP the query sequence."""
    if current_ctx() is None:
        return q, k, v
    if current_ctx().strategy == "tp":
        return (constrain(q, "dp", None, "tp", None), constrain(k, "dp", None, "tp", None),
                constrain(v, "dp", None, "tp", None))
    return (constrain(q, "dp", "tp", None, None), constrain(k, "dp", None, None, None),
            constrain(v, "dp", None, None, None))
