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
``all_gather``), and `all_gather_dim` / `reduce_scatter_dim` are the
collectives of the sharded train step (`runtime.steps`), over the group of
one axis set (`Mesh.group`: the data axes, or "model").

The model axis (the reference's GSPMD layouts for tensor, sequence and
context parallelism) is written out as Megatron-style layers with explicit
collectives (`models.common`, `models.attention`, `models.transformer`).
The layout moves are autograd functions over the model group: the
sequence-sharded residual gathered whole (an all-gather, whose backward is
a reduce-scatter: `gather_from_sequence`), partial sums reduced into the
residual's layout (a reduce-scatter, whose backward is an all-gather:
`reduce_scatter_to_sequence`; where ``fit_spec`` leaves the sequence whole,
an all-reduce both ways), and the vocab-parallel cross-entropy's three
all-reduces. The ``constrain*`` hints name these moves where the reference
calls them. A replicated activation's gradient is held as each model
rank's part of it (its rows, heads or vocab columns), so a leaf that the
spec replicates over "model" ends the backward with its part of the
gradient and the step sums it over the model group once.

The recurrent mixers (`models.ssm`, `models.rglru`) take the whole
sequence (gathered) on the rank's channels and reduce their partial output
back; the SSD's norm over its split channels sums the ranks' sums of squares
(`sum_over_model`), and the RG-LRU's row-split gate matrices give partials
over every channel that are reduce-scattered to the rank's
(`reduce_scatter_channels`).

The MoE layouts (`models.moe`) add the expert-parallel exchanges over
"model" (`scatter_to_experts`, a reduce-scatter over the expert dim whose
backward is an all-gather, and `gather_from_experts`, its conjugate) and
the load-balancing loss's sums over the global batch (`sum_over_tokens`:
an all-reduce over every rank whose backward sums over the data ranks
only).
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

MODEL_AXIS_ITEM = ("ROADMAP A item 1's next slice: the model axis in training for the enc-dec "
                   "family")


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
    row-major order. `launch.mesh` builds one.

    A mesh with a "model" axis also holds one process group per axis set
    that the train step needs (`group`): "model" (the ranks that share this
    rank's other coordinates) and the other axes together (the data axes:
    the ranks that share its model coordinate). Every rank makes every group
    of both sets in the same order, here, as ``new_group`` asks; a set that
    spans the whole world is ``ctx`` itself. A ``ctx`` without a group (a
    layout only: coordinates and blocks) makes none."""

    MODEL = "model"

    def __init__(self, shape: dict, ctx: DecodeCtx):
        if math.prod(shape.values()) != ctx.world_size:
            raise ValueError(f"a mesh of shape {dict(shape)} needs "
                             f"{math.prod(shape.values())} ranks; the process group has "
                             f"{ctx.world_size}")
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.ctx = ctx
        self.coords = self.coords_of(ctx.rank)
        self._groups: dict[tuple, DecodeCtx] = {}
        if self.MODEL in self.shape and ctx.group is not None:
            for axes in (tuple(a for a in self.axis_names if a != self.MODEL), (self.MODEL,)):
                if axes:
                    self._groups[axes] = self._make_group(axes)

    def coords_of(self, rank: int) -> dict:
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, coords: dict) -> int:
        rank = 0
        for name in self.axis_names:
            rank = rank * self.shape[name] + coords[name]
        return rank

    def _make_group(self, axes: tuple) -> DecodeCtx:
        """This rank's group over ``axes``: the ranks whose other
        coordinates equal its own, ranked by their row-major index over
        ``axes`` (``new_group`` orders a group by global rank, the same
        order). Makes every such group of the mesh, in one order."""
        size = _axis_size(self, axes)
        index = 0
        for a in axes:
            index = index * self.shape[a] + self.coords[a]
        if size == self.ctx.world_size:
            return self.ctx
        others = [a for a in self.axis_names if a not in axes]
        mine = None
        for fixed in _grid(self, others):
            ranks = [self.rank_of({**fixed, **inner}) for inner in _grid(self, list(axes))]
            group = dist.new_group(ranks=ranks)
            if self.ctx.rank in ranks:
                mine = group
        return DecodeCtx(mine, index, size, self.ctx.backend)

    def group(self, axes) -> DecodeCtx:
        """The group over the axis set ``axes`` (a name or a tuple: the data
        axes, or "model") made with the mesh: its collectives
        (`all_gather_dim`, `reduce_scatter_dim`, `psum`) run over the ranks
        that share this rank's other coordinates. A set that spans the whole
        world is ``ctx``."""
        axes = _axes(axes)
        if _axis_size(self, axes) == self.ctx.world_size:
            return self.ctx
        if axes not in self._groups:
            raise ValueError(f"{self!r} holds no process group over {axes} (groups: "
                             f"{sorted(self._groups)}; a mesh without a process group holds "
                             "none)")
        return self._groups[axes]

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


def _grid(mesh, axes: list) -> list[dict]:
    """Every coordinate assignment of ``axes``, in row-major order."""
    out = [{}]
    for a in axes:
        out = [{**c, a: i} for c in out for i in range(mesh.shape[a])]
    return out


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
# Activation constraints and the model axis's layout moves
# ---------------------------------------------------------------------------

_ACTIVE: list[tuple[ShardingCtx, int | None]] = []


class activation_sharding:
    """Context manager installing the ambient `ShardingCtx` that
    `constrain` reads, with the rows of the batch this rank holds
    (``local_batch``; None: not checked). The backward of a loss taken
    inside it (activation checkpointing recomputes the forward there) runs
    inside it too."""

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


def model_size() -> int:
    """The ambient mesh's model axis size (1 without an ambient context)."""
    ctx = current_ctx()
    return 1 if ctx is None else _axis_size(ctx.mesh, ctx.tp)


def model_group() -> DecodeCtx | None:
    """The ambient mesh's group over its model axis when that axis is above
    1; None otherwise (no ambient context, or a model axis of 1: every move
    below is then the identity)."""
    ctx = current_ctx()
    if ctx is None or model_size() == 1:
        return None
    return ctx.mesh.group(ctx.tp)


def model_part(size: int) -> tuple[int, int]:
    """(index, parts) of this rank's block of a dim of ``size`` whose spec
    entry is the model axis: (its model coordinate, M) where ``fit_spec``
    splits the dim, (0, 1) where it leaves it whole."""
    m = model_size()
    if m == 1 or size % m:
        return 0, 1
    return current_ctx().mesh.coords[current_ctx().tp], m


def sequence_split(t: int) -> bool:
    """Whether the residual stream of a sequence of ``t`` positions is split
    over the model axis: the reference's ``constrain_residual`` spec
    P(dp, tp, None) through ``fit_spec`` (a sequence the axis does not
    divide stays whole)."""
    return model_part(t)[1] > 1


class _AllGatherDim(torch.autograd.Function):
    """The parts of a tensor split along ``dim`` over the group → the whole
    on every rank; the backward reduce-scatters each rank's part of the
    gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _ReduceScatterDim(torch.autograd.Function):
    """Each rank's partial sum → the sum, this rank's part along ``dim``;
    the backward all-gathers the parts' gradients."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _SumOverModel(torch.autograd.Function):
    """Partial sums → their sum on every model rank, where the residual's
    sequence is whole; the backward sums the ranks' parts of the gradient
    the same way (the sum's inputs each see the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return psum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous().clone(), ctx.group), None


def gather_from_sequence(x: torch.Tensor, split: bool) -> torch.Tensor:
    """x (B, T/M, ...) in the residual's layout → (B, T, ...), the whole
    sequence: an all-gather over the model group where the sequence is
    split (``split``), the identity where it is whole or there is no model
    axis (Megatron's ``gather_from_sequence_parallel_region``)."""
    group = model_group() if split else None
    if group is None:
        return x
    return _AllGatherDim.apply(x, 1, group)


def sequence_shard(x: torch.Tensor, split: bool) -> torch.Tensor:
    """x (B, T, ...) whole on every model rank → this rank's rows in the
    residual's layout: its sequence shard where ``split``, all of x where
    the sequence is whole."""
    group = model_group() if split else None
    if group is None:
        return x
    n = x.shape[1] // group.world_size
    return x[:, group.rank * n:(group.rank + 1) * n]


def reduce_scatter_to_sequence(x: torch.Tensor, split: bool) -> torch.Tensor:
    """Each model rank's partial sum x (B, T, ...) → the sum in the
    residual's layout: a reduce-scatter to this rank's sequence shard where
    the sequence is split, an all-reduce where it is whole, the identity
    without a model axis (Megatron's ``reduce_scatter_to_sequence_parallel_
    region`` and ``reduce_from_tensor_model_parallel_region``)."""
    group = model_group()
    if group is None:
        return x
    if split:
        return _ReduceScatterDim.apply(x, 1, group)
    return _SumOverModel.apply(x, group)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """Each model rank's partial sum x over its block of a split dim (a
    norm's sum of squares over its channels) → their sum on every model
    rank (`_SumOverModel`: an all-reduce both ways); the identity without a
    model axis."""
    group = model_group()
    return x if group is None else _SumOverModel.apply(x, group)


def reduce_scatter_channels(x: torch.Tensor) -> torch.Tensor:
    """Each model rank's partial sum x (..., W) over all W channels (its
    input rows of a row-split matrix) → the sum's W/M channels of this rank
    (a reduce-scatter over the last dim, whose backward all-gathers the
    channels' gradients); the identity without a model axis."""
    group = model_group()
    return x if group is None else _ReduceScatterDim.apply(x, -1, group)


def data_size() -> int:
    """The ambient mesh's data axes' rank count (1 without an ambient context)."""
    ctx = current_ctx()
    return 1 if ctx is None else _axis_size(ctx.mesh, ctx.dp)


def data_group() -> DecodeCtx | None:
    """The ambient mesh's group over its data axes when they hold more than
    one rank; None otherwise."""
    if data_size() == 1:
        return None
    ctx = current_ctx()
    return ctx.mesh.group(ctx.dp)


def scatter_to_experts(x: torch.Tensor) -> torch.Tensor:
    """The MoE dispatch under expert parallelism: every model rank's buffer
    (E, ...) of all experts' slots, holding only the slots of its own tokens
    (zero elsewhere), → this rank's E/M experts' slots summed over the ranks
    (a reduce-scatter over dim 0; exact: each slot has one writer). The
    backward all-gathers the experts' gradients."""
    return _ReduceScatterDim.apply(x, 0, model_group())


def gather_from_experts(x: torch.Tensor) -> torch.Tensor:
    """The MoE return under expert parallelism: this rank's experts' outputs
    (E/M, ...) → every expert's on every model rank (an all-gather over dim
    0). The backward reduce-scatters the ranks' gradients to the experts'
    owners."""
    return _AllGatherDim.apply(x, 0, model_group())


class _SumOverTokens(torch.autograd.Function):
    """Each rank's sums over the tokens it holds → their sum over the mesh
    (one all-reduce over every rank). The loss holds the result on every
    rank and the step averages the data ranks' gradients, so the backward
    sums the data ranks' cotangents; a model rank keeps its own (the step
    sums a model-replicated leaf's gradient once)."""

    @staticmethod
    def forward(ctx, x, world, data):
        ctx.data = data
        return psum(x.contiguous().clone(), world)

    @staticmethod
    def backward(ctx, g):
        if ctx.data is None:
            return g, None, None
        return psum(g.contiguous().clone(), ctx.data), None, None


def sum_over_tokens(x: torch.Tensor) -> torch.Tensor:
    """The sum over the global batch of per-rank sums over disjoint token
    sets (the rows over the data axes; over "model", each rank's sequence
    shard or share of rows): `_SumOverTokens` on the ambient mesh, the
    identity on one rank. The MoE load-balancing loss's means (the
    reference's are over the global batch: a per-rank loss is not its
    share)."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh.ctx.world_size == 1:
        return x
    if data_size() * model_size() != ctx.mesh.ctx.world_size:
        raise NotImplementedError(f"{ctx.mesh!r}: a token sum over data {ctx.dp} and "
                                  f"{ctx.tp!r} that do not span the mesh")
    return _SumOverTokens.apply(x, ctx.mesh.ctx, data_group())


def _check_batch(x: torch.Tensor, dims) -> None:
    _, local_batch = _ACTIVE[-1]
    if dims and dims[0] == "dp" and local_batch is not None and x.shape[0] != local_batch:
        raise ValueError(f"a batch dim of {x.shape[0]} where this rank holds {local_batch} "
                         "rows")


def constrain(x: torch.Tensor, *dims, split: bool = False) -> torch.Tensor:
    """The reference's sharding hint with symbolic dims "dp" | "tp" | None,
    on x in the residual's layout (batch over the data axes; the sequence,
    dim 1, over the model axis where ``split``): a "dp" leading dim must be
    the local batch; a "tp" dim 1 keeps the residual's layout (the
    identity); None at dim 1 gathers the sequence whole
    (`gather_from_sequence`). The identity without an ambient context."""
    if not _ACTIVE:
        return x
    _check_batch(x, dims)
    if len(dims) > 1 and dims[1] is None:
        return gather_from_sequence(x, split)
    return x


def constrain_residual(h: torch.Tensor, split: bool = False) -> torch.Tensor:
    """Residual stream: batch over the data axes, sequence over model (the
    layers hand it over in that layout: the identity)."""
    return constrain(h, "dp", "tp", None, split=split)


def constrain_qkv(q, k, v, split: bool = False):
    """Attention entry, q/k/v (B, T, N, HD): TP holds its heads over the
    whole sequence (gathered before the projection onto them, so here the
    identity); CP its query rows, with K and V gathered over the whole
    sequence where it is split (`gather_from_sequence`)."""
    ctx = current_ctx()
    if ctx is None:
        return q, k, v
    if ctx.strategy == "tp":
        return tuple(constrain(x, "dp", None, "tp", None) for x in (q, k, v))
    kv = constrain(torch.cat([k, v], dim=2), "dp", None, None, None, split=split)   # one gather
    return (constrain(q, "dp", "tp", None, None, split=split),
            *kv.split(k.shape[2], dim=2))


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """Mean cross-entropy over this rank's vocab columns [v0, v0 + V/M) of
    the logits (the padded slots already at -1e30): the forward all-reduces
    the row max, the sum of exponentials and the gold logit (which only the
    rank owning the label's column holds); the backward is softmax minus
    one-hot on the local columns, with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, v0, group):
        x = logits.float()
        m = pmax(x.amax(-1).contiguous(), group)
        e = torch.exp(x - m[..., None])
        se = psum(e.sum(-1), group)
        local = labels.long() - v0
        mine = (local >= 0) & (local < x.shape[-1])
        idx = torch.where(mine, local, 0)
        gold = psum(torch.where(mine, x.gather(-1, idx[..., None])[..., 0], 0.0), group)
        loss = (torch.log(se) + m - gold).mean()
        ctx.save_for_backward(e, se, idx, mine)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, se, idx, mine = ctx.saved_tensors
        d = e / se[..., None]
        d.scatter_add_(-1, idx[..., None], -mine[..., None].to(d.dtype))
        return (d * (g / mine.numel())).to(ctx.dtype), None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 v0: int) -> torch.Tensor:
    """Mean cross-entropy of logits (..., V/M) holding the columns [v0,
    v0 + V/M) of this model rank (`_VocabParallelCrossEntropy`); the same
    value on every rank of the model group."""
    return _VocabParallelCrossEntropy.apply(logits, labels, v0, model_group())
