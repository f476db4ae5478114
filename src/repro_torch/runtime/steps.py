"""The serving decode tick: one call advances every active slot by one token;
and the training step (`make_train_step`).

Port of the reference `runtime/steps.py::make_serve_decode_step` for one
device, without the mesh plan, with ``nan_flags``: the tick returns the
greedy next tokens, the logits and a per-slot flag that the slot's logits
row is finite (the serving engine's quarantine signal, computed inside the
tick so that it rides the tick's one device-to-host wait). The reference
jits its tick, so shapes stay static and the serving engine pays one
dispatch per tick. Here the tick — `models.transformer.lm_decode_step`,
the greedy argmax and the finite flags — is captured once per engine as a
CUDA graph and replayed:

* on the CPU the step runs eagerly (the path the CPU tests take);
* on the card with ``ctx=None`` (the paged pool in every storage mode, with
  or without the host tier, and the contiguous slot pool) the first call
  runs eagerly: it is the engine's real first tick, and it loads the
  kernels' libraries, cuBLAS's handles and the quantizers' constants. The
  second call captures the tick over static device buffers (the token and
  active inputs; the next tokens, the logits and the finite flags) in a
  `torch.cuda.CUDAGraph`
  and replays it; every later call copies the inputs from pinned host
  memory into the input buffers and replays. The outputs are copied out of
  the static buffers, so a caller may keep a tick's logits across ticks. A
  failed capture or replay raises; nothing falls back to eager;
* with ``ctx`` (the block-sharded tick, whose all-reduces are not captured)
  and for a step built inside `eager`, every call runs eagerly.

A replay reads the addresses that the capture saw, so the tick updates
every state tensor in place and never rebinds one, and the engine's writes
between ticks (admission, block growth, release, host-tier moves) go into
the same tensors; the tick makes no tensor from host data. Kernel launches
keep their meaning, "launched and executed" (`kernels.common.LAUNCHES`):
the capture counts none, and each replay adds one tick's launches, as the
capture's wrappers counted them.

`make_train_step` is the counterpart of the reference's `make_train_step`:
the loss, its gradient with respect to every parameter (through kernel
B3-bwd on the card), then `adamw_update`, eagerly. Without a `MeshPlan` it
runs on one device. With one it runs what the reference's jitted step runs
under its `param_specs` over the plan's mesh (`ShardedTrainStep`): FSDP
over the data axes and, for the dense families, tensor, sequence and
context parallelism over "model". Each rank holds its block of every
parameter and of the AdamW moments and master, gathers its model blocks
whole over the data axes at the step's start, runs the loss on its rows of
the global batch (`batch_specs`; every model rank the same rows, the
layers' collectives over the model group), and reduces each gradient to
its mean over the data ranks (a reduce-scatter to its block, an all-reduce
where the spec replicates it), after one sum over the model group where
the spec replicates the leaf over "model".

`PooledServer` drives that tick for what the serving engine does not
serve: the reference serves the enc-dec family (whose requests carry
frames) and the vision frontend's image requests through the model API on
a pooled contiguous state, driven by its mesh step builder. The server
admits each request into a free slot (a batch-1 prefill, written into the
slot), ticks the pool greedily with an active mask and frees a slot when
its request ends.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import P, fit_spec
from repro_torch.kernels.common import LAUNCHES


@dataclass(frozen=True)
class MeshPlan:
    """Axis roles for a given mesh (`launch.mesh`)."""
    mesh: Any
    dp: tuple[str, ...]            # batch/FSDP axes
    tp: str = "model"

    @classmethod
    def for_mesh(cls, mesh) -> "MeshPlan":
        return cls(mesh=mesh, dp=tuple(n for n in mesh.axis_names if n != "model"))

    def decode_axes(self, global_batch: int):
        """(batch_axes, seq_axes) for decode: the batch takes the data axes
        it can fill; the KV cache's sequence dim takes "model" plus any data
        axis the batch cannot occupy."""
        batch_axes, seq_axes = [], []
        filled = 1
        for a in self.dp:
            if global_batch % (filled * self.mesh.shape[a]) == 0:
                batch_axes.append(a)
                filled *= self.mesh.shape[a]
            else:
                seq_axes.append(a)
        seq_axes.append(self.tp)
        return (tuple(batch_axes) or None,
                tuple(seq_axes) if len(seq_axes) > 1 else seq_axes[0])

    def decode_seq_axes(self, global_batch: int):
        return self.decode_axes(global_batch)[1]


def batch_specs(mesh, batch: dict, dp) -> dict:
    """Each batch leaf's spec: its leading dim over the data axes."""
    return {k: fit_spec(mesh, P(dp, *([None] * (v.ndim - 1))), v.shape)
            for k, v in batch.items()}

_EAGER_DEPTH = 0


@contextlib.contextmanager
def eager():
    """Steps built inside this context run eagerly on every device: the
    counterpart of ``jax.disable_jit()``, for an eager run to hold a graphed
    one against."""
    global _EAGER_DEPTH
    _EAGER_DEPTH += 1
    try:
        yield
    finally:
        _EAGER_DEPTH -= 1


def graphed(device, ctx=None) -> bool:
    """Whether a step built now for ``device`` and ``ctx`` replays a CUDA
    graph: on a CUDA device, unsharded, outside `eager`."""
    return torch.device(device).type == "cuda" and ctx is None and _EAGER_DEPTH == 0


class ServeDecodeStep:
    """The counterpart of the reference's ``make_serve_decode_step`` tick:
    ``step(token (S,) int32, active (S,) bool)`` (host arrays) →
    ``(next_token (S,), logits (S, V_pad), finite (S,) bool)`` on the
    device — ``finite[s]``: every column of row ``s``, padded ones included,
    is finite — advancing every
    active slot of ``state`` by one token (the module docstring says how it
    runs). ``decode_step(params, state, token, active, ctx)`` is the model's
    tick (`models.registry.ModelAPI.decode_step`); ``state`` is updated in
    place."""

    def __init__(self, decode_step, params: dict, state, slots: int, device, ctx=None):
        self.device = torch.device(device)
        self.graphed = graphed(self.device, ctx)
        self._decode_step, self._params, self._state, self._ctx = decode_step, params, state, ctx
        on_card = self.device.type == "cuda"
        # host staging, written through numpy (no tensor is made of host
        # data); on the CPU it is the step's input itself
        self._host_tok = torch.zeros(slots, dtype=torch.int32, pin_memory=on_card)
        self._host_act = torch.zeros(slots, dtype=torch.bool, pin_memory=on_card)
        self._tok, self._act = self._host_tok, self._host_act
        if on_card:
            self._tok = torch.zeros(slots, dtype=torch.int32, device=self.device)
            self._act = torch.zeros(slots, dtype=torch.bool, device=self.device)
        self._copied = None          # an event after the last copy out of the staging
        self._calls = 0
        self._graph = None
        self._out = None             # the graph's static (next_token, logits, finite)
        self.launches_per_tick: Counter | None = None   # a replay's kernel launches

    def _tick(self):
        logits, _ = self._decode_step(self._params, self._state, self._tok, self._act,
                                      self._ctx)
        return logits.argmax(dim=-1), logits, torch.isfinite(logits).all(dim=-1)

    def _capture(self) -> None:
        before = Counter(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._out = self._tick()
        self.launches_per_tick = Counter({k: n - before[k] for k, n in LAUNCHES.items()
                                          if n > before[k]})
        LAUNCHES.clear()
        LAUNCHES.update(before)
        self._graph = graph

    def __call__(self, token: np.ndarray, active: np.ndarray):
        if self._copied is not None:
            self._copied.synchronize()          # the staging's last copy has left
        self._host_tok.numpy()[:] = token
        self._host_act.numpy()[:] = active
        self._calls += 1
        if self.device.type == "cpu":
            return self._tick()
        self._tok.copy_(self._host_tok, non_blocking=True)
        self._act.copy_(self._host_act, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()
        if not self.graphed or self._calls == 1:
            return self._tick()
        if self._graph is None:
            self._capture()
        self._graph.replay()
        LAUNCHES.update(self.launches_per_tick)
        return tuple(t.clone() for t in self._out)


class PooledServer:
    """Serve requests through a model's API (`models.registry.ModelAPI`) on
    a pooled contiguous state of ``slots`` rows, ``init_state(slots,
    max_seq, device, ctx)`` (the enc-dec family's max_seq is T_enc). A
    request is ``(tokens (1, T) int32, inputs)``, ``inputs`` the prefill's
    keywords: ``frames=`` (1, T_enc, D) for the enc-dec family, ``patches=``
    (1, P, F) for the vision frontend. Requests take free slots in order,
    each prefilled at batch 1 and written into its slot (`admit`); greedy
    ticks of a `ServeDecodeStep` built here (`tick`: a CUDA graph after its
    first call on a card, unsharded and outside `eager`) advance the active
    slots; a request ends at its ``new_tokens``-th token (the prefill's
    included) or at a logits row that is not finite (``nonfinite`` lists
    it), and its slot is reset (`release`) and taken by the next request
    waiting. Every write to the pool is in place, as the graph needs."""

    def __init__(self, api, params: dict, slots: int, max_seq: int, device, ctx=None):
        self.api, self.params, self.slots, self.max_seq = api, params, slots, max_seq
        self.device, self.ctx = torch.device(device), ctx
        self.pool = api.init_state(slots, max_seq, self.device, ctx)
        self.step = ServeDecodeStep(api.decode_step, params, self.pool, slots, self.device, ctx)
        self.ticks = 0
        self.nonfinite: list[int] = []

    def admit(self, slot: int, tokens: torch.Tensor, inputs: dict) -> torch.Tensor:
        """Prefill one request at batch 1 into row ``slot`` of the pool →
        the logits row (V_pad,) of its prompt's last position."""
        logits, src = self.api.prefill(self.params, tokens.to(self.device), self.max_seq,
                                       **inputs)
        self.api.write_into_slot(self.pool, src, slot, ctx=self.ctx)
        return logits[0]

    def tick(self, tokens: np.ndarray, active: np.ndarray):
        """One `ServeDecodeStep` tick over the pool: (next tokens, logits,
        finite flags) on the device."""
        self.ticks += 1
        return self.step(tokens, active)

    def release(self, slot: int) -> None:
        self.api.reset_slot(self.pool, slot)

    def serve(self, requests, new_tokens: int, on_logits=None) -> list[list[int]]:
        """Serve every request to its end → its greedy tokens, the
        prefill's first. ``on_logits(request, index, row)`` sees each
        logits row on the device, index 0 the prefill's."""
        out = [[] for _ in requests]
        waiting = list(range(len(requests)))[::-1]
        owner = [None] * self.slots
        tok, active = np.zeros(self.slots, np.int32), np.zeros(self.slots, bool)

        def take(slot, token, row, finite) -> None:
            i = owner[slot]
            if on_logits is not None:
                on_logits(i, len(out[i]), row)
            if finite:
                out[i].append(int(token))
                tok[slot] = token
            else:
                self.nonfinite.append(i)
            if not finite or len(out[i]) == new_tokens:
                self.release(slot)
                owner[slot], active[slot] = None, False

        while waiting or active.any():
            for slot in range(self.slots):
                if owner[slot] is None and waiting:
                    owner[slot], active[slot] = waiting.pop(), True
                    tokens, inputs = requests[owner[slot]]
                    row = self.admit(slot, tokens, inputs)
                    token, finite = to_host(row.argmax(), torch.isfinite(row).all())
                    take(slot, token, row, bool(finite))
            if active.any():
                nxt, logits, finite = self.tick(tok.copy(), active.copy())
                nx, fin = to_host(nxt, finite)
                for slot in np.flatnonzero(active):
                    take(slot, nx[slot], logits[slot], bool(fin[slot]))
        return out


def to_host(*tensors) -> list[np.ndarray]:
    """Numpy copies of a tick's small outputs behind one wait for the
    device: on a card each is copied into pinned memory without blocking and
    the stream is synchronized once."""
    if all(t.device.type == "cpu" for t in tensors):
        return [t.numpy() for t in tensors]
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


def make_train_step(cfg, plan: MeshPlan | None = None, opt_cfg=None, device="cuda"):
    """step(params, opt_state, batch) → (params, opt_state, {"loss",
    "grad_norm", "lr"} as device scalars). ``batch`` holds tensors on
    ``device`` (`runtime.data.PrefetchIterator`). A parameter that the
    loss does not reach gets a zero gradient, as under ``jax.grad``. With
    ``plan`` the step is a `ShardedTrainStep` (params, opt_state and batch
    this rank's blocks and rows)."""
    from repro_torch.kernels.common import resolve_device
    from repro_torch.runtime.optimizer import AdamWConfig
    opt_cfg = opt_cfg or AdamWConfig()
    resolve_device(device)
    if plan is not None:
        return ShardedTrainStep(cfg, plan, opt_cfg)
    from repro_torch.models import get_model
    from repro_torch.runtime.optimizer import adamw_update
    from repro_torch.runtime.tree import tree_map
    api = get_model(cfg)

    def step(params, opt_state, batch):
        grads, loss = _loss_and_grads(api, params, batch)
        params = tree_map(lambda t: t.detach(), params)
        new_params, new_opt, metrics = adamw_update(params, grads, opt_state, opt_cfg)
        return new_params, new_opt, {"loss": loss.detach(), **metrics}

    return step


def model_axis_refusal(cfg, m: int) -> str | None:
    """Why ``cfg`` cannot train on a model axis of ``m`` > 1 (None: it
    can): the enc-dec family, and dims the layers need split that the axis
    does not divide (experts, SSD channels or RG-LRU channels that the
    spec leaves whole stay whole on every rank: `models.moe`,
    `models.ssm`, `models.rglru`)."""
    from repro_torch.distributed.sharding import MODEL_AXIS_ITEM
    if cfg.encdec:
        return f"the enc-dec family: {MODEL_AXIS_ITEM} is not ported"
    kinds = set(cfg.block_kinds())
    if "S" in kinds:
        di = cfg.ssm_expand * cfg.d_model
        nh = di // cfg.ssm_head_dim
        if di % m == 0 and nh % m:
            return (f"the spec splits the SSD's d_inner of {di} over it, but not its {nh} "
                    "heads (the SSD layers hold whole heads)")
    if kinds & {"A", "L"} and cfg.attn_strategy == "tp" and cfg.num_heads % m:
        return (f"{cfg.num_heads} heads do not split over it (the tp layers hold whole "
                "heads)")
    if cfg.padded_vocab % m:
        return (f"the padded vocab of {cfg.padded_vocab} does not split over it (the "
                "vocab-parallel head and loss hold whole columns)")
    return None


def _refill(tree, items):
    """A tree of ``tree``'s structure whose leaves are ``items``, in order."""
    from repro_torch.runtime.tree import tree_map
    it = iter(items)
    return tree_map(lambda _: next(it), tree)


def _loss_and_grads(api, params, batch):
    """(the gradient of the loss of ``batch`` with respect to every leaf of
    ``params``, as a tree; the loss)."""
    from repro_torch.runtime.tree import leaves, tree_map
    params = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = api.loss(params, batch)
    grads = torch.autograd.grad(loss, [t for _, t in leaves(params)], allow_unused=True,
                                materialize_grads=True)
    return _refill(params, grads), loss


class ShardedTrainStep:
    """The train step under ``plan``: FSDP over the plan's data axes and the
    model axis's layouts, with the reference's parameter specs
    (`param_specs` of `ShardingCtx(mesh, dp, tp, strategy, moe_strategy)`,
    ``pspec``: a leaf may split one dim over the data axes and another over
    "model", e.g. ``attn/wq`` P(f, m, None)) and the same specs for the
    AdamW moments and master (``ospec``). A call takes this rank's blocks
    of the parameters and of the optimizer state (`shard`) and this rank's
    rows of the global batch (`local_batch`; the same rows on every model
    rank):

    * it gathers every leaf split over the data axes whole over the data
      group (one all-gather a leaf, at the step's start); model blocks stay
      local;
    * runs ``api.loss`` on its rows under the ambient `ShardingCtx` (the
      model axis's collectives run inside the layers, `models.common`,
      `models.attention`) and takes the gradients. A leaf that the spec
      splits over "model" then holds its block's gradient; a leaf that it
      replicates over "model" (norm scales, cp's attention weights,
      replicated KV, the projector) holds this rank's part (each model rank
      saw other rows, heads or vocab columns) and is summed over the model
      group once (an all-reduce);
    * reduces each gradient to its mean over the data ranks: a
      reduce-scatter over the data group to the leaf's block, an all-reduce
      where the spec replicates the leaf over the data axes, each a sum
      divided by the data rank count;
    * returns as the loss the mean of the data ranks' losses (the global
      batch's: its rows split evenly; the same on every model rank);
    * AdamW updates the local blocks; its clip takes the global norm from
      one all-reduce over every rank of the per-leaf sums of squares, each
      distinct block counted once (a leaf replicated over an axis only at
      coordinate 0 of that axis), then summed leaf by leaf in the tree's
      order: at one rank the bits of `optimizer.global_norm`.

    The MoE family trains on any such mesh: its layers take the reference's
    ``ep`` or expert-TP layouts over "model" and its load-balancing loss
    over the global batch (`models.moe`). The SSD and the RG-LRU run their
    scans over the gathered sequence on the rank's heads or channels
    (`models.ssm`, `models.rglru`). A model axis above 1 raises for the
    enc-dec family (`sharding.MODEL_AXIS_ITEM`) and where the heads (tp
    attention, or the SSD's where the spec splits its channels) or the
    padded vocab do not split over it."""

    def __init__(self, cfg, plan: MeshPlan, opt_cfg):
        from repro_torch.distributed.sharding import (
            ShardingCtx, _axis_size, param_specs)
        from repro_torch.models import get_model
        from repro_torch.runtime.optimizer import AdamWState
        from repro_torch.runtime.tree import leaves
        from repro_torch.weights import init_lm_params
        mesh = plan.mesh
        self.cfg, self.plan, self.opt_cfg = cfg, plan, opt_cfg
        self.api = get_model(cfg)
        self.sctx = ShardingCtx(mesh=mesh, dp=plan.dp, tp=plan.tp, strategy=cfg.attn_strategy,
                                moe_strategy=cfg.moe_strategy)
        self.n, self.m = _axis_size(mesh, plan.dp), _axis_size(mesh, plan.tp)
        if self.n * self.m != mesh.ctx.world_size:
            raise NotImplementedError(f"data axes {plan.dp} of {self.n} ranks and {plan.tp!r} of "
                                      f"{self.m} in a world of {mesh.ctx.world_size}: training "
                                      "runs over every rank")
        if self.m > 1:
            why = model_axis_refusal(cfg, self.m)
            if why is not None:
                raise NotImplementedError(f"{cfg.name}: a {plan.tp!r} axis of {self.m} in "
                                          f"training: {why}")
        dp_entry = plan.dp[0] if len(plan.dp) == 1 else tuple(plan.dp)
        self.pshape = init_lm_params(cfg, None, "meta")
        self.pspec = param_specs(self.sctx, self.pshape)
        self.ospec = AdamWState(step=P(), m=self.pspec, v=self.pspec,
                                master=self.pspec if opt_cfg.use_master else ())
        self.rank0 = all(mesh.coords[a] == 0 for a in plan.dp)
        self.model0 = mesh.coords[plan.tp] == 0
        self.layout = {}            # path → (whole shape, spec, the dim split over the data axes)
        self.model_dim = {}         # path → the dim split over "model" (M > 1)
        # (None where the spec splits none)
        shapes = {path: tuple(t.shape) for path, t in leaves(self.pshape)}
        for path, sp in param_specs(self.sctx, shapes).items():
            dims = [i for i, e in enumerate(sp) if e == dp_entry]
            mdims = [i for i, e in enumerate(sp) if e == plan.tp and self.m > 1]
            if len(dims) > 1 or len(mdims) > 1 or any(
                    e is not None and e not in (dp_entry, plan.tp) and _axis_size(mesh, e) > 1
                    for e in sp):
                raise NotImplementedError(f"{path}: spec {sp} splits a dim over axes other "
                                          f"than one data dim {plan.dp} and one {plan.tp!r} dim")
            self.layout[path] = (shapes[path], sp, dims[0] if dims else None)
            self.model_dim[path] = mdims[0] if mdims else None

    def _leaves(self, tree):
        """(tensor, whole shape, spec, data dim) of every leaf of a
        parameter tree, in the tree's order."""
        from repro_torch.runtime.tree import leaves
        out = []
        for path, t in leaves(tree):
            if path not in self.layout:
                raise ValueError(f"{path}: not a parameter of {self.cfg.name}")
            out.append((t, *self.layout[path]))
        if len(out) != len(self.layout):
            raise ValueError(f"a tree of {len(out)} of the config's {len(self.layout)} "
                             "parameter paths")
        return out

    def shard(self, params):
        """This rank's blocks of a whole parameter tree."""
        from repro_torch.distributed.sharding import shard
        return _refill(params, [shard(t, sp, self.plan.mesh)
                                for t, _, sp, _ in self._leaves(params)])

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch (numpy arrays or tensors)."""
        from repro_torch.distributed.sharding import local_block
        mesh = self.plan.mesh
        specs = batch_specs(mesh, batch, self.plan.dp)
        return {k: v[local_block(mesh, specs[k], v.shape)] for k, v in batch.items()}

    def __call__(self, params, opt_state, batch):
        from repro_torch.runtime.optimizer import adamw_update
        from repro_torch.runtime.tree import tree_map
        grads, loss, gnorm = self.gradients(params, batch)
        params = tree_map(lambda t: t.detach(), params)
        new_params, new_opt, metrics = adamw_update(params, grads, opt_state, self.opt_cfg,
                                                    gnorm=gnorm)
        return new_params, new_opt, {"loss": loss, **metrics}

    def gradients(self, params, batch):
        """(each leaf's gradient block, reduced to its mean over the data
        ranks; the loss, the data ranks' mean; the global gradient norm) of
        the loss of ``batch`` (this rank's rows) at ``params`` (this rank's
        blocks): the step before AdamW."""
        from repro_torch.core.quantization import div_const
        from repro_torch.distributed.sharding import (
            activation_sharding, all_gather_dim, local_shape, psum, reduce_scatter_dim)
        from repro_torch.runtime.tree import leaves
        mesh, ctx, n = self.plan.mesh, self.plan.mesh.ctx, float(self.n)
        data = mesh.group(self.plan.dp)
        model = mesh.group(self.plan.tp) if self.m > 1 else None
        local = self._leaves(params)
        for (path, _), (t, shape, sp, _) in zip(leaves(params), local):
            if tuple(t.shape) != local_shape(mesh, sp, shape):
                raise ValueError(f"{path}: this rank holds {tuple(t.shape)}; its block of "
                                 f"{shape} under {sp} is {local_shape(mesh, sp, shape)}")
        whole = _refill(params, [t if d is None else all_gather_dim(t, d, data)
                                 for t, _, _, d in local])
        with activation_sharding(self.sctx, local_batch=next(iter(batch.values())).shape[0]):
            grads, loss = _loss_and_grads(self.api, whole, batch)
        del whole
        with torch.no_grad():
            reduced, sq = [], []
            for (path, g), (_, _, _, d) in zip(leaves(grads), local):
                md = self.model_dim[path]
                if model is not None and md is None:      # this model rank's part
                    g = psum(g.contiguous(), model)
                g = div_const(psum(g.contiguous(), data) if d is None
                              else reduce_scatter_dim(g, d, data), n)
                reduced.append(g)
                distinct = (d is not None or self.rank0) and (md is not None or self.model0)
                sq.append(torch.sum(torch.square(g.to(torch.float32))) if distinct
                          else g.new_zeros((), dtype=torch.float32))
            grads = _refill(params, reduced)
            loss = div_const(psum(loss.detach().clone(), data), n)
            sq = psum(torch.stack(sq), ctx)
            total = sq[0]
            for i in range(1, sq.shape[0]):
                total = total + sq[i]
            gnorm = torch.sqrt(total)
        return grads, loss, gnorm
