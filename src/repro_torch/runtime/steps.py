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

`make_train_step` is the counterpart of the reference's `make_train_step`
on one device, without a mesh: the loss, its gradient with respect to every
parameter (through kernel B3-bwd on the card), then `adamw_update`. It
runs eagerly.

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

import numpy as np
import torch

from repro_torch.kernels.common import LAUNCHES

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


def make_train_step(cfg, opt_cfg=None, device="cuda"):
    """step(params, opt_state, batch) → (params, opt_state, {"loss",
    "grad_norm", "lr"} as device scalars). ``batch`` holds tensors on
    ``device`` (`runtime.data.PrefetchIterator`). A parameter that the
    loss does not reach gets a zero gradient, as under ``jax.grad``."""
    from repro_torch.kernels.common import resolve_device
    from repro_torch.models import get_model
    from repro_torch.runtime.optimizer import AdamWConfig, adamw_update
    from repro_torch.runtime.tree import leaves, tree_map
    api = get_model(cfg)
    opt_cfg = opt_cfg or AdamWConfig()
    resolve_device(device)

    def step(params, opt_state, batch):
        params = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = api.loss(params, batch)
        grads = iter(torch.autograd.grad(loss, [t for _, t in leaves(params)],
                                         allow_unused=True, materialize_grads=True))
        grads = tree_map(lambda _: next(grads), params)
        params = tree_map(lambda t: t.detach(), params)
        new_params, new_opt, metrics = adamw_update(params, grads, opt_state, opt_cfg)
        return new_params, new_opt, {"loss": loss.detach(), **metrics}

    return step
