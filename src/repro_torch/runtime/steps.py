"""The serving decode tick: one call advances every active slot by one token.

Port of the reference `runtime/steps.py::make_serve_decode_step` for one
device, without the mesh plan and without ``nan_flags`` (ROADMAP A.4). The
reference jits its tick, so shapes stay static and the serving engine pays
one dispatch per tick. Here the tick — `models.transformer.lm_decode_step`
and the greedy argmax — is captured once per engine as a CUDA graph and
replayed:

* on the CPU the step runs eagerly (the path the CPU tests take);
* on the card with ``ctx=None`` (the paged pool in every storage mode, with
  or without the host tier, and the contiguous slot pool) the first call
  runs eagerly: it is the engine's real first tick, and it loads the
  kernels' libraries, cuBLAS's handles and the quantizers' constants. The
  second call captures the tick over static device buffers (the token and
  active inputs, the logits and the next tokens) in a `torch.cuda.CUDAGraph`
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
    ``(next_token (S,), logits (S, V_pad))`` on the device, advancing every
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
        self._out = None             # the graph's static (next_token, logits)
        self.launches_per_tick: Counter | None = None   # a replay's kernel launches

    def _tick(self):
        logits, _ = self._decode_step(self._params, self._state, self._tok, self._act,
                                      self._ctx)
        return logits.argmax(dim=-1), logits

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
        nxt, logits = self._out
        return nxt.clone(), logits.clone()
