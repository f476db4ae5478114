"""The port's serving tick (`repro_torch.runtime.steps`) on the CPU, and what
a CUDA graph of it needs from the tick: every state tensor updated in place
across ticks (a replay writes to the addresses its capture saw), and no
tensor made of host data inside the tick (a capture would freeze it).

The engines serve qwen3-0.6b.reduced() at float32 compute with the port's
own random weights; the step's graph runs only on the card
(tests/test_torch_cuda.py), so here the step is eager and is held bit for
bit against `lm_decode_step`. The engine's greedy tokens against the JAX
engine's, through this step, are tests/test_torch_engine.py's cases.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.runtime import steps
from repro_torch.runtime.serve import Request, ServingEngine
from repro_torch.weights import init_lm_params

CFG = dataclasses.replace(get_config("qwen3-0.6b").reduced(), dtype="float32")
# the vocab padded, so that the tick masks the padded logits as qwen3-0.6b's does
CFG_PADDED = dataclasses.replace(CFG, vocab_size=CFG.padded_vocab - 12)
POOLS = {"contiguous": dict(paged=False),
         "int8": dict(paged=True, block_size=16, num_blocks=12),
         "fp16": dict(paged=True, block_size=16, num_blocks=12, kv_pool_dtype="fp16"),
         "int4": dict(paged=True, block_size=16, num_blocks=12, kv_pool_dtype="int4")}
# three ticks: both slots, the first alone, the second alone
ACTIVE = ([True, True], [True, False], [False, True])


def _engine(cfg, pool: str, seed: int = 0) -> ServingEngine:
    """An engine of 2 slots × 128 positions holding prompts of 40 and 70
    tokens (admitted, not yet decoded)."""
    params = init_lm_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    eng = ServingEngine(cfg, params, max_seq=128, slots=2, device="cpu", **POOLS[pool])
    rng = np.random.default_rng(seed)
    for i, n in enumerate((40, 70)):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                           max_new_tokens=8))
    eng._admit()
    return eng


def _state_tensors(state) -> dict:
    """Every tensor of a decode state by name: the cursor and each layer's
    cache fields (a paged pool's data leaves, sink block included)."""
    out = {"pos": state.pos}
    for i, c in enumerate(state.caches):
        if dataclasses.is_dataclass(c):
            out.update({f"{i}.data.{f}": t for f, t in c.data.items()})
            out.update({f"{i}.{f}": getattr(c, f) for f in
                        ("heavy_idx", "length", "page_table", "refcount", "sel_hist")})
        else:
            out.update({f"{i}.{f}": getattr(c, f) for f in c._fields})
    return out


def _rebound_after_ticks(eng) -> list:
    """The state tensors whose storage moved over three ticks of
    `lm_decode_step` with slots going active and inactive."""
    where = {k: t.untyped_storage().data_ptr() for k, t in _state_tensors(eng._state).items()}
    for act in ACTIVE:
        transformer.lm_decode_step(eng.params, eng.cfg, eng._state,
                                   torch.from_numpy(eng._tokens.copy()), torch.tensor(act))
    now = _state_tensors(eng._state)
    assert now.keys() == where.keys()
    return sorted(k for k, t in now.items() if t.untyped_storage().data_ptr() != where[k])


@pytest.mark.parametrize("pool", list(POOLS))
def test_ticks_update_every_state_tensor_in_place(pool):
    eng = _engine(CFG, pool)
    assert _rebound_after_ticks(eng) == []


def test_in_place_check_catches_an_injected_rebinding(monkeypatch):
    """The check can fail: an append that rebinds the pool's cursor to a
    copy is reported in every layer."""
    import repro_torch.models.blocks as blocks
    real = blocks.append_token_paged

    def append(pool, *a, **kw):
        out = real(pool, *a, **kw)
        pool.length = pool.length.clone()
        return out

    eng = _engine(CFG, "int8")
    monkeypatch.setattr(blocks, "append_token_paged", append)
    assert _rebound_after_ticks(eng) == [f"{i}.length" for i in range(CFG.num_layers)]


class HostData(TorchDispatchMode):
    """Records every op that turns host data into a tensor — `torch.tensor`
    / `torch.as_tensor` of Python or numpy data (``lift_fresh``), a 0-dim
    tensor of a Python scalar (``scalar_tensor``) — or reads a tensor back
    on the host (``_local_scalar_dense``: ``item``, ``int``, ``bool``;
    ``nonzero``, whose shape depends on the data): a capture would freeze
    the first and refuses the second."""

    BAD = {"aten.lift_fresh.default", "aten.lift_fresh_copy.default",
           "aten.scalar_tensor.default", "aten._local_scalar_dense.default",
           "aten.nonzero.default"}

    def __init__(self):
        super().__init__()
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in self.BAD:
            self.bad.append(str(func))
        return func(*args, **(kwargs or {}))


def _tick_under_host_data(pool: str) -> list:
    eng = _engine(CFG_PADDED, pool)
    with HostData() as mode:
        eng._decode(eng._tokens.copy(), eng._mask.copy())
    return mode.bad


@pytest.mark.parametrize("pool", ["int8", "contiguous"])
def test_tick_makes_no_tensor_of_host_data(pool):
    assert _tick_under_host_data(pool) == []


def test_host_data_check_catches_an_injected_tensor_literal(monkeypatch):
    """The check can fail: the padded vocab masked through a
    ``torch.tensor(-1e30)`` made in the tick is reported (once per tick)."""
    def mask(logits, cfg):
        v = torch.arange(cfg.padded_vocab, device=logits.device)
        return torch.where(v < cfg.vocab_size, logits,
                           torch.tensor(-1e30, dtype=logits.dtype, device=logits.device))

    monkeypatch.setattr(transformer, "vocab_mask_logits", mask)
    assert _tick_under_host_data("int8") == ["aten.lift_fresh.default"]


@pytest.mark.parametrize("pool", ["contiguous", "int8", "int4"])
def test_cpu_step_equals_lm_decode_step_bitwise(pool):
    """Three ticks through the engine's step and through `lm_decode_step` on
    a twin engine: the same next tokens, logits and state, bit for bit."""
    eng, twin = _engine(CFG, pool), _engine(CFG, pool)
    assert not eng._step.graphed
    for act in ACTIVE:
        tok = eng._tokens.copy()
        nxt, logits = eng._decode(tok, np.array(act))
        want, _ = transformer.lm_decode_step(twin.params, twin.cfg, twin._state,
                                             torch.from_numpy(tok), torch.tensor(act))
        assert torch.equal(logits, want) and torch.equal(nxt, want.argmax(-1))
        eng._tokens[:] = twin._tokens[:] = nxt.numpy()
    got, want = _state_tensors(eng._state), _state_tensors(twin._state)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_eager_switch_turns_capture_off_for_steps_built_inside():
    """A step replays a graph only on a CUDA device, unsharded, outside
    `steps.eager()`; the switch nests and is undone on the way out, an
    exception included."""
    assert steps.graphed("cuda") and steps.graphed(torch.device("cuda", 0))
    assert not steps.graphed("cpu") and not steps.graphed("cuda", ctx=object())
    with steps.eager():
        assert not steps.graphed("cuda")
        with steps.eager():
            assert not steps.graphed("cuda")
        assert not steps.graphed("cuda")
    assert steps.graphed("cuda")
    with pytest.raises(KeyError):
        with steps.eager():
            raise KeyError
    assert steps.graphed("cuda")
    with steps.eager():
        eng = _engine(CFG, "int8")
    assert not eng._step.graphed
