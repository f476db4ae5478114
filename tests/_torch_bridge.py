"""Helpers shared by the port's parity tests (tests/test_torch_*.py): move
numpy data into the JAX reference and the PyTorch port, and compare their
outputs field by field."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

# one intra-op thread in every test process: the suite runs several pytest
# workers side by side, and the port's small CPU ops gain little from more
# threads while idle ones spin on the cores the other workers need (the
# spawned gloo ranks run one thread each too)
torch.set_num_threads(1)

POOL_FIELDS = ("k_codes", "k_scale", "v_codes", "v_scale", "feat_words", "feat_scale",
               "feat_zero", "heavy_idx", "length", "page_table", "refcount", "sel_hist")
CACHE_FIELDS = ("k_codes", "k_scale", "v_codes", "v_scale", "feat_words", "feat_scale",
                "feat_zero", "heavy_idx", "length")


def tt(x) -> torch.Tensor:
    """numpy/JAX array → CPU tensor; uint32 words keep their bits as int32."""
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def tn(x: torch.Tensor, like=None) -> np.ndarray:
    """CPU tensor → numpy; int32 words read back as uint32 when ``like`` is."""
    a = x.detach().cpu().numpy()
    if like is not None and np.asarray(like).dtype == np.uint32:
        a = a.view(np.uint32)
    return a


def assert_fields_equal(jx, tx, fields, layer=None):
    for f in fields:
        j = np.asarray(getattr(jx, f))
        if layer is not None:
            j = j[layer]
        np.testing.assert_array_equal(tn(getattr(tx, f), j), j, err_msg=f)


def f32_configs():
    """qwen3-0.6b.reduced() at float32 compute, for the reference and the port."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    return (dataclasses.replace(jget("qwen3-0.6b").reduced(), dtype="float32"),
            dataclasses.replace(tget("qwen3-0.6b").reduced(), dtype="float32"))



def int8_codes(rows: np.ndarray) -> np.ndarray:
    """The int8 K/V codes of pool rows (..., HD): an int8 pool stores them;
    an fp16 pool stores code × the row's scale, whose largest |code| is 127
    (f16 rounding moves a ratio by at most 127·2^-10, well under a half)."""
    if rows.dtype == np.int8:
        return rows.astype(np.int16)
    rows = np.nan_to_num(rows.astype(np.float32))     # a poisoned row: code 0
    amax = np.abs(rows).max(-1, keepdims=True)
    return np.round(rows * 127 / np.where(amax > 0, amax, 1)).astype(np.int16)


def record_ticks(eng) -> list:
    """Wrap a serving engine's decode call (the port's or the reference's):
    per tick the slots' mask, the logits rows, and the int8 K/V codes (every
    layer) of the blocks the active slots map."""
    ticks, orig = [], eng._decode

    def recording(*args):
        out = orig(*args)
        if torch.is_tensor(out[1]):
            caches = eng._state.caches
            codes = np.stack([torch.stack([getattr(c, f) for c in caches]).numpy()
                              for f in ("k_codes", "v_codes")])
            pt, lg = caches[0].page_table.numpy(), out[1].float().numpy()
        else:
            st = out[3].period_states[0]
            codes = np.stack([np.asarray(st.k_codes), np.asarray(st.v_codes)])
            pt, lg = np.asarray(st.page_table[0]), np.asarray(out[1])
        mask = np.asarray(args[-1]).copy()
        read = np.unique(pt[mask][pt[mask] >= 0])
        ticks.append((mask, np.array(lg, np.float32), int8_codes(codes[:, :, read])))
        return out

    eng._decode = recording
    return ticks


def layer_codes(state, cfg) -> np.ndarray:
    """Every layer's int8 K then V codes (an fp16 pool's by `int8_codes`) as
    one int16 vector, layer by layer: the port's state holds a list of
    caches, the reference's stacks layer l at ``period_states[l % P][l //
    P]`` and keeps the rest in its tail. Paged pools and sliding-window rings
    alike; a recurrent layer ("S", "R") has no codes (a model without
    attention layers gives an empty vector)."""
    if hasattr(state, "caches"):
        layers = [c for c in state.caches if hasattr(c, "k_codes")]
        get = lambda c, f: getattr(c, f).numpy()                    # noqa: E731
    else:
        p, n = len(state.period_states), len(cfg.layer_pattern)
        n_periods = cfg.num_layers // n if p else 0
        layers = [(state.period_states[i % n], i // n) for i in range(n_periods * n)]
        layers += [(st, None) for st in state.tail_states]
        layers = [c for c in layers if hasattr(c[0], "k_codes")]
        get = lambda c, f: np.asarray(getattr(c[0], f) if c[1] is None   # noqa: E731
                                      else getattr(c[0], f)[c[1]])
    return np.concatenate([np.zeros(0, np.int16)] + [
        int8_codes(get(c, f)).ravel() for f in ("k_codes", "v_codes") for c in layers])


def record_code_ticks(eng, cfg) -> list:
    """Wrap a serving engine's decode call (the port's or the reference's):
    per tick the slots' mask, the logits rows and `layer_codes` of the state
    the tick left."""
    ticks, orig = [], eng._decode

    def recording(*args):
        out = orig(*args)
        port = torch.is_tensor(out[1])
        lg = out[1].float().numpy() if port else np.asarray(out[1])
        ticks.append((np.asarray(args[-1]).copy(), np.array(lg, np.float32),
                      layer_codes(eng._state if port else out[3], cfg)))
        return out

    eng._decode = recording
    return ticks


# The engines' tick logits (tests/test_torch_scheduler.py's policy): 1e-5
# while both states hold the same int8 K/V codes; where the two packages'
# f32 forwards round a stored K or V value to adjacent codes, the codes may
# differ by one step and the rows by 1e-3 (one code moved the rows by up to
# 1.7e-4 on the dense configs' traces, against O(0.1) for a wrong history).
SAME_CODES_TOL = dict(rtol=1e-5, atol=1e-5)
CODE_STEP_TOL = dict(rtol=1e-5, atol=1e-3)


def assert_code_ticks_close(jticks, tticks, step_tol=CODE_STEP_TOL) -> int:
    """Masks equal, codes at most one step apart, logits within the policy
    above (``step_tol`` where a code is a step apart), tick for tick.
    Returns the number of ticks with a code step."""
    assert len(jticks) == len(tticks)
    stepped = 0
    for (jm, jl, jc), (tm, tl, tc) in zip(jticks, tticks):
        np.testing.assert_array_equal(jm, tm)
        assert jc.shape == tc.shape
        diff = int(np.abs(jc.astype(np.int32) - tc).max()) if jc.size else 0
        assert diff <= 1, f"stored codes {diff} steps apart"
        stepped += diff > 0
        np.testing.assert_allclose(tl[tm], jl[jm], **(step_tol if diff else SAME_CODES_TOL))
    return stepped


# --------------------------------------------------------------------------
# Training parity (tests/test_torch_train.py, tests/test_torch_train_loop.py)
# --------------------------------------------------------------------------

# a training batch at T 64, batch 2 (the reference's `make_batch`)
TRAIN_SHAPE = dict(name="train_t64", seq_len=64, global_batch=2, kind="train")
# sliding windows cut to this so that they bind at T 64
TRAIN_WINDOW = 24
# f32 on both sides: the loss within LOSS_TOL; a gradient leaf within
# GRAD_RTOL of its largest magnitude (the reference's sums run in other
# orders over 64-token sequences and a two-layer model's products; a wrong
# or missing term moves a leaf by O(1) of it)
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_RTOL = 1e-4


def check_loss_and_gradients(arch: str) -> float:
    """``ModelAPI.loss`` of ``arch``'s reduced f32 config and the gradient
    of every parameter against ``jax.value_and_grad`` of the reference's
    loss, on the same parameters (`params_from_numpy`) and batch. Returns
    the worst leaf's error over its largest magnitude."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.configs.base import ShapeConfig as JShape
    from repro.models import get_model as jget_model
    from repro.runtime.data import make_batch as jmake_batch
    from repro_torch.configs import get_config as tget_config
    from repro_torch.models import get_model as tget_model
    from repro_torch.runtime.tree import leaves
    from repro_torch.weights import params_from_numpy

    cfgs = []
    for get in (jget_config, tget_config):
        cfg = dataclasses.replace(get(arch).reduced(), dtype="float32")
        if cfg.local_window:
            cfg = dataclasses.replace(cfg, local_window=TRAIN_WINDOW)
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    japi = jget_model(jcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    batch = jmake_batch(jcfg, JShape(**TRAIN_SHAPE), seed=1, step=0)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: japi.loss(p, batch)))(jp)

    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)       # noqa: E731
    params = params_from_numpy(to_np(jp), tcfg, "cpu")
    keyed = [t.requires_grad_() for _, t in leaves(params)]
    loss = tget_model(tcfg).loss(params, {k: torch.from_numpy(np.asarray(v))
                                          for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    grads = torch.autograd.grad(loss, keyed, allow_unused=True, materialize_grads=True)

    want = dict(leaves(params_from_numpy(to_np(jgrads), tcfg, "cpu")))
    names = [k for k, _ in leaves(params)]
    assert names == list(want)
    worst = 0.0
    for name, got in zip(names, grads):
        ref = want[name].numpy()
        scale = float(np.abs(ref).max())
        err = float(np.abs(got.numpy() - ref).max())
        assert err <= GRAD_RTOL * scale + 1e-12, f"{name}: {err} vs max |ref| {scale}"
        worst = max(worst, err / max(scale, 1e-30))
    print(f"{arch}: loss {float(loss.detach()):.6f}, {len(names)} leaves, worst leaf error "
          f"{worst:.3g} of its max")
    return worst


def start_ranks(task: str, inp, world: int, workdir, timeout: float = 240):
    """Start ``world`` ranks of `_torch_dist_worker.py` ``task`` (a task or
    a comma-separated list) joined over gloo through a `FileStore` in
    ``workdir`` (no TCP port), one thread each; returns a function that
    waits for them and returns each rank's results (the caller works
    meanwhile). A failing rank's output is in the assertion message."""
    workdir = pathlib.Path(workdir)
    torch.save(inp, workdir / "in.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    script = pathlib.Path(__file__).resolve().parent / "_torch_dist_worker.py"
    procs = [subprocess.Popen([sys.executable, str(script), task, str(workdir), str(r),
                               str(world)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]

    def join() -> list:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
        return [torch.load(workdir / f"out{r}.pt", weights_only=False) for r in range(world)]
    return join


def spawn_ranks(task: str, inp, world: int, workdir, timeout: float = 240) -> list:
    """`start_ranks` and wait for them: each rank's results."""
    return start_ranks(task, inp, world, workdir, timeout)()
