"""The JAX package's sequence-sharded flat decode, run for the port's parity
tests (tests/test_torch_sp_flat.py), with its intermediates.

`run_island` runs the reference island of `models/blocks.py::_attn_decode`
(the fourth branch: local lengths from the cursor, `sp_append_token`, local
lengths from the valid length, then `sp_salca_decode` and `sp_dense_decode`)
over ``n`` shards of axis "seq", in two parts. The append runs eagerly,
under `jax.vmap` over the shards with the axis named "seq" (the reference's
own collectives and ``axis_index``): under `jit` XLA turns its divisions by
constants into multiplications by their reciprocals (`sym_quantize`'s
``amax / 127`` moves an appended scale by an ulp; ROADMAP C) where the port
divides, and an eager `shard_map` takes seconds per call. The decode then
runs in `shard_map` under `jit` on a mesh of ``n`` devices, as the
reference's engine runs it. It also returns what the reference computes on
the way: each shard's pre-pool and pooled bins, the all-reduced histogram,
the threshold and each shard's compacted selection, taken from the calls
the reference makes (`_halo_exchange`, `histogram256`, `locate_threshold`,
`compact_indices`) by wrapping them while the island is traced.

    python tests/_torch_sp_reference.py <workdir>

runs every case of ``workdir/in.pkl`` (a list of case dicts) on meshes of
2 and 4 of 4 forced host devices and writes ``workdir/out.pkl`` (the XLA
flag must be set before jax starts, hence the process).
"""

import contextlib
import os
import pickle
import sys

import numpy as np

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import jax                                  # noqa: E402
import jax.numpy as jnp                     # noqa: E402
from jax.sharding import Mesh               # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import compat                    # noqa: E402
from repro.core import cache as jc          # noqa: E402
from repro.core import sp_decode as sp      # noqa: E402
from repro.core.selection import SalcaParams  # noqa: E402

ht = sp.ht            # the histogram module the reference's island calls through
DATA = ("k_codes", "k_scale", "v_codes", "v_scale", "feat_words", "feat_scale", "feat_zero")


@contextlib.contextmanager
def _stashing(stash: dict):
    """Wrap the reference's calls so the traced island records its
    intermediates (the last call of each wins)."""
    saved = (sp._halo_exchange, ht.histogram256, ht.locate_threshold, ht.compact_indices)

    def halo(x, halo_, axis):
        stash["bins"] = x
        return saved[0](x, halo_, axis)

    def hist(bins):
        stash["pooled"] = bins
        return saved[1](bins)

    def locate(h, k):
        stash["hist"] = h
        stash["threshold"] = t = saved[2](h, k)
        return t

    def compact(keep, cap):
        out = saved[3](keep, cap)
        stash["indices"], stash["mask"], stash["count"] = out
        return out

    sp._halo_exchange, ht.histogram256, ht.locate_threshold, ht.compact_indices = (
        halo, hist, locate, compact)
    try:
        yield
    finally:
        sp._halo_exchange, ht.histogram256, ht.locate_threshold, ht.compact_indices = saved


def jax_cache(case: dict):
    """The global cache of a case, built eagerly (the port divides where
    jit multiplies): per slot a prefill of ``k``/``v`` rows laid out as
    given, padded to ``rows``; lengths from ``lengths``."""
    params = SalcaParams(**case["params"])
    c = jc.prefill_cache(jnp.asarray(case["k"]), jnp.asarray(case["v"]),
                         max_seq=case["rows"], params=params)
    return c._replace(length=jnp.asarray(case["lengths"], jnp.int32))


def _appended(case: dict, cache, n: int):
    """The reference's append on ``n`` shards, eagerly (module docstring):
    returns the global cache holding every shard's appended rows, and each
    shard's local lengths from the valid length (B, n)."""
    def split(x):
        return jnp.stack(jnp.split(x, n, axis=1))

    shards = cache._replace(**{f: split(getattr(cache, f)) for f in DATA},
                            heavy_idx=jnp.broadcast_to(cache.heavy_idx,
                                                       (n,) + cache.heavy_idx.shape),
                            length=jnp.broadcast_to(cache.length, (n,) + cache.length.shape))

    def append(c, k1, v1, wp, vl):
        c = c._replace(length=sp.local_lengths(wp, c.max_seq, "seq"))
        c = sp.sp_append_token(c, k1, v1, wp, "seq")
        return c, sp.local_lengths(vl, c.max_seq, "seq")

    out, local_len = jax.vmap(append, in_axes=(0, None, None, None, None), axis_name="seq")(
        shards, jnp.asarray(case["k1"]), jnp.asarray(case["v1"]),
        jnp.asarray(case["cursor"], jnp.int32), jnp.asarray(case["valid_len"], jnp.int32))
    joined = cache._replace(**{f: jnp.concatenate(list(getattr(out, f)), axis=1)
                               for f in DATA})
    return joined, local_len.T


def run_island(case: dict, mesh) -> dict:
    """The reference island on ``mesh`` (axis "seq") for one case: a query
    ``q``, an appended token ``k1``/``v1`` at global cursor ``cursor`` (-1:
    an inactive slot), the valid lengths ``valid_len`` after it, ``window``
    for the dense tick. Returns numpy arrays: outputs, leaves (global),
    each shard's local lengths (B, n), bins/pooled (global, shard by shard
    along the last axis), hist and threshold (replicated), indices/mask
    (each shard's ``cap`` columns in turn) and count (B, KV, n)."""
    params = SalcaParams(**case["params"])
    n = mesh.devices.size
    cache, local_len = _appended(case, jax_cache(case), n)
    stash: dict = {}
    seq = P(None, "seq")

    def island(q, vl, c):
        c = c._replace(length=sp.local_lengths(vl, c.max_seq, "seq"))
        with _stashing(stash):
            o = sp.sp_salca_decode(q, c, params, "seq", shard_cap=case.get("shard_cap"))
        d = sp.sp_dense_decode(q, c, "seq", window=case["window"], global_len=vl)
        inter = {f: stash[f] for f in ("pooled", "hist", "threshold", "indices", "mask")}
        inter["bins"] = stash.get("bins", stash["pooled"])
        inter["count"] = stash["count"][..., None]
        return o, d, inter

    rep3 = P(None, None, None)
    cspec = type(cache)(
        k_codes=P(None, "seq", None, None), k_scale=seq, v_codes=P(None, "seq", None, None),
        v_scale=seq, feat_words=P(None, "seq", None, None), feat_scale=seq, feat_zero=seq,
        heavy_idx=rep3, length=P(None))
    last = P(None, None, "seq")
    ispec = dict(bins=last, pooled=last, hist=rep3, threshold=P(None, None), indices=last,
                 mask=last, count=last)
    f = jax.jit(compat.shard_map(island, mesh=mesh, in_specs=(rep3, P(None), cspec),
                                 out_specs=(rep3, rep3, ispec), check_vma=False))
    o, d, inter = f(jnp.asarray(case["q"]), jnp.asarray(case["valid_len"], jnp.int32), cache)
    out = dict(out=o, dense=d, local_len=local_len,
               **{f"leaf_{k}": getattr(cache, k) for k in DATA}, **inter)
    return {k: np.asarray(v) for k, v in out.items()}


def one_device_mesh():
    return compat.make_mesh((1,), ("seq",))


def main() -> int:
    workdir = sys.argv[1]
    assert len(jax.devices()) == 4, jax.devices()
    with open(os.path.join(workdir, "in.pkl"), "rb") as fh:
        cases = pickle.load(fh)
    res = {n: [run_island(c, Mesh(np.array(jax.devices()[:n]), ("seq",))) for c in cases]
           for n in (2, 4)}
    with open(os.path.join(workdir, "out.pkl"), "wb") as fh:
        pickle.dump(res, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
