"""The reference's `compressed_psum` on 4 forced host devices, for
tests/test_torch_ef21.py (a subprocess: the device count is fixed when jax
starts).

    python tests/_torch_ef21_reference.py <in.npz> <out.npz>

``in.npz`` holds per-rank gradients and errors, ``g/<leaf>`` and
``e/<leaf>`` of shape (4, ...). Under ``jit(shard_map)`` over a (4,)
"data" mesh, as the reference's DDP step runs it, each device computes its
leaves' mean and new error (`compressed_psum`) and the codes and scale of
its corrected gradient (`_quantize_leaf`); ``out.npz`` holds them stacked
over the devices: ``mean/<leaf>``, ``err/<leaf>``, ``codes/<leaf>``,
``scale/<leaf>``.
"""

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import sys  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import compat  # noqa: E402
from repro.distributed.compression import _quantize_leaf, compressed_psum  # noqa: E402


def main() -> int:
    assert len(jax.devices()) == 4
    with np.load(sys.argv[1]) as z:
        names = sorted(k[2:] for k in z.files if k.startswith("g/"))
        grads = {n: z[f"g/{n}"] for n in names}
        errors = {n: z[f"e/{n}"] for n in names}
    mesh = compat.make_mesh((4,), ("data",))

    def local(g, e):
        g = {n: v[0] for n, v in g.items()}
        e = {n: v[0] for n, v in e.items()}
        mean, new_err = compressed_psum(g, "data", e)
        q = {n: _quantize_leaf(g[n] + e[n]) for n in g}
        return ({n: v[None] for n, v in mean.items()}, {n: v[None] for n, v in new_err.items()},
                {n: c[None] for n, (c, _) in q.items()}, {n: s[None] for n, (_, s) in q.items()})

    spec = {n: P("data") for n in names}
    f = jax.jit(compat.shard_map(local, mesh=mesh, in_specs=(spec, spec),
                                 out_specs=(spec, spec, spec, spec), check_vma=False))
    mean, err, codes, scale = f(grads, errors)
    out = {}
    for key, tree in (("mean", mean), ("err", err), ("codes", codes), ("scale", scale)):
        out.update({f"{key}/{n}": np.asarray(v) for n, v in tree.items()})
    np.savez(sys.argv[2], **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
