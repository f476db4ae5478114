"""The reference's jitted `make_train_step` on data × model meshes of forced
host devices, for tests/test_torch_tp_train.py (the dense families) and
tests/test_torch_moe_train.py (granite-moe-3b-a800m on (1, 4) and (2, 2))
(a subprocess: the device count is fixed when jax starts).

    python tests/_torch_tp_reference.py <out.npz> <arch>:<data>x<model> ...

Per case: the reduced config at f32, weights from ``init(PRNGKey(0))``,
3 steps of `make_batch(seed=1)` at T 64 and a global batch of 4 under
GSPMD's layouts for the mesh (the reference's `param_specs` and
``constrain*`` hints) with the AdamW settings of the test. ``out.npz``
holds ``<case>/metrics`` (steps × (loss, grad_norm)) and
``<case>/params/<path>`` (the final parameters, gathered whole).
"""

import os

# one thread a device: it runs beside spawned gloo ranks on a shared CPU
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")

import dataclasses  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.distributed.sharding import path_of  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.runtime import (  # noqa: E402
    AdamWConfig, MeshPlan, init_opt_state, make_batch, make_train_step)

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
SHAPE = dict(name="t", seq_len=64, global_batch=4, kind="train")
STEPS = 3
OVER = {"gemma3-12b": dict(local_window=24), "recurrentgemma-2b": dict(num_layers=3)}


def main() -> int:
    out = {}
    for case in sys.argv[2:]:
        arch, mesh_s = case.split(":")
        shape = tuple(int(x) for x in mesh_s.split("x"))
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                  **OVER.get(arch, {}))
        plan = MeshPlan.for_mesh(compat.make_mesh(shape, ("data", "model")))
        opt = AdamWConfig(**OPT)
        p = jax.jit(get_model(cfg).init)(jax.random.PRNGKey(0))
        o = init_opt_state(p, opt)
        batches = [make_batch(cfg, ShapeConfig(**SHAPE), seed=1, step=s) for s in range(STEPS)]
        _, jitted, _, _ = make_train_step(cfg, plan, opt)
        f = jitted(batches[0])
        metrics = []
        for b in batches:
            p, o, m = f(p, o, b)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        out[f"{case}/metrics"] = np.asarray(metrics)
        for kp, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
            out[f"{case}/params/{path_of(kp)}"] = np.asarray(leaf)
    np.savez(sys.argv[1], **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
