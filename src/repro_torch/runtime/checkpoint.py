"""Fault-tolerant checkpointing: atomic, asynchronous, keep-N.

Port of the reference `runtime/checkpoint.py`, with its layout and
protocol: ``<dir>/step_<N>/arrays.npz`` + ``meta.json``, written into
``.tmp_step_<N>_<pid>`` and renamed, so a crash mid-save never corrupts the
latest checkpoint (and `latest_step` never sees a half-written one). The
tensors are pulled to the host synchronously (cheap beside a training
step); the files are written by a background thread, one save in flight at
a time. bf16 tensors are stored as f32 (exact) and restored to the
target's dtype. Keys are the tree's paths joined with "/" (`runtime.tree`:
dicts and lists, the port's own layout).

A sharded tree (each rank holding its blocks under any data × model
layout, ``shardings`` a tree of `distributed.sharding.NamedSharding`) is
saved whole, as the reference's `_flatten` pulls a sharded array whole:
every rank gathers the blocks over the whole mesh and the mesh's first rank
writes. A blocking save returns on every rank once
the step is on disk, and `wait` joins an asynchronous one on every rank.
`restore(shardings=)` is the reference's reshard-on-restore (an elastic
restart): every rank reads the whole arrays and keeps its block under the
given specs and mesh, which may differ from the saving run's.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.runtime.tree import leaves, tree_map


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    """A host copy of every leaf as numpy (the caller may go on updating the
    tensors while the write runs), bf16 (which npz cannot hold) as f32."""
    return {key: t.detach().to("cpu", torch.float32 if t.dtype == torch.bfloat16 else t.dtype,
                               copy=True).numpy()
            for key, t in leaves(tree)}


def _sharding_leaves(tree: Any, shardings: Any) -> list:
    """The sharding of every leaf of ``tree``, in order."""
    out = []
    tree_map(lambda _, s: out.append(s), tree, shardings)
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._mesh = None              # the mesh of the last sharded save
        os.makedirs(directory, exist_ok=True)

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree: Any, meta: dict | None = None,
             block: bool = False, shardings: Any = None) -> None:
        """Write ``tree`` as step ``step``; with ``shardings`` its leaves are
        this rank's blocks, gathered whole on every rank (a collective) and
        written by the mesh's first rank."""
        if shardings is not None:
            from repro_torch.distributed.sharding import gather
            specs = _sharding_leaves(tree, shardings)
            self._mesh = specs[0].mesh if specs else None
            whole = iter([gather(t, s.spec, s.mesh) for (_, t), s in zip(leaves(tree), specs)])
            tree = tree_map(lambda _: next(whole), tree)
            if self._mesh is not None and self._mesh.ctx.rank != 0:
                if block:
                    self.wait()
                return
        flat = _flatten(tree)          # to the host now; the write may be async
        if self._thread is not None:
            self._thread.join()        # one save in flight at a time

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}_{os.getpid()}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "time": time.time(), **(meta or {})}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if self.async_save and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            if shardings is not None:
                self.wait()

    def wait(self) -> None:
        """Join the save in flight; after a sharded save, on every rank of
        its mesh (a collective: every rank calls it)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            from repro_torch.distributed.sharding import barrier
            barrier(self._mesh.ctx)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep_n)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: int | None = None, device=None,
                shardings: Any = None) -> tuple[int, Any]:
        """(step, a tree of ``target``'s structure, each tensor in its
        target's dtype, on ``device`` — the target's device when None).
        With ``shardings`` (a tree of `NamedSharding` of ``target``'s
        structure) each tensor is this rank's block of the stored array
        under its sharding, and ``target`` holds the blocks' shapes. Only
        the arrays ``target`` names are read (a subtree of the saved tree
        restores alone)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        keys = iter(k for k, _ in leaves(target))
        specs = iter(_sharding_leaves(target, shardings) if shardings is not None else ())

        def pick(t):
            key = next(keys)
            arr = z[key]             # read from the archive as the target asks for it
            if shardings is not None:
                from repro_torch.distributed.sharding import local_block
                s = next(specs)
                arr = np.array(arr[local_block(s.mesh, s.spec, arr.shape)])   # a 0-d copy stays 0-d
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{key}: checkpoint {arr.shape} != target {tuple(t.shape)}")
            return torch.from_numpy(arr).to(device=device or t.device, dtype=t.dtype)
        with np.load(os.path.join(self.dir, f"step_{step}", "arrays.npz")) as z:
            return step, tree_map(pick, target)

    def read_meta(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)
