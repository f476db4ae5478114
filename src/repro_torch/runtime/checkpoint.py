"""Fault-tolerant checkpointing: atomic, asynchronous, keep-N.

Port of the reference `runtime/checkpoint.py`, with its layout and
protocol: ``<dir>/step_<N>/arrays.npz`` + ``meta.json``, written into
``.tmp_step_<N>_<pid>`` and renamed, so a crash mid-save never corrupts the
latest checkpoint (and `latest_step` never sees a half-written one). The
tensors are pulled to the host synchronously (cheap beside a training
step); the files are written by a background thread, one save in flight at
a time. bf16 tensors are stored as f32 (exact) and restored to the
target's dtype. Keys are the tree's paths joined with "/" (`runtime.tree`:
dicts and lists, the port's own layout). `restore` puts every tensor on
one device; restoring onto another layout (the reference's
reshard-on-restore) waits for multi-GPU training.
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


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree: Any, meta: dict | None = None,
             block: bool = False) -> None:
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

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, target: Any, step: int | None = None,
                device=None) -> tuple[int, Any]:
        """(step, a tree of ``target``'s structure, each tensor in its
        target's dtype, on ``device`` — the target's device when None)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        with np.load(os.path.join(self.dir, f"step_{step}", "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        keys = iter(k for k, _ in leaves(target))

        def pick(t):
            key = next(keys)
            arr = flat[key]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{key}: checkpoint {arr.shape} != target {tuple(t.shape)}")
            return torch.from_numpy(arr).to(device=device or t.device, dtype=t.dtype)
        return step, tree_map(pick, target)

    def read_meta(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)
