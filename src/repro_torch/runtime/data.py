"""Synthetic but learnable training data with background prefetch.

Port of the reference `runtime/data.py`. Token streams come from a seeded
order-1 Markov chain over the vocabulary, deterministic per (seed, step),
so a restart resumes the exact stream (a checkpoint stores only the step),
and structured enough that a small model's loss falls. The enc-dec family's
frames and the vision frontend's patches are seeded Gaussians. The batches
are made with numpy in the reference's order of draws, so every batch is
the reference's bit for bit.

`PrefetchIterator` keeps ``depth`` host batches ahead in a daemon thread;
``next`` pops one and moves it to the trainer's device as tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _markov_tokens(rng: np.random.Generator, batch: int, seq: int, vocab: int,
                   order_states: int = 64) -> np.ndarray:
    """Tokens from a small-state Markov chain: next = (a*s + c + noise) % V."""
    s = rng.integers(0, order_states, size=(batch,))
    a = 31
    out = np.empty((batch, seq + 1), np.int32)
    for t in range(seq + 1):
        out[:, t] = (s * 97) % vocab
        noise = rng.integers(0, 4, size=(batch,))
        s = (a * s + 17 + noise) % order_states
    return out


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int, step: int,
               reduced: bool = False) -> dict[str, np.ndarray]:
    """The batch of ``step``: {"tokens", "labels"} (B, T) int32, plus
    "frames" (B, T, D) f32 for the enc-dec family (its decoder stream is
    min(decoder_max_len, 448) tokens) or "patches" (B, P, F) f32 for the
    vision frontend (P image rows ahead of T - P text tokens)."""
    sh = shape.reduced() if reduced else shape
    b, t = sh.global_batch, sh.seq_len
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    if cfg.encdec:
        td = min(cfg.decoder_max_len, 448)
        toks = _markov_tokens(rng, b, td, cfg.vocab_size)
        return {
            "frames": rng.standard_normal((b, t, cfg.d_model), np.float32) * 0.02,
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }
    if cfg.frontend == "vision":
        p = min(cfg.num_image_tokens, max(t - 8, 0))
        toks = _markov_tokens(rng, b, t - p, cfg.vocab_size)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "patches": rng.standard_normal((b, p, cfg.frontend_dim), np.float32) * 0.02,
        }
    toks = _markov_tokens(rng, b, t, cfg.vocab_size)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def to_device(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (token ids int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.long() if t.dtype == torch.int32 else t).to(device)
    return out


class PrefetchIterator:
    """Background-thread prefetch of host batches; ``next`` → (step, batch)
    with the batch's tensors on ``device`` (numpy arrays when None)."""

    def __init__(self, gen: Callable[[int], dict[str, np.ndarray]],
                 start_step: int = 0, depth: int = 2, device=None):
        self.gen = gen
        self.device = device
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.gen(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    pass
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        if self.device is not None:
            batch = to_device(batch, self.device)
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
