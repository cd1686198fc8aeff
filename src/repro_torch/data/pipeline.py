"""Deterministic synthetic LM data for the trainer and the federated LM.

The port of ``repro/data/pipeline.py``: the same numpy draws, so both
packages see bitwise the same tokens.  ``TokenPipeline.batch(step)`` is
pure in ``step`` (``np.random.default_rng((seed, step))``), so a run
resumed from a checkpoint replays the exact stream position.  Batches are
numpy; the caller moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig


def class_token_sequences(rng: np.random.Generator, labels: np.ndarray,
                          vocab_size: int, seq_len: int,
                          noise: float = 0.1) -> np.ndarray:
    """Class-conditional token streams for the federated LM path.

    One (seq_len,) int32 sequence per label: class c walks the vocab
    cyclically with stride ``1 + (c % (V-1))`` from a random start, with a
    ``noise`` fraction of positions resampled uniformly.
    ``make_federated(task="tokens")`` (data/federated.py) routes through
    here.
    """
    labels = np.asarray(labels)
    n = len(labels)
    starts = rng.integers(0, vocab_size, n)
    steps = 1 + (labels % max(vocab_size - 1, 1))
    pos = np.arange(seq_len)
    toks = (starts[:, None] + steps[:, None] * pos[None, :]) % vocab_size
    resample = rng.random((n, seq_len)) < noise
    toks = np.where(resample, rng.integers(0, vocab_size, (n, seq_len)),
                    toks)
    return toks.astype(np.int32)


class TokenPipeline:
    """Stateless-per-step synthetic token source: batch(step) is pure."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg, shape = self.cfg, self.shape
        rng = np.random.default_rng((self.seed, step))
        B, S = shape.global_batch, shape.seq_len
        if cfg.family == "vlm":
            np_ = min(cfg.n_frontend_tokens, S // 2)
            return {
                "patch_embeds": rng.normal(
                    0, 1, (B, np_, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(
                    0, cfg.vocab_size, (B, S - np_)).astype(np.int32),
            }
        if cfg.family == "audio":
            mask = rng.random((B, S)) < 0.08
            return {
                "frames": rng.normal(0, 1, (B, S, cfg.d_model)).astype(
                    np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                    np.int32),
                "mask": mask,
            }
        return {"tokens": rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)}

    def iterator(self, start_step: int = 0, prefetch: int = 2
                 ) -> Iterator[Dict[str, np.ndarray]]:
        """Background-thread prefetching iterator (overlaps host data
        generation with device compute)."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
