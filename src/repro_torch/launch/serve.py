"""Serving entry point: thin shim over the serving plane (repro_torch.serve).

The port of ``repro/launch/serve.py``.  :func:`main` drives
:class:`repro_torch.serve.engine.ServeEngine` — fixed-slot continuous
batching with per-slot positions, exact prompt handoff, and cache-row
reset on slot recycle — over a decoder arch of the registry (dense, moe,
rwkv6, zamba2; the vlm and audio frontends take inputs the engine does
not pass) with random params drawn on the device from ``--seed``.  The flags are the
reference's, plus ``--device`` (default ``cuda``; ``cpu`` only when asked
for).

Example (CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch qwen2-7b --smoke --requests 8 --max-new 16

The original prototype :class:`Server` is kept below for API
compatibility; the engine supersedes it (the prototype shares one
position counter across slots, so a recycled slot continues at its
neighbours' RoPE offset).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm

log = logging.getLogger("repro_torch.serve")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    #: True when the server's max_len cut generation short of max_new
    truncated: bool = False

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


class Server:
    """Fixed-slot continuous-batching decoder (prototype; see module
    docstring — new code should use :class:`repro_torch.serve.ServeEngine`)."""

    def __init__(self, cfg, batch_slots: int, max_len: int, tp: int = 1,
                 seed: int = 0, dtype=torch.float32,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        self.cfg = cfg
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.pending: List[Deque[int]] = [deque() for _ in range(batch_slots)]
        self.max_len = max_len
        self.tp = tp
        self.device = dev
        self.params = lm.init_params(cfg, seed, tp, dtype, dev)
        self.cache = lm.init_cache(cfg, batch_slots, max_len, tp, dtype, dev)
        self.pos = 0

    def _next(self, logits: torch.Tensor) -> np.ndarray:
        return torch.argmax(logits[:, :self.cfg.vocab_size], -1).to(
            torch.int32).cpu().numpy().copy()

    # -- batched service loop ------------------------------------------------
    @torch.no_grad()
    def run(self, requests: List[Request]) -> Tuple[List[Request], int]:
        queue = list(requests)
        done: List[Request] = []
        B = len(self.slots)

        # pack first wave: right-align prompts to a common prefill length
        wave = [queue.pop(0) for _ in range(min(B, len(queue)))]
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt
            self.slots[i] = r
        logits, self.cache = lm.serve_prefill(
            self.cfg, self.params,
            {"tokens": torch.as_tensor(toks, device=self.device)}, self.tp,
            self.cache)
        self.pos = plen
        next_tok = self._next(logits)

        steps = 0
        while any(s is not None for s in self.slots) and self.pos < \
                self.max_len:
            logits, self.cache = lm.serve_step(
                self.cfg, self.params,
                torch.as_tensor(next_tok, device=self.device), self.pos,
                self.tp, self.cache)
            self.pos += 1
            steps += 1
            next_tok = self._next(logits)
            for i, r in enumerate(self.slots):
                if r is None:
                    continue
                if self.pending[i]:
                    # mid-handoff: this step consumed a prompt token, and
                    # more remain — feed the next one, emit nothing
                    next_tok[i] = self.pending[i].popleft()
                    continue
                r.out.append(int(next_tok[i]))
                if r.done:
                    done.append(r)
                    # continuous batching: hand the slot to a queued
                    # request; its *whole* prompt decodes token-by-token
                    # into the live batch via the pending queue
                    self.slots[i] = queue.pop(0) if queue else None
                    if self.slots[i] is not None:
                        pending = deque(
                            int(t) for t in self.slots[i].prompt)
                        next_tok[i] = pending.popleft()
                        self.pending[i] = pending
        for s in self.slots:
            if s is not None:
                s.truncated = True  # max_len fired before max_new tokens
                done.append(s)
        return done, steps


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device: cuda (default), cuda:N or cpu")
    return ap.parse_args(argv)


def run(argv=None, cfg=None):
    """Build the engine from the flags and serve the burst; returns
    ``(engine, done, report)``.  ``cfg`` overrides what ``--arch`` /
    ``--smoke`` resolve to (a depth-cut config, say)."""
    from repro_torch.serve import ServeEngine, ServeRequest, ServeSpec, report

    args = parse_args(argv)
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(
            args.arch)
    if not cfg.is_decoder:
        raise SystemExit(f"{args.arch} is encoder-only: nothing to decode")
    rng = np.random.default_rng(args.seed)
    reqs = [ServeRequest(i, rng.integers(0, cfg.vocab_size,
                                         rng.integers(4, args.prompt_len + 1)
                                         ).astype(np.int32),
                         args.max_new) for i in range(args.requests)]
    spec = ServeSpec(slots=args.slots,
                     max_len=args.prompt_len + args.max_new * 4,
                     prefill_len=args.prompt_len, max_new=args.max_new,
                     seed=args.seed)
    params = lm.init_params(cfg, args.seed, tp=1, dtype=torch.float32,
                            device=dev)
    engine = ServeEngine(cfg, params, spec)
    done = engine.run(reqs)
    return engine, done, report(done)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    t0 = time.time()
    engine, done, r = run(argv)
    log.info("served %d requests (%d truncated), %.1f tok/s, "
             "p50 latency %.3fs, %.1f s in all (call shapes: %s)",
             r["requests"], r["truncated"], r["tok_per_s"],
             r["latency_p50_s"], time.time() - t0,
             {k: sorted(v) for k, v in engine.call_shapes.items()})
    return done


if __name__ == "__main__":
    main()
