"""Fixed-slot continuous-batching serve engine.

The port of ``repro/serve/engine.py``: the same host-side slot
bookkeeping, admission, force-fed prompt handoff, prefill-wave rule and
cache-row reset, over the port's LM facade (models/lm.py).

  * **One shape per config.**  Exactly three device calls — prefill
    ``(B, P)``, decode ``(B,)``, slot reset ``(B,)`` mask — all shaped by
    :class:`ServeSpec`, never by the live request mix.  PyTorch has no
    traces, so the reference's ``trace_counts`` becomes
    :attr:`ServeEngine.call_shapes`: the distinct input shapes each call
    saw, one per call kind for a run.
  * **Per-slot positions.**  A recycled slot restarts at position 0 with
    its own entry in the ``(B,)`` position vector while neighbours keep
    decoding (models/attention.py decode_attention).
  * **Cache-reset invariant.**  Before a slot is reused, its cache rows are
    reset in place to exactly the ``init_cache`` state (positions ``-1``,
    K/V ``0``), so a recycled slot is indistinguishable from a fresh one.
  * **Exact handoff.**  A request admitted mid-flight force-feeds its
    remaining prompt tokens through decode steps (logits discarded until
    the last prompt token); nothing of the prompt is dropped.  Batched
    prefill is only exact for attention-only families — recurrent state
    (ssm/hybrid) integrates padding, so those families always force-feed.

Two deliberate differences: a prefilled request's first-token time is
taken when the prefill wave has returned its tokens (the reference stamps
it with the time the wave started, which leaves the prefill out of TTFT);
and a config with a modality frontend (vlm, audio), whose prefill needs
more than the tokens the engine passes, fails at its first prefill with
a ``ValueError`` naming the input (models/transformer.py
``embed_inputs``) where the reference's fails with a ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.serve.spec import ServeSpec


@dataclasses.dataclass
class ServeRequest:
    """One generation request plus its measured lifecycle."""
    rid: int
    prompt: np.ndarray            # (len,) int32 token ids
    max_new: int
    #: open-loop arrival offset (seconds from engine start); 0 = already
    #: queued when the engine starts
    arrival: float = 0.0
    out: List[int] = dataclasses.field(default_factory=list)
    #: True when the max_len position budget ended generation before
    #: max_new tokens — distinguishable from a normally-finished request
    truncated: bool = False
    # lifecycle timestamps (seconds from engine start; -1 = never)
    t_admit: float = -1.0
    t_first: float = -1.0         # first *generated* token emitted
    t_done: float = -1.0

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


def _leaves_with_axes(cache, axes):
    """(tensor, logical axes) for every leaf of a cache tree, walked as the
    reference's ``jax.tree.map(fn, cache, axes)`` walks it: the cache's
    NamedTuples may nest (zamba2's ZambaCache holds a MambaState and a
    KVCache); an axes leaf is a plain tuple."""
    if isinstance(cache, torch.Tensor):
        yield cache, axes
        return
    for c, a in zip(cache, axes):
        yield from _leaves_with_axes(c, a)


class ServeEngine:
    """Continuous-batching decoder over an LM-facade param tree.

    ``cfg`` is the bound :class:`ModelConfig`, ``params`` the tree from
    ``lm.init_params`` or ``convert.params_from_numpy``; the engine runs
    on the device that holds them, with its cache in ``spec.dtype``.
    """

    def __init__(self, cfg, params, spec: ServeSpec, tp: int = 1):
        spec.validate()
        self.cfg = cfg
        self.spec = spec
        self.tp = tp
        self.params = params
        self.device = params["embed"].device
        self.dtype = (torch.float32 if spec.dtype == "float32"
                      else torch.bfloat16)
        B, T = spec.slots, spec.max_len
        self.is_transformer = cfg.family in lm.TRANSFORMER_FAMILIES
        #: physical cache rows per slot (SWA archs ring over the window)
        self.cache_rows = (min(T, cfg.swa_window) if cfg.swa_window else T)
        self.cache = lm.init_cache(cfg, B, T, tp, self.dtype, self.device)
        self._axes = lm.cache_axes_tree(cfg, tp)
        # host-side slot state
        self.slot_req: List[Optional[ServeRequest]] = [None] * B
        self.pending: List[Deque[int]] = [deque() for _ in range(B)]
        self.pos = np.zeros(B, np.int32)          # tokens consumed per slot
        self.next_tok = np.zeros(B, np.int32)     # last model output per slot
        #: call kind -> the distinct input shapes it was called with (the
        #: one-shape-per-config contract: one each)
        self.call_shapes: Dict[str, Set[Tuple]] = {
            "prefill": set(), "decode": set(), "reset": set()}
        #: call kind -> host seconds of each call, result on the host
        self.call_seconds: Dict[str, List[float]] = {
            "prefill": [], "decode": [], "reset": []}

    # ------------------------------------------------------------------
    # the three device calls
    # ------------------------------------------------------------------

    def _argmax(self, logits: torch.Tensor) -> np.ndarray:
        nxt = torch.argmax(logits[:, :self.cfg.vocab_size], dim=-1)
        return nxt.to(torch.int32).cpu().numpy()

    def _prefill(self, toks: np.ndarray, last_pos: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        self.call_shapes["prefill"].add((toks.shape, last_pos.shape))
        with torch.no_grad():
            logits, self.cache = lm.serve_prefill(
                self.cfg, self.params,
                {"tokens": torch.as_tensor(toks, device=self.device)},
                self.tp, self.cache,
                last_pos=torch.as_tensor(last_pos, device=self.device))
            nxt = self._argmax(logits)
        self.call_seconds["prefill"].append(time.perf_counter() - t0)
        return nxt

    def _decode(self, toks: np.ndarray, pos: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        self.call_shapes["decode"].add((toks.shape, pos.shape))
        with torch.no_grad():
            logits, self.cache = lm.serve_step(
                self.cfg, self.params, torch.as_tensor(toks, device=self.device),
                torch.as_tensor(pos, device=self.device), self.tp, self.cache)
            nxt = self._argmax(logits)
        self.call_seconds["decode"].append(time.perf_counter() - t0)
        return nxt

    def _reset(self, mask: np.ndarray) -> None:
        """Reset the rows of the slots in ``mask`` ((B,) bool) to the
        init_cache state, in place: int leaves -> -1 ("empty position"),
        float leaves -> 0."""
        t0 = time.perf_counter()
        self.call_shapes["reset"].add((mask.shape,))
        m = torch.as_tensor(mask, device=self.device)
        for leaf, ax in _leaves_with_axes(self.cache, self._axes):
            idx = [slice(None)] * leaf.dim()
            idx[ax.index("cache_batch")] = m
            leaf[tuple(idx)] = -1 if not leaf.is_floating_point() else 0
        self.call_seconds["reset"].append(time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # slot bookkeeping (host side)
    # ------------------------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self, queue: Deque[ServeRequest], now: float) -> List[int]:
        """Move arrived requests into free slots; resets their cache rows.
        Returns the admitted slot indices."""
        admitted = []
        mask = np.zeros(self.spec.slots, bool)
        for i in self._free_slots():
            if not queue or queue[0].arrival > now:
                break
            r = queue.popleft()
            r.t_admit = now
            self.slot_req[i] = r
            self.pending[i] = deque(int(t) for t in np.asarray(r.prompt))
            self.pos[i] = 0
            self.next_tok[i] = 0
            mask[i] = True
            admitted.append(i)
        if admitted:
            self._reset(mask)
        return admitted

    def _retire(self, i: int, now: float, truncated: bool,
                done: List[ServeRequest]) -> None:
        r = self.slot_req[i]
        r.truncated = truncated
        r.t_done = now
        done.append(r)
        self.slot_req[i] = None
        self.pending[i].clear()

    # ------------------------------------------------------------------
    # batched prefill (attention-only families, fresh batches)
    # ------------------------------------------------------------------

    def _can_prefill(self, slots: List[int]) -> bool:
        """Batched prefill is used when *every* active slot was admitted
        this instant (no slot holds live decode state the (B, P) prefill
        would clobber) and every prompt fits the prefill width."""
        if not self.is_transformer:
            return False
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if sorted(slots) != active:
            return False
        # a padded prefill wider than the physical cache would ring-evict
        # the *real* rows of a short prompt in favour of its padding
        if self.spec.prefill_len > self.cache_rows:
            return False
        return all(len(self.pending[i]) <= self.spec.prefill_len
                   for i in slots)

    def _prefill_wave(self, slots: List[int],
                      now: Callable[[], float]) -> None:
        B, P = self.spec.slots, self.spec.prefill_len
        toks = np.zeros((B, P), np.int32)
        last_pos = np.zeros(B, np.int32)
        for i in slots:
            prompt = list(self.pending[i])
            toks[i, :len(prompt)] = prompt        # left-aligned: exact
            last_pos[i] = len(prompt) - 1
            self.pending[i].clear()
        nxt = self._prefill(toks, last_pos)
        t = now()   # the first tokens exist once the wave has run
        for i in slots:
            r = self.slot_req[i]
            self.pos[i] = len(r.prompt)
            self.next_tok[i] = nxt[i]
            r.out.append(int(nxt[i]))
            r.t_first = t

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def run(self, requests: List[ServeRequest],
            clock: Callable[[], float] = time.monotonic,
            ) -> List[ServeRequest]:
        """Serve ``requests`` (open loop: each becomes admissible at its
        ``arrival`` offset) to completion; returns them in finish order
        with lifecycle timestamps filled in."""
        t0 = clock()
        now = lambda: clock() - t0  # noqa: E731
        queue: Deque[ServeRequest] = deque(
            sorted(requests, key=lambda r: (r.arrival, r.rid)))
        done: List[ServeRequest] = []
        B, T = self.spec.slots, self.spec.max_len

        while queue or any(r is not None for r in self.slot_req):
            t = now()
            admitted = self._admit(queue, t)
            if admitted and self._can_prefill(admitted):
                self._prefill_wave(admitted, now)
                # a prefilled request may already be done (max_new == 1)
                # or have spent its whole position budget on the prompt
                for i in admitted:
                    r = self.slot_req[i]
                    if r is None:
                        continue
                    if r.done:
                        self._retire(i, now(), truncated=False, done=done)
                    elif self.pos[i] >= T:
                        self._retire(i, now(), truncated=True, done=done)
                continue

            active = [i for i in range(B) if self.slot_req[i] is not None]
            if not active:
                # open loop: idle until the next arrival
                if queue:
                    wait = queue[0].arrival - now()
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
                continue

            # one decode step over all B slots (idle slots feed token 0
            # at their stale position; their output is discarded and
            # their rows are reset at the next admit)
            toks = np.array(self.next_tok, np.int32, copy=True)
            for i in active:
                if self.pending[i]:
                    toks[i] = self.pending[i].popleft()  # force-feed
            nxt = self._decode(toks, np.array(self.pos, np.int32, copy=True))
            t = now()
            for i in active:
                self.pos[i] += 1
                self.next_tok[i] = nxt[i]
                r = self.slot_req[i]
                if self.pending[i]:
                    # consumed a prompt token, more remain: no output yet
                    if self.pos[i] >= T:
                        self._retire(i, t, truncated=True, done=done)
                    continue
                r.out.append(int(nxt[i]))
                if r.t_first < 0:
                    r.t_first = t
                if r.done:
                    self._retire(i, t, truncated=False, done=done)
                elif self.pos[i] >= T:
                    # position budget exhausted before max_new tokens
                    self._retire(i, t, truncated=True, done=done)
        return done
