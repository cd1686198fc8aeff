"""Population plane: indexed client state at 100k-1M scale.

The port of ``repro/core/population.py``, numpy only and draw for draw the
same: every rng family below is seeded as in the reference, so sizes,
class structure, templates, per-client rows and the slotted process masks
equal the reference's bitwise.

  * **Indexed content** — client c's samples come from the dedicated
    stream ``[seed, CONTENT_STREAM, c]``: any client can be materialized
    lazily, in any order.  Population-level structure (per-client sizes,
    class pools / dirichlet proportions, class templates) is drawn
    vectorized from its own streams, so building a 1M-client population
    is a few array draws, not a loop.
  * **Static row cap** — per-client sample counts are log-normal like the
    legacy generator but clipped to ``CAP_FACTOR * samples_per_client``,
    so every materialized batch/eval buffer shape is a function of the
    config only (the flat-memory invariant: peak device bytes do not grow
    with N).
  * **Stochastic client-state processes** (FLGo's availability /
    responsiveness / completion models): slotted Bernoulli availability
    folded into ``SimEnv.alive``, per-client latency multipliers folded
    into the tier profile, and a completion process the strategies
    consult when a round reports back.  All are pure functions of
    ``(spec seed, time slot)``, so crash-resume needs no snapshot state.

Plane selection (``PopulationConfig.plane``):

  * ``"legacy"``   — the sequential generator and full resident stack.
  * ``"stacked"``  — the indexed generator, materialized for all N and
    resident on the environment's device.
  * ``"streaming"``— the indexed generator, materialized per round for
    only the K sampled clients and uploaded (core/executor.py
    ``_round_data``): flat device memory at any N.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.data.federated import _class_templates, parse_partitioner
from repro_torch.data.pipeline import class_token_sequences

#: rng stream tags (seed-sequence entropy appended to ``population.seed``)
SIZE_STREAM = 0x512E5        # per-client sample counts (vectorized)
CLASS_STREAM = 0xC1A55       # class pools / dirichlet proportions
TEMPLATE_STREAM = 0x7E391    # class templates (image/features kinds)
CONTENT_STREAM = 0xC047E     # per-client sample content ([.., .., c])
AVAIL_STREAM = 0xA3A11       # slotted availability masks ([.., .., slot])
RESP_STREAM = 0x4E592        # per-client responsiveness multipliers
COMPL_STREAM = 0xC03B1       # slotted completion masks ([.., .., slot])
EVAL_STREAM = 0xE3A1C        # the eval-subset draw
PROFILE_STREAM = 0x9404E     # device-class membership (profile presets)

#: accepted data planes (PopulationConfig.plane)
PLANES = ("legacy", "stacked", "streaming")

#: static per-client row cap = CAP_FACTOR * samples_per_client (clipping
#: the log-normal size draw here is what makes device buffer shapes a
#: function of the config, not of N — the flat-memory invariant)
CAP_FACTOR = 4
#: legacy generator's size floor (data/federated.py ``max(.., 20)``)
MIN_SAMPLES = 20

#: default slot width (sim seconds) for the slotted Bernoulli processes
DEFAULT_PERIOD = 20.0

#: the ``phone`` device-class preset (``profile='phone:<frac>'``): a
#: diurnal sine availability wave, heavy-tailed responsiveness, and a
#: flaky completion process — the non-phone remainder of the population
#: stays always-on, unit-latency, and always-completing.
PHONE_AVAILABILITY = "sine:0.7,0.25,240"
PHONE_RESPONSIVENESS = "lognormal:0.5"
PHONE_COMPLETION = "bernoulli:0.9"

#: bound on cached per-slot process masks (a pure-function cache; cleared
#: wholesale when it grows past this, never invalidated)
_SLOT_CACHE_MAX = 1024


# ---------------------------------------------------------------------------
# process grammars
# ---------------------------------------------------------------------------

def parse_process(value: str, field: str, off: str):
    """``'<off>'`` -> None | ``'bernoulli:<p>[:<period>]'`` ->
    ``(p, period)`` | ``'sine:<p>,<amp>,<period>'`` ->
    ``("sine", p, amp, period)``.  Raises ValueError with the grammar.

    The sine form is a diurnal wave: within each ``DEFAULT_PERIOD``-wide
    slot the Bernoulli probability is
    ``clip(p + amp * sin(2*pi*t_mid / period), 0, 1)`` evaluated at the
    slot midpoint ``t_mid``, so availability swells and ebbs on a
    ``period``-second cycle while staying a pure function of
    ``(seed, slot)``."""
    s = str(value)
    if s == off:
        return None
    kind, _, rest = s.partition(":")
    if kind == "sine":
        try:
            p, amp, period = (float(v) for v in rest.split(","))
        except ValueError:
            raise ValueError(
                f"bad {field} process {value!r}; expected "
                f"'sine:<p>,<amp>,<period>' (e.g. 'sine:0.7,0.25,240')")
        if not 0.0 <= p <= 1.0:
            raise ValueError(
                f"{field} sine base probability must be in [0, 1], got {p}")
        if not amp >= 0:
            raise ValueError(
                f"{field} sine amplitude must be >= 0, got {amp}")
        if not period > 0:
            raise ValueError(f"{field} period must be > 0, got {period}")
        return "sine", p, amp, period
    if kind != "bernoulli":
        raise ValueError(
            f"unknown {field} process {value!r}; expected {off!r}, "
            f"'bernoulli:<p>[:<period>]' or 'sine:<p>,<amp>,<period>'")
    parts = rest.split(":") if rest else []
    if len(parts) not in (1, 2):
        raise ValueError(
            f"bad {field} process {value!r}; expected "
            f"'bernoulli:<p>[:<period>]'")
    try:
        p = float(parts[0])
        period = float(parts[1]) if len(parts) == 2 else DEFAULT_PERIOD
    except ValueError:
        raise ValueError(
            f"bad {field} process {value!r}; <p> and <period> must be "
            f"numbers (e.g. 'bernoulli:0.9:{DEFAULT_PERIOD:g}')")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"{field} probability must be in [0, 1], got {p}")
    if not period > 0:
        raise ValueError(f"{field} period must be > 0, got {period}")
    return p, period


def parse_responsiveness(value: str):
    """``'none'`` -> None | ``'lognormal:<sigma>'`` ->
    ("lognormal", sigma) | ``'uniform:<lo>,<hi>'`` ->
    ("uniform", (lo, hi)).  Raises ValueError with the grammar."""
    s = str(value)
    if s == "none":
        return None
    kind, _, arg = s.partition(":")
    if kind == "lognormal":
        try:
            sigma = float(arg)
        except ValueError:
            raise ValueError(
                f"bad responsiveness {value!r}; expected "
                f"'lognormal:<sigma>' (e.g. 'lognormal:0.5')")
        if not sigma >= 0:
            raise ValueError(
                f"responsiveness sigma must be >= 0, got {sigma}")
        return "lognormal", sigma
    if kind == "uniform":
        try:
            lo, hi = (float(v) for v in arg.split(","))
        except ValueError:
            raise ValueError(
                f"bad responsiveness {value!r}; expected "
                f"'uniform:<lo>,<hi>' (e.g. 'uniform:0.5,2.0')")
        if not 0 < lo <= hi:
            raise ValueError(
                f"responsiveness uniform bounds must satisfy 0 < lo <= hi, "
                f"got ({lo}, {hi})")
        return "uniform", (lo, hi)
    raise ValueError(
        f"unknown responsiveness process {value!r}; expected 'none', "
        f"'lognormal:<sigma>' or 'uniform:<lo>,<hi>'")


def parse_profile(value: str) -> Optional[float]:
    """``'none'`` -> None | ``'phone:<frac>'`` -> frac in (0, 1].  A
    profile bundles the three client-state processes for a device class
    (the ``PHONE_*`` presets) applied to a seeded ``frac`` fraction of
    the population; everyone else stays always-on.  Raises ValueError
    with the grammar."""
    s = str(value)
    if s == "none":
        return None
    kind, _, arg = s.partition(":")
    if kind != "phone":
        raise ValueError(
            f"unknown population profile {value!r}; expected 'none' or "
            f"'phone:<frac>' (e.g. 'phone:0.3')")
    try:
        frac = float(arg)
    except ValueError:
        raise ValueError(
            f"bad population profile {value!r}; <frac> must be a number "
            f"(e.g. 'phone:0.3')")
    if not 0.0 < frac <= 1.0:
        raise ValueError(
            f"population profile fraction must be in (0, 1], got {frac}")
    return frac


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    """Core-side mirror of :class:`repro_torch.api.spec.PopulationSpec`
    (held on :class:`~repro_torch.core.simulation.SimConfig`).  ``active``
    is False iff every knob is at its default (``seed`` alone is inert),
    in which case the spec bridge maps the section to ``population =
    None`` and the environment builds the exact legacy plane."""
    plane: str = "legacy"             # legacy | stacked | streaming
    availability: str = "always"      # always | bernoulli:.. | sine:..
    responsiveness: str = "none"      # none | lognormal:<s> | uniform:<lo>,<hi>
    completion: str = "none"          # none | bernoulli:<p>[:<period>]
    profile: str = "none"             # none | phone:<frac> (bundled preset)
    eval_clients: int = 0             # evaluate on a seeded subset (0 = all)
    seed: int = 0                     # dedicated population rng stream seed

    @property
    def indexed(self) -> bool:
        """True when the data plane uses the indexed generator."""
        return self.plane != "legacy"

    @property
    def active(self) -> bool:
        return (self.plane != "legacy" or self.availability != "always"
                or self.responsiveness != "none" or self.completion != "none"
                or self.profile != "none" or self.eval_clients > 0)


# ---------------------------------------------------------------------------
# the population
# ---------------------------------------------------------------------------

class Population:
    """Flat per-client state arrays + the indexed sample generator + the
    stochastic client-state processes for one materialized scenario.

    The data half (sizes, class structure, templates, ``materialize``)
    is only built for the indexed planes; a ``plane="legacy"``
    population carries just the processes and the eval subset on top of
    the legacy generator's data.
    """

    def __init__(self, cfg: PopulationConfig, sc, model):
        self.cfg = cfg
        self.sc = sc
        self.n = int(sc.n_clients)
        self._seed = int(cfg.seed)
        self.plane = cfg.plane

        # -- client-state processes (pure functions of (seed, slot)) ----
        # a profile preset supplies all three process strings and a
        # seeded device-class membership mask; the spec layer rejects
        # profile + explicit processes, so there is no merge to resolve
        avail_s, resp_s, compl_s = (cfg.availability, cfg.responsiveness,
                                    cfg.completion)
        frac = parse_profile(cfg.profile)
        self._phone: Optional[np.ndarray] = None
        if frac is not None:
            rng = np.random.default_rng([self._seed, PROFILE_STREAM])
            self._phone = rng.random(self.n) < frac
            avail_s, resp_s, compl_s = (PHONE_AVAILABILITY,
                                        PHONE_RESPONSIVENESS,
                                        PHONE_COMPLETION)
        self._avail = parse_process(avail_s, "availability", off="always")
        self._compl = parse_process(compl_s, "completion", off="none")
        self._avail_cache: Dict[int, np.ndarray] = {}
        self._compl_cache: Dict[int, np.ndarray] = {}
        resp = parse_responsiveness(resp_s)
        if resp is None:
            self.resp_factors = None
        else:
            rng = np.random.default_rng([self._seed, RESP_STREAM])
            kind, arg = resp
            self.resp_factors = (rng.lognormal(0.0, arg, self.n)
                                 if kind == "lognormal"
                                 else rng.uniform(*arg, self.n))
            if self._phone is not None:
                # non-phones keep unit latency; the full-N draw happens
                # first so the phone draws don't depend on the fraction
                self.resp_factors = np.where(self._phone,
                                             self.resp_factors, 1.0)

        # -- eval subset ------------------------------------------------
        if cfg.eval_clients <= 0 or cfg.eval_clients >= self.n:
            self.eval_ids = np.arange(self.n)
        else:
            rng = np.random.default_rng([self._seed, EVAL_STREAM])
            self.eval_ids = np.sort(
                rng.choice(self.n, cfg.eval_clients, replace=False))

        # -- indexed data plane -----------------------------------------
        if not cfg.indexed:
            return
        self.kind = "features" if model.data_kind == "text" \
            else model.data_kind
        if self.kind == "tokens":
            self.shape: Tuple[int, ...] = (sc.seq_len,)
            self.dtype = np.dtype(np.int32)
            self.templates = None
        else:
            self.shape = ((sc.image_hw, sc.image_hw, 3)
                          if self.kind == "image" else (sc.n_features,))
            self.dtype = np.dtype(np.float32)
            self.templates = _class_templates(
                np.random.default_rng([self._seed, TEMPLATE_STREAM]),
                sc.n_classes, self.shape)

        #: static row caps: clipping the size draw to ``cap`` is what
        #: makes materialized buffer shapes N-independent
        self.cap = max(CAP_FACTOR * int(sc.samples_per_client), MIN_SAMPLES)
        self.cap_train = int(0.8 * self.cap)
        self.cap_test = self.cap - self.cap_train

        # per-client sizes: vectorized log-normal (legacy distribution),
        # floored at MIN_SAMPLES like the legacy generator, ceiled at cap
        rng = np.random.default_rng([self._seed, SIZE_STREAM])
        raw = rng.lognormal(np.log(sc.samples_per_client), 0.3, self.n)
        self.sizes = np.clip(raw.astype(np.int64), MIN_SAMPLES,
                             self.cap).astype(np.int32)
        #: per-client train split (the Eq. 4 sample weights + pad counts)
        self.n_train = (0.8 * self.sizes).astype(np.int32)

        # class structure: one vectorized draw for all N clients
        part_kind, alpha = parse_partitioner(sc.partitioner)
        rng = np.random.default_rng([self._seed, CLASS_STREAM])
        self.probs = None
        self.pools = None
        if part_kind == "dirichlet":
            self.probs = rng.dirichlet(np.full(sc.n_classes, alpha),
                                       size=self.n)
        elif sc.classes_per_client < sc.n_classes:
            # without-replacement pools for all clients at once: argsort
            # of a uniform matrix is a vectorized permutation per row
            u = rng.random((self.n, sc.n_classes), dtype=np.float32)
            self.pools = np.argsort(u, axis=1, kind="stable")[
                :, :sc.classes_per_client].astype(np.int32)
        # else: i.i.d. — every client draws from all classes

    # -- indexed content ------------------------------------------------
    def client_rows(self, c: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """(x, y, n_train) for client ``c`` from its dedicated content
        stream — lazily indexable, order-independent, reproducible."""
        rng = np.random.default_rng([self._seed, CONTENT_STREAM, int(c)])
        n = int(self.sizes[c])
        sc = self.sc
        if self.probs is not None:
            y = rng.choice(sc.n_classes, n, p=self.probs[c]).astype(np.int32)
        elif self.pools is not None:
            y = rng.choice(self.pools[c], n).astype(np.int32)
        else:
            y = rng.choice(sc.n_classes, n).astype(np.int32)
        if self.kind == "tokens":
            x = class_token_sequences(rng, y, sc.vocab_size, sc.seq_len)
        else:
            x = self.templates[y] + rng.normal(
                0, 1.0, size=(n,) + self.shape).astype(np.float32)
        return x, y, int(self.n_train[c])

    def materialize(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        """Padded train rows for the sampled ids: ``{x, y, mask}`` with a
        fixed ``(len(ids), cap_train, ...)`` shape.  Duplicate ids (the
        executor's dead-slot padding repeats a live id) are generated
        once and copied, so a padded round costs the live clients only."""
        ids = np.asarray(ids)
        k = len(ids)
        xs = np.zeros((k, self.cap_train) + self.shape, self.dtype)
        ys = np.zeros((k, self.cap_train), np.int32)
        mask = np.zeros((k, self.cap_train), bool)
        rows = {int(c): self.client_rows(int(c)) for c in np.unique(ids)}
        for j, c in enumerate(ids):
            x, y, n_tr = rows[int(c)]
            xs[j, :n_tr] = x[:n_tr]
            ys[j, :n_tr] = y[:n_tr]
            mask[j, :n_tr] = True
        return {"x": xs, "y": ys, "mask": mask}

    def materialize_stack(self) -> Dict[str, np.ndarray]:
        """The full resident train stack (the ``stacked`` plane): the same
        rows ``materialize`` streams, for all N clients, plus the legacy
        ``n_samples`` key for the eager helpers."""
        stack = self.materialize(np.arange(self.n))
        stack["n_samples"] = self.n_train.copy()
        return stack

    def test_stack(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        """Padded per-client test rows for ``ids`` (the eval subset) in
        the same layout as :meth:`SimEnv._stack_test`."""
        ids = np.asarray(ids)
        k = len(ids)
        xs = np.zeros((k, self.cap_test) + self.shape, self.dtype)
        ys = np.zeros((k, self.cap_test), np.int32)
        mask = np.zeros((k, self.cap_test), bool)
        for j, c in enumerate(ids):
            x, y, n_tr = self.client_rows(int(c))
            t = len(y) - n_tr
            xs[j, :t] = x[n_tr:]
            ys[j, :t] = y[n_tr:]
            mask[j, :t] = True
        return {"x": xs, "y": ys, "mask": mask}

    def batch_nbytes(self, k: int) -> int:
        """Host/device bytes of one materialized k-client round batch (the
        streaming plane's peak data-plane footprint)."""
        row = (int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize
               + np.dtype(np.int32).itemsize + np.dtype(bool).itemsize)
        return int(k) * self.cap_train * row

    # -- processes ------------------------------------------------------
    def _slot_mask(self, now: float, proc, stream: int,
                   cache: Dict[int, np.ndarray]) -> Optional[np.ndarray]:
        if proc is None:
            return None
        if proc[0] == "sine":
            # diurnal wave: DEFAULT_PERIOD-wide slots, probability
            # evaluated at the slot midpoint of the sine cycle
            _, p0, amp, period = proc
            slot = int(now // DEFAULT_PERIOD)
            m = cache.get(slot)
            if m is None:
                if len(cache) > _SLOT_CACHE_MAX:
                    cache.clear()
                mid = (slot + 0.5) * DEFAULT_PERIOD
                p = float(np.clip(
                    p0 + amp * np.sin(2.0 * np.pi * mid / period), 0.0, 1.0))
                m = np.random.default_rng(
                    [self._seed, stream, slot]).random(self.n) < p
                cache[slot] = m
            return m
        p, period = proc
        slot = int(now // period)
        m = cache.get(slot)
        if m is None:
            if len(cache) > _SLOT_CACHE_MAX:
                cache.clear()
            m = np.random.default_rng(
                [self._seed, stream, slot]).random(self.n) < p
            cache[slot] = m
        return m

    def availability_mask(self, now: float) -> Optional[np.ndarray]:
        """(N,) bool availability at ``now`` (slotted Bernoulli or sine),
        or None when the process is off — ``SimEnv.alive`` then keeps the
        exact legacy expression.  Under a device-class profile the
        process only gates the profiled class; everyone else stays on."""
        m = self._slot_mask(now, self._avail, AVAIL_STREAM,
                            self._avail_cache)
        if m is not None and self._phone is not None:
            m = m | ~self._phone
        return m

    def completion_mask(self, now: float) -> Optional[np.ndarray]:
        """(N,) bool round-completion mask at ``now``, or None when the
        process is off.  Consulted by the strategies when a round reports
        back: a sampled, still-alive client can fail to return its
        update, shrinking the participant set (Eq. 4 renormalizes over
        the survivors inside the same fused step — no retrace).  Under a
        profile, non-profiled clients always complete."""
        m = self._slot_mask(now, self._compl, COMPL_STREAM,
                            self._compl_cache)
        if m is not None and self._phone is not None:
            m = m | ~self._phone
        return m
