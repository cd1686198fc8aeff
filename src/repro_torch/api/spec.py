"""Declarative experiment specification (the port's copy of the schema).

The same :class:`ExperimentSpec` as ``repro/api/spec.py``: the same nine
sections and fields, the same JSON documents, the same canonical JSON and
therefore the same content hash (the default spec hashes to
``60fd95ec9d49`` in both packages).  The device a run uses is *not* part of
the spec: it is an argument of ``api.build``.

Validation is the reference's, section for section, the mesh, fault,
population and topology sections included.  Every registered model is
ported, the ``tiny_lm`` LMs included.
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
from typing import Any, Dict, Optional, Tuple

from repro_torch.compress import transport
from repro_torch.core import population as population_mod
from repro_torch.core import topology as topology_mod
from repro_torch.core.simulation import PAPER_DELAY_BANDS, SimConfig

SPEC_VERSION = 7
_READABLE_VERSIONS = (1, 2, 3, 4, 5, 6, 7)

#: the attention backends the reference's transformer models accept
ATTENTION_BACKENDS = ("auto", "flash", "reference")


def _resolve_legacy_task(task: Any, existing_model: Optional[str]) -> str:
    """The ``data.task`` deprecation shim: map a v1/v2 task value to its
    registered model name, erroring on unknown values and on conflicts
    with an explicitly given ``data.model``."""
    from repro_torch.models.registry import LEGACY_TASKS
    if task not in LEGACY_TASKS:
        raise SpecError(
            f"data.task (deprecated) must be one of "
            f"{sorted(LEGACY_TASKS)}, got {task!r}; new specs should "
            f"name a registered model via data.model")
    model = LEGACY_TASKS[task]
    if existing_model is not None and existing_model != model:
        raise SpecError(
            f"data.task={task!r} (deprecated) conflicts with "
            f"data.model={existing_model!r}; drop the task key")
    return model


class SpecError(ValueError):
    """A spec failed validation; the message says how to fix it."""


def _strict_fields(cls, d: Dict[str, Any], section: str) -> Dict[str, Any]:
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise SpecError(
            f"unknown field(s) {unknown} in {section} spec; "
            f"valid fields: {sorted(fields)}")
    return d


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SpecError(msg)


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DataSpec:
    """What each client holds and trains.  ``model`` is a registry name;
    ``seed`` drives the whole environment materialization."""
    model: str = "cnn"
    n_clients: int = 100
    n_classes: int = 10
    partitioner: str = "#class"          # "#class" | "dirichlet:<alpha>"
    classes_per_client: int = 2          # used by the "#class" partitioner
    samples_per_client: int = 60
    image_hw: int = 12                   # image-kind models
    n_features: int = 128                # features-kind models
    vocab_size: int = 64                 # tokens-kind models
    seq_len: int = 16                    # tokens-kind models
    attention_backend: str = "auto"
    seed: int = 0

    def validate(self) -> None:
        from repro_torch.models import registry as model_registry
        if self.model in model_registry.UNPORTED_MODELS:
            raise SpecError(
                f"model {self.model!r} is not ported to the PyTorch package "
                f"yet (ROADMAP {model_registry.UNPORTED_MODELS[self.model]});"
                f" ported: {model_registry.registered_models()}")
        if self.model not in model_registry.MODELS:
            raise SpecError(
                f"unknown model {self.model!r}; "
                f"registered: {model_registry.registered_models()} "
                f"(register new ones via models/registry.register_model)")
        _require(self.vocab_size >= 2 and self.seq_len >= 2,
                 f"data.vocab_size and data.seq_len must be >= 2, got "
                 f"({self.vocab_size}, {self.seq_len})")
        _require(self.attention_backend in ATTENTION_BACKENDS,
                 f"data.attention_backend must be one of "
                 f"{ATTENTION_BACKENDS}, got {self.attention_backend!r}")
        _require(self.n_clients >= 1,
                 f"data.n_clients must be >= 1, got {self.n_clients}")
        _require(self.n_classes >= 2,
                 f"data.n_classes must be >= 2, got {self.n_classes}")
        _require(self.classes_per_client >= 1,
                 f"data.classes_per_client must be >= 1, "
                 f"got {self.classes_per_client}")
        _require(self.samples_per_client >= 1,
                 f"data.samples_per_client must be >= 1, "
                 f"got {self.samples_per_client}")
        from repro_torch.data.federated import parse_partitioner
        try:
            parse_partitioner(self.partitioner)
        except ValueError as e:
            raise SpecError(f"data.partitioner: {e}")


@dataclasses.dataclass
class TierSpec:
    """Latency tiers, the dropout profile, and re-tiering cadence."""
    n_tiers: int = 5
    clients_per_round: int = 10          # sample size per (tier) round
    delay_bands: Tuple[Tuple[float, float], ...] = PAPER_DELAY_BANDS
    base_compute: float = 1.0
    n_unstable: int = 10                 # permanent dropouts
    dropout_window: Tuple[float, float] = (50.0, 400.0)
    retier_every: int = 0
    retier_drift: float = 0.2

    def __post_init__(self):
        self.delay_bands = tuple(
            (float(lo), float(hi)) for lo, hi in self.delay_bands)
        self.dropout_window = tuple(float(v) for v in self.dropout_window)

    def validate(self, n_clients: int) -> None:
        _require(1 <= self.n_tiers <= n_clients,
                 f"tiers.n_tiers must be in [1, n_clients={n_clients}], "
                 f"got {self.n_tiers}")
        _require(self.clients_per_round >= 1,
                 f"tiers.clients_per_round must be >= 1, "
                 f"got {self.clients_per_round}")
        _require(len(self.delay_bands) >= 1,
                 "tiers.delay_bands needs at least one (lo, hi) band")
        for i, (lo, hi) in enumerate(self.delay_bands):
            _require(0 <= lo <= hi,
                     f"tiers.delay_bands[{i}] must satisfy 0 <= lo <= hi, "
                     f"got ({lo}, {hi})")
        _require(0 <= self.n_unstable <= n_clients,
                 f"tiers.n_unstable must be in [0, n_clients={n_clients}], "
                 f"got {self.n_unstable}")
        lo, hi = self.dropout_window
        _require(0 <= lo <= hi,
                 f"tiers.dropout_window must satisfy 0 <= lo <= hi, "
                 f"got ({lo}, {hi})")
        _require(self.retier_every >= 0,
                 f"tiers.retier_every must be >= 0 (0 = never), "
                 f"got {self.retier_every}")
        _require(0 <= self.retier_drift < 1,
                 f"tiers.retier_drift must be in [0, 1), "
                 f"got {self.retier_drift}")


@dataclasses.dataclass
class StrategySpec:
    """Server policy by registry name; kwargs are validated against the
    strategy constructor's signature."""
    name: str = "fedat"
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def validate(self) -> None:
        from repro_torch.core import strategies
        if self.name not in strategies.STRATEGIES:
            raise SpecError(
                f"unknown strategy {self.name!r}; "
                f"registered: {sorted(strategies.STRATEGIES)}")
        if "codec" in self.kwargs:
            raise SpecError(
                "the link codec belongs in transport.codec, not "
                "strategy.kwargs['codec'] (one spec field per dimension)")
        params = inspect.signature(
            strategies.STRATEGIES[self.name]).parameters
        bad = sorted(k for k in self.kwargs if k not in params)
        if bad:
            raise SpecError(
                f"strategy {self.name!r} does not accept kwargs {bad}; "
                f"accepted: {sorted(params)}")


@dataclasses.dataclass
class TransportSpec:
    """The link codec, by registry string (``none``, ``polyline:<p>``,
    ``quantize8``, ``quantize16``, ...).  ``None`` keeps each strategy's
    paper default."""
    codec: Optional[str] = None

    def validate(self) -> None:
        if self.codec is None:
            return
        try:
            transport.get_codec(self.codec)
        except ValueError as e:
            raise SpecError(f"transport.codec: {e}")


@dataclasses.dataclass
class EngineSpec:
    """Run budget and the local-training execution knobs."""
    total_updates: int = 200
    eval_every: int = 10
    seed: int = 0
    local_epochs: int = 3
    batch_size: int = 10
    lr: float = 1e-3
    prox_lambda: float = 0.4

    def validate(self) -> None:
        _require(self.total_updates >= 1,
                 f"engine.total_updates must be >= 1, "
                 f"got {self.total_updates}")
        _require(self.eval_every >= 1,
                 f"engine.eval_every must be >= 1, got {self.eval_every}")
        _require(self.local_epochs >= 1 and self.batch_size >= 1,
                 "engine.local_epochs and engine.batch_size must be >= 1")


@dataclasses.dataclass
class MeshSpec:
    """Device mesh for the round step (launch/mesh.py).

    * ``"single"`` — no mesh; the executor runs the single-device round
      bodies (the default, and the bitwise-parity anchor).
    * ``"host"`` — a mesh over the launched ranks (``python -m
      torch.distributed.run --nproc-per-node N``); ``n_pods > 1`` adds the
      pod (tier) axis.
    * ``"production"`` — the 256/512-device datacenter shapes (data axis
      16; ``n_pods=2`` adds the pod axis), read by the dry-run only.

    With a data axis of size D > 1 the per-round clients are split over
    it, which requires ``tiers.clients_per_round % D == 0`` — checked
    statically here when D is known (``single``/``production``), at
    environment build time for ``host`` (D is the world size).
    ``shard_tiers`` lays the (M, ...) tier-model stack over the pod axis.
    """
    kind: str = "single"                 # single | host | production
    n_pods: int = 1
    shard_tiers: bool = False

    def to_name(self) -> Optional[str]:
        """The :func:`repro_torch.launch.mesh.resolve_mesh` name
        (None = single)."""
        if self.kind == "single":
            return None
        return self.kind if self.n_pods == 1 else f"{self.kind}:{self.n_pods}"

    @classmethod
    def from_name(cls, name: Optional[str],
                  shard_tiers: bool = False) -> "MeshSpec":
        from repro_torch.launch import mesh as mesh_mod
        kind, n_pods = mesh_mod.parse_mesh_name(name)
        return cls(kind=kind, n_pods=n_pods, shard_tiers=shard_tiers)

    def validate(self, clients_per_round: int,
                 k_field: str = "tiers.clients_per_round") -> None:
        from repro_torch.launch import mesh as mesh_mod
        _require(self.kind in mesh_mod.MESH_KINDS,
                 f"mesh.kind must be one of {mesh_mod.MESH_KINDS}, "
                 f"got {self.kind!r}")
        _require(self.n_pods >= 1,
                 f"mesh.n_pods must be >= 1, got {self.n_pods}")
        if self.kind == "single":
            _require(self.n_pods == 1,
                     "mesh.n_pods > 1 needs mesh.kind 'host' or "
                     "'production' (a single device has no pod axis)")
        if self.kind == "production":
            _require(self.n_pods in (1, 2),
                     f"production mesh has 1 or 2 pods, "
                     f"got mesh.n_pods={self.n_pods}")
        if self.shard_tiers:
            _require(self.n_pods > 1,
                     "mesh.shard_tiers maps tiers onto the pod axis and "
                     "needs mesh.n_pods > 1")
        d = mesh_mod.STATIC_DATA_AXIS.get(self.kind)
        if d and clients_per_round % d:
            k = clients_per_round
            raise SpecError(
                f"{k_field}={k} does not pad to a multiple "
                f"of the {self.kind} mesh data axis (size {d}); use a "
                f"multiple of {d} (e.g. {((k + d - 1) // d) * d}).  For "
                f"'host' meshes this is checked at build time against the "
                f"actual device count.")


@dataclasses.dataclass
class FaultSpec:
    """Deterministic fault plane (core/faults.py).

    Every fault draw comes from a dedicated rng stream seeded by
    ``faults.seed``, so the all-defaults section is *exactly* the
    zero-fault engine.  Churn shapes the environment's availability
    windows; blackouts/poisoning/clipping act inside the engine loop;
    ``checkpoint_every`` enables bitwise crash-resume.
    """
    churn_rate: float = 0.0
    churn_events: int = 2
    churn_downtime: float = 30.0
    churn_window: Tuple[float, float] = (50.0, 400.0)
    blackouts: int = 0
    blackout_duration: float = 60.0
    blackout_window: Tuple[float, float] = (50.0, 400.0)
    nan_rate: float = 0.0
    update_clip: float = 0.0
    checkpoint_every: int = 0
    seed: int = 0

    def __post_init__(self):
        self.churn_window = tuple(float(v) for v in self.churn_window)
        self.blackout_window = tuple(float(v) for v in self.blackout_window)

    def validate(self) -> None:
        _require(0 <= self.churn_rate <= 1,
                 f"faults.churn_rate must be in [0, 1], "
                 f"got {self.churn_rate}")
        _require(self.churn_events >= 0,
                 f"faults.churn_events must be >= 0, "
                 f"got {self.churn_events}")
        _require(self.churn_downtime > 0,
                 f"faults.churn_downtime must be > 0, "
                 f"got {self.churn_downtime}")
        lo, hi = self.churn_window
        _require(0 <= lo <= hi,
                 f"faults.churn_window must satisfy 0 <= lo <= hi, "
                 f"got ({lo}, {hi})")
        _require(self.blackouts >= 0,
                 f"faults.blackouts must be >= 0, got {self.blackouts}")
        _require(self.blackout_duration > 0,
                 f"faults.blackout_duration must be > 0, "
                 f"got {self.blackout_duration}")
        lo, hi = self.blackout_window
        _require(0 <= lo <= hi,
                 f"faults.blackout_window must satisfy 0 <= lo <= hi, "
                 f"got ({lo}, {hi})")
        _require(0 <= self.nan_rate <= 1,
                 f"faults.nan_rate must be in [0, 1], got {self.nan_rate}")
        _require(self.update_clip >= 0,
                 f"faults.update_clip must be >= 0 (0 = off), "
                 f"got {self.update_clip}")
        _require(self.checkpoint_every >= 0,
                 f"faults.checkpoint_every must be >= 0 (0 = off), "
                 f"got {self.checkpoint_every}")


@dataclasses.dataclass
class PopulationSpec:
    """Million-client population plane (core/population.py).

    ``plane`` selects the data path: ``"legacy"`` (the default) keeps the
    seed generator and device-resident stacked train data — with every
    other field at its default this section maps to *no* population
    config at all, so golden trajectories are untouched.  ``"stacked"``
    switches to the indexed population generator (vectorized size/class
    draws, per-client content streams) with the full train stack still
    device-resident; ``"streaming"`` keeps the same generator but
    materializes only the K sampled clients' rows per round, so device
    memory stays flat in N (the 100k–1M regime).

    The stochastic client-state processes follow FLGo's taxonomy and are
    drawn from dedicated population rng streams seeded by ``seed``:

    * ``availability`` — ``"always"``, ``"bernoulli:<p>[:<period>]"``
      (per time-slot of length ``period``, default 20 sim-seconds, each
      client is available with probability p — fresh iid draw per slot),
      or the diurnal ``"sine:<p>,<amp>,<period>"`` (the slot probability
      follows ``clip(p + amp*sin(2*pi*t/period), 0, 1)``).
    * ``responsiveness`` — ``"none"``, ``"lognormal:<sigma>"`` or
      ``"uniform:<lo>,<hi>"``: a per-client latency multiplier applied
      to the profiled latencies *before* tier assignment.
    * ``completion`` — same grammar as availability: per-slot probability
      that a sampled client actually completes its round (incomplete
      clients are dropped before Eq. 4, which renormalizes over the
      survivors without retracing).

    ``profile`` bundles the three processes into device-class presets:
    ``"phone:<frac>"`` marks that fraction of clients as phone-like
    (diurnal sine availability, lognormal responsiveness, bernoulli
    completion — the ``core/population.PHONE_*`` presets) with the rest
    staying always-on; the class assignment draws from its own dedicated
    stream.
    A profile owns the process fields, so combining it with explicit
    non-default availability/responsiveness/completion is rejected.

    ``eval_clients`` caps the server-side eval set to a fixed random
    subset (0 = every client), which keeps the test stack O(1) in N.
    """
    #: "legacy" | "stacked" | "streaming" (see class docstring)
    plane: str = "legacy"
    availability: str = "always"
    responsiveness: str = "none"
    completion: str = "none"
    #: "none" or "phone:<frac>" — bundled device-class preset (owns the
    #: three process fields above)
    profile: str = "none"
    #: eval on a fixed random subset of this many clients (0 = all)
    eval_clients: int = 0
    #: the dedicated population rng stream seed
    seed: int = 0

    def validate(self, n_clients: int) -> None:
        _require(self.plane in population_mod.PLANES,
                 f"population.plane must be one of "
                 f"{population_mod.PLANES}, got {self.plane!r}")
        for field_name, value, off in (
                ("availability", self.availability, "always"),
                ("completion", self.completion, "none")):
            try:
                population_mod.parse_process(value, field_name, off)
            except ValueError as e:
                raise SpecError(f"population.{field_name}: {e}")
        try:
            population_mod.parse_responsiveness(self.responsiveness)
        except ValueError as e:
            raise SpecError(f"population.responsiveness: {e}")
        try:
            prof = population_mod.parse_profile(self.profile)
        except ValueError as e:
            raise SpecError(f"population.profile: {e}")
        if prof is not None and (self.availability != "always"
                                 or self.responsiveness != "none"
                                 or self.completion != "none"):
            raise SpecError(
                f"population.profile={self.profile!r} owns the "
                f"availability/responsiveness/completion processes; drop "
                f"the explicit process fields (or drop the profile)")
        _require(0 <= self.eval_clients <= n_clients,
                 f"population.eval_clients must be in "
                 f"[0, n_clients={n_clients}], got {self.eval_clients}")

    def to_config(self) -> Optional[population_mod.PopulationConfig]:
        """The :class:`SimConfig` payload; ``None`` when every knob is at
        its default (modulo seed), which is *exactly* the legacy plane."""
        cfg = population_mod.PopulationConfig(
            plane=self.plane, availability=self.availability,
            responsiveness=self.responsiveness, completion=self.completion,
            profile=self.profile,
            eval_clients=self.eval_clients, seed=self.seed)
        return cfg if cfg.active else None

    @classmethod
    def from_config(
            cls, pc: Optional[population_mod.PopulationConfig]
    ) -> "PopulationSpec":
        if pc is None:
            return cls()
        return cls(plane=pc.plane, availability=pc.availability,
                   responsiveness=pc.responsiveness,
                   completion=pc.completion, profile=pc.profile,
                   eval_clients=pc.eval_clients, seed=pc.seed)


@dataclasses.dataclass
class TopologySpec:
    """Hierarchical geo-distributed federation (core/topology.py).

    The tree is clients -> ``edges_per_silo`` edge aggregators per silo
    -> ``n_silos`` regional silos -> the global server.  Silos take
    contiguous client-id blocks (region skew under the ``#class``
    partitioner); edges within a silo are latency tiers.  Edges run the
    synchronous intra-tier Eq. 4 average; each silo enters the global
    Eq. 3 asynchronously with the straggler-aware cross weights (slow
    silos renormalize out during blackouts via the elastic layer).

    Each of the three link classes (``client_edge``, ``edge_silo``,
    ``silo_global``) takes an optional uniform delay band under
    ``delay`` (drawn per scheduled silo round from the dedicated
    topology rng stream, composing with population responsiveness and
    fault churn) and an optional codec override under ``codec``
    (``client_edge`` defaults to the strategy/transport codec,
    the WAN hops default to ``none``); per-link wire bytes are
    accounted separately by the strategy.  ``compensation`` is the
    delayed-gradient strength ``lam``: a silo's update is corrected by
    ``lam * (w_global_now - w_global_at_dispatch)`` before Eq. 3
    ("Stragglers Are Not Disaster", PAPERS.md).

    The all-defaults section maps to *no* topology config (the flat
    FedAT engine, bitwise); the degenerate 1-silo/1-edge zero-delay
    tree is pinned bitwise against the flat ``n_tiers=1`` run.
    """
    n_silos: int = 1
    edges_per_silo: int = 1
    #: clients sampled per edge per round (0 = tiers.clients_per_round)
    clients_per_edge: int = 0
    #: per-link-class [lo, hi] uniform delay bands, e.g.
    #: {"silo_global": [5, 20]}
    delay: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    #: per-link-class codec overrides, e.g. {"silo_global": "quantize8"}
    codec: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: delayed-gradient compensation strength lam in [0, 1] (0 = off)
    compensation: float = 0.0
    #: silo s multiplies its silo_global delay by 1 + silo_skew * s
    silo_skew: float = 0.0
    #: the dedicated topology rng stream seed
    seed: int = 0

    def __post_init__(self):
        self.delay = {k: tuple(float(x) for x in v)
                      for k, v in self.delay.items()}
        self.codec = dict(self.codec)

    def validate(self, n_clients: int) -> None:
        _require(self.n_silos >= 1 and self.edges_per_silo >= 1,
                 f"topology.n_silos and topology.edges_per_silo must be "
                 f">= 1, got ({self.n_silos}, {self.edges_per_silo})")
        _require(self.n_silos * self.edges_per_silo <= n_clients,
                 f"topology needs n_silos * edges_per_silo <= "
                 f"n_clients={n_clients}, got "
                 f"{self.n_silos} * {self.edges_per_silo}")
        _require(self.clients_per_edge >= 0,
                 f"topology.clients_per_edge must be >= 0 (0 = inherit "
                 f"tiers.clients_per_round), got {self.clients_per_edge}")
        for field_name, mapping in (("delay", self.delay),
                                    ("codec", self.codec)):
            unknown = sorted(set(mapping) - set(topology_mod.LINK_CLASSES))
            if unknown:
                raise SpecError(
                    f"topology.{field_name} names unknown link class(es) "
                    f"{unknown}; the tree (clients -> edges -> silos -> "
                    f"global) has exactly these link classes: "
                    f"{list(topology_mod.LINK_CLASSES)}")
        for link, band in self.delay.items():
            _require(len(band) == 2 and 0 <= band[0] <= band[1],
                     f"topology.delay[{link!r}] must be [lo, hi] with "
                     f"0 <= lo <= hi, got {list(band)}")
        for link, codec in self.codec.items():
            try:
                transport.get_codec(codec)
            except ValueError as e:
                raise SpecError(f"topology.codec[{link!r}]: {e}")
        _require(0 <= self.compensation <= 1,
                 f"topology.compensation must be in [0, 1], "
                 f"got {self.compensation}")
        _require(self.silo_skew >= 0,
                 f"topology.silo_skew must be >= 0, got {self.silo_skew}")

    def to_config(self) -> Optional[topology_mod.TopologyConfig]:
        """The :class:`SimConfig` payload; ``None`` when every knob is at
        its default (modulo seed), which is *exactly* the flat engine."""
        if (self.n_silos == 1 and self.edges_per_silo == 1
                and self.clients_per_edge == 0 and not self.delay
                and not self.codec and self.compensation == 0
                and self.silo_skew == 0):
            return None
        return topology_mod.TopologyConfig(
            n_silos=self.n_silos, edges_per_silo=self.edges_per_silo,
            clients_per_edge=self.clients_per_edge,
            delay=tuple((k, lo, hi)
                        for k, (lo, hi) in sorted(self.delay.items())),
            codec=tuple(sorted(self.codec.items())),
            compensation=self.compensation, silo_skew=self.silo_skew,
            seed=self.seed)

    @classmethod
    def from_config(
            cls, tc: Optional[topology_mod.TopologyConfig]
    ) -> "TopologySpec":
        if tc is None:
            return cls()
        return cls(n_silos=tc.n_silos, edges_per_silo=tc.edges_per_silo,
                   clients_per_edge=tc.clients_per_edge,
                   delay={k: (lo, hi) for k, lo, hi in tc.delay},
                   codec=dict(tc.codec),
                   compensation=tc.compensation, silo_skew=tc.silo_skew,
                   seed=tc.seed)


# ---------------------------------------------------------------------------
# the composed spec
# ---------------------------------------------------------------------------

_SECTIONS = {"data": DataSpec, "tiers": TierSpec, "strategy": StrategySpec,
             "transport": TransportSpec, "engine": EngineSpec,
             "mesh": MeshSpec, "faults": FaultSpec,
             "population": PopulationSpec, "topology": TopologySpec}


@dataclasses.dataclass
class ExperimentSpec:
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    tiers: TierSpec = dataclasses.field(default_factory=TierSpec)
    strategy: StrategySpec = dataclasses.field(default_factory=StrategySpec)
    transport: TransportSpec = dataclasses.field(
        default_factory=TransportSpec)
    engine: EngineSpec = dataclasses.field(default_factory=EngineSpec)
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    faults: FaultSpec = dataclasses.field(default_factory=FaultSpec)
    population: PopulationSpec = dataclasses.field(
        default_factory=PopulationSpec)
    topology: TopologySpec = dataclasses.field(default_factory=TopologySpec)

    # -- validation -----------------------------------------------------
    def validate(self) -> "ExperimentSpec":
        self.data.validate()
        self.tiers.validate(self.data.n_clients)
        self.strategy.validate()
        self.transport.validate()
        self.engine.validate()
        self.mesh.validate(self.tiers.clients_per_round)
        self.faults.validate()
        self.population.validate(self.data.n_clients)
        self.topology.validate(self.data.n_clients)
        if self.topology.to_config() is not None:
            if self.topology.clients_per_edge:
                self.mesh.validate(self.topology.clients_per_edge,
                                   k_field="topology.clients_per_edge")
            _require(self.strategy.name == "fedat",
                     f"the topology plane runs the tiered FedAT strategy "
                     f"(edges = Eq. 4, silos = Eq. 3); got "
                     f"strategy.name={self.strategy.name!r} — drop the "
                     f"topology section or use fedat")
            _require(self.faults.nan_rate == 0
                     and self.faults.update_clip == 0,
                     "the server-side validation gate (faults.nan_rate / "
                     "faults.update_clip) is not supported under the "
                     "topology plane yet; churn, blackouts and "
                     "crash-resume all compose")
        return self

    # -- serialization --------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["tiers"]["delay_bands"] = [list(b)
                                     for b in self.tiers.delay_bands]
        d["tiers"]["dropout_window"] = list(self.tiers.dropout_window)
        d["faults"]["churn_window"] = list(self.faults.churn_window)
        d["faults"]["blackout_window"] = list(self.faults.blackout_window)
        d["topology"]["delay"] = {k: list(v) for k, v
                                  in self.topology.delay.items()}
        d["spec_version"] = SPEC_VERSION
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        d = dict(d)
        version = d.pop("spec_version", SPEC_VERSION)
        if version not in _READABLE_VERSIONS:
            raise SpecError(f"spec_version {version} not supported "
                            f"(this build reads {_READABLE_VERSIONS} and "
                            f"writes {SPEC_VERSION})")
        unknown = sorted(set(d) - set(_SECTIONS))
        if unknown:
            raise SpecError(f"unknown section(s) {unknown} in experiment "
                            f"spec; valid sections: {sorted(_SECTIONS)}")
        parts = {}
        for name, section_cls in _SECTIONS.items():
            sub = d.get(name, {})
            if not isinstance(sub, dict):
                raise SpecError(f"section {name!r} must be an object, "
                                f"got {type(sub).__name__}")
            if name == "data":
                sub = cls._migrate_task(dict(sub))
            parts[name] = section_cls(
                **_strict_fields(section_cls, sub, name))
        return cls(**parts)

    @staticmethod
    def _migrate_task(data: Dict[str, Any]) -> Dict[str, Any]:
        """Deprecation shim: the v1/v2 ``data.task`` enum migrates to
        ``data.model`` (image -> cnn, text -> logreg)."""
        if "task" not in data:
            return data
        task = data.pop("task")
        data["model"] = _resolve_legacy_task(task, data.get("model"))
        return data

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    # -- provenance -----------------------------------------------------
    def canonical_json(self) -> str:
        """Key-sorted, whitespace-free JSON: the hash input."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def hash(self) -> str:
        """Stable 12-hex content hash for result provenance."""
        return hashlib.sha256(
            self.canonical_json().encode()).hexdigest()[:12]

    def env_dict(self) -> Dict[str, Any]:
        """The sub-dict that determines :class:`SimEnv` materialization
        (the environment cache key), as in the reference."""
        d = self.to_dict()
        tiers = d["tiers"]
        tiers.pop("retier_every"), tiers.pop("retier_drift")
        eng = d["engine"]
        local = {k: eng[k] for k in ("local_epochs", "batch_size", "lr",
                                     "prox_lambda")}
        f = d["faults"]
        churn = {k: f[k] for k in ("churn_rate", "churn_events",
                                   "churn_downtime", "churn_window",
                                   "seed")}
        return {"data": d["data"], "tiers": tiers, "local": local,
                "mesh": d["mesh"], "churn": churn,
                "population": d["population"],
                "topology": d["topology"]}

    def env_hash(self) -> str:
        return hashlib.sha256(json.dumps(
            self.env_dict(), sort_keys=True,
            separators=(",", ":")).encode()).hexdigest()[:12]

    # -- overrides ------------------------------------------------------
    def with_overrides(self, overrides: Dict[str, Any]) -> "ExperimentSpec":
        """A new spec with dotted-path fields replaced, e.g.
        ``{"strategy.name": "fedavg", "transport.codec": "quantize8"}``.
        Unknown paths raise :class:`SpecError`; new keys may only be
        created under the open dicts (``strategy.kwargs``,
        ``topology.delay``, ``topology.codec``)."""
        overrides = dict(overrides)
        if "data.task" in overrides:
            overrides["data.model"] = _resolve_legacy_task(
                overrides.pop("data.task"), overrides.get("data.model"))
        d = self.to_dict()
        for path, value in overrides.items():
            parts = path.split(".")
            cur: Any = d
            for i, p in enumerate(parts[:-1]):
                if not isinstance(cur, dict) or p not in cur:
                    raise SpecError(
                        f"unknown spec path {path!r}: no section "
                        f"{'.'.join(parts[:i + 1])!r}; top-level sections: "
                        f"{sorted(_SECTIONS)}")
                cur = cur[p]
            leaf = parts[-1]
            open_dict = len(parts) >= 2 and (
                parts[-2] == "kwargs"
                or (parts[0] == "topology"
                    and parts[-2] in ("delay", "codec")))
            if not isinstance(cur, dict) or (leaf not in cur
                                             and not open_dict):
                raise SpecError(
                    f"unknown spec field {path!r}; valid fields under "
                    f"{'.'.join(parts[:-1]) or 'the spec root'}: "
                    f"{sorted(cur) if isinstance(cur, dict) else '<leaf>'}")
            cur[leaf] = value
        return ExperimentSpec.from_dict(d)

    # -- bridge to the core layer ---------------------------------------
    def to_sim_config(self) -> SimConfig:
        """Materialization recipe for :class:`~repro_torch.core.
        simulation.SimEnv`."""
        return SimConfig(
            model=self.data.model, n_clients=self.data.n_clients,
            n_classes=self.data.n_classes,
            classes_per_client=self.data.classes_per_client,
            samples_per_client=self.data.samples_per_client,
            image_hw=self.data.image_hw, n_features=self.data.n_features,
            vocab_size=self.data.vocab_size, seq_len=self.data.seq_len,
            attention_backend=self.data.attention_backend,
            n_tiers=self.tiers.n_tiers,
            clients_per_round=self.tiers.clients_per_round,
            local_epochs=self.engine.local_epochs,
            batch_size=self.engine.batch_size, lr=self.engine.lr,
            prox_lambda=self.engine.prox_lambda,
            n_unstable=self.tiers.n_unstable,
            base_compute=self.tiers.base_compute, seed=self.data.seed,
            partitioner=self.data.partitioner,
            delay_bands=self.tiers.delay_bands,
            dropout_window=self.tiers.dropout_window,
            mesh=self.mesh.to_name(), shard_tiers=self.mesh.shard_tiers,
            churn_rate=self.faults.churn_rate,
            churn_events=self.faults.churn_events,
            churn_downtime=self.faults.churn_downtime,
            churn_window=self.faults.churn_window,
            fault_seed=self.faults.seed,
            population=self.population.to_config(),
            topology=self.topology.to_config())

    @classmethod
    def from_sim_config(cls, sc: SimConfig) -> "ExperimentSpec":
        """The inverse bridge: a truthful spec echo for runs driven through
        an already-built environment (the legacy ``run_*`` wrappers)."""
        return cls(
            data=DataSpec(
                model=sc.model, n_clients=sc.n_clients,
                n_classes=sc.n_classes, partitioner=sc.partitioner,
                classes_per_client=sc.classes_per_client,
                samples_per_client=sc.samples_per_client,
                image_hw=sc.image_hw, n_features=sc.n_features,
                vocab_size=sc.vocab_size, seq_len=sc.seq_len,
                attention_backend=sc.attention_backend,
                seed=sc.seed),
            tiers=TierSpec(
                n_tiers=sc.n_tiers, clients_per_round=sc.clients_per_round,
                delay_bands=sc.delay_bands, base_compute=sc.base_compute,
                n_unstable=sc.n_unstable,
                dropout_window=sc.dropout_window),
            engine=EngineSpec(
                local_epochs=sc.local_epochs, batch_size=sc.batch_size,
                lr=sc.lr, prox_lambda=sc.prox_lambda),
            mesh=MeshSpec.from_name(sc.mesh, shard_tiers=sc.shard_tiers),
            faults=FaultSpec(
                churn_rate=sc.churn_rate, churn_events=sc.churn_events,
                churn_downtime=sc.churn_downtime,
                churn_window=sc.churn_window, seed=sc.fault_seed),
            population=PopulationSpec.from_config(sc.population),
            topology=TopologySpec.from_config(sc.topology))
