"""Shared simulation environment for all FL methods (paper §6.1 setup).

100 clients on synthetic non-IID data; latency profile with the paper's
five delay bands; 10 "unstable" clients that drop out permanently at a
random time; fixed seeds so every method sees identical partitions,
latencies, and dropout schedule.

The port of ``repro/core/simulation.py``: the same
``np.random.default_rng(seed)`` stream in the same order, so partitions,
latencies, tier maps and the dropout schedule equal the reference's
bitwise; the fault plane's transient churn windows, the population
plane's client state (core/population.py) and the topology plane's tree
(core/topology.py) come from their own dedicated streams, as there.  The
padded train stacks live on the environment's device, except on the
streaming population plane, which uploads one K-client batch a round
(core/executor.py).  The initial model comes from a ``torch.Generator``
seeded with ``seed``, or is injected (``params0=``, e.g. the reference's
as numpy; a nested tree, the LM's, is flattened to the model's flat
keys).  :meth:`SimEnv.evaluate` records the span ``eval.accuracy``
(spans.py) around the per-client forward and its read-back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import faults as faults_mod
from repro_torch.core import population as population_mod
from repro_torch.core import tiering
from repro_torch.core import topology as topology_mod
from repro_torch.core.clients import make_client_update, make_eval_fn
from repro_torch.data.federated import make_federated, pad_stack
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import registry as model_registry
from repro_torch.models.common import flatten_tree

PAPER_DELAY_BANDS = ((0.0, 0.0), (0.0, 5.0), (6.0, 10.0), (11.0, 15.0),
                     (20.0, 30.0))


@dataclasses.dataclass
class SimConfig:
    """The reference's SimConfig fields.  ``population`` and ``topology``
    take the planes' configs (None = the legacy data plane and the flat
    FedAT engine).  ``mesh`` names the mesh of the round step
    (launch/mesh.py grammar: None/"single" | "host[:n_pods]" |
    "production[:n_pods]"); with a data axis D > 1 the per-round client
    fan-out is split over its ranks (core/executor.py), and
    ``clients_per_round`` must pad to a multiple of D.  ``shard_tiers``
    lays the tier-model stack over the pod axis (a layout)."""
    model: str = "cnn"
    n_clients: int = 100
    n_classes: int = 10
    classes_per_client: int = 2
    samples_per_client: int = 60
    image_hw: int = 12
    n_features: int = 128
    vocab_size: int = 64
    seq_len: int = 16
    attention_backend: str = "auto"
    n_tiers: int = 5
    clients_per_round: int = 10
    local_epochs: int = 3
    batch_size: int = 10
    lr: float = 1e-3
    prox_lambda: float = 0.4
    n_unstable: int = 10
    base_compute: float = 1.0      # seconds per local round before delays
    seed: int = 0
    partitioner: str = "#class"
    delay_bands: Tuple[Tuple[float, float], ...] = PAPER_DELAY_BANDS
    dropout_window: Tuple[float, float] = (50.0, 400.0)
    churn_rate: float = 0.0
    churn_events: int = 2
    churn_downtime: float = 30.0
    churn_window: Tuple[float, float] = (50.0, 400.0)
    fault_seed: int = 0
    mesh: Optional[str] = None
    shard_tiers: bool = False
    population: Optional[population_mod.PopulationConfig] = None
    topology: Optional[topology_mod.TopologyConfig] = None


class SimEnv:
    """One materialized scenario: partitions, latencies/tiers, dropout
    schedule, model init, the device-resident data plane, and (optionally)
    the mesh the round step splits its clients over.

    ``sc.mesh`` names the mesh (launch/mesh.py grammar); with a data axis
    of size D > 1 each rank trains K/D of the round's clients, which
    requires ``clients_per_round % D == 0`` (checked here, before any
    round).  A shape-only (production) mesh cannot run a round and
    raises."""

    def __init__(self, sc: SimConfig, device: DeviceLike = None,
                 params0: Optional[Dict[str, Any]] = None):
        self.sc = sc
        self.device = resolve_device(device)
        rng = np.random.default_rng(sc.seed)

        # the mesh of the round step (None = one device), resolved per
        # environment; sized from this env's own mesh, never the ambient
        # one
        from repro_torch.launch import mesh as mesh_mod
        self.mesh = mesh_mod.resolve_mesh(sc.mesh)
        if self.mesh is not None:
            self.mesh.require_runnable("a federated round")
        self.data_axis = (self.mesh.shape.get("data", 1)
                          if self.mesh is not None else 1)
        # the per-round fan-out that must pad over the data axis is the
        # per-edge sample size under the topology plane, else the flat
        # clients_per_round — the error names the spec field that failed
        k, k_field = sc.clients_per_round, "tiers.clients_per_round"
        if sc.topology is not None and sc.topology.clients_per_edge:
            k, k_field = (sc.topology.clients_per_edge,
                          "topology.clients_per_edge")
        if k % self.data_axis:
            d = self.data_axis
            raise ValueError(
                f"{k_field}={k} does not pad to a multiple of the "
                f"mesh data axis (size {d}, mesh {sc.mesh!r}); use a "
                f"multiple of {d} (e.g. {((k + d - 1) // d) * d})")
        self.model = model_registry.build_model(
            sc.model, model_registry.DataDims(
                n_classes=sc.n_classes, image_hw=sc.image_hw,
                n_features=sc.n_features, vocab_size=sc.vocab_size,
                seq_len=sc.seq_len,
                attention_backend=sc.attention_backend))

        # population plane (None = the legacy data plane); its draws come
        # from dedicated spec-seeded streams, so the environment rng below
        # is untouched either way
        self.population = (None if sc.population is None
                           else population_mod.Population(
                               sc.population, sc, self.model))
        #: True when per-round batches are materialized on the host and
        #: uploaded instead of gathered from a resident stack
        self.streaming = (self.population is not None
                          and self.population.plane == "streaming")
        if self.population is not None and self.population.cfg.indexed:
            # indexed data plane: flat (N,) state arrays + lazy per-client
            # content streams; the test stack holds the eval subset only
            pop = self.population
            self.ds = None
            self.n_train_all = pop.n_train
            self.train = None if self.streaming else pop.materialize_stack()
            self.test = pop.test_stack(pop.eval_ids)
        else:
            self.ds = make_federated(
                task=self.model.data_kind, n_clients=sc.n_clients,
                n_classes=sc.n_classes,
                classes_per_client=sc.classes_per_client,
                samples_per_client=sc.samples_per_client,
                image_hw=sc.image_hw, n_features=sc.n_features,
                seed=sc.seed, partitioner=sc.partitioner,
                vocab_size=sc.vocab_size, seq_len=sc.seq_len)
            self.train = pad_stack(self.ds)
            self.n_train_all = self.train["n_samples"]
            self.test = self._stack_test()
            if (self.population is not None
                    and len(self.population.eval_ids) < sc.n_clients):
                ids = self.population.eval_ids
                self.test = {k: v[ids] for k, v in self.test.items()}

        # latency profile -> tiers (paper: 5 delay bands on top of compute)
        base = np.full(sc.n_clients, sc.base_compute)
        lat = tiering.profile_latencies(base, sc.delay_bands, rng)
        if (self.population is not None
                and self.population.resp_factors is not None):
            # per-client responsiveness multipliers reshape the tiers
            lat = lat * self.population.resp_factors
        self.tm = tiering.assign_tiers(lat, sc.n_tiers)

        # topology plane: silo/edge membership over the same profiled
        # latencies; None = flat FedAT.  The per-run link-delay stream
        # lives on the strategy, so a cached env stays shareable.
        self.topology = (None if sc.topology is None else
                         topology_mod.Topology(
                             sc.topology, sc.n_clients, lat,
                             sc.clients_per_round))

        # unstable clients drop permanently at a random time (+inf = stable)
        self.dropout_ids = rng.choice(sc.n_clients, sc.n_unstable,
                                      replace=False)
        self.dropout_at = np.full(sc.n_clients, np.inf)
        self.dropout_at[self.dropout_ids] = rng.uniform(
            *sc.dropout_window, size=sc.n_unstable)

        # transient churn windows on top of permanent dropout, drawn from
        # the dedicated fault stream so the environment rng above is
        # untouched; None when churn is off
        self.churn_down = faults_mod.churn_schedule(
            sc.n_clients, sc.churn_rate, sc.churn_events,
            sc.churn_downtime, sc.churn_window, sc.fault_seed)

        if params0 is None:
            gen = torch.Generator().manual_seed(sc.seed)
            params0 = self.model.init_params(gen)
        self.params0 = {
            k: (v.detach() if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v))).to(self.device).clone()
            for k, v in flatten_tree(params0).items()}
        self.update_fn = make_client_update(
            self.model, local_epochs=sc.local_epochs,
            batch_size=sc.batch_size, lr=sc.lr, prox_lambda=sc.prox_lambda)
        self.update_fn_noprox = make_client_update(
            self.model, local_epochs=sc.local_epochs,
            batch_size=sc.batch_size, lr=sc.lr, prox_lambda=0.0)
        self.eval_fn = make_eval_fn(self.model)
        self.model_bytes = sum(v.numel() * v.element_size()
                               for v in self.params0.values())

        # device-resident data plane: uploaded once, gathered per round
        # (the streaming plane has none: one K-client batch a round)
        self.train_dev = (None if self.train is None
                          else self.upload(self.train))
        self._test_dev = None
        self._executor = None

    @property
    def client_cap(self) -> int:
        """Padded train rows per client (the sample-slot axis)."""
        if self.train is not None:
            return int(self.train["y"].shape[1])
        return int(self.population.cap_train)

    def upload(self, stack: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host rows ``{x, y, mask}`` -> the device layout the round
        bodies read (int64 labels, float32 mask)."""
        return {"x": torch.from_numpy(stack["x"]).to(self.device),
                "y": torch.from_numpy(stack["y"]).to(self.device,
                                                     torch.int64),
                "mask": torch.from_numpy(stack["mask"]).to(self.device,
                                                           torch.float32)}

    def _stack_test(self):
        cap = max(len(c.y_test) for c in self.ds.clients)
        n = self.ds.n_clients
        xs = np.zeros((n, cap) + self.ds.input_shape, self.ds.input_dtype)
        ys = np.zeros((n, cap), np.int32)
        mask = np.zeros((n, cap), bool)
        for i, c in enumerate(self.ds.clients):
            k = len(c.y_test)
            xs[i, :k] = c.x_test
            ys[i, :k] = c.y_test
            mask[i, :k] = True
        return {"x": xs, "y": ys, "mask": mask}

    # ------------------------------------------------------------------
    def executor(self):
        """The cached round executor for this environment."""
        if self._executor is None:
            from repro_torch.core.executor import RoundExecutor
            self._executor = RoundExecutor(self)
        return self._executor

    def alive(self, now: float) -> np.ndarray:
        """Per-client availability at ``now``: not permanently dropped and
        not inside a transient churn down-window.  A client sampled while
        up can be down by the time its round completes — the strategies
        re-filter on completion, which is how mid-round failures shrink
        the participant set.  A population availability process is folded
        in too.  With churn and availability off this is the exact
        permanent-dropout compare."""
        up = self.dropout_at > now
        if self.churn_down is not None:
            starts, ends = self.churn_down
            down = ((starts <= now) & (now < ends)).any(axis=1)
            up = up & ~down
        if self.population is not None:
            avail = self.population.availability_mask(now)
            if avail is not None:
                up = up & avail
        return up

    def completion(self, now: float) -> Optional[np.ndarray]:
        """Per-client round-completion mask at ``now`` under the
        population plane's completion process, or None when no process is
        set (the strategies then keep the plain completion paths)."""
        if self.population is None:
            return None
        return self.population.completion_mask(now)

    def data_plane_bytes(self) -> int:
        """Peak device-resident data-plane bytes: the train stacks
        (resident planes) or the streamed per-round batch (the executor's
        high-water mark, or the static bound before any round ran), plus
        the eval test stack — counted in the reference's host layout
        (float32 x, int32 y, bool mask), so both packages report the same
        number for the same spec."""
        test = sum(np.asarray(v).nbytes for v in self.test.values())
        if self.train is not None:
            return test + sum(self.train[k].nbytes
                              for k in ("x", "y", "mask"))
        peak = (self._executor.stream_bytes
                if self._executor is not None
                and self._executor.stream_bytes else
                self.population.batch_nbytes(self.sc.clients_per_round))
        return test + peak

    def retier(self, rng: np.random.Generator, drift: float = 0.2) -> bool:
        """Re-profile client latencies and rebuild the tier map; returns
        True when any tier membership changed."""
        new_lat = tiering.drift_latencies(self.tm.latencies, rng, drift)
        old = self.tm
        self.tm = tiering.retier(self.tm, new_lat)
        return any(not np.array_equal(a, b)
                   for a, b in zip(old.members, self.tm.members))

    def sample_clients(self, pool: np.ndarray, k: int,
                       rng: np.random.Generator) -> np.ndarray:
        if len(pool) == 0:
            return pool
        k = min(k, len(pool))
        return rng.choice(pool, k, replace=False)

    @property
    def dropout_time(self) -> Dict[int, float]:
        """Dict view of the dropout schedule (derived from ``dropout_at``)."""
        return {int(c): float(self.dropout_at[c]) for c in self.dropout_ids}

    def client_batch(self, ids: np.ndarray) -> Dict[str, torch.Tensor]:
        """The train rows ``{x, y, mask}`` of clients ``ids`` on the
        device, in :meth:`upload`'s layout (materialized on demand on the
        streaming plane)."""
        if self.train is None:
            return self.upload(self.population.materialize(ids))
        return self.upload({k: self.train[k][ids] for k in ("x", "y", "mask")})

    def n_samples(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(self.n_train_all[ids])).to(
            self.device)

    def evaluate(self, params) -> Tuple[float, float]:
        """(weighted global accuracy, per-client accuracy variance)."""
        if self._test_dev is None:  # upload the test stack once
            self._test_dev = self.upload(self.test)
        t = self._test_dev
        with spans.span("eval.accuracy"):
            accs = self.eval_fn(params, t["x"], t["y"],
                                t["mask"]).cpu().numpy()
        weights = self.test["mask"].sum(1)
        glob = float((accs * weights).sum() / weights.sum())
        return glob, float(np.var(accs))
