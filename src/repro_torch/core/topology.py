"""Topology plane: hierarchical geo-distributed federation (the port of
``repro/core/topology.py``, numpy only; membership and delay draws equal
the reference's bitwise).

FedAT's flat layout is one hop: clients -> tiered server.  Production FL
is cross-device *and* cross-silo (Papaya, PAPERS.md): clients talk to a
nearby **edge** aggregator over a LAN-ish link, edges feed a regional
**silo**, and silos update the **global** server over WAN.  This module
is the declarative tree plus its deterministic network model:

* three **link classes** — ``client_edge``, ``edge_silo``,
  ``silo_global`` — each with its own delay band (drawn from the
  dedicated ``LINK_STREAM`` spec rng stream, so the population/fault
  planes' streams are untouched) and its own codec from the transport
  registry (WAN hops can compress harder than LAN hops, with per-link
  wire bytes accounted separately by the strategy);
* **region skew for free** — silos take contiguous client-id blocks, so
  under the ``#classes`` partitioner each silo sees a different label
  slice; edges within a silo are latency-tiered via
  :func:`~repro_torch.core.tiering.assign_tiers`;
* a deterministic **WAN skew ramp** — silo ``s`` multiplies its
  ``silo_global`` delay by ``1 + silo_skew * s``, so "the slow region"
  is a spec knob, not a roll of the dice;
* **delayed-gradient compensation** ("Stragglers Are Not Disaster",
  PAPERS.md): a silo trains from the global model it fetched at
  dispatch time; with ``compensation = lam > 0`` its update is corrected
  by ``lam * (w_now - w_dispatch)`` before entering Eq. 3, so stale
  silo updates are *repaired* rather than merely down-weighted.

The bitwise contract (pinned in tests/test_torch_topology.py): an absent
``topology`` section changes nothing, and the degenerate
single-silo/single-edge tree with zero-delay bands and default codecs is
bitwise-identical to the flat FedAT run with ``n_tiers=1`` — the extra
aggregation levels collapse to exact identities (x1.0 weighted averages
over singleton stacks), and zero-width uniform bands draw exactly 0.0
while still consuming their stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.core import tiering

#: the three hop classes of the clients -> edges -> silos -> global tree;
#: spec ``topology.delay`` / ``topology.codec`` dicts are keyed by these.
LINK_CLASSES = ("client_edge", "edge_silo", "silo_global")

#: dedicated rng stream for per-round link-delay draws
#: (``default_rng([seed, LINK_STREAM])``) — engine event order and the
#: population/fault streams never shift when delay bands change.
LINK_STREAM = 0x70B0A


@dataclass(frozen=True)
class TopologyConfig:
    """SimConfig payload for the topology plane (built by
    ``TopologySpec.to_config``; ``None`` on SimConfig = flat FedAT)."""
    n_silos: int = 1
    edges_per_silo: int = 1
    #: clients sampled per edge per round (0 = inherit
    #: ``tiers.clients_per_round``)
    clients_per_edge: int = 0
    #: ((link_class, lo, hi), ...) uniform delay bands in sim-time units
    delay: Tuple[Tuple[str, float, float], ...] = ()
    #: ((link_class, codec_name), ...) per-link codec overrides
    codec: Tuple[Tuple[str, str], ...] = ()
    #: delayed-gradient compensation strength lam in [0, 1]
    compensation: float = 0.0
    #: silo s multiplies its silo_global delay by ``1 + silo_skew * s``
    silo_skew: float = 0.0
    seed: int = 0

    def delay_band(self, link: str) -> Tuple[float, float]:
        for name, lo, hi in self.delay:
            if name == link:
                return float(lo), float(hi)
        return 0.0, 0.0

    def codec_name(self, link: str, default: str) -> str:
        for name, codec in self.codec:
            if name == link:
                return codec
        return default


class Topology:
    """The materialized tree: silo/edge membership over concrete client
    ids plus the link-delay model.  Built once per SimEnv (pure function
    of the config + the latency profile); all per-run draw *state* lives
    on the strategy via :meth:`new_link_rng` so cached envs stay
    shareable across runs.
    """

    def __init__(self, cfg: TopologyConfig, n_clients: int,
                 latencies: np.ndarray, k_round: int):
        S, E = cfg.n_silos, cfg.edges_per_silo
        if S * E > n_clients:
            raise ValueError(
                f"topology needs n_silos*edges_per_silo <= n_clients "
                f"({S}*{E} > {n_clients})")
        self.cfg = cfg
        self.n_silos = S
        self.edges_per_silo = E
        self.k_edge = int(cfg.clients_per_edge or k_round)
        # contiguous id blocks per silo: under the #classes partitioner
        # client order tracks label structure, so silos = skewed regions
        self.silo_members = [np.asarray(m) for m in
                             np.array_split(np.arange(n_clients), S)]
        # edges within a silo are latency tiers over the silo's members
        self.edge_members = []
        for mem in self.silo_members:
            tm = tiering.assign_tiers(latencies[mem], E)
            self.edge_members.append([mem[ids] for ids in tm.members])
        self.silo_mult = 1.0 + cfg.silo_skew * np.arange(S, dtype=np.float64)

    def new_link_rng(self) -> np.random.Generator:
        """Fresh per-run link-delay stream (strategy-owned, snapshotted
        for bitwise crash-resume)."""
        return np.random.default_rng([self.cfg.seed, LINK_STREAM])

    def draw_delays(self, rng: np.random.Generator, silo: int):
        """One scheduled silo round's link delays, in a fixed draw order
        (client_edge x E, edge_silo x E, silo_global x 1) so consumption
        per round is constant regardless of which edges sampled empty.
        Zero-width bands draw exactly 0.0 (numpy uniform(0, 0) == 0.0)
        while still advancing the stream."""
        E = self.edges_per_silo
        ce_lo, ce_hi = self.cfg.delay_band("client_edge")
        es_lo, es_hi = self.cfg.delay_band("edge_silo")
        sg_lo, sg_hi = self.cfg.delay_band("silo_global")
        ce = rng.uniform(ce_lo, ce_hi, E)
        es = rng.uniform(es_lo, es_hi, E)
        sg = float(rng.uniform(sg_lo, sg_hi)) * float(self.silo_mult[silo])
        return ce, es, sg
