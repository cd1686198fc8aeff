"""Device-resident round execution (the port of ``repro/core/executor.py``).

Per popped event a strategy calls one round method; each runs, on the
environment's device:

* FedAT (:meth:`RoundExecutor.fedat_round`, Algorithm 1 steps 1-5):
  downlink ``codec.lossy`` -> gather of the sampled clients' rows from the
  resident train stacks -> local prox+Adam training of the K clients as one
  client-batched model -> uplink ``codec.lossy`` -> Eq. 4 intra-tier
  average -> tier-slot update -> Eq. 3 cross-tier average.
* FedAvg/TiFL (:meth:`fedavg_round`) and FedAsync (:meth:`fedasync_round`).
* FedAT under the topology plane (:meth:`fedat_topology_round`): one silo
  round over its E edges x K_edge sampled clients.
* With the fault plane's gate (``gate=``, core/steps.py), FedAT and
  FedAvg/TiFL rounds take a separate gated body: after the uplink decode
  the poisoned slots are NaN'd, the gate zero-weights non-finite clients,
  clips deltas from the decoded downlink and renormalizes Eq. 4, and a
  round with no surviving client keeps the previous tier slot (FedAT) or
  model (FedAvg).  ``gate=None`` runs the ungated bodies unchanged.

**Streaming population plane**: there is no resident train stack; the
sampled clients' padded rows are materialized on the host each round
(``Population.materialize``) and uploaded, and the round bodies read them
in place of the resident gather (:meth:`_round_data`).  Dead slots repeat
a live id's rows, so the upload equals the gather of the stacked plane
byte for byte.

**Fixed-shape padding contract** (kept from the reference): a sample of
``n`` live clients is padded to ``clients_per_round`` slots by repeating a
live id with a zero Eq. 4 weight; exactly-zero terms leave the weighted sum
unchanged, so every round has the same shapes.

**Permutations.**  The reference shuffles each client's samples per epoch
with ``jax.random.permutation`` from keys split off the event's
``draw_seed``.  Here the executor's ``perm_source(seed, n_live, n_slots)``
returns the ``(n_slots, E, cap)`` permutations; the default draws them
from a CPU ``torch.Generator`` seeded with ``seed`` (the same permutations
on any device), and tests substitute the reference's own key path.

**Spans** (spans.py): ``fedat.round`` around each FedAT round, gated or
not, with the children ``round.perms`` (the draw and its upload),
``round.data``, ``codec.down``, ``client.update`` (core/clients.py),
``codec.up``, ``round.eq4`` and ``round.eq3``, in that order; with tracing
on, the counters ``client.slots`` and ``client.real_samples``
(:meth:`RoundExecutor._count_samples`).

Execution is eager.  The Eq. 4 / Eq. 3 weight vectors are computed on the
host (numpy twins in core/aggregation.py) and uploaded per event.  The
tier-model stack is updated in place (the strategy owns it).
``trace_counts`` keeps the reference's step keys: each round-body
configuration that ran, counted once (there is no trace to repeat).

**Client sharding on a mesh.**  When the environment's mesh has a
``data`` axis of size D > 1 (one rank a device, every rank running the
same host program with the same draws), rank r trains the padded clients
``[r*K/D, (r+1)*K/D)``: the downlink lossy step on the whole global model,
local training of its K/D clients, the uplink lossy step on them (one B1
launch a link, as on one device), and the fp32 products ``w_intra *
leaf`` summed over its clients; one ``all_reduce`` over the data group
completes Eq. 4 (:meth:`_intra_average`).  Everything after it (tier-slot
write, Eq. 3) runs whole on every rank.  The FedAT and FedAvg/TiFL steps
take keys ``(..., "dataD")``; FedAsync trains one client and is the same
under any mesh; the gated bodies and the topology round refuse D > 1, as
the reference's do.  With D == 1 (no mesh, or a one-rank mesh) the same
bodies take all K slots: no collective, the single-device keys.  D > 1
matches the single-device trajectory within a tolerance only: the sum
over ranks re-associates Eq. 4, and the uplink codec groups its blocks
per rank.

**Tier stacks over ``pod``** (``SimConfig.shard_tiers`` on a mesh with a
``pod`` axis of P > 1, where the reference pins the stack to the pod axis:
the client-sharded FedAT round and the topology round).  Each rank holds
its pod's slots of the (M, ...) tier (or silo) stack
(:meth:`RoundExecutor.tier_slots`, the rule ``"tiers": "pod"``), and the
strategy allocates only those.  A round writes the new tier model on the
ranks that own its slot (every rank has it whole after Eq. 4's
``all_reduce``); Eq. 3 takes the fp32 products summed over a rank's own
slots, and one ``all_reduce`` over the pod group completes it, as
:meth:`_intra_average` completes Eq. 4 over ``data``.  When P does not
divide M the stack stays whole on every rank, as the reference's
``with_sharding_constraint`` leaves it (five tiers over two pods).  The
per-silo ``dispatch`` stack stays whole.  Snapshots gather the stack
(:meth:`RoundExecutor.whole_tiers`), so they restore under any pod count.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import spans
from repro_torch.core import aggregation
from repro_torch.core import steps as fl_steps
from repro_torch.runtime import sharding as shd

Params = Dict[str, torch.Tensor]
PermSource = Callable[[int, int, int], torch.Tensor]


class RoundExecutor:
    """Owns the per-round data selection and the round bodies for one
    :class:`~repro_torch.core.simulation.SimEnv`.

    ``perm_source`` (see module doc) may be replaced by the caller; it is
    a plain attribute.
    """

    def __init__(self, env, perm_source: Optional[PermSource] = None):
        self.env = env
        self.K = int(env.sc.clients_per_round)
        self.device = env.device
        self.perm_source: PermSource = perm_source or self.torch_perms
        #: the env's mesh (None = one device) and its data-axis size D;
        #: D > 1 runs the client-sharded bodies, D == 1 the single-device
        #: ones unchanged
        self.mesh = env.mesh
        self.D = int(env.data_axis)
        assert self.K % self.D == 0, "SimEnv validates divisibility"
        #: this rank's padded client slots (all of them at D == 1) and the
        #: step keys' mesh tag
        self._shard = slice(None)
        self._dtag: Tuple[str, ...] = ()
        if self.D > 1:
            r, k = self.mesh.coord("data"), self.K // self.D
            self._shard = slice(r * k, (r + 1) * k)
            self._dtag = (f"data{self.D}",)
            self._group = self.mesh.group("data")[0]
        #: lay the (M, ...) tier stack over the mesh's pod axis (the
        #: reference's condition: the flag, a mesh, and pod > 1)
        self.shard_tiers = (bool(env.sc.shard_tiers) and self.mesh is not None
                            and self.mesh.shape.get("pod", 1) > 1)
        if self.shard_tiers:
            self._pod_group, self._pod_ranks = self.mesh.group("pod")
        self.streaming = bool(env.streaming)
        self._tag: Tuple[str, ...] = ("stream",) if self.streaming else ()
        #: step key -> 1 for each round-body configuration that ran
        self.trace_counts: Dict[tuple, int] = {}
        #: topology plane: a silo round fans out over E edges x K_edge
        #: client slots; None = flat
        self.topo = env.topology
        if self.topo is not None:
            self.E = int(self.topo.edges_per_silo)
            self.K_edge = int(self.topo.k_edge)
        #: high-water mark of the streamed per-round batch bytes (0 until
        #: a streaming round runs; SimEnv.data_plane_bytes reads it)
        self.stream_bytes = 0

    # ------------------------------------------------------------------
    # host-side marshalling (tiny per-event vectors)
    # ------------------------------------------------------------------
    def _pad_ids(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(ids (n,)) -> (padded ids (K,), padded sample counts (K,)).

        Dead slots repeat a live id (valid gather target, finite params)
        and get sample count 0, which zeroes them out of Eq. 4 exactly.
        """
        n = len(ids)
        pid = np.empty(self.K, np.int32)
        pid[:n] = ids
        pid[n:] = ids[0] if n else 0
        ns = np.zeros(self.K, np.float32)
        ns[:n] = self.env.n_train_all[ids]
        return pid, ns

    def torch_perms(self, seed: int, n_live: int, n_slots: int
                    ) -> torch.Tensor:
        """Default permutation source: ``n_slots x E`` permutations of the
        sample slots from a CPU generator seeded with ``seed``."""
        sc = self.env.sc
        cap = self.env.client_cap
        g = torch.Generator().manual_seed(int(seed))
        return torch.stack([
            torch.stack([torch.randperm(cap, generator=g)
                         for _ in range(sc.local_epochs)])
            for _ in range(n_slots)])

    def _perms(self, seed: int, n_live: int, n_slots: int,
               ns: Optional[np.ndarray] = None) -> torch.Tensor:
        """The round's permutations on the device.  With the slots' sample
        counts ``ns`` and tracing on, first counts the round's sample
        slots and the real samples among them, from the permutations as
        the source gave them (on the host, for the default source)."""
        perms = self.perm_source(seed, n_live, n_slots)
        if ns is not None and spans.on():
            self._count_samples(perms, ns[:n_live])
        return perms.to(self.device, torch.int64)

    def _count_samples(self, perms: torch.Tensor, n_real: np.ndarray
                       ) -> None:
        """Counters ``client.slots`` (the K x E x visited slots a round
        trains) and ``client.real_samples`` (the live clients' real
        samples among them: of the first ``cap // batch * batch`` slots
        of each shuffle, those below the client's size hold its rows)."""
        sc = self.env.sc
        visited = self.env.client_cap // sc.batch_size * sc.batch_size
        spans.count("client.slots", self.K * sc.local_epochs * visited)
        lim = torch.as_tensor(n_real.astype(np.int64),
                              device=perms.device)[:, None, None]
        live = perms[:len(n_real), :, :visited]
        spans.count("client.real_samples", int((live < lim).sum()))

    def _round_data(self, pid: np.ndarray, rows: slice = slice(None)
                    ) -> Dict[str, torch.Tensor]:
        """The padded clients' rows ``pid[rows]`` on the device: gathered
        from the resident train stacks, or (streaming plane) materialized
        on the host (all of ``pid``, the same host work on every rank)
        and uploaded."""
        if self.streaming:
            batch = self.env.population.materialize(pid)
            self.stream_bytes = max(self.stream_bytes,
                                    sum(a.nbytes for a in batch.values()))
            return self.env.upload({k: v[rows] for k, v in batch.items()})
        idx = torch.from_numpy(pid[rows].astype(np.int64)).to(self.device)
        stacks = self.env.train_dev
        return {k: stacks[k].index_select(0, idx) for k in ("x", "y", "mask")}

    def _pad_topology(self, ids_edges):
        """Per-edge live id lists -> the flat (E*K_edge,) padded id
        vector, the per-edge Eq. 4 weights ``w_intra`` (each edge's K_edge
        slots sum to 1 over its live clients; empty edges stay all-zero),
        the Eq. 4-over-edges weights ``w_edge`` (per-edge live sample
        mass, renormalized over non-empty edges) and the per-edge live
        counts.  Dead slots repeat a live id behind exactly-zero weights,
        as in :meth:`_pad_ids`; the reference's numpy, verbatim."""
        E, Ke = self.E, self.K_edge
        fallback = next(int(ids[0]) for ids in ids_edges if len(ids))
        pid = np.full(E * Ke, fallback, np.int32)
        ns = np.zeros(E * Ke, np.float32)
        w_intra = np.zeros(E * Ke, np.float32)
        edge_samples = np.zeros(E, np.float32)
        counts = []
        for e, ids in enumerate(ids_edges):
            n = len(ids)
            counts.append(n)
            if n:
                pid[e * Ke:e * Ke + n] = ids
                ns[e * Ke:e * Ke + n] = self.env.n_train_all[ids]
                w_intra[e * Ke:(e + 1) * Ke] = \
                    aggregation.client_weights_host(ns[e * Ke:(e + 1) * Ke])
                edge_samples[e] = ns[e * Ke:(e + 1) * Ke].sum(
                    dtype=np.float32)
        return pid, w_intra, aggregation.client_weights_host(edge_samples), \
            counts

    def _topology_perms(self, seed: int, counts) -> torch.Tensor:
        """One draw for the whole silo round, ``perm_source(seed, n_live,
        E*K_edge)``: the live rows, in edge order, go to the head of each
        edge's K_edge block, and the padded slots take the remaining rows
        in slot order.  The reference's source gives its own permutations
        (zero keys on the padded rows); with one edge this is the flat
        round's draw, row for row."""
        E, Ke = self.E, self.K_edge
        perms = self._perms(seed, sum(counts), E * Ke)
        order = np.empty(E * Ke, np.int64)
        live = np.zeros(E * Ke, bool)
        off = 0
        for e, n in enumerate(counts):
            order[e * Ke:e * Ke + n] = np.arange(off, off + n)
            live[e * Ke:e * Ke + n] = True
            off += n
        order[~live] = np.arange(off, E * Ke)
        return perms[torch.from_numpy(order).to(perms.device)]

    def _weights(self, w: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(w, np.float32)).to(self.device)

    def _key(self, *key) -> None:
        """Record a round body's step key (``dataD`` under client
        sharding, ``stream`` on the streaming plane)."""
        self.trace_counts.setdefault(key + self._tag, 1)

    @staticmethod
    def _sum_over(sums: Params, group) -> Params:
        """In place: one ``all_reduce`` over ``group`` of all the leaves'
        fp32 partial sums (a flat buffer in sorted-key order)."""
        keys = sorted(sums)
        buf = torch.cat([sums[k].reshape(-1) for k in keys])
        dist.all_reduce(buf, group=group)
        off = 0
        for k in keys:
            n = sums[k].numel()
            sums[k] = buf[off:off + n].reshape(sums[k].shape)
            off += n
        return sums

    def _intra_average(self, client_params: Params, w_intra: np.ndarray
                       ) -> Params:
        """Eq. 4 over this rank's clients ``w_intra[self._shard]``: the
        fp32 products summed over the clients, then (D > 1) one
        ``all_reduce`` of all leaves' partial sums over the data group,
        cast back to each leaf's dtype.  ``w_intra`` is normalized over
        all K slots, so the sum of the partial sums is the weighted
        average; padded zero-weight slots stay neutral on whichever rank
        holds them."""
        sums = aggregation.weighted_average(
            client_params, self._weights(w_intra[self._shard]),
            dtype=torch.float32)
        if self.D > 1:
            self._sum_over(sums, self._group)
        return {k: v.to(client_params[k].dtype) for k, v in sums.items()}

    # ------------------------------------------------------------------
    # the tier stack's layout (shard_tiers)
    # ------------------------------------------------------------------
    def tier_slots(self, M: int) -> range:
        """The slots of the (M, ...) tier stack this rank holds: its pod's
        block where the reference pins the stack to ``pod``
        (``shard_tiers``, in the client-sharded FedAT round and the
        topology round; ``sharding.tier_slots``), else all M."""
        if self.shard_tiers and (self.D > 1 or self.topo is not None):
            return shd.tier_slots(self.mesh, M)
        return range(M)

    def _write_slot(self, stack: Params, m: int, model: Params,
                    slots: range) -> None:
        """Slot ``m`` of the stack <- ``model``, on the ranks that hold
        it."""
        if m in slots:
            for k, v in model.items():
                stack[k][m - slots.start] = v

    def _cross_average(self, stack: Params, cross_weights, slots: range
                       ) -> Params:
        """Eq. 3 over the stack.  Whole: the weighted average.  Laid over
        ``pod``: the fp32 products summed over this rank's slots, one
        ``all_reduce`` over the pod group, cast back to each leaf's
        dtype."""
        if len(slots) == len(cross_weights):
            return aggregation.weighted_average(stack,
                                                self._weights(cross_weights))
        w = np.asarray(cross_weights, np.float32)[slots.start:slots.stop]
        sums = aggregation.weighted_average(stack, self._weights(w),
                                            dtype=torch.float32)
        self._sum_over(sums, self._pod_group)
        return {k: v.to(stack[k].dtype) for k, v in sums.items()}

    def whole_tiers(self, stack: Params, M: int) -> Params:
        """The whole (M, ...) stack from this rank's slots: one gather of
        every leaf's rows over the pod group (the stack itself when it is
        whole)."""
        if len(self.tier_slots(M)) == M:
            return stack
        keys = sorted(stack)
        rows = shd.all_gather_rows(
            torch.cat([stack[k].reshape(-1) for k in keys]),
            self._pod_group, self._pod_ranks, self.mesh.coord("pod"),
            self.mesh.backend == "nccl")
        out, off = {}, 0
        for k in keys:
            n = stack[k].numel()
            out[k] = rows[:, off:off + n].reshape(
                (M,) + tuple(stack[k].shape[1:]))
            off += n
        return out

    def local_tiers(self, stack: Params, M: int) -> Params:
        """This rank's slots of the whole (M, ...) ``stack``."""
        slots = self.tier_slots(M)
        if len(slots) == M:
            return stack
        return {k: v[slots.start:slots.stop].clone()
                for k, v in stack.items()}

    def _refuse_gate_sharded(self) -> None:
        if self.D > 1:
            raise NotImplementedError(
                "the update validation gate is single-device only for now "
                f"(mesh data axis D={self.D}); run gated fault scenarios "
                "without a mesh data axis")

    # ------------------------------------------------------------------
    # public per-event entry points
    # ------------------------------------------------------------------
    def fedat_round(self, w_global: Params, tier_models: Params, m: int,
                    ids: np.ndarray, seed: int, *, codec, use_prox: bool,
                    cross_weights, gate=None, poison=None
                    ) -> Tuple[Params, Params]:
        """One FedAT tier-completion round (Algorithm 1 steps 1-5).

        ``cross_weights`` is the (M,) Eq. 3 weight vector the strategy
        computed on the host.  ``tier_models`` slot ``m`` is overwritten in
        place.  Returns ``(w_global, tier_models)``.  ``gate`` (an
        :class:`~repro_torch.core.steps.UpdateGate`) selects the gated
        body, ``poison`` its (K,) bool uplink-poison mask (None = none).
        """
        with spans.span("fedat.round"):
            if gate is not None:
                return self._fedat_round_gated(
                    w_global, tier_models, m, ids, seed, codec=codec,
                    use_prox=use_prox, cross_weights=cross_weights,
                    gate=gate, poison=poison)
            return self._fedat_round(w_global, tier_models, m, ids, seed,
                                     codec=codec, use_prox=use_prox,
                                     cross_weights=cross_weights)

    def _fedat_round(self, w_global: Params, tier_models: Params, m: int,
                     ids: np.ndarray, seed: int, *, codec, use_prox: bool,
                     cross_weights) -> Tuple[Params, Params]:
        """The ungated FedAT round."""
        self._key("fedat", codec.name, use_prox, *self._dtag)
        pid, ns = self._pad_ids(ids)
        with spans.span("round.perms"):
            perms = self._perms(seed, len(ids), self.K, ns)
        update = (self.env.update_fn if use_prox
                  else self.env.update_fn_noprox)
        with spans.span("round.data"):
            batch = self._round_data(pid, self._shard)
        with spans.span("codec.down"):
            w_sent = codec.lossy(w_global)
        client_params, _ = update(w_sent, batch, perms[self._shard])
        with spans.span("codec.up"):
            client_params = codec.lossy(client_params)
        with spans.span("round.eq4"):
            tier_model = self._intra_average(
                client_params, aggregation.client_weights_host(ns))
        with spans.span("round.eq3"):
            slots = self.tier_slots(len(cross_weights))
            self._write_slot(tier_models, m, tier_model, slots)
            w_new = self._cross_average(tier_models, cross_weights, slots)
        return w_new, tier_models

    def fedat_topology_round(self, w_global: Params, silo_models: Params,
                             dispatch: Params, s: int, ids_edges,
                             seed: int, *, codecs, use_prox: bool,
                             cross_weights
                             ) -> Tuple[Params, Params, Params]:
        """One hierarchical silo round (the reference's
        ``_fedat_topology_step``, eager).

        ``ids_edges`` is a length-E sequence of per-edge live client id
        arrays (availability/completion filtered; at least one
        non-empty), ``codecs`` the (client_edge, edge_silo, silo_global)
        codec triple, ``cross_weights`` the (S,) Eq. 3 vector.  In order:
        the downlink chain silo_global -> edge_silo -> client_edge on the
        silo's dispatch-time global ``dispatch[s]``; local training of
        all E x K_edge slots as one client-batched model; the client_edge
        uplink; per-edge Eq. 4 (E slices of the flat Eq. 4 body, in edge
        order), each through edge_silo; Eq. 4 over the edges;
        silo_global; the delayed-gradient compensation ``m + lam * (g -
        st)``, product and add as separate ops (no contraction); the
        silo-slot write; Eq. 3; the ``dispatch[s] <- w_new`` refresh.
        ``silo_models`` and ``dispatch`` are written in place.  Returns
        ``(w_global, silo_models, dispatch)``.
        """
        if self.D > 1:
            raise NotImplementedError(
                f"the topology plane is single-data-axis for now (mesh "
                f"data axis D={self.D}); use a D==1 mesh — multi-pod "
                f"host meshes with one device per pod still map silos "
                f"onto the pod axis (mesh.shard_tiers)")
        ce, es, sg = codecs
        E, Ke = self.E, self.K_edge
        lam = float(self.topo.cfg.compensation)
        self._key("fedat_topo", ce.name, es.name, sg.name, use_prox, lam)
        pid, w_intra, w_edge, counts = self._pad_topology(ids_edges)
        perms = self._topology_perms(seed, counts)
        update = (self.env.update_fn if use_prox
                  else self.env.update_fn_noprox)
        w_stale = {k: v[s] for k, v in dispatch.items()}
        w_sent = ce.lossy(es.lossy(sg.lossy(w_stale)))
        client_params, _ = update(w_sent, self._round_data(pid), perms)
        client_params = ce.lossy(client_params)
        w_intra = self._weights(w_intra)
        edge_models = []
        for e in range(E):
            pe = {k: v[e * Ke:(e + 1) * Ke] for k, v in client_params.items()}
            edge_models.append(es.lossy(aggregation.weighted_average(
                pe, w_intra[e * Ke:(e + 1) * Ke])))
        edge_stack = {k: torch.stack([em[k] for em in edge_models])
                      for k in client_params}
        silo_model = sg.lossy(aggregation.weighted_average(
            edge_stack, self._weights(w_edge)))
        if lam > 0:
            lam32 = torch.tensor(np.float32(lam), device=self.device)
            silo_model = {k: silo_model[k]
                          + lam32 * (w_global[k] - w_stale[k])
                          for k in silo_model}
        slots = self.tier_slots(len(cross_weights))
        self._write_slot(silo_models, s, silo_model, slots)
        w_new = self._cross_average(silo_models, cross_weights, slots)
        for k, v in w_new.items():
            dispatch[k][s] = v
        return w_new, silo_models, dispatch

    def fedavg_round(self, w: Params, ids: np.ndarray, seed: int, *,
                     codec=None, gate=None, poison=None) -> Params:
        """One synchronous FedAvg round over the sampled clients (TiFL
        rounds run through here too).  ``codec=None`` is the paper's raw
        f32 link; a codec compresses both links as in the FedAT round.
        ``gate``/``poison`` select the gated body, as in
        :meth:`fedat_round`."""
        if gate is not None:
            return self._fedavg_round_gated(w, ids, seed, codec=codec,
                                            gate=gate, poison=poison)
        self._key(*(("fedavg",) if codec is None else ("fedavg", codec.name)),
                  *self._dtag)
        pid, ns = self._pad_ids(ids)
        perms = self._perms(seed, len(ids), self.K)
        w_in = w if codec is None else codec.lossy(w)
        client_params, _ = self.env.update_fn_noprox(
            w_in, self._round_data(pid, self._shard), perms[self._shard])
        if codec is not None:
            client_params = codec.lossy(client_params)
        return self._intra_average(client_params,
                                   aggregation.client_weights_host(ns))

    # ------------------------------------------------------------------
    # the fault plane's gated bodies
    # ------------------------------------------------------------------
    def _poison(self, poison: Optional[np.ndarray]) -> torch.Tensor:
        mask = np.zeros(self.K, bool) if poison is None else poison
        return torch.from_numpy(np.asarray(mask, bool)).to(self.device)

    def _gated_uplink(self, client_params: Params, ns: np.ndarray,
                      ref: Params, gate, poison):
        """Poison the decoded uplink, then gate it against ``ref``:
        (sanitized params, gated Eq. 4 weights, any_ok)."""
        client_params = fl_steps.poison_updates(client_params,
                                                self._poison(poison))
        return fl_steps.gate_updates(
            client_params, self._weights(aggregation.client_weights_host(ns)),
            ref, float(gate.clip_norm))

    def _fedat_round_gated(self, w_global: Params, tier_models: Params,
                           m: int, ids: np.ndarray, seed: int, *, codec,
                           use_prox: bool, cross_weights, gate, poison
                           ) -> Tuple[Params, Params]:
        """The FedAT round with the gate spliced in after the uplink
        decode; the clip reference is the decoded downlink ``w_sent``.
        With no surviving client the tier slot keeps its model."""
        self._refuse_gate_sharded()
        self._key("fedat", codec.name, use_prox, "gate", gate.clip_norm)
        pid, ns = self._pad_ids(ids)
        with spans.span("round.perms"):
            perms = self._perms(seed, len(ids), self.K, ns)
        update = (self.env.update_fn if use_prox
                  else self.env.update_fn_noprox)
        with spans.span("round.data"):
            batch = self._round_data(pid)
        with spans.span("codec.down"):
            w_sent = codec.lossy(w_global)
        client_params, _ = update(w_sent, batch, perms)
        with spans.span("codec.up"):
            client_params = codec.lossy(client_params)
        with spans.span("round.eq4"):
            client_params, w_ok, any_ok = self._gated_uplink(
                client_params, ns, w_sent, gate, poison)
            tier_model = aggregation.weighted_average(client_params, w_ok)
        with spans.span("round.eq3"):
            for k, v in tier_model.items():
                tier_models[k][m] = torch.where(any_ok, v, tier_models[k][m])
            w_global = aggregation.weighted_average(
                tier_models, self._weights(cross_weights))
        return w_global, tier_models

    def _fedavg_round_gated(self, w: Params, ids: np.ndarray, seed: int, *,
                            codec, gate, poison) -> Params:
        """The FedAvg/TiFL round with the gate; with no surviving client
        the server keeps its previous model."""
        self._refuse_gate_sharded()
        self._key(*(("fedavg",) if codec is None else ("fedavg", codec.name)),
                  "gate", gate.clip_norm)
        pid, ns = self._pad_ids(ids)
        perms = self._perms(seed, len(ids), self.K)
        w_in = w if codec is None else codec.lossy(w)
        client_params, _ = self.env.update_fn_noprox(
            w_in, self._round_data(pid), perms)
        if codec is not None:
            client_params = codec.lossy(client_params)
        client_params, w_ok, any_ok = self._gated_uplink(
            client_params, ns, w_in, gate, poison)
        new_w = aggregation.weighted_average(client_params, w_ok)
        return {k: torch.where(any_ok, new_w[k], w[k]) for k in w}

    def fedasync_round(self, w: Params, client: int, a_eff: float,
                       seed: int, *, codec=None) -> Params:
        """One asynchronous client update with staleness mix-in.

        The interpolation coefficients are rounded to f32 on the host, and
        both products are formed before the add, as in the reference.
        FedAsync trains one client per event, so it is the same under any
        mesh.
        """
        self._key(*(("fedasync",) if codec is None
                    else ("fedasync", codec.name)))
        pid = np.asarray([client], np.int32)
        perms = self._perms(seed, 1, 1)
        w_in = w if codec is None else codec.lossy(w)
        client_params, _ = self.env.update_fn_noprox(
            w_in, self._round_data(pid), perms)
        client_w = {k: v[0] for k, v in client_params.items()}
        if codec is not None:
            client_w = codec.lossy(client_w)
        c_glob = torch.tensor(np.float32(1.0 - a_eff), device=self.device)
        c_loc = torch.tensor(np.float32(a_eff), device=self.device)
        return {k: c_glob * w[k] + c_loc * client_w[k] for k in w}
