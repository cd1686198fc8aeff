"""Materialize and execute :class:`~repro_torch.api.spec.ExperimentSpec`
runs on a device.

``build(spec, device=...)`` turns the declarative spec into a :class:`Run`
handle — ``(SimEnv, ServerStrategy, EngineConfig)`` wired together — with
the environment drawn from a cache keyed on the spec's environment hash
and the device, so sweeping the strategy/codec/budget plane over one
scenario reuses one materialized environment.  ``Run.run()`` executes the
event loop and returns a :class:`Result` carrying the metrics, the spec
echo and the spec hash; ``sweep()`` expands a cartesian grid of
dotted-path overrides into tagged runs.

Checkpointing: ``Run.run(checkpoint_dir=...)`` persists the final global
params (checkpoint/ckpt.py: atomic, integrity-hashed; nested like the
reference's tree, so both packages' manifests agree) next to a
``spec.json`` carrying the producing spec and its hash;
``build(spec, resume_from=dir)`` restores those params as the run's
initial model **iff** the saved spec hash matches the current spec's.
Independently, a spec with ``faults.checkpoint_every > 0`` persists full
engine snapshots under ``<checkpoint_dir>/engine`` as the run progresses,
and ``Run.run(resume_engine=True)`` replays the remainder of a killed run
bitwise — same hash guard, same :class:`SpecError`.
"""
from __future__ import annotations

import dataclasses
import inspect
import itertools
import json
import os
import shutil
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch import checkpoint as ckpt
from repro_torch.api.spec import ExperimentSpec, FaultSpec, SpecError
from repro_torch.core import faults as faults_mod
from repro_torch.core import strategies
from repro_torch.core.engine import EngineConfig, ServerStrategy, run_engine
from repro_torch.core.scheduler import Metrics
from repro_torch.core.simulation import SimEnv
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.common import flatten_tree, unflatten_tree

#: (env_hash, device) -> SimEnv, shared across strategy/codec sweeps
_ENV_CACHE: Dict[Tuple[str, str], SimEnv] = {}


def clear_env_cache() -> None:
    """Drop all cached environments (frees device-resident train stacks)."""
    _ENV_CACHE.clear()


def get_env(spec: ExperimentSpec, device: DeviceLike = None) -> SimEnv:
    """The cached environment for a spec's environment section on
    ``device`` (None = cuda)."""
    dev = resolve_device(device)
    key = (spec.env_hash(), str(dev))
    if key not in _ENV_CACHE:
        try:
            _ENV_CACHE[key] = SimEnv(spec.to_sim_config(), device=dev)
        except ValueError as e:
            raise SpecError(str(e)) from e
    return _ENV_CACHE[key]


def _make_strategy(spec: ExperimentSpec) -> ServerStrategy:
    factory = strategies.STRATEGIES[spec.strategy.name]
    kwargs = dict(spec.strategy.kwargs)
    params = inspect.signature(factory).parameters
    if "codec" in params:
        kwargs.setdefault("codec", spec.transport.codec)
    elif spec.transport.codec is not None:
        accepting = sorted(
            n for n, f in strategies.STRATEGIES.items()
            if "codec" in inspect.signature(f).parameters)
        raise SpecError(
            f"strategy {spec.strategy.name!r} does not take a transport "
            f"codec; codec-capable strategies: {accepting}")
    return factory(**kwargs)


def _fault_config(fs: FaultSpec) -> Optional[faults_mod.FaultConfig]:
    """Engine-plane fault knobs from the spec's ``faults`` section, or
    None when every knob is off — a zero-fault spec gives the EngineConfig
    of the fault-free engine.  Churn is *not* here: it shapes client
    availability, so it rides the environment (``to_sim_config``)."""
    fc = faults_mod.FaultConfig(
        blackouts=fs.blackouts,
        blackout_duration=fs.blackout_duration,
        blackout_window=tuple(fs.blackout_window),
        nan_rate=fs.nan_rate,
        update_clip=fs.update_clip,
        checkpoint_every=fs.checkpoint_every,
        seed=fs.seed)
    return fc if fc.active else None


def _engine_ckpt_dir(checkpoint_dir: str, spec: ExperimentSpec,
                     resume: bool) -> str:
    """The engine-state checkpoint directory under ``checkpoint_dir``,
    guarded by a spec-hash sidecar: resuming an engine snapshot under a
    *different* spec would splice two configurations into one
    trajectory, so a mismatch is an actionable :class:`SpecError`."""
    eng = os.path.join(checkpoint_dir, "engine")
    os.makedirs(eng, exist_ok=True)
    try:
        saved = ckpt.read_sidecar(eng)
    except FileNotFoundError:
        if resume:
            raise SpecError(
                f"resume_engine=True but {eng!r} has no {ckpt.SIDECAR} — "
                f"nothing was ever checkpointed there (run with "
                f"checkpoint_dir= and faults.checkpoint_every > 0 first)")
        if mesh_mod.is_writer():
            ckpt.write_sidecar(eng, {"spec_hash": spec.hash(),
                                     "spec": spec.to_dict()})
        return eng
    if saved.get("spec_hash") != spec.hash():
        raise SpecError(
            f"engine checkpoint dir {eng!r} holds snapshots written by "
            f"spec {saved.get('spec_hash')} but the current spec hashes "
            f"to {spec.hash()}; point checkpoint_dir somewhere fresh or "
            f"load the matching spec from "
            f"{os.path.join(eng, ckpt.SIDECAR)!r}")
    return eng


@dataclasses.dataclass
class Result:
    """One finished run: metrics + the exact configuration that made them."""
    spec: ExperimentSpec
    spec_hash: str
    metrics: Metrics
    tag: str = ""

    def summary(self) -> Dict[str, Any]:
        s = self.metrics.summary()
        s["spec_hash"] = self.spec_hash
        if self.tag:
            s["tag"] = self.tag
        return s


@dataclasses.dataclass
class Run:
    """A materialized experiment, ready to execute (repeatable: each
    ``run()`` restarts the engine from the bound strategy's fresh state).

    ``initial_params`` (set by ``build(resume_from=...)``) replaces the
    environment's seeded model init for the duration of the run; the
    original ``params0`` is restored afterwards so the cached environment
    stays reproducible for other runs.
    """
    spec: ExperimentSpec
    env: SimEnv
    strategy: ServerStrategy
    cfg: EngineConfig
    tag: str = ""
    initial_params: Optional[Dict[str, Any]] = None

    def run(self, on_eval: Optional[Callable[[dict], None]] = None,
            checkpoint_dir: Optional[str] = None,
            resume_engine: bool = False) -> Result:
        """Execute the event loop; ``on_eval`` streams each recorded eval
        point (dict with time/round/acc/acc_var/bytes_up/bytes_down).
        ``checkpoint_dir`` saves the final global params + the producing
        spec (hash-stamped) there, resumable via ``build(spec,
        resume_from=checkpoint_dir)``.  With ``faults.checkpoint_every >
        0`` it also persists full engine snapshots under
        ``<checkpoint_dir>/engine``; ``resume_engine=True`` restores the
        newest one and replays the rest of the run bitwise."""
        eng_dir = None
        if checkpoint_dir is not None and self.spec.faults.checkpoint_every:
            eng_dir = _engine_ckpt_dir(checkpoint_dir, self.spec,
                                       resume_engine)
        elif resume_engine:
            raise SpecError(
                "resume_engine=True needs checkpoint_dir= and "
                "faults.checkpoint_every > 0 — there is no engine "
                "snapshot to resume from otherwise")
        params0 = self.env.params0
        if self.initial_params is not None:
            self.env.params0 = self.initial_params
        try:
            metrics = run_engine(self.env, self.strategy, self.cfg,
                                 on_record=on_eval,
                                 checkpoint_dir=eng_dir,
                                 resume=resume_engine)
        finally:
            self.env.params0 = params0
        if checkpoint_dir is not None and mesh_mod.is_writer():
            save_checkpoint(checkpoint_dir, self.spec,
                            self.strategy.global_params(),
                            step=self.cfg.total_updates)
        return Result(spec=self.spec, spec_hash=self.spec.hash(),
                      metrics=metrics, tag=self.tag)


def save_checkpoint(directory: str, spec: ExperimentSpec,
                    params: Dict[str, Any], step: int) -> None:
    """Final-params checkpoint (checkpoint/ckpt.py; the flat params
    nested like the reference's tree) + spec provenance sidecar; a
    blocking write, so the caller can exit right after.

    The directory holds exactly one spec's checkpoint: stale steps left
    by earlier runs are cleared first (the manager's keep-last-k GC could
    otherwise delete the step being written when a reused directory holds
    higher-numbered steps of another spec)."""
    mgr = ckpt.CheckpointManager(directory)
    for s in mgr.all_steps():
        if s != step:
            shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                          ignore_errors=True)
    mgr.save(step, {"params": unflatten_tree(params)}, blocking=True)
    # "step" binds the sidecar to the exact step it describes
    ckpt.write_sidecar(directory, {"spec_hash": spec.hash(), "step": step,
                                   "spec": spec.to_dict()})


def _load_checkpoint(directory: str, spec: ExperimentSpec,
                     env: SimEnv) -> Dict[str, Any]:
    """Restore params for ``spec`` from ``directory`` onto the
    environment's device; a spec-hash mismatch (or a missing/corrupt
    checkpoint) is an actionable SpecError."""
    try:
        saved = ckpt.read_sidecar(directory)
    except FileNotFoundError:
        raise SpecError(
            f"no {ckpt.SIDECAR} in checkpoint dir {directory!r}; expected "
            f"a checkpoint written by Run.run(checkpoint_dir=...)")
    except (OSError, json.JSONDecodeError) as e:
        raise SpecError(f"unreadable {ckpt.SIDECAR} in checkpoint dir "
                        f"{directory!r}: {e}") from e
    if saved.get("spec_hash") != spec.hash():
        raise SpecError(
            f"checkpoint {directory!r} was written by spec "
            f"{saved.get('spec_hash')} but the current spec hashes to "
            f"{spec.hash()}; load the matching spec from its "
            f"{ckpt.SIDECAR} (api.ExperimentSpec.from_dict(doc['spec'])) "
            f"or point resume_from at a checkpoint of this spec")
    try:
        # restore the exact step the sidecar describes — never "latest"
        state, _ = ckpt.CheckpointManager(directory).restore(
            like={"params": unflatten_tree(env.params0)},
            step=saved.get("step"))
    except FileNotFoundError as e:
        raise SpecError(f"checkpoint dir {directory!r} has a spec.json "
                        f"but no restorable step "
                        f"{saved.get('step')}: {e}") from e
    return flatten_tree(state["params"])


def build(spec: ExperimentSpec, env: Optional[SimEnv] = None,
          device: DeviceLike = None,
          resume_from: Optional[str] = None) -> Run:
    """Validate the spec and materialize ``(SimEnv, strategy,
    EngineConfig)`` on ``device`` (None = cuda; "cpu" must be asked for).

    ``env`` injects an already-built environment (e.g. one built with an
    injected ``params0``); it then overrides the spec's materialization
    and its own device is used.  ``resume_from`` restores a
    ``Run.run(checkpoint_dir=...)`` checkpoint as the initial model (the
    spec hash must match).
    """
    spec.validate()
    if env is None:
        env = get_env(spec, device)
    initial = (None if resume_from is None
               else _load_checkpoint(resume_from, spec, env))
    return Run(
        spec=spec, env=env, strategy=_make_strategy(spec),
        cfg=EngineConfig(total_updates=spec.engine.total_updates,
                         eval_every=spec.engine.eval_every,
                         seed=spec.engine.seed,
                         retier_every=spec.tiers.retier_every,
                         retier_drift=spec.tiers.retier_drift,
                         faults=_fault_config(spec.faults)),
        initial_params=initial)


def run_spec(spec: ExperimentSpec, env: Optional[SimEnv] = None,
             on_eval: Optional[Callable[[dict], None]] = None,
             device: DeviceLike = None) -> Result:
    """Build + run in one call."""
    return build(spec, env=env, device=device).run(on_eval=on_eval)


def sweep(base_spec: ExperimentSpec, grid: Dict[str, Iterable[Any]],
          on_result: Optional[Callable[[Result], None]] = None,
          device: DeviceLike = None) -> List[Result]:
    """Cartesian expansion of a dotted-path override grid into tagged runs;
    every combination is validated before any run executes."""
    if not grid:
        raise SpecError("sweep grid is empty; pass at least one "
                        "dotted-path axis, e.g. {'strategy.name': [...]}")
    axes = [(path, list(values)) for path, values in grid.items()]
    for path, values in axes:
        if not values:
            raise SpecError(f"sweep axis {path!r} has no values")
    runs = []
    for combo in itertools.product(*(vals for _, vals in axes)):
        overrides = {path: v for (path, _), v in zip(axes, combo)}
        spec = base_spec.with_overrides(overrides)
        spec.validate()
        tag = ",".join(f"{path}={v}" for path, v in overrides.items())
        runs.append((spec, tag))
    results = []
    for spec, tag in runs:
        run = build(spec, device=device)
        run.tag = tag
        res = run.run()
        if on_result is not None:
            on_result(res)
        results.append(res)
    return results
