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

Checkpointing and engine resume are not ported yet (ROADMAP A12).
"""
from __future__ import annotations

import dataclasses
import inspect
import itertools
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.api.spec import ExperimentSpec, SpecError
from repro_torch.core import strategies
from repro_torch.core.engine import EngineConfig, ServerStrategy, run_engine
from repro_torch.core.scheduler import Metrics
from repro_torch.core.simulation import SimEnv
from repro_torch.device import DeviceLike, resolve_device

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
    ``run()`` restarts the engine from the bound strategy's fresh state)."""
    spec: ExperimentSpec
    env: SimEnv
    strategy: ServerStrategy
    cfg: EngineConfig
    tag: str = ""

    def run(self, on_eval: Optional[Callable[[dict], None]] = None
            ) -> Result:
        """Execute the event loop; ``on_eval`` streams each recorded eval
        point (dict with time/round/acc/acc_var/bytes_up/bytes_down)."""
        metrics = run_engine(self.env, self.strategy, self.cfg,
                             on_record=on_eval)
        return Result(spec=self.spec, spec_hash=self.spec.hash(),
                      metrics=metrics, tag=self.tag)


def build(spec: ExperimentSpec, env: Optional[SimEnv] = None,
          device: DeviceLike = None) -> Run:
    """Validate the spec and materialize ``(SimEnv, strategy,
    EngineConfig)`` on ``device`` (None = cuda; "cpu" must be asked for).

    ``env`` injects an already-built environment (e.g. one built with an
    injected ``params0``); it then overrides the spec's materialization
    and its own device is used.
    """
    spec.validate()
    if env is None:
        env = get_env(spec, device)
    return Run(
        spec=spec, env=env, strategy=_make_strategy(spec),
        cfg=EngineConfig(total_updates=spec.engine.total_updates,
                         eval_every=spec.engine.eval_every,
                         seed=spec.engine.seed,
                         retier_every=spec.tiers.retier_every,
                         retier_drift=spec.tiers.retier_drift))


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
