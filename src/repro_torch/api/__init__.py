"""Declarative experiment API of the port.

    from repro_torch import api

    spec = api.ExperimentSpec(
        data=api.DataSpec(n_clients=40),
        transport=api.TransportSpec(codec="quantize8"),
        engine=api.EngineSpec(total_updates=120))
    result = api.build(spec, device="cuda").run()

CLI: ``python -m repro_torch.api.cli --set strategy.name=fedat
--sweep transport.codec=none,quantize8 [--device cpu]``.
"""
from repro_torch.api.build import (Result, Run, build,  # noqa: F401
                                   clear_env_cache, get_env, run_spec,
                                   save_checkpoint, sweep)
from repro_torch.api.spec import (SPEC_VERSION, DataSpec,  # noqa: F401
                                  EngineSpec, ExperimentSpec, FaultSpec,
                                  MeshSpec, PopulationSpec, SpecError,
                                  StrategySpec, TierSpec, TopologySpec,
                                  TransportSpec)
