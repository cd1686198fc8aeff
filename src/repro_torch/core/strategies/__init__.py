"""Pluggable server strategies for the event-driven engine (core/engine.py).

Each strategy reimplements one of the paper's methods as policy hooks over
the shared loop; the rng draw order inside each hook is the reference's."""
from typing import Callable, Dict

from repro_torch.core.engine import ServerStrategy
from repro_torch.core.strategies.fedasync import FedAsyncStrategy
from repro_torch.core.strategies.fedat import FedATStrategy
from repro_torch.core.strategies.fedavg import FedAvgStrategy
from repro_torch.core.strategies.tifl import TiFLStrategy

STRATEGIES: Dict[str, Callable[..., ServerStrategy]] = {
    "fedat": FedATStrategy,
    "fedavg": FedAvgStrategy,
    "tifl": TiFLStrategy,
    "fedasync": FedAsyncStrategy,
}


def make_strategy(name: str, **kwargs) -> ServerStrategy:
    if name not in STRATEGIES:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"registered: {sorted(STRATEGIES)}")
    return STRATEGIES[name](**kwargs)
