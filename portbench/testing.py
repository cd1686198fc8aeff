"""Helpers of the benchmark's CPU tests: a cell at its smoke size on the
CPU, the harness's look for a card skipped, the rest of a run driven."""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Any, Dict

from portbench import harness

SRC = str(harness.ROOT / "src")


def use_port() -> None:
    """Put the port's ``src/`` on the path."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)


@contextlib.contextmanager
def one_thread():
    """torch on one thread for the block: the test workers share the
    machine's cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def smoke_run(workload: str, seed: int = 3, seconds: float = 0.5,
              trace: bool = False) -> Dict[str, Any]:
    use_port()
    cell = harness.load_cell(workload, seed=seed, seconds=seconds,
                             trace=trace, device="cpu", smoke=True,
                             t_start=time.perf_counter())
    with one_thread():
        return harness.run_cell(cell)


def control_readings(workload: str, seed: int, variant: str):
    from portbench import control
    use_port()
    cell = harness.load_cell(workload, device="cpu", smoke=True)
    with one_thread():
        return cell, control.readings(cell, seed, [variant])[variant]
