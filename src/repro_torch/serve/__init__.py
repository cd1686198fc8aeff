"""Serving plane: continuous batching over the port's LM facade.

The port of ``repro/serve``:

  * :mod:`repro_torch.serve.engine`  — fixed-slot continuous-batching
    prefill/decode engine (one shape per call kind; per-slot positions;
    force-fed prompt handoff; cache-row reset on slot recycle).
  * :mod:`repro_torch.serve.loadgen` — open-loop Poisson load generation
    and the p50/p95/p99 latency + throughput report.
  * :mod:`repro_torch.serve.spec`    — :class:`ServeSpec`.

Serving a federated checkpoint (``repro/serve/loader.py``) needs the
engine's checkpointing first (ROADMAP A12; the federated ``tiny_lm``
path and the checkpoint module are ported): :func:`load_checkpoint`,
:class:`LoadedCheckpoint` and :func:`serve_from_checkpoint` raise until
then.
"""
from repro_torch.serve.engine import ServeEngine, ServeRequest  # noqa: F401
from repro_torch.serve.loadgen import (  # noqa: F401
    make_requests,
    poisson_arrivals,
    report,
)
from repro_torch.serve.spec import ServeSpec  # noqa: F401

_UNPORTED = ("serving a federated checkpoint is not ported to the PyTorch "
             "package yet (ROADMAP A12: the engine's checkpoint and "
             "resume); serve a zoo decoder with "
             "python -m repro_torch.launch.serve")


def load_checkpoint(*args, **kwargs):
    raise NotImplementedError(_UNPORTED)


class LoadedCheckpoint:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_UNPORTED)


def serve_from_checkpoint(*args, **kwargs):
    raise NotImplementedError(_UNPORTED)
