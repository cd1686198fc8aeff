"""Serving plane: continuous batching over the port's LM facade.

The port of ``repro/serve``:

  * :mod:`repro_torch.serve.engine`  — fixed-slot continuous-batching
    prefill/decode engine (one shape per call kind; per-slot positions;
    force-fed prompt handoff; cache-row reset on slot recycle).
  * :mod:`repro_torch.serve.loadgen` — open-loop Poisson load generation
    and the p50/p95/p99 latency + throughput report.
  * :mod:`repro_torch.serve.spec`    — :class:`ServeSpec`.
  * :mod:`repro_torch.serve.loader`  — resolve a checkpoint directory by
    spec hash (the ``spec.json`` sidecar), rebuild the registered model
    from the spec, restore the exact step the sidecar names onto the
    caller's device.
"""
from repro_torch.serve.engine import ServeEngine, ServeRequest  # noqa: F401
from repro_torch.serve.loader import (  # noqa: F401
    LoadedCheckpoint,
    load_checkpoint,
)
from repro_torch.serve.loadgen import (  # noqa: F401
    make_requests,
    poisson_arrivals,
    report,
)
from repro_torch.serve.spec import ServeSpec  # noqa: F401


def serve_from_checkpoint(checkpoint_dir, serve_spec, requests,
                          device=None):
    """Load a spec-hash-verified checkpoint onto ``device`` (None = cuda)
    and serve ``requests`` through a fresh engine; returns ``(loaded,
    done_requests)``."""
    loaded = load_checkpoint(checkpoint_dir, device=device)
    eng = ServeEngine(loaded.config, loaded.lm_params, serve_spec)
    return loaded, eng.run(requests)
