"""ServeSpec: the declarative serving-side configuration (the port of
``repro/serve/spec.py``, the same fields, defaults and errors).

Deliberately *not* a section of :class:`repro_torch.api.spec.ExperimentSpec`:
the experiment spec hashes training provenance, and how a checkpoint is
later served (slot count, cache length) must not change which checkpoint
it resolves to.  The serve spec therefore lives next to the engine and
is validated the same way (fail early, name the fix).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.api.spec import SpecError, _strict_fields


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """How the engine batches and bounds one serving run."""
    #: fixed decode-batch width: every engine call is shaped (slots, ...)
    #: so admission/retirement never changes a shape
    slots: int = 4
    #: absolute-position budget per request (cache length for full-cache
    #: archs; SWA archs ring over min(max_len, window)).  A request whose
    #: prompt + generation would cross this is retired with
    #: ``truncated=True``.
    max_len: int = 64
    #: padded prompt length of the batched prefill; prompts longer
    #: than this are force-fed token-by-token through decode instead
    prefill_len: int = 16
    #: per-request decode budget when the request doesn't carry its own
    max_new: int = 16
    #: engine rng seed (slot-independent; generation itself is greedy
    #: argmax, so this only seeds synthetic prompts in the entry points)
    seed: int = 0
    #: compute/cache dtype: "float32" | "bfloat16"
    dtype: str = "float32"

    def validate(self) -> "ServeSpec":
        if self.slots < 1:
            raise SpecError(f"serve.slots must be >= 1, got {self.slots}")
        if self.max_len < 2:
            raise SpecError(
                f"serve.max_len must be >= 2 (one prompt token + one "
                f"generated token), got {self.max_len}")
        if not (0 < self.prefill_len <= self.max_len):
            raise SpecError(
                f"serve.prefill_len must be in [1, max_len={self.max_len}]"
                f", got {self.prefill_len} — the prefill trace writes "
                f"cache rows 0..prefill_len-1")
        if self.max_new < 1:
            raise SpecError(f"serve.max_new must be >= 1, got "
                            f"{self.max_new}")
        if self.dtype not in ("float32", "bfloat16"):
            raise SpecError(f"serve.dtype must be float32|bfloat16, got "
                            f"{self.dtype!r}")
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServeSpec":
        return cls(**_strict_fields(cls, dict(d), "serve")).validate()
