"""Spec-hash-addressed checkpoint loading for the serving plane.

The port of ``repro/serve/loader.py``.  A checkpoint directory written by
``Run.run(checkpoint_dir=...)`` (or the CLI's ``--checkpoint-dir``) of
either package carries a ``spec.json`` sidecar binding its params to
exactly one :class:`ExperimentSpec` hash and one step.
:func:`load_checkpoint` resolves that binding end to end:

  sidecar -> ExperimentSpec.from_dict -> hash verify -> registry model
          -> CheckpointManager.restore(step=<sidecar step>) -> device

The params are stored as the reference's nested LM tree (the port's
``save_checkpoint`` nests its flat dict the same way), so a checkpoint
of either package restores into the port's LM facade tree as it is
(``models/convert.py`` keeps the reference's keys, shapes and layouts).
Every failure mode is the reference's actionable :class:`SpecError` — a
serving process must never come up on the wrong weights silently.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.api.spec import ExperimentSpec, SpecError
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import registry as model_registry
from repro_torch.models.common import unflatten_tree


@dataclasses.dataclass(frozen=True)
class LoadedCheckpoint:
    """A federated checkpoint resolved into a servable model."""
    #: the spec that trained these params (rebuilt from the sidecar)
    spec: ExperimentSpec
    #: its 12-hex provenance hash (== sidecar's, verified)
    spec_hash: str
    #: the training step the params belong to
    step: int
    #: the restored LM-facade params tree, on the loader's device
    params: Dict[str, Any]
    #: the registry model bound to the spec's DataDims
    model: model_registry.FLModel

    @property
    def config(self):
        """The bound ModelConfig the engine rebuilds prefill/decode from
        (never ``None`` — the loader refuses non-servable models)."""
        return self.model.config

    @property
    def lm_params(self) -> Dict[str, Any]:
        """The LM-facade params tree (federated checkpoints store
        ``{"params": <lm tree>}``; restore unwraps that already)."""
        return self.params


def spec_hash_of(doc: dict) -> str:
    """Hash of a spec *document* (dict) via a from_dict round-trip — the
    only hash that can be compared against a live spec's ``.hash()``."""
    return ExperimentSpec.from_dict(dict(doc)).hash()


def load_checkpoint(directory: str,
                    expect_spec: Optional[ExperimentSpec] = None,
                    device: DeviceLike = None) -> LoadedCheckpoint:
    """Resolve ``directory`` into a :class:`LoadedCheckpoint` whose params
    sit on ``device`` (None = cuda).

    ``expect_spec`` pins the load to one spec: a sidecar whose hash
    differs is refused.  Without it, the sidecar's own embedded spec
    document is trusted — but still re-hashed after the from_dict round
    trip, so a hand-edited or version-drifted sidecar cannot smuggle
    mismatched provenance.
    """
    dev = resolve_device(device)
    try:
        saved = ckpt.read_sidecar(directory)
    except FileNotFoundError:
        raise SpecError(
            f"no {ckpt.SIDECAR} in checkpoint dir {directory!r}; serving "
            f"needs a checkpoint written by Run.run(checkpoint_dir=...) "
            f"or the CLI's --checkpoint-dir")
    except (OSError, json.JSONDecodeError) as e:
        raise SpecError(f"unreadable {ckpt.SIDECAR} in checkpoint dir "
                        f"{directory!r}: {e}") from e

    doc = saved.get("spec")
    if not isinstance(doc, dict):
        raise SpecError(
            f"{ckpt.SIDECAR} in {directory!r} has no embedded spec "
            f"document; re-checkpoint with a current repro build")
    try:
        spec = ExperimentSpec.from_dict(dict(doc)).validate()
    except SpecError as e:
        raise SpecError(f"checkpoint {directory!r} sidecar spec does not "
                        f"parse: {e}") from e
    if spec.hash() != saved.get("spec_hash"):
        raise SpecError(
            f"checkpoint {directory!r} sidecar is self-inconsistent: "
            f"embedded spec hashes to {spec.hash()} but the sidecar "
            f"claims {saved.get('spec_hash')} — the sidecar was edited "
            f"or written by an incompatible spec version; re-checkpoint")
    if expect_spec is not None and expect_spec.hash() != spec.hash():
        raise SpecError(
            f"checkpoint {directory!r} was written by spec {spec.hash()} "
            f"but serving was asked for spec {expect_spec.hash()}; point "
            f"at a checkpoint of the expected spec, or drop expect_spec "
            f"to serve what the directory actually holds")

    d = spec.data
    model = model_registry.build_model(d.model, model_registry.DataDims(
        n_classes=d.n_classes, image_hw=d.image_hw,
        n_features=d.n_features, vocab_size=d.vocab_size,
        seq_len=d.seq_len, attention_backend=d.attention_backend))
    if model.config is None:
        servable = [n for n in model_registry.registered_models()
                    if model_registry.MODELS[n](
                        model_registry.DataDims()).config is not None]
        raise SpecError(
            f"model {d.model!r} has no decode path (FLModel.config is "
            f"None) — only LM-facade models are servable; servable "
            f"models: {servable}")

    # the restore takes each leaf's device and dtype from ``like``
    shapes = model.init_params(torch.Generator().manual_seed(0))
    like = {"params": unflatten_tree({
        k: torch.empty(v.shape, dtype=v.dtype, device=dev)
        for k, v in shapes.items()})}
    try:
        # the exact sidecar step — never "latest", which in a reused
        # directory could be another spec's params
        state, step = ckpt.CheckpointManager(directory).restore(
            like=like, step=saved.get("step"))
    except FileNotFoundError as e:
        raise SpecError(
            f"checkpoint dir {directory!r} has a {ckpt.SIDECAR} but no "
            f"restorable step {saved.get('step')}: {e}") from e
    return LoadedCheckpoint(spec=spec, spec_hash=spec.hash(), step=step,
                            params=state["params"], model=model)
