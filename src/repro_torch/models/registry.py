"""FLModel registry: the federated path's view of a model.

The engine, executor and spec API never name a concrete architecture —
they consume a bound :class:`FLModel`, a small protocol of functions over
a dict of tensors:

  * ``init_params(generator)``              -> params dict (CPU)
  * ``apply(params, x)``                    -> logits, batched over clients
  * ``loss(params, x, y, mask)``            -> (K,) masked per-client loss
  * ``eval_metrics(params, x, y, mask)``    -> (K,) per-client accuracy
  * ``batch_shape`` / ``batch_dtype``       -> per-sample input contract

``apply``/``loss``/``eval_metrics`` take params with a leading client axis
K and inputs ``(K, B, ...)``.  Registered here: ``cnn`` and ``logreg``
(the paper's models).  The reference's ``tiny_lm`` entries are not ported
yet (ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import cnn


@dataclasses.dataclass(frozen=True)
class DataDims:
    """The data-plane knobs a model needs to size itself."""
    n_classes: int = 10
    image_hw: int = 12
    n_features: int = 128
    vocab_size: int = 64
    seq_len: int = 16
    attention_backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class FLModel:
    """One model bound to a scenario's :class:`DataDims`.

    ``loss`` weights samples by ``mask``, so the executor's zero-weight
    padding slots stay exactly neutral.
    """
    name: str
    #: what the federated partitioner synthesizes: "image" | "features"
    data_kind: str
    init_params: Callable[[torch.Generator], Dict[str, torch.Tensor]]
    apply: Callable[..., torch.Tensor]
    loss: Callable[..., torch.Tensor]
    eval_metrics: Callable[..., torch.Tensor]
    batch_shape: Tuple[int, ...]
    batch_dtype: Any = np.float32


MODELS: Dict[str, Callable[[DataDims], FLModel]] = {}

#: registered in the reference, not yet in the port -> the ROADMAP item
UNPORTED_MODELS: Dict[str, str] = {"tiny_lm": "A11", "tiny_lm_long": "A11"}

#: the ``task`` values spec versions 1/2 used, mapped to registry names
LEGACY_TASKS: Dict[str, str] = {"image": "cnn", "text": "logreg"}


def register_model(name: str,
                   factory: Callable[[DataDims], FLModel]) -> None:
    if name in MODELS:
        raise ValueError(f"model {name!r} is already registered")
    MODELS[name] = factory


def registered_models() -> List[str]:
    return sorted(MODELS)


def build_model(name: str, dims: DataDims) -> FLModel:
    if name in UNPORTED_MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP "
            f"{UNPORTED_MODELS[name]}")
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; "
                         f"registered: {registered_models()}")
    return MODELS[name](dims)


# ---------------------------------------------------------------------------
# classification objective (shared by cnn / logreg)
# ---------------------------------------------------------------------------

def _classification_loss(apply_fn):
    def loss(params, x, y, mask):
        logits = apply_fn(params, x)                      # (K, B, C)
        labels = F.one_hot(y, logits.shape[-1]).to(logits.dtype)
        logp = torch.log_softmax(logits, dim=-1)
        ce = -(labels * logp).sum(dim=-1)                 # (K, B)
        return (ce * mask).sum(dim=-1) / mask.sum(dim=-1).clamp_min(1.0)
    return loss


def _classification_eval(apply_fn):
    def eval_metrics(params, x, y, mask):
        pred = apply_fn(params, x).argmax(dim=-1)
        return (((pred == y) * mask).sum(dim=-1)
                / mask.sum(dim=-1).clamp_min(1.0))
    return eval_metrics


def _make_cnn(dims: DataDims) -> FLModel:
    in_shape = (dims.image_hw, dims.image_hw, 3)
    return FLModel(
        name="cnn", data_kind="image",
        init_params=lambda g: cnn.cnn_init(g, in_shape=in_shape,
                                           n_classes=dims.n_classes),
        apply=cnn.cnn_apply_clients,
        loss=_classification_loss(cnn.cnn_apply_clients),
        eval_metrics=_classification_eval(cnn.cnn_apply_clients),
        batch_shape=in_shape)


def _make_logreg(dims: DataDims) -> FLModel:
    return FLModel(
        name="logreg", data_kind="features",
        init_params=lambda g: cnn.logreg_init(
            g, n_features=dims.n_features, n_classes=dims.n_classes),
        apply=cnn.logreg_apply_clients,
        loss=_classification_loss(cnn.logreg_apply_clients),
        eval_metrics=_classification_eval(cnn.logreg_apply_clients),
        batch_shape=(dims.n_features,))


register_model("cnn", _make_cnn)
register_model("logreg", _make_logreg)
