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
(the paper's models), and ``tiny_lm`` / ``tiny_lm_long``, the dense LM
stack on the federated path.  Params are a flat dict: the LM's nested tree
is flattened at the model's boundary (``models/common.flatten_tree``, keys
like ``layers/attn/wq``, in the reference's leaf order), so the client
update, the codecs and the Eq. 3/4 averages see one dict of leaves for
every model.
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
    #: the bound ModelConfig of an LM entry (None for cnn / logreg)
    config: Any = None


MODELS: Dict[str, Callable[[DataDims], FLModel]] = {}

#: registered in the reference, not yet in the port -> the ROADMAP item
UNPORTED_MODELS: Dict[str, str] = {}

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


# ---------------------------------------------------------------------------
# tiny_lm: the LM stack on the federated path
# ---------------------------------------------------------------------------

def _make_tiny_lm(dims: DataDims, arch: str = "tiny-lm",
                  name: str = "tiny_lm") -> FLModel:
    """A tiny dense causal LM (``configs/tiny_lm.py``) trained federated
    on class-conditional token streams: the reference's ``tiny_lm``.

    Params come from the LM's own specs (``models/lm.py``), flattened;
    the forward is ``transformer.forward_train_clients`` over the K
    clients' params at once; the objective is next-token cross-entropy
    averaged per sample, then mask-weighted over the client's sample
    slots.  ``dims.attention_backend`` lands on the bound config."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import common, lm, transformer

    cfg = get_config(arch).replace(
        vocab_size=dims.vocab_size,
        attention_backend=dims.attention_backend)

    def apply(params, x):
        """params: flat, every leaf (K, ...); x: (K, B, S) tokens ->
        logits (K, B, S, V) fp32."""
        return transformer.forward_train_clients(
            cfg, common.unflatten_tree(params), x)

    def _per_sample_ce(params, x):
        logp = torch.log_softmax(apply(params, x)[..., :-1, :], dim=-1)
        labels = x[..., 1:].long()
        nll = -logp.gather(-1, labels[..., None])[..., 0]   # (K, B, S-1)
        return nll.mean(dim=-1)                              # (K, B)

    def loss(params, x, y, mask):
        del y  # next-token objective; the class label only shapes the data
        ce = _per_sample_ce(params, x)
        return (ce * mask).sum(dim=-1) / mask.sum(dim=-1).clamp_min(1.0)

    def eval_metrics(params, x, y, mask):
        del y
        pred = apply(params, x)[..., :-1, :].argmax(dim=-1)  # (K, B, S-1)
        ok = (pred == x[..., 1:].long()).float().mean(dim=-1)
        return (ok * mask).sum(dim=-1) / mask.sum(dim=-1).clamp_min(1.0)

    def init_params(gen: torch.Generator):
        tree = common.init_from_specs(lm.param_specs(cfg, 1), gen, "cpu",
                                      torch.float32)
        return common.flatten_tree(tree)

    return FLModel(
        name=name, data_kind="tokens", init_params=init_params,
        apply=apply, loss=loss, eval_metrics=eval_metrics,
        batch_shape=(dims.seq_len,), batch_dtype=np.int32, config=cfg)


def _make_tiny_lm_long(dims: DataDims) -> FLModel:
    """The long-sequence tiny LM (arch ``tiny-lm-long``): the same stack
    with ``attn_chunk`` 32, for seq_len about 128."""
    return _make_tiny_lm(dims, arch="tiny-lm-long", name="tiny_lm_long")


register_model("cnn", _make_cnn)
register_model("logreg", _make_logreg)
register_model("tiny_lm", _make_tiny_lm)
register_model("tiny_lm_long", _make_tiny_lm_long)
