"""Synthetic federated datasets with controllable non-i.i.d.-ness.

The port of ``repro/data/federated.py``: the same generator, seeded the
same way, with the same rng draw order, so both packages train on
byte-identical partitions.

  * ``#class`` partitioning — each client holds samples from exactly
    ``classes_per_client`` labels (the paper's 2/4/6/8-class splits),
  * ``dirichlet:<alpha>`` partitioning — per-client label distributions
    drawn from Dir(alpha),
  * unequal client sizes (log-normal), 80/20 train/test split per client,
  * "image" kind: class-template + noise images (CNN-learnable),
  * "features" kind: class-conditional feature vectors (logreg-learnable),
  * "tokens" kind: class-conditional Markov token streams
    (data/pipeline.py; the federated tiny LM's data).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.data.pipeline import class_token_sequences


@dataclasses.dataclass
class ClientData:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_train(self) -> int:
        return len(self.y_train)


@dataclasses.dataclass
class FederatedDataset:
    clients: List[ClientData]
    n_classes: int
    input_shape: Tuple[int, ...]
    input_dtype: np.dtype = np.float32

    @property
    def n_clients(self) -> int:
        return len(self.clients)


def _class_templates(rng, n_classes, shape, scale=2.0):
    return rng.normal(0.0, scale, size=(n_classes,) + shape).astype(np.float32)


def parse_partitioner(partitioner: str) -> Tuple[str, float]:
    """``'#class'`` -> ("#class", 0) | ``'dirichlet:<alpha>'`` ->
    ("dirichlet", alpha).  Raises ValueError with the accepted grammar."""
    kind, _, arg = str(partitioner).partition(":")
    if kind == "#class":
        return "#class", 0.0
    if kind == "dirichlet":
        try:
            alpha = float(arg) if arg else 0.5
        except ValueError:
            raise ValueError(
                f"bad dirichlet concentration in partitioner "
                f"{partitioner!r} (expected e.g. 'dirichlet:0.3')")
        if not alpha > 0:
            raise ValueError(f"dirichlet alpha must be > 0, got {alpha}")
        return "dirichlet", alpha
    raise ValueError(f"unknown partitioner {partitioner!r}; expected "
                     f"'#class' or 'dirichlet:<alpha>'")


#: accepted data kinds; "text" is the pre-registry alias for "features"
DATA_KINDS = ("image", "features", "tokens")


def make_federated(
    task: str = "image",
    n_clients: int = 100,
    n_classes: int = 10,
    classes_per_client: int = 2,
    samples_per_client: int = 100,
    image_hw: int = 12,
    n_features: int = 128,
    noise: float = 1.0,
    seed: int = 0,
    partitioner: str = "#class",
    vocab_size: int = 64,
    seq_len: int = 16,
) -> FederatedDataset:
    """``task`` is the data kind (``DATA_KINDS``; "text" aliases
    "features").  ``#class``: classes_per_client >= n_classes => i.i.d.
    ``dirichlet:<alpha>``: per-client class proportions drawn from
    Dir(alpha); classes_per_client is ignored."""
    data_kind = "features" if task == "text" else task
    if data_kind not in DATA_KINDS:
        raise ValueError(f"unknown data kind {task!r}; "
                         f"expected one of {DATA_KINDS} (or 'text')")
    kind, alpha = parse_partitioner(partitioner)
    rng = np.random.default_rng(seed)
    if data_kind == "tokens":
        shape, dtype = (seq_len,), np.int32
        templates = None
    else:
        shape = ((image_hw, image_hw, 3) if data_kind == "image"
                 else (n_features,))
        dtype = np.float32
        templates = _class_templates(rng, n_classes, shape)

    clients = []
    for c in range(n_clients):
        if kind == "dirichlet":
            p = rng.dirichlet(np.full(n_classes, alpha))
            n = max(int(rng.lognormal(np.log(samples_per_client), 0.3)), 20)
            y = rng.choice(n_classes, n, p=p).astype(np.int32)
        else:
            if classes_per_client >= n_classes:
                labels_pool = np.arange(n_classes)
            else:
                labels_pool = rng.choice(n_classes, classes_per_client,
                                         replace=False)
            n = max(int(rng.lognormal(np.log(samples_per_client), 0.3)), 20)
            y = rng.choice(labels_pool, n).astype(np.int32)
        if data_kind == "tokens":
            x = class_token_sequences(rng, y, vocab_size, seq_len)
        else:
            x = templates[y] + rng.normal(
                0, noise, size=(n,) + shape).astype(np.float32)
        n_tr = int(0.8 * n)
        clients.append(ClientData(x[:n_tr], y[:n_tr], x[n_tr:], y[n_tr:]))
    return FederatedDataset(clients, n_classes, shape, np.dtype(dtype))


def pad_stack(ds: FederatedDataset, max_samples: int = 0
              ) -> Dict[str, np.ndarray]:
    """Stack clients into dense arrays padded to a common sample count,
    with sample masks."""
    cap = max_samples or max(c.n_train for c in ds.clients)
    n = ds.n_clients
    xs = np.zeros((n, cap) + ds.input_shape, ds.input_dtype)
    ys = np.zeros((n, cap), np.int32)
    mask = np.zeros((n, cap), bool)
    for i, c in enumerate(ds.clients):
        k = min(c.n_train, cap)
        xs[i, :k] = c.x_train[:k]
        ys[i, :k] = c.y_train[:k]
        mask[i, :k] = True
    return {"x": xs, "y": ys, "mask": mask,
            "n_samples": mask.sum(1).astype(np.int32)}
