"""Parameters carried across between the reference and the port.

The reference's params are a dict pytree of arrays; the port's are a dict
of tensors with the same keys, shapes and layouts (HWIO conv weights,
``(in, out)`` dense weights).  Trees may nest: the LM's tree holds a
``layers`` subtree of stacked tensors.  Both directions go through numpy,
so this module needs neither jax nor the reference package: anything
``np.asarray`` accepts (a jax array included) is a valid leaf.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_numpy(tree: Mapping[str, Any], device: DeviceLike = None
                      ) -> Dict[str, Any]:
    """Reference params (a dict of arrays, nested or flat) -> the port's
    dict of tensors on ``device`` (copies; the source is never aliased)."""
    dev = resolve_device(device)
    return {k: (params_from_numpy(v, dev) if isinstance(v, Mapping)
                else torch.from_numpy(np.array(v, copy=True)).to(dev))
            for k, v in tree.items()}


def params_to_numpy(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's params -> dict of numpy arrays (the reference's layout)."""
    return {k: (params_to_numpy(v) if isinstance(v, Mapping)
                else v.detach().cpu().numpy())
            for k, v in params.items()}
