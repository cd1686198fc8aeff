"""Device resolution for the port's entry points.

Every entry point (``api.build``, ``SimEnv``, the CLI) takes an explicit
``device``.  ``None`` means the card (``cuda``).  There is no silent
fallback: asking for the card where CUDA is absent raises, and the CPU is
used only when the caller passes ``device="cpu"`` (as the tests do).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; "
                         f"expected 'cuda[:i]' or 'cpu'")
    return dev

