"""The device an entry point of the port runs on."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``. ``"cuda"`` needs a card: without
    one this raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch sees no CUDA device; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU"
        )
    return dev
