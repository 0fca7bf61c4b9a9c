"""What the drivers share: the device flags, the default directories, the
trained weights of a net and PSNR."""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.train import DEFAULT_CHECKPOINT_DIR

# Where the drivers write when no directory is given.
CACHE_DIR = os.path.join("~", ".cache", "srs_tpu_torch")
QA_DATA_DIR = os.path.join(CACHE_DIR, "qa")


def add_device_args(ap: argparse.ArgumentParser, cpu_flag: bool = True) -> None:
    """``--cpu`` where the reference has it, else ``--device`` (cuda by
    default): the card unless the CPU is asked for."""
    if cpu_flag:
        ap.add_argument("--cpu", action="store_true")
    else:
        ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))


def device_of(args: argparse.Namespace) -> str:
    if hasattr(args, "cpu"):
        return "cpu" if args.cpu else "cuda"
    return args.device


def out_dir_of(path: Optional[str]) -> str:
    """``path``, or the command line's checkpoint directory, expanded."""
    return os.path.expanduser(path or DEFAULT_CHECKPOINT_DIR)


def cache_dir(*parts: str) -> str:
    d = os.path.join(os.path.expanduser(CACHE_DIR), *parts)
    os.makedirs(d, exist_ok=True)
    return d


def trained_params(name: str, scale: int,
                   checkpoint_dir: Optional[str]) -> Optional[Dict[str, torch.Tensor]]:
    """The state dict the port saved for ``name`` at ``scale`` in
    ``checkpoint_dir``, else the store's (the two places the reference's
    ``build_model`` looks), or None."""
    from ..models.registry import load_checkpoint, load_packaged

    sd = load_checkpoint(name, scale, checkpoint_dir)
    return sd if sd is not None else load_packaged(f"{name}_x{scale}.pt")


def load_net(name: str, scale: int, checkpoint_dir: Optional[str],
             device: str) -> Tuple[torch.nn.Module, bool]:
    """(bfloat16 net on ``device``, trained): the saved weights, else the
    untrained init (exact bicubic, or the identity polish)."""
    from ..models.registry import build_model

    return build_model(name, scale, trained_params(name, scale, checkpoint_dir), device=device)


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float(10 * np.log10(255.0**2 / max(mse, 1e-12)))


def upload_u8(corpus, device) -> torch.Tensor:
    """The corpus rounded to uint8 and uploaded once (a quarter of the
    bytes; dequantized per batch)."""
    arr = np.clip(np.round(np.asarray(corpus)), 0, 255).astype(np.uint8)
    return torch.from_numpy(arr).to(device)


def run_chunks(n_chunks: int, chunk: int, step, log=None) -> List[float]:
    """The reference trainers' loop: ``n_chunks`` chunks of ``chunk``
    steps, ``step()`` returning each step's loss as a 0-d device tensor.
    Returns every chunk's mean loss (one host read per chunk); ``log(chunk
    index, mean loss)`` sees each."""
    losses = []
    for c in range(n_chunks):
        total = sum(step() for _ in range(chunk))
        losses.append(float(total) / chunk)
        if log is not None:
            log(c, losses[-1])
    return losses
