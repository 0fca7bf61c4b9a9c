"""Seeded weights: the float32 state dicts of the nets whose configuration
entry names ``"weights": {"seed": <int>}`` in place of trained files, one
for each scale of the route that serves the net. Each is drawn by its
kind's ``init`` (``nets/<kind>.py``) from a generator seeded by the
entry's seed with the net's name and scale, never by a run's ``--seed``,
so every run, both sides of a comparison and the reference get equal
tensors. The benchmark hands them to the program as ``{name}_x{scale}.pt``
files under ``PipelineConfig.checkpoint_dir`` (``run.py``), as a user
serves weights of their own; the reference takes them from here."""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch

from . import nets


def net_seed(seed: int, name: str, scale: int) -> int:
    """The generator seed of ``name`` at ``scale`` under the entry's
    ``seed``: 63 bits of a SHA-256, the same in every process."""
    digest = hashlib.sha256(f"{int(seed)}:{name}:x{int(scale)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def seeded(config: dict) -> Dict[Tuple[str, int], Dict[str, torch.Tensor]]:
    """(name, scale) -> state dict of every seeded net of ``config``, at
    each scale of its route that serves it."""
    route, out = config["route"], {}
    for name, spec in config["nets"].items():
        if "weights" not in spec:
            continue
        kind = nets.load(spec["kind"])
        for scale in sorted({int(s) for s, members in zip(route["ladder"], route["steps"])
                             if any(m == name for m, _passes in members)}):
            gen = torch.Generator().manual_seed(net_seed(spec["weights"]["seed"], name, scale))
            out[(name, scale)] = kind.init(spec, scale, gen)
    return out
