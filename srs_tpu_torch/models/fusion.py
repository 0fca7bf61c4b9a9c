"""Linear fusion of SR nets, the ``fusion`` provider's weights (port of
``srs_tpu/models/fusion.py``).

``FUSION.json`` holds, per scale, the members (registry names, ``name+``
for a member served as its dihedral self-ensemble, and ``bicubic``) and
their affine least-squares weights, which sum to 1. Members without
weights are dropped at serving time and the rest renormalised
(``SuperResolutionModule._fusion_for``).

The port reads the file by path: ``ModelConfig.checkpoint_dir`` first,
then the store's copy of the reference's (``evaljson.packaged_eval_dir``),
as ``models/evaljson.py`` reads EVAL.json. It never writes into the
store: ``save_fusion`` takes the directory to write.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .evaljson import packaged_eval_dir

__all__ = ["fusion_path", "load_fusion", "fit_affine_weights", "save_fusion"]


def fusion_path(checkpoint_dir: Optional[str] = None) -> Optional[str]:
    """The first FUSION.json: ``checkpoint_dir``'s, then the packaged one."""
    for d in (checkpoint_dir, packaged_eval_dir()):
        if not d:
            continue
        p = os.path.join(d, "FUSION.json")
        if os.path.isfile(p):
            return p
    return None


def load_fusion(
    scale: int, checkpoint_dir: Optional[str] = None
) -> Optional[Tuple[List[str], List[float]]]:
    """(members, weights) for ``scale``, or None when no file has a valid
    entry for it."""
    p = fusion_path(checkpoint_dir)
    if p is None:
        return None
    try:
        with open(p) as f:
            entry = json.load(f).get(f"x{scale}")
        if not entry:
            return None
        members = [str(m) for m in entry["members"]]
        weights = [float(w) for w in entry["weights"]]
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return None
    if len(members) != len(weights) or not members:
        return None
    return members, weights


def save_fusion(
    per_scale: Dict[int, Tuple[Sequence[str], Sequence[float], Dict]],
    out_dir: str,
) -> str:
    """Write ``out_dir``/FUSION.json, merged over the scales it already has."""
    p = os.path.join(out_dir, "FUSION.json")
    data: Dict = {}
    if os.path.isfile(p):
        with open(p) as f:
            data = json.load(f)
    for scale, (members, weights, meta) in per_scale.items():
        data[f"x{scale}"] = {
            "members": list(members),
            "weights": [float(w) for w in weights],
            **meta,
        }
    with open(p, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    return p


def fit_affine_weights(outputs: Sequence[np.ndarray], target: np.ndarray) -> np.ndarray:
    """Least-squares weights over member ``outputs`` minimising the MSE to
    ``target`` subject to sum(w) == 1: with w_K = 1 - sum(w_0..K-2), the
    normal equations on the members' differences from the last member."""
    k = len(outputs)
    if k == 1:
        return np.ones(1)
    t = target.astype(np.float64).ravel()
    ys = [np.asarray(o, np.float64).ravel() for o in outputs]
    base = ys[-1]
    d = np.stack([y - base for y in ys[:-1]], axis=1)  # [P, K-1]
    r = t - base
    g = d.T @ d
    b = d.T @ r
    # a small ridge keeps near-duplicate members solvable
    w_head = np.linalg.solve(g + 1e-8 * np.trace(g) / max(len(b), 1) * np.eye(len(b)), b)
    return np.concatenate([w_head, [1.0 - float(np.sum(w_head))]])
