"""Per-scale quality-net selection from held-out panel evidence (port of
``srs_tpu/models/selection.py:1-92``).

Each ladder step serves the trained candidate with the best
``photo_panel.mean_delta`` at its scale in EVAL.json (with the
self-ensemble on, ``photo_panel_ensemble``'s where a candidate has one:
the "+" mode ranks the nets differently); the configured net
only loses a step to a candidate that is trained at that scale and
strictly better on record. "Trained" is the caller's predicate: in the
port, a net is trained at a scale when its weights were handed in.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

from .evaljson import load_eval, packaged_eval_dir

__all__ = ["QUALITY_CANDIDATES", "panel_best_model"]

# Quality-tier candidates, flagship first (iteration order breaks exact
# ties; the robust net belongs to degradation routing).
QUALITY_CANDIDATES = ("edsr_xl", "edsr_l", "edsr_m", "rcan", "espcn")

# (eval.json path, mtime) -> parsed ledger
_CACHE: Dict[Tuple[str, float], Dict[str, Any]] = {}


def _ledger(checkpoint_dir: Optional[str]) -> Dict[str, Any]:
    """EVAL.json of ``checkpoint_dir`` when it holds one, else the
    packaged ledger, else {}."""
    for d in (checkpoint_dir, packaged_eval_dir()):
        if not d:
            continue
        path = os.path.join(d, "EVAL.json")
        try:
            key = (path, os.path.getmtime(path))
        except OSError:
            continue
        if key not in _CACHE:
            _CACHE.clear()
            _CACHE[key] = load_eval(d)
        return _CACHE[key]
    return {}


def panel_best_model(
    scale: int,
    default: str,
    is_trained: Callable[[str, int], bool],
    checkpoint_dir: Optional[str] = None,
    ensemble: bool = False,
) -> str:
    """Panel-best trained quality net for one ladder step of ``scale``;
    ``default`` when no trained candidate carries evidence. ``ensemble``
    reads the ``photo_panel_ensemble`` blocks first."""
    data = _ledger(checkpoint_dir)
    field = "photo_panel_ensemble" if ensemble else "photo_panel"
    order = (default,) + tuple(n for n in QUALITY_CANDIDATES if n != default)
    best_name: Optional[str] = None
    best_delta = float("-inf")
    for name in order:
        entry = data.get(f"{name}_x{scale}") or {}
        delta = (entry.get(field) or entry.get("photo_panel") or {}).get("mean_delta")
        if delta is None or delta <= best_delta:
            continue
        if not is_trained(name, scale):
            continue
        best_name, best_delta = name, float(delta)
    return best_name or default
