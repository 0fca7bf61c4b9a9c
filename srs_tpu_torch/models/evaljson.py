"""EVAL.json, the evidence ledger of the checkpoints (port of
``srs_tpu/models/evaljson.py``).

The port reads the reference's packaged ledger by path and never imports
the JAX package: the packaged directory is ``srs_tpu/models/checkpoints``
beside this package in a checkout. :func:`update_eval` writes the port's
own ledgers, under ``~/.cache/srs_tpu_torch`` unless a directory is
given, and never into the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional

from ..utils.paths import REFERENCE_DIR

__all__ = ["DERIVED_EVIDENCE", "DEFAULT_EVAL_DIR", "eval_path", "load_eval", "update_eval",
           "packaged_eval_dir"]

# Evidence blocks measured against one set of weights: a trainer that
# replaces the weights passes them as ``drop`` (reference evaljson.py:27).
DERIVED_EVIDENCE = (
    "photo_panel",
    "photo_panel_ensemble",
    "photo_panel_noise",
    "photo_panel_blur",
    "photo_holdout_x2",
    "cond_panel",
)

# Where the port's ledger lives when no directory is given.
DEFAULT_EVAL_DIR = os.path.join("~", ".cache", "srs_tpu_torch")


def eval_path(out_dir: Optional[str] = None) -> str:
    """The ledger's path in ``out_dir`` (``DEFAULT_EVAL_DIR`` by default)."""
    return os.path.join(os.path.expanduser(out_dir or DEFAULT_EVAL_DIR), "EVAL.json")


def load_eval(out_dir: Optional[str] = None) -> Dict[str, Any]:
    """The ledger in ``out_dir``, or {} when it has none."""
    path = eval_path(out_dir)
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def update_eval(out_dir: Optional[str], key: str, fields: Dict[str, Any],
                drop: Iterable[str] = (), replace: bool = False) -> Dict[str, Any]:
    """Merge ``fields`` into entry ``key`` of the ledger in ``out_dir``
    (``DEFAULT_EVAL_DIR`` when None), keeping every other entry and field;
    ``drop`` removes named fields first, ``replace=True`` swaps the whole
    entry; the file is replaced atomically (reference evaljson.py:49).
    Returns the merged entry. A directory inside the JAX package raises
    ``ValueError``."""
    path = eval_path(out_dir)
    ref = os.path.realpath(REFERENCE_DIR) + os.sep
    if os.path.realpath(path).startswith(ref):
        raise ValueError(f"{path}: the port never writes into the JAX package")
    data = load_eval(out_dir)
    if replace:
        data[key] = {}
    entry = data.setdefault(key, {})
    for k in drop:
        entry.pop(k, None)
    entry.update(fields)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return entry


def packaged_eval_dir() -> str:
    """The JAX package's checkpoints directory of this checkout (absent
    where the checkpoints are not copied, which reads as an empty
    ledger)."""
    return os.path.join(REFERENCE_DIR, "models", "checkpoints")
