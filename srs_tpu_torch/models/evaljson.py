"""EVAL.json, the evidence ledger of the checkpoints (port of
``srs_tpu/models/evaljson.py``).

The packaged ledger is the store's copy of the reference's
(``PACKAGED_EVAL_DIR``, byte-equal to
``srs_tpu/models/checkpoints/EVAL.json``). Like the reference's, its
place is fixed: pointing ``registry.PACKAGED_CHECKPOINT_DIR`` elsewhere
hides the stored nets, not the ledgers. :func:`update_eval` writes the
port's own ledgers, under ``~/.cache/srs_tpu_torch`` unless a directory
is given, and never into the JAX package or the store.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional

from ..utils.paths import REFERENCE_DIR

__all__ = ["DERIVED_EVIDENCE", "DEFAULT_EVAL_DIR", "PACKAGED_EVAL_DIR", "eval_path",
           "load_eval", "update_eval", "packaged_eval_dir"]

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
# The store, whose EVAL.json and FUSION.json are the packaged ledgers.
PACKAGED_EVAL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints")


def eval_path(out_dir: Optional[str] = None) -> str:
    """The ledger's path in ``out_dir`` (``DEFAULT_EVAL_DIR`` by default)."""
    return os.path.join(os.path.expanduser(out_dir or DEFAULT_EVAL_DIR), "EVAL.json")


def load_eval(out_dir: Optional[str] = None) -> Dict[str, Any]:
    """The ledger in ``out_dir``, or {} when it has none; one that is not
    JSON raises ``ValueError`` naming it."""
    path = eval_path(out_dir)
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        try:
            return json.load(f)
        except ValueError as e:
            raise ValueError(f"{path}: not loadable ({e})") from e


def update_eval(out_dir: Optional[str], key: str, fields: Dict[str, Any],
                drop: Iterable[str] = (), replace: bool = False) -> Dict[str, Any]:
    """Merge ``fields`` into entry ``key`` of the ledger in ``out_dir``
    (``DEFAULT_EVAL_DIR`` when None), keeping every other entry and field;
    ``drop`` removes named fields first, ``replace=True`` swaps the whole
    entry; the file is replaced atomically (reference evaljson.py:49).
    Returns the merged entry. A directory inside the JAX package or the
    store raises ``ValueError``."""
    path = eval_path(out_dir)
    for guarded, what in ((REFERENCE_DIR, "the JAX package"), (packaged_eval_dir(), "the store")):
        if os.path.realpath(path).startswith(os.path.realpath(guarded) + os.sep):
            raise ValueError(f"{path}: the port never writes into {what}")
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
    """``PACKAGED_EVAL_DIR``, which holds the packaged EVAL.json and
    FUSION.json (a directory without them reads as an empty ledger). A
    ledger its manifest lists that is missing or differs from the
    manifest's bytes or sha256 raises ``registry.StoreError``."""
    from . import registry

    for fname in ("EVAL.json", "FUSION.json"):
        registry.packaged_file(fname, PACKAGED_EVAL_DIR, check_sha=True)
    return PACKAGED_EVAL_DIR
