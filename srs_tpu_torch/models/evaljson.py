"""Read-only access to EVAL.json, the evidence ledger of the packaged
checkpoints (port of ``srs_tpu/models/evaljson.py:41-85``).

The port reads the ledger by path and never imports the JAX package: the
packaged directory is ``srs_tpu/models/checkpoints`` beside this package
in a checkout. Writers (``update_eval``) stay with the reference.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

from ..utils.paths import REFERENCE_DIR

__all__ = ["load_eval", "packaged_eval_dir"]


def load_eval(out_dir: str) -> Dict[str, Any]:
    """The ledger in ``out_dir``, or {} when it has none."""
    path = os.path.join(out_dir, "EVAL.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def packaged_eval_dir() -> str:
    """The JAX package's checkpoints directory of this checkout (absent
    where the checkpoints are not copied, which reads as an empty
    ledger)."""
    return os.path.join(REFERENCE_DIR, "models", "checkpoints")
