"""Re-run the held-out eval panel of already-trained nets and merge the
numbers into EVAL.json, with no training (port of ``scripts/reeval.py``).

Eval code evolves after a net is trained; rerunning the eval is seconds,
retraining an hour.

    python -m srs_tpu_torch.drivers.reeval [--cpu] [--only edsr_l_robust_x2,...]
        [out_dir]

Scores every ``{name}_x{scale}.pt`` (scales 2-4) in ``out_dir`` (default
``~/.cache/srs_tpu_torch/models``) and merges each entry into the
EVAL.json there, keeping the training provenance and the derived
evidence blocks. ``main`` returns {net key: the merged entry}.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from ._common import out_dir_of, trained_params


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--cpu" in argv:
        argv.remove("--cpu")
        device = "cpu"
    only = None
    if "--only" in argv:
        i = argv.index("--only")
        only = set(argv[i + 1].split(","))
        del argv[i : i + 2]
    out_dir = out_dir_of(argv[0] if argv else None)

    from ..models.evaljson import update_eval
    from ..models.registry import MODEL_REGISTRY, build_model
    from ..models.train import eval_on_holdout
    from ..utils.device import resolve_device

    resolve_device(device)
    merged = {}
    for name in sorted(MODEL_REGISTRY):
        for scale in (1, 2, 3, 4):
            tag = f"{name}_x{scale}"
            if only is not None and tag not in only:
                continue
            params = None if scale == 1 else trained_params(name, scale, out_dir)
            if params is None:
                continue
            net, _ = build_model(name, scale, params, device=device)
            t0 = time.time()
            stats = eval_on_holdout(net, scale, n=12, size=256)
            if "robust" in name:
                deg = eval_on_holdout(net, scale, n=12, size=256, degradation="robust")
                stats["psnr_net_degraded"] = deg["psnr_net"]
                stats["psnr_bicubic_degraded"] = deg["psnr_bicubic"]
            # same weights, fresher eval code: a merge
            merged[tag] = update_eval(out_dir, tag, stats)
            print(f"[{tag}] {json.dumps(stats)} ({time.time() - t0:.1f}s)", flush=True)
    print("updated", os.path.join(out_dir, "EVAL.json"))
    return merged


if __name__ == "__main__":
    main()
