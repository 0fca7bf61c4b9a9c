"""The conditioned polish's acceptance on the held-out photo panel (port
of ``scripts/cond_panel.py``).

For each panel image the HR is distorted with a known recipe (sigma-8
noise, a 1.0 blur, q35 JPEG), and the trained ``cond_polish`` must
restore it better conditioned on the matching vector than blind (c = 0),
and stay near the identity on clean images at c = 0.

    python -m srs_tpu_torch.drivers.cond_panel [--cpu] [--no-write]
        [--checkpoint-dir DIR]

Prints one JSON line per image and a summary, and records ``cond_panel``
under ``cond_polish_x1`` in the EVAL.json of ``--checkpoint-dir``
(default ``~/.cache/srs_tpu_torch/models``, where ``cond_polish_x1.pt``
is read). ``main`` returns the report; ``ok`` is false, and the command
exits 1, when no trained polish is there. Needs the panel's packages.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from ._common import add_device_args, device_of, out_dir_of, psnr


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m srs_tpu_torch.drivers.cond_panel")
    add_device_args(ap)
    ap.add_argument("--no-write", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    args = ap.parse_args(argv)

    import torch

    from ..models.conditioning import build_cond_polish
    from ..models.corpus import _cv2
    from ..models.registry import load_checkpoint
    from .photo_eval import load_panel

    device = device_of(args)
    ckdir = out_dir_of(args.checkpoint_dir)
    params = load_checkpoint("cond_polish", 1, ckdir)
    if params is None:
        print(f"no trained cond_polish checkpoint in {ckdir}", file=sys.stderr)
        return {"ok": False}
    net, _ = build_cond_polish(params, device=device)
    panel = load_panel()
    cv2 = _cv2()

    def run(x, c):
        with torch.no_grad():
            y = net(torch.from_numpy(np.ascontiguousarray(x, np.float32))[None].to(device), c)
        return torch.clamp(y, 0, 255)[0].float().cpu().numpy()

    rows = []
    for tag, hr in panel:
        # the documented recipe the conditioning vector names
        rng = np.random.default_rng(5)
        d = cv2.GaussianBlur(hr, (0, 0), 1.0)
        ok, buf = cv2.imencode(".jpg", d[..., ::-1].astype(np.uint8),
                               [int(cv2.IMWRITE_JPEG_QUALITY), 35])
        d = cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1].astype(np.float32)
        d = np.clip(d + rng.normal(0, 8, d.shape), 0, 255).astype(np.float32)
        # the trained contract (degrade_conditioned): noise sigma = 25 c0,
        # blur sigma = 1.6 c1, JPEG table scale = 2.5 c2 (q35 ~ 50/35)
        c = torch.tensor([[8.0 / 25.0, 1.0 / 1.6, 1.43 / 2.5]], dtype=torch.float32,
                         device=device)
        row = {
            "image": tag,
            "distorted": round(psnr(d, hr), 3),
            "conditioned": round(psnr(run(d, c), hr), 3),
            "blind": round(psnr(run(d, torch.zeros_like(c)), hr), 3),
            "clean_passthrough": round(psnr(run(hr, torch.zeros_like(c)), hr), 3),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    mean_c = float(np.mean([r["conditioned"] for r in rows]))
    mean_b = float(np.mean([r["blind"] for r in rows]))
    mean_d = float(np.mean([r["distorted"] for r in rows]))
    summary = {
        "panel_mean_distorted": round(mean_d, 3),
        "panel_mean_conditioned": round(mean_c, 3),
        "panel_mean_blind": round(mean_b, 3),
        "cond_beats_blind": mean_c > mean_b,
        "min_clean_passthrough": round(min(r["clean_passthrough"] for r in rows), 2),
    }
    print(json.dumps(summary))
    if not args.no_write:
        from ..models.evaljson import update_eval

        update_eval(ckdir, "cond_polish_x1", {"cond_panel": summary})
        print("EVAL.json updated")
    return {"ok": True, "rows": rows, "summary": summary}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
