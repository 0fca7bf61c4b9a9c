"""The routed default's acceptance on the held-out photo panel (port of
``scripts/routed_panel.py``).

Runs the FULL pipeline (per-scale selection, degradation routing and the
SR-gain self-probe: what a user's x2 job serves) on each panel image
downscaled by ``--scale`` and scores the output against the held-out HR.
Acceptance: no panel image below bicubic for the routed default.

    python -m srs_tpu_torch.drivers.routed_panel [--cpu] [--scale 2]
        [--routes bicubic,shrink] [--no-write] [--checkpoint-dir DIR]

Prints one JSON line per image and route plus a summary per route, and
records ``routed_panel[_<route>]`` under ``pipeline_x{scale}`` in the
EVAL.json of ``--checkpoint-dir`` (default
``~/.cache/srs_tpu_torch/models``, where the nets are read). ``main``
returns the report; ``ok`` is the first route's verdict, which is the
exit code from the command line. Needs the panel's packages
(``photo_eval.load_panel``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

from ._common import add_device_args, device_of, out_dir_of, psnr


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m srs_tpu_torch.drivers.routed_panel")
    add_device_args(ap)
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--no-write", action="store_true")
    ap.add_argument("--routes", default="bicubic,shrink",
                    help="comma list of sr_gain_route values to measure; the acceptance "
                    "verdict (no image negative) applies to the FIRST")
    ap.add_argument("--checkpoint-dir", default=None)
    args = ap.parse_args(argv)

    import torch

    from ..io.image import load_image
    from ..models.corpus import _cv2
    from ..ops.resize import resize_bicubic_up
    from ..pipeline import PipelineConfig, SuperResolutionPipeline
    from .photo_eval import load_panel

    device = device_of(args)
    ckdir = out_dir_of(args.checkpoint_dir)
    panel = load_panel()
    cv2 = _cv2()
    s = args.scale
    routes = [r.strip() for r in args.routes.split(",") if r.strip()]
    eval_update: Dict[str, Any] = {}
    first_summary = None
    with tempfile.TemporaryDirectory() as td:
        for route in routes:
            cfg = PipelineConfig(block_size=128, overlap_ratio=0.2, target_resolution="0x0",
                                 provider="quality", enable_qa=False, sr_gain_route=route,
                                 device=device, checkpoint_dir=ckdir)
            pipe = SuperResolutionPipeline(cfg)
            rows = []
            for tag, hr in panel:
                lr = cv2.resize(hr, (hr.shape[1] // s, hr.shape[0] // s),
                                interpolation=cv2.INTER_AREA)
                # the baseline quantized like the pipeline's 8-bit output
                up = resize_bicubic_up(torch.from_numpy(lr)[None], s)[0].numpy()
                base = psnr(np.round(np.clip(up, 0, 255)), hr)
                pipe.config.target_resolution = f"{hr.shape[1]}x{hr.shape[0]}"
                out = os.path.join(td, f"routed_{tag}_x{s}_{route}.png")
                r = pipe.process(lr, out)
                if not r.success:
                    raise RuntimeError(r.error_message)
                p = psnr(load_image(out), hr)
                info = dict(pipe.last_run_info)
                probe = info.get("sr_gain_probe")
                row = {
                    "image": tag,
                    "psnr": round(p, 3),
                    "delta": round(p - base, 3),
                    "provider": info.get("provider"),
                    "models": info.get("models"),
                    "sr_gain_probe": round(probe, 3) if probe is not None else None,
                }
                if info.get("sr_gain_alpha") is not None:
                    row["sr_gain_alpha"] = info["sr_gain_alpha"]
                rows.append(row)
                print(json.dumps({"route": route, **row}), flush=True)
            deltas = [r["delta"] for r in rows]
            summary = {
                "scale": s,
                "route": route,
                "mean_delta": round(float(np.mean(deltas)), 3),
                "min_delta": round(float(np.min(deltas)), 3),
                "no_image_negative": bool(min(deltas) >= -0.01),
            }
            print(json.dumps(summary))
            key = "routed_panel" if route == routes[0] else f"routed_panel_{route}"
            eval_update[key] = {"rows": rows, **summary}
            if first_summary is None:
                first_summary = summary
    if not args.no_write:
        from ..models.evaljson import update_eval

        update_eval(ckdir, f"pipeline_x{s}", eval_update)
        print("EVAL.json updated")
    return {"ok": first_summary["no_image_negative"], **eval_update}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
