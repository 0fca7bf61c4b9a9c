"""End-to-end quality benchmark: the pipeline's output PSNR against a
known HR truth, per provider (port of ``scripts/quality_bench.py``).

Net-level eval (EVAL.json) scores the bare nets; this runs the WHOLE
pipeline (tiling -> SR ladder -> blend -> save) on synthetic LR inputs
whose HR ground truth is known, per provider: the system-level analog of
the reference's remote-provider quality claims
(super_resolution_module.py:561-711).

    python -m srs_tpu_torch.drivers.quality_bench [--cpu] [--n 6]
        [--size 512] [--no-photo] [--checkpoint-dir DIR]

Prints one JSON line per provider and a summary table; ``main`` returns
the rows. The photo row needs the held-out portrait (``photo_eval.
load_panel``), which raises ``PhotoDataMissing`` where matplotlib or PIL
is not installed: pass ``--no-photo`` there. Trained nets are read from
``--checkpoint-dir`` (default ``~/.cache/srs_tpu_torch/models``), the
port's flag.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

from ._common import add_device_args, device_of, out_dir_of, psnr

# (provider, extra PipelineConfig fields), the reference's rows.
PROVIDERS = [
    ("bicubic", {}),
    ("fast", {}),
    ("quality", {}),
    ("quality", {"quality_model": "rcan"}),
    ("quality", {"quality_model": "edsr_l"}),
    ("hybrid", {}),
    ("zssr", {"zssr_steps": 100}),
]


def label_of(provider: str, extra: Dict[str, Any]) -> str:
    return provider + (f"[{extra['quality_model']}]" if "quality_model" in extra else "")


def bench_images(n: int, hr_size: int, no_photo: bool) -> List:
    """[(kind, HR float32)]: ``n`` held-out renders (seeds 880000+, disjoint
    from training and fitting), then the portrait unless ``no_photo``."""
    from ..models.corpus import _cv2, render_image, render_natural

    images = []
    for i in range(n):
        render = render_natural if i % 2 else render_image
        images.append(("proc", render(880_000 + i, hr_size)))
    if not no_photo:
        from .photo_eval import load_panel

        cv2 = _cv2()
        for _tag, photo in load_panel(["portrait"]):
            ph, pw = photo.shape[:2]
            s = min(hr_size / ph, hr_size / pw, 1.0)
            if s < 1.0:
                photo = cv2.resize(photo, (int(pw * s) // 4 * 4, int(ph * s) // 4 * 4),
                                   interpolation=cv2.INTER_AREA)
            images.append(("photo", photo))
    return images


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser(prog="python -m srs_tpu_torch.drivers.quality_bench")
    add_device_args(ap)
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--size", type=int, default=512, help="HR size (LR = size/2)")
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--no-photo", action="store_true",
                    help="skip the held-out real-photograph row")
    ap.add_argument("--checkpoint-dir", default=None)
    args = ap.parse_args(argv)

    from ..io.image import load_image
    from ..models.corpus import _cv2
    from ..pipeline import PipelineConfig, SuperResolutionPipeline

    cv2 = _cv2()
    device = device_of(args)
    ckdir = out_dir_of(args.checkpoint_dir)
    hr_size = args.size
    images = bench_images(args.n, hr_size, args.no_photo)

    out_rows = []
    with tempfile.TemporaryDirectory() as td:
        for prov, extra in PROVIDERS:
            scores: Dict[str, list] = {"proc": [], "photo": []}
            for i, (kind, hr) in enumerate(images):
                lr = cv2.resize(hr, (hr.shape[1] // args.scale, hr.shape[0] // args.scale),
                                interpolation=cv2.INTER_AREA)
                cfg = PipelineConfig(block_size=128,
                                     target_resolution=f"{hr.shape[1]}x{hr.shape[0]}",
                                     provider=prov, enable_qa=False, device=device,
                                     checkpoint_dir=ckdir, **extra)
                out = os.path.join(td, f"{prov}_{i}.png")
                r = SuperResolutionPipeline(cfg).process(lr, out)
                if not r.success:
                    raise RuntimeError(r.error_message)
                scores[kind].append(psnr(load_image(out), hr))
            row = {
                "provider": label_of(prov, extra),
                "psnr_mean": round(float(np.mean(scores["proc"])), 3),
                "psnr_min": round(float(np.min(scores["proc"])), 3),
                "n": len(scores["proc"]),
                "hr": hr_size,
                "scale": args.scale,
            }
            if scores["photo"]:
                row["photo_psnr"] = round(float(np.mean(scores["photo"])), 3)
            out_rows.append(row)
            print(json.dumps(row), flush=True)
    base = next(r["psnr_mean"] for r in out_rows if r["provider"] == "bicubic")
    base_ph = next((r.get("photo_psnr") for r in out_rows if r["provider"] == "bicubic"), None)
    print("\nprovider          PSNR    vs bicubic   photo    vs bicubic")
    for r in out_rows:
        line = f"{r['provider']:<16} {r['psnr_mean']:6.2f}  {r['psnr_mean'] - base:+.2f} dB"
        if base_ph is not None and "photo_psnr" in r:
            line += f"   {r['photo_psnr']:6.2f}  {r['photo_psnr'] - base_ph:+.2f} dB"
        print(line)
    return out_rows


if __name__ == "__main__":
    main()
