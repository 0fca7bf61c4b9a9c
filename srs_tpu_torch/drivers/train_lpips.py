"""Train the LPIPS feature nets on the distortion ladder with a ranking
loss (port of ``scripts/train_lpips.py``).

The reference's LPIPS loads torch-lpips's pretrained VGG/Alex features
(quality_assessment_module.py:135-146); with no pretrained perceptual
weights to fetch, the features are trained here: for a reference patch
and two distortions at severities k1 < k2 the metric must rank D(ref, d1)
< D(ref, d2), a 2AFC-style hinge, within a kind and across kinds.

    python -m srs_tpu_torch.drivers.train_lpips [--net alex,vgg]
        [--steps 1500] [--cpu] [--out DIR] [--mix v3] [--pairs-n 48]
        [--holdout-n 16]

Saves ``lpips_{net}.pt`` state dicts in ``--out`` (default
``~/.cache/srs_tpu_torch/models``), which ``LPIPSMetric(params={net:
state})`` reads, with their EVAL.json entries; prints the held-out
ranking accuracy against the seeded features. ``main`` returns the
report. ``--mix`` (the reference's pairs come from the ``v3`` mix, which
needs the photo packages; ``proc`` does not), ``--pairs-n`` and
``--holdout-n`` (images behind the training and held-out pairs) are the
port's.
"""

from __future__ import annotations

import argparse
import os
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from ._common import add_device_args, cache_dir, device_of, out_dir_of, run_chunks, upload_u8

SEED0 = 640_000  # disjoint from training/eval/fit seed ranges
CHUNK = 100  # steps per logged chunk


def build_pairs(n_imgs: int, size: int, seed0: int, mix: str = "v3"):
    """(ref, d_lo, d_hi) float32 stacks from the ``fit_qa_models``
    distortion ladder: per image, one within-kind pair per kind and four
    cross-kind pairs with a severity gap of at least 2. Cached under
    ``~/.cache/srs_tpu_torch/lpips`` (rendering is host cv2 work)."""
    from ..models.corpus import render_any
    from .fit_qa_models import distort

    photos = 0
    if mix != "proc":
        from ..models.photo_data import require_photo_paths

        photos = len(require_photo_paths(f"the {mix!r} pair mix"))
    cache = os.path.join(cache_dir("lpips"), f"pairs_v2_{n_imgs}_{size}_{seed0}_{mix}"
                         f"_p{photos}.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            return z["refs"], z["lows"], z["highs"]
    refs, lows, highs = [], [], []
    rng = np.random.default_rng(seed0)
    kinds = ("blur", "noise", "jpeg", "upscale")
    for i in range(n_imgs):
        img = render_any(seed0 + i, size, mix=mix)
        for kind in kinds:
            k1, k2 = sorted(rng.choice(5, 2, replace=False) + 1)
            refs.append(img)
            lows.append(distort(img, kind, int(k1)))
            highs.append(distort(img, kind, int(k2)))
        # cross-kind pairs: a comparable scale ACROSS distortion kinds
        for _ in range(4):
            ka, kb = rng.choice(4, 2, replace=False)
            sb = int(rng.integers(1, 4))  # 1..3
            sa = int(rng.integers(sb + 2, 6))  # sb+2 .. 5
            refs.append(img)
            lows.append(distort(img, kinds[kb], sb))
            highs.append(distort(img, kinds[ka], sa))
    out = (np.stack(refs).astype(np.float32), np.stack(lows).astype(np.float32),
           np.stack(highs).astype(np.float32))
    np.savez(cache + ".tmp.npz", refs=out[0], lows=out[1], highs=out[2])
    os.replace(cache + ".tmp.npz", cache)
    return out


def ranking_accuracy(pair_acc_fn, refs, lows, highs, chunk: int = 32) -> float:
    """Fraction of triplets with D(ref, lo) < D(ref, hi);
    ``pair_acc_fn(r, lo, hi) -> [N] bool`` runs batched."""
    ok, n = 0.0, len(refs)
    for i in range(0, n, chunk):
        ok += float(pair_acc_fn(refs[i:i + chunk], lows[i:i + chunk],
                                highs[i:i + chunk]).sum())
    return ok / n


def distance(module, a, b):
    """[N] LPIPS distances of NHWC [0, 255] batches: unit-normalised
    features, squared differences summed over channels, averaged over
    positions and stages."""
    from ..models.lpips import _unit_normalize

    fa = module((a / 127.5 - 1.0).permute(0, 3, 1, 2))
    fb = module((b / 127.5 - 1.0).permute(0, 3, 1, 2))
    total = 0.0
    for x, y in zip(fa, fb):
        d = _unit_normalize(x) - _unit_normalize(y)
        total = total + (d * d).sum(dim=1).mean(dim=(1, 2))
    return total / len(fa)


def hinge_loss(module, r, lo, hi):
    """The 2AFC hinge on a batch of triplets: the higher severity must
    measure farther by a margin proportional to the pair's scale."""
    import torch

    d_lo = distance(module, r, lo)
    d_hi = distance(module, r, hi)
    m = 0.15 * (d_lo + d_hi).detach() + 1e-4
    return torch.relu(d_lo - d_hi + m).mean()


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m srs_tpu_torch.drivers.train_lpips")
    ap.add_argument("--net", type=str, default="alex,vgg")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    add_device_args(ap)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--mix", type=str, default="v3")
    ap.add_argument("--pairs-n", type=int, default=48)
    ap.add_argument("--holdout-n", type=int, default=16)
    args = ap.parse_args(argv)

    import torch

    from ..models.evaljson import update_eval
    from ..models.lpips import _ARCHS, FeatureNet, _no_tf32, seeded_lpips_params
    from ..models.train import make_optimizer
    from ..utils.device import resolve_device

    device = resolve_device(device_of(args))
    out_dir = out_dir_of(args.out)
    os.makedirs(out_dir, exist_ok=True)
    print("building distortion pairs...", flush=True)
    refs, lows, highs = build_pairs(args.pairs_n, args.size, SEED0, args.mix)
    h_refs, h_lows, h_highs = build_pairs(args.holdout_n, args.size, SEED0 + 10_000, args.mix)
    n = len(refs)

    def up8(a):
        # the stacks are 8-bit to within +-0.5, far below the severity gaps
        # the hinge ranks
        return upload_u8(a, device).float()

    hr_d, hlo_d, hhi_d = up8(h_refs), up8(h_lows), up8(h_highs)
    r_d, lo_d, hi_d = up8(refs), up8(lows), up8(highs)
    report: Dict[str, Any] = {"pairs": int(n), "nets": {}}
    for net in args.net.split(","):
        net = net.strip()
        module = FeatureNet(**_ARCHS[net])
        module.load_state_dict(seeded_lpips_params(net))
        module = module.to(device)
        seed = zlib.crc32(net.encode()) % (2**31)

        @torch.no_grad()
        def pair_acc(r, lo, hi, m=module):
            return distance(m, r, lo) < distance(m, r, hi)

        with _no_tf32():
            module.eval()
            acc0 = ranking_accuracy(pair_acc, hr_d, hlo_d, hhi_d)
            gen = torch.Generator(device).manual_seed(seed + 1)
            t0 = time.time()
            with torch.inference_mode(False), torch.enable_grad():
                module.train().requires_grad_(True)
                opt = make_optimizer(module.parameters(), args.lr)

                def step():
                    idx = torch.randint(0, n, (args.batch,), generator=gen, device=device)
                    opt.zero_grad()
                    loss = hinge_loss(module, r_d[idx], lo_d[idx], hi_d[idx])
                    loss.backward()
                    opt.step()
                    return loss.detach()

                def log(c, loss, net=net):
                    if (c * CHUNK) % 200 == 0:
                        print(f"[{net}] step {c * CHUNK}: loss {loss:.6f}", flush=True)

                losses = run_chunks(max(args.steps // CHUNK, 1), CHUNK, step, log)
            module.eval().requires_grad_(False)
            acc1 = ranking_accuracy(pair_acc, hr_d, hlo_d, hhi_d)
        print(f"[{net}] ranking accuracy: random {acc0:.3f} -> trained {acc1:.3f} "
              f"({time.time() - t0:.0f}s)", flush=True)
        state = {k: v.detach().to("cpu", torch.float32).contiguous()
                 for k, v in module.state_dict().items()}
        path = os.path.join(out_dir, f"lpips_{net}.pt")
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        print(f"[{net}] saved {path}", flush=True)
        update_eval(out_dir, f"lpips_{net}", {
            "rank_acc_random": round(acc0, 4),
            "rank_acc_trained": round(acc1, 4),
            "steps": args.steps, "pairs": int(n),
        }, replace=True)
        report["nets"][net] = {"rank_acc_random": acc0, "rank_acc_trained": acc1,
                               "chunk_losses": losses, "path": path, "state": state}
    print("DONE", flush=True)
    return report


if __name__ == "__main__":
    main()
