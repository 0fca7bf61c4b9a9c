"""Train ``espcn_polish``, the scale-1 polish of the hybrid ladder (port of
``scripts/train_polish.py``).

The reference's hybrid ladder ends with a polish model (veImageX fast_sr
1.0x, super_resolution_module.py:964-981). This trains it as an
SR-artifact cleanup net: pairs are (a frozen x2 net's output, the HR
truth), the nets ``hybrid`` polishes after (the quality net ``edsr_xl``
with probability 0.6, else the fast ``espcn``), read from the checkpoint
directory (untrained, they are bicubic).

    python -m srs_tpu_torch.drivers.train_polish [--steps 20000] [--cpu]
        [--out DIR] [--mix v3] [--corpus-n 3072]

Saves ``espcn_polish_x1.pt`` and its EVAL.json entry in ``--out``
(default ``~/.cache/srs_tpu_torch/models``); ``main`` returns the report
(held-out PSNR of the SR and of its polish, the chunk losses, the saved
path and state); :func:`train` and :func:`holdout` are its two halves.
``--mix`` (the reference trains on the ``v3`` corpus, which needs the
photo packages; ``proc`` does not) and ``--corpus-n`` are the port's.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ._common import add_device_args, device_of, load_net, out_dir_of, run_chunks, upload_u8


def polish_inputs(hr: torch.Tensor, q_net, f_net, use_q: torch.Tensor) -> torch.Tensor:
    """What the polish learns to clean: ``hr`` area-downscaled x2 and
    upscaled by the quality producer where ``use_q`` ([N, 1, 1, 1] bool),
    else by the fast one, clamped to [0, 255]."""
    from ..models.train import downsample_area

    lr_b = downsample_area(hr, 2)
    with torch.no_grad():
        sr_q = torch.clamp(q_net(lr_b), 0, 255)
        sr_f = torch.clamp(f_net(lr_b), 0, 255)
    return torch.where(use_q, sr_q, sr_f)


def train(corpus: torch.Tensor, q_net, f_net, args: argparse.Namespace,
          device: torch.device) -> Tuple[torch.nn.Module, List[float], int]:
    """(polish net, each chunk's mean loss, steps run): ``espcn_polish``
    from its init, trained on random HR crops of ``corpus`` and their SR,
    the quality producer's with probability 0.6."""
    from ..models.registry import build_model, init_params
    from ..models.train import (cosine_decay_schedule, init_train_state, random_crops,
                                train_step)

    hp = args.patch * 2
    gen = torch.Generator(device).manual_seed(11)
    n_chunks = max(args.steps // args.scan_chunk, 1)
    with torch.inference_mode(False), torch.enable_grad():
        net, _ = build_model("espcn_polish", 1, init_params("espcn_polish", 1, 0),
                             device=device, master_weights=True)
        net, opt = init_train_state(net, cosine_decay_schedule(args.lr, max(args.steps, 1)))

        def step():
            hr = random_crops(corpus, args.batch, hp, gen)
            use_q = torch.rand((args.batch, 1, 1, 1), generator=gen, device=device) < 0.6
            return train_step(net, opt, polish_inputs(hr, q_net, f_net, use_q), hr)["loss"]

        def log(c, loss):
            if (c + 1) * args.scan_chunk % 1000 == 0:
                print(f"[espcn_polish] step {(c + 1) * args.scan_chunk}: loss {loss:.5f}",
                      flush=True)

        losses = run_chunks(n_chunks, args.scan_chunk, step, log)
    return net.eval().requires_grad_(False), losses, n_chunks * args.scan_chunk


@torch.no_grad()
def holdout(q_net, net, device: torch.device) -> Tuple[float, float]:
    """(PSNR of the quality producer's SR, PSNR of its polish) on eight
    held-out 192-px renders: the polish must beat the SR, and not hurt."""
    from ..models.corpus import make_corpus
    from ..models.train import _psnr, downsample_area

    hr = torch.from_numpy(make_corpus(8, 192, seed=100_500)[:, :192, :192]).to(device)
    sr = torch.clamp(q_net(downsample_area(hr, 2)), 0, 255)
    return _psnr(sr, hr), _psnr(torch.clamp(net(sr), 0, 255), hr)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m srs_tpu_torch.drivers.train_polish")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--patch", type=int, default=48)  # LR patch; HR = 2x
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--scan-chunk", type=int, default=50)
    add_device_args(ap)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--mix", type=str, default="v3")
    ap.add_argument("--corpus-n", type=int, default=3072)
    args = ap.parse_args(argv)

    from ..models.evaljson import DERIVED_EVIDENCE, update_eval
    from ..models.train import save_checkpoint
    from ..utils.device import resolve_device
    from .pretrain import load_corpus

    device = resolve_device(device_of(args))
    out_dir = out_dir_of(args.out)
    corpus = upload_u8(load_corpus(n=args.corpus_n, mix=args.mix), device)
    # the frozen SR producers polish follows at serving time
    q_net, _ = load_net("edsr_xl", 2, out_dir, device)
    f_net, _ = load_net("espcn", 2, out_dir, device)
    t0 = time.time()
    net, losses, steps = train(corpus, q_net, f_net, args, device)
    sr_db, pol_db = holdout(q_net, net, device)
    print(f"[espcn_polish] holdout: sr {sr_db:.2f} dB -> polished {pol_db:.2f} dB "
          f"({time.time() - t0:.0f}s)", flush=True)
    state = {k: v.detach().to("cpu", torch.float32) for k, v in net.state_dict().items()}
    path = save_checkpoint(state, "espcn_polish", 1, out_dir)
    entry = update_eval(out_dir, "espcn_polish_x1", {
        "holdout_sr": round(sr_db, 3),
        "holdout_polished": round(pol_db, 3),
        "sr_producer": "edsr_xl/espcn x2 mix",
        "steps": args.steps,
        "train_seconds": round(time.time() - t0, 1),
    }, drop=DERIVED_EVIDENCE)
    print("DONE", flush=True)
    return {"eval": entry, "chunk_losses": losses, "steps_run": steps, "path": path,
            "state": state}


if __name__ == "__main__":
    main()
