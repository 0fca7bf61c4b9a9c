"""Train ``cond_polish``, the FiLM prompt-conditioned restoration net (port
of ``scripts/train_cond.py``).

The reference's prompt categories steer its diffusion provider's output
(super_resolution_module.py:102-222); here a category maps to a
conditioning vector (``models/conditioning.CATEGORY_CONDITIONING``) that
FiLM-modulates this net. Pairs: an HR patch distorted by a per-image
random noise, blur and JPEG mix, and the HR truth, with c the APPLIED
strengths (``degrade_conditioned``, on the device): the net learns
p(clean | distorted, c). The FiLM layer trains through the out-of-place
arm of ``CondPolish.forward``.

    python -m srs_tpu_torch.drivers.train_cond [--steps 20000] [--cpu]
        [--mix p70] [--out DIR] [--corpus-n 3072]

Saves ``cond_polish_x1.pt`` and its EVAL.json entry in ``--out`` (default
``~/.cache/srs_tpu_torch/models``); ``main`` returns the report (the
held-out checks, the chunk losses, how far the FiLM layer moved, the
saved path and state); :func:`train` and :func:`holdout` are its two
halves. The default ``p70`` mix needs the photo packages;
``--mix proc`` does not. ``--corpus-n`` is the port's.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ._common import add_device_args, device_of, out_dir_of, run_chunks, upload_u8


def train(corpus: torch.Tensor, args: argparse.Namespace, device: torch.device
          ) -> Tuple[torch.nn.Module, List[float], int]:
    """(cond_polish net, each chunk's mean loss, steps run): the net from
    its init, trained on random crops of ``corpus`` distorted with the
    strengths ``c`` it is conditioned on."""
    from ..models.conditioning import degrade_conditioned
    from ..models.registry import build_model, init_params
    from ..models.train import (cosine_decay_schedule, init_train_state, random_crops,
                                train_step)

    gen = torch.Generator(device).manual_seed(13)
    n_chunks = max(args.steps // args.scan_chunk, 1)
    with torch.inference_mode(False), torch.enable_grad():
        net, _ = build_model("cond_polish", 1, init_params("cond_polish", 1, 0),
                             device=device, master_weights=True)
        net, opt = init_train_state(net, cosine_decay_schedule(args.lr, max(args.steps, 1)))

        def step():
            hr = random_crops(corpus, args.batch, args.patch, gen)
            dist, c = degrade_conditioned(hr, gen)
            return train_step(lambda x: net(x, c), opt, dist, hr)["loss"]

        def log(ci, loss):
            if (ci + 1) * args.scan_chunk % 1000 == 0:
                print(f"[cond_polish] step {(ci + 1) * args.scan_chunk}: loss {loss:.5f}",
                      flush=True)

        losses = run_chunks(n_chunks, args.scan_chunk, step, log)
    return net.eval().requires_grad_(False), losses, n_chunks * args.scan_chunk


@torch.no_grad()
def holdout(net, mix: str, device: torch.device) -> Dict[str, float]:
    """PSNR on eight fresh 192-px images of ``mix``, distorted with every
    image degraded: the distorted input, the conditioned restoration (it
    must beat the input and the blind ``c = 0`` one), the blind one, and
    ``c = 0`` on the clean input (it must stay near identity)."""
    from ..models.conditioning import COND_DIM, degrade_conditioned
    from ..models.corpus import make_corpus
    from ..models.train import _psnr

    hr = torch.from_numpy(make_corpus(8, 192, seed=200_700, mix=mix)[:, :192, :192]
                          ).to(device)

    def psnr(pred):
        return _psnr(torch.clamp(pred, 0, 255), hr)

    dist, c = degrade_conditioned(hr, torch.Generator(device).manual_seed(77), zero_frac=0.0)
    return {"distorted": psnr(dist), "conditioned": psnr(net(dist, c)),
            "blind": psnr(net(dist, torch.zeros_like(c))),
            "clean": psnr(net(hr, torch.zeros((hr.shape[0], COND_DIM), device=device)))}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m srs_tpu_torch.drivers.train_cond")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--patch", type=int, default=64)  # x1 net; % 8 == 0
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--scan-chunk", type=int, default=50)
    ap.add_argument("--mix", type=str, default="p70")
    add_device_args(ap)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--corpus-n", type=int, default=3072)
    args = ap.parse_args(argv)

    from ..models.evaljson import DERIVED_EVIDENCE, update_eval
    from ..models.registry import init_params
    from ..models.train import save_checkpoint
    from ..utils.device import resolve_device
    from .pretrain import load_corpus

    device = resolve_device(device_of(args))
    out_dir = out_dir_of(args.out)
    if args.patch % 8:
        raise ValueError(f"--patch {args.patch}: the JPEG blocks need a multiple of 8")
    corpus = upload_u8(load_corpus(n=args.corpus_n, mix=args.mix), device)
    t0 = time.time()
    net, losses, steps = train(corpus, args, device)
    film0 = init_params("cond_polish", 1, 0)["film.weight"]
    film_moved = float((net.film.weight.detach().cpu().float() - film0).abs().max())
    rows = holdout(net, args.mix, device)
    print(f"[cond_polish] holdout: distorted {rows['distorted']:.2f} dB -> restored "
          f"{rows['conditioned']:.2f} dB (blind c=0: {rows['blind']:.2f})", flush=True)
    print(f"[cond_polish] clean passthrough: {rows['clean']:.2f} dB "
          f"({time.time() - t0:.0f}s)", flush=True)
    state = {k: v.detach().to("cpu", torch.float32) for k, v in net.state_dict().items()}
    path = save_checkpoint(state, "cond_polish", 1, out_dir)
    entry = update_eval(out_dir, "cond_polish_x1", {
        "holdout_distorted": round(rows["distorted"], 3),
        "holdout_conditioned": round(rows["conditioned"], 3),
        "holdout_blind": round(rows["blind"], 3),
        "clean_passthrough": round(rows["clean"], 3),
        "steps": args.steps, "mix": args.mix,
        "train_seconds": round(time.time() - t0, 1),
    }, drop=DERIVED_EVIDENCE)
    print("DONE", flush=True)
    return {"eval": entry, "chunk_losses": losses, "steps_run": steps,
            "film_weight_moved": film_moved, "path": path, "state": state}


if __name__ == "__main__":
    main()
