"""Train the ARK class-conditional diffusion generator (port of
``scripts/train_ark.py``).

The learned model behind the ARK text-to-image API (reference:
ark_api_module.py:17-96, ``models/generative.py``), trained on the
8-family class-labelled corpus; the EMA weights are saved as
``ark_gen_x1.pt`` with ``ark_meta.json`` (size, base, depth) and an
EVAL.json entry.

    python -m srs_tpu_torch.drivers.train_ark [--steps 40000] [--out DIR]
        [--n-per-class 384] [--size 64] [--base 64] [--batch 64]
        [--init-from DIR] [--cpu] [--depth 2] [--dtype bfloat16]

``--out`` defaults to ``~/.cache/srs_tpu_torch/models``, where
``generate`` and ``eval_ark`` read the generator. ``main`` returns the
report (the EVAL.json entry, the logged losses, the saved path and
state). ``--depth`` and ``--dtype`` are the port's.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional

from ._common import add_device_args, device_of, out_dir_of


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m srs_tpu_torch.drivers.train_ark")
    ap.add_argument("--steps", type=int, default=40000)
    ap.add_argument("--n-per-class", type=int, default=384)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--base", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--scan-chunk", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="checkpoint dir (default: ~/.cache/srs_tpu_torch/models)")
    ap.add_argument("--init-from", default=None,
                    help="warm-start from a directory holding ark_gen_x1.pt (the weights "
                    "do not depend on the resolution)")
    add_device_args(ap)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)

    from ..models.evaljson import update_eval
    from ..models.generative import make_class_corpus, train_ark
    from ..utils.device import resolve_device

    device = resolve_device(device_of(args))
    out = out_dir_of(args.out)
    t0 = time.time()
    print(f"[ark] rendering class corpus ({args.n_per_class}/class @ {args.size}px)...",
          flush=True)
    corpus = make_class_corpus(args.n_per_class, args.size, args.seed)
    print(f"[ark] corpus {corpus[0].shape} in {time.time() - t0:.1f}s", flush=True)

    tlog, slog = time.time(), 0
    logged = []

    def log(step, loss):
        nonlocal tlog, slog
        now = time.time()
        logged.append([step, loss])
        print(f"[ark] step {step}/{args.steps} loss {loss:.5f} "
              f"({(step - slog) / max(now - tlog, 1e-9):.1f} steps/s)", flush=True)
        tlog, slog = now, step

    _module, state, loss = train_ark(
        steps=args.steps, n_per_class=args.n_per_class, size=args.size, base=args.base,
        depth=args.depth, batch=args.batch, lr=args.lr, seed=args.seed,
        scan_chunk=args.scan_chunk, checkpoint_dir=out, log_fn=log, corpus=corpus,
        init_from=args.init_from, device=device, dtype=args.dtype,
    )
    dt = time.time() - t0
    print(f"[ark] done: final loss {loss:.5f} in {dt:.0f}s -> {out}/ark_gen_x1.pt")
    entry = {
        "final_loss": loss,
        "steps": args.steps,
        "base": args.base,
        "size": args.size,
        "n_per_class": args.n_per_class,
        "train_seconds": dt,
    }
    # replace: every other generator field (class accuracy, gen2k NIQE) came
    # from the weights this run just replaced
    entry = update_eval(out, "ark_gen_x1", entry, replace=True)
    print(f"[ark] EVAL.json updated: {entry}")
    return {"eval": entry, "logged": logged, "path": os.path.join(out, "ark_gen_x1.pt"),
            "state": state}


if __name__ == "__main__":
    main()
