"""Pretrain the registry SR nets on the procedural corpus and save them
(port of ``scripts/pretrain.py``):

    python -m srs_tpu_torch.drivers.pretrain [out_dir] [--only a_x2,b_x3]
        [--steps N] [--steps-map k=N,...] [--skip-existing] [--corpus-n N]
        [--mix proc|v3|...] [--grain G] [--init-from DIR] [--lr LR]
        [--device cuda|cpu] [--dtype bfloat16|float32] [--scan-chunk 50]

Writes one ``{name}_x{scale}.pt`` state dict per (model, scale) into
``out_dir`` (default ``~/.cache/srs_tpu_torch/models``, where the command
line's ``process`` reads trained nets) and merges a held-out eval panel
(PSNR against bicubic and bicubic + IBP) into EVAL.json beside them,
dropping the evidence blocks derived from the old weights. ``main``
returns the report: ``eval`` ({net key: its EVAL.json entry}) and
``states`` (the state dict each net was saved with). A photo-bearing ``--mix`` (every
mix but ``proc``) raises ``PhotoDataMissing`` where no photo package is
installed. ``--dtype`` (float32 for a CPU or parity run) and
``--scan-chunk`` (steps per logged chunk; a run takes ``max(steps //
chunk, 1) * chunk`` steps) are the port's.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from ._common import cache_dir, out_dir_of, upload_u8

CONFIGS = [
    # (model, scale, steps[, degradation])
    ("espcn", 2, 30000),
    ("espcn", 3, 30000),
    ("espcn", 4, 30000),
    ("edsr_m", 2, 40000),
    ("edsr_m", 3, 40000),
    ("edsr_m", 4, 40000),
    ("rcan", 2, 40000),
    ("rcan", 3, 40000),
    ("rcan", 4, 40000),
    ("edsr_l", 2, 40000),
    ("edsr_l", 3, 40000),
    ("edsr_xl", 2, 40000),
    ("edsr_xl", 3, 40000),
    ("edsr_xl", 4, 40000),
    ("edsr_l_robust", 2, 40000, "robust"),
    ("edsr_l_robust", 3, 40000, "robust"),
    # texture tier: fine-tuned from edsr_l on the "tex" mix (--mix tex
    # --init-from a directory holding edsr_l_tex_x2 seeded from edsr_l_x2)
    ("edsr_l_tex", 2, 25000),
]

CORPUS_N = 3072
CORPUS_SIZE = 256
# The photo-statistics mix (bundled photos + render_photo + the procedural
# families); "proc" is the procedural corpus alone.
CORPUS_MIX = "v3"


def load_corpus(n: int = CORPUS_N, size: int = CORPUS_SIZE, seed: int = 0,
                mix: str = CORPUS_MIX):
    """The corpus, cached under ``~/.cache/srs_tpu_torch/corpus`` (making
    it is minutes of host cv2 at the default size). A photo-bearing mix
    raises ``PhotoDataMissing`` when no photo package is installed."""
    import numpy as np

    from ..models.corpus import make_corpus

    tag = f"{mix}_" if mix != "proc" else ""
    if mix != "proc":
        from ..models.photo_data import require_photo_paths

        tag += f"p{len(require_photo_paths(f'the {mix!r} corpus mix'))}_"
    cache = os.path.join(cache_dir("corpus"), f"srs_corpus_{tag}{n}_{size}_{seed}.npy")
    if os.path.exists(cache):
        return np.load(cache)
    t0 = time.time()
    corpus = make_corpus(n, size, seed=seed, mix=mix)
    np.save(cache + ".tmp.npy", corpus)
    os.replace(cache + ".tmp.npy", cache)
    print(f"corpus: {corpus.shape} in {time.time() - t0:.1f}s", flush=True)
    return corpus


def _pop(argv: List[str], flag: str, cast=str):
    if flag not in argv:
        return None
    i = argv.index(flag)
    value = cast(argv[i + 1])
    del argv[i : i + 2]
    return value


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    argv = list(sys.argv[1:] if argv is None else argv)
    only = _pop(argv, "--only")
    only = only.split(",") if only else None
    steps_override = _pop(argv, "--steps", int)
    steps_map = {}
    spec = _pop(argv, "--steps-map")
    if spec:
        # per-net step counts for multi-net runs: --steps-map edsr_xl_x2=100000,...
        for kv in spec.split(","):
            k, v = kv.split("=")
            steps_map[k] = int(v)
    skip_existing = "--skip-existing" in argv
    if skip_existing:
        argv.remove("--skip-existing")
    corpus_n = _pop(argv, "--corpus-n", int) or CORPUS_N
    mix = _pop(argv, "--mix") or CORPUS_MIX
    grain = _pop(argv, "--grain", float) or 0.0
    init_from = _pop(argv, "--init-from")
    lr = _pop(argv, "--lr", float)
    lr = 2e-4 if lr is None else lr
    device = _pop(argv, "--device") or "cuda"
    dtype = _pop(argv, "--dtype") or "bfloat16"
    scan_chunk = _pop(argv, "--scan-chunk", int) or 50
    out_dir = out_dir_of(argv[0] if argv else None)

    from ..models.evaljson import DERIVED_EVIDENCE, load_eval, update_eval
    from ..models.registry import build_model
    from ..models.train import eval_on_holdout, train_synthetic
    from ..utils.device import resolve_device

    device = resolve_device(device)  # no card: raise before the corpus is made
    if only is None:
        configs = list(CONFIGS)
    else:
        # the --only order: the caller lists the highest-priority nets first
        by_key = {f"{c[0]}_x{c[1]}": c for c in CONFIGS}
        unknown = [k for k in only if k not in by_key]
        if unknown:
            # a typo'd --only must not exit 0 with nothing trained
            sys.exit(f"--only: unknown net keys {unknown}; valid: {sorted(by_key)}")
        configs = [by_key[k] for k in only]
    for k in steps_map:
        if not any(f"{c[0]}_x{c[1]}" == k for c in CONFIGS):
            print(f"WARNING: --steps-map key {k!r} matches no config; ignored", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    # once per process for every net; dequantized per batch in train_synthetic
    corpus = upload_u8(load_corpus(n=corpus_n, mix=mix), device)

    panel = load_eval(out_dir)
    states = {}
    for cfg_row in configs:
        name, scale, steps = cfg_row[:3]
        if steps_override:
            steps = steps_override
        steps = steps_map.get(f"{name}_x{scale}", steps)
        # skip only a committed save (save_checkpoint renames a whole file
        # into place) that has its eval entry
        ckpt = os.path.join(out_dir, f"{name}_x{scale}.pt")
        if skip_existing and os.path.isfile(ckpt) and f"{name}_x{scale}" in panel:
            print(f"[{name}_x{scale}] skip: checkpoint exists", flush=True)
            continue
        degradation = cfg_row[3] if len(cfg_row) > 3 else "area"
        t0 = time.time()
        state, loss = train_synthetic(
            name, scale, steps=steps, corpus_n=corpus_n, corpus_size=CORPUS_SIZE,
            patch=48, batch=32, lr=lr, checkpoint_dir=out_dir, scan_chunk=scan_chunk,
            corpus=corpus, dtype=dtype, degradation=degradation, hr_grain=grain,
            init_from=init_from, device=device,
            log_fn=lambda s, l, n=name, sc=scale, t=t0: print(
                f"[{n}_x{sc}] step {s}: loss {l:.5f} ({time.time() - t:.0f}s)", flush=True)
            if s % 1000 == 0 else None,
        )
        states[f"{name}_x{scale}"] = state
        net, _ = build_model(name, scale, state, dtype=dtype, device=device)
        stats = eval_on_holdout(net, scale, n=12, size=256)
        if degradation != "area":
            # the matching degraded holdout (the robust net's home turf) too
            deg = eval_on_holdout(net, scale, n=12, size=256, degradation=degradation)
            stats["psnr_net_degraded"] = deg["psnr_net"]
            stats["psnr_bicubic_degraded"] = deg["psnr_bicubic"]
        stats["final_loss"] = loss
        stats["train_seconds"] = time.time() - t0
        stats["degradation"] = degradation
        stats["mix"] = mix
        if grain:
            stats["hr_grain"] = grain
        if init_from:
            stats["init_from"] = init_from
        if lr != 2e-4:
            stats["lr"] = lr
        print(f"[{name}_x{scale}] {json.dumps(stats)}", flush=True)
        # written per net, so a killed multi-net run keeps its finished
        # entries; the derived evidence of the old weights is dropped
        panel[f"{name}_x{scale}"] = update_eval(out_dir, f"{name}_x{scale}", stats,
                                                drop=DERIVED_EVIDENCE)
    print("DONE", flush=True)
    return {"eval": panel, "states": states}


if __name__ == "__main__":
    main()
