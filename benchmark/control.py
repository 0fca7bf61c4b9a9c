#!/usr/bin/env python3
"""The check's control, on the card at a cell's own size.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]
        [--variants fp8 [fp32 half_tiles one_pass]]

For each seed, each of the run's checked images (the traffic file's
``check_jobs``) goes through the plain reference ("tf32", as a run
compares) and through each variant put in the program's place: "fp8",
the control (every convolution, linear layer and product of the nets in
float8 e4m3, one precision step below the configuration's bfloat16, and
QA in float32 with TF32, the step below its float32); "fp32", the reference with TF32 off, which shows how much
of a reading the reference's own TF32 makes; and the planted faults
"half_tiles" (half of the tiles served by bicubic alone) and "one_pass"
(each dihedral member run once). Each line printed is the comparison's
numbers for one variant and image, as a run prints them for the
program; a limit has to lie below the control's readings. Seeded nets
(``yardstick/weights.py``) are drawn by ``reference.run`` for every
variant alike. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402
from yardstick import check, inputs, reference  # noqa: E402


def as_program_record(ref: dict) -> dict:
    """The reference's route in the form of the program's run record."""
    route = ref["route"]
    return {"provider": route["provider"], "ladder": route["ladder"],
            "step_members": route["steps"], **ref["layout"],
            "routing": {"model": route["model"],
                        "sr_gain": (ref["probe"] or {}).get("gain"),
                        "alpha": (ref["probe"] or {}).get("alpha")}}


def as_program_report(ref: dict, config: dict) -> dict:
    """The reference's QA values in the form of the program's report,
    with every key the configuration's QA states."""
    return {**{k: 0.0 for k in config.get("qa_keys", ())}, **ref["qa"]}


def control_rows(image, config: dict, store: str, device, variant: str = "fp8",
                 ref: dict = None) -> list:
    """The check's rows for ``variant`` in the program's place."""
    ref = ref or reference.run(image, config, store, device)
    low = reference.run(image, config, store, device, variant)
    return check.compare(config, as_program_record(low), low["tiff"],
                         as_program_report(low, config), ref, 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["fp8"],
                    choices=[p for p in reference.PRECISIONS if p != "tf32"])
    args = ap.parse_args(argv)
    cell, config, traffic, _e2e, _pl = run.load_cell(args.workload)
    run.require_cards(1)
    from srs_tpu_torch.models import registry

    pool = inputs.load_pool(traffic["input"], run.INPUT_CACHE)
    for seed in args.seeds:
        jobs = inputs.checked_jobs(traffic["check_jobs"], seed)
        order = inputs.job_order(traffic["input"]["pool"], seed, jobs[-1] + 1)
        for j in jobs:
            s, how = order[j]
            image = inputs.orient(pool[s], how)
            t0 = time.perf_counter()
            ref = reference.run(image, config, registry.PACKAGED_CHECKPOINT_DIR, "cuda")
            print(json.dumps({"workload": args.workload, "seed": seed, "job": j,
                              "image": [s, how], "variant": "tf32",
                              "seconds": time.perf_counter() - t0, "qa": ref["qa"]}), flush=True)
            for variant in args.variants:
                t0 = time.perf_counter()
                rows = control_rows(image, config, registry.PACKAGED_CHECKPOINT_DIR, "cuda",
                                    variant, ref)
                print(json.dumps({"workload": args.workload, "seed": seed, "job": j,
                                  "image": [s, how], "variant": variant,
                                  "seconds": time.perf_counter() - t0,
                                  "correct": check.verdict(rows), "check": check.as_dict(rows)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
