"""The comparison that decides ``correct``: what the timed path produced
for the checked image against the plain reference, each number beside
its limit (the configuration file's ``check`` table)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# A number that could not be read (no file, no record): over every limit.
MISSING = 1e9


def program_route(info: dict) -> dict:
    """The route the program's per-job record says it served."""
    return {"provider": info.get("provider"), "model": (info.get("routing") or {}).get("model"),
            "ladder": [int(s) for s in info.get("ladder") or []],
            "steps": [[[str(m), int(p)] for m, p in st] for st in info.get("step_members") or []]}


def _same_route(a: dict, b: dict) -> bool:
    return all(a.get(k) == b.get(k) for k in ("provider", "model", "ladder", "steps"))


# The QA report's full-reference values the reference works out again:
# (report key, name of the compared gap).
QA_VALUES = (("psnr", "qa_psnr_gap_db"), ("ssim", "qa_ssim_gap"), ("ms_ssim", "qa_ms_ssim_gap"),
             ("lpips_vgg", "qa_lpips_vgg_gap"), ("lpips_alex", "qa_lpips_alex_gap"))


def compare(config: dict, info: Optional[dict], tiff: Optional[np.ndarray],
            report: Optional[dict], ref: dict, jobs_failed: int) -> List[Tuple[str, float, float]]:
    """[(name, value, limit)] for one checked image: a run is correct when
    every value is at or under its limit. ``info`` is the checked job's
    run record, ``tiff`` its file read back, ``report`` its QA report."""
    limits = config["check"]
    stated = {k: config["route"][k] for k in ("provider", "model", "ladder", "steps")}
    rows: List[Tuple[str, float, float]] = [("jobs_failed", float(jobs_failed), 0.0)]
    routes_agree = (info is not None and _same_route(program_route(info), ref["route"])
                    and _same_route(ref["route"], stated))
    rows.append(("route_differs", 0.0 if routes_agree else 1.0, 0.0))
    lay = {k: (info or {}).get(k) for k in ("num_tiles", "block", "overlap")}
    rows.append(("layout_differs", 0.0 if lay == ref["layout"] else 1.0, 0.0))
    th, tw = ref["target"]
    shape_ok = tiff is not None and tuple(tiff.shape) == (th, tw, 3) and tiff.dtype == np.uint8
    rows.append(("size_differs", 0.0 if shape_ok else 1.0, 0.0))
    if shape_ok:
        diff = np.abs(tiff.astype(np.int16) - ref["tiff"].astype(np.int16))
        mean_abs = float(diff.mean(dtype=np.float64))
    else:
        mean_abs = MISSING
    rows.append(("tiff_mean_abs_lsb", mean_abs, float(limits["tiff_mean_abs_lsb"])))
    report = report or {}
    if "qa_keys" in config:
        # every key the configuration's QA states, and no other
        rows.append(("qa_keys_differ", float(len(set(report) ^ set(config["qa_keys"]))), 0.0))
    for key, name in QA_VALUES:
        if name in limits:
            v = report.get(key)
            rows.append((name, abs(float(v) - ref["qa"][key])
                         if isinstance(v, (int, float)) and np.isfinite(v) else MISSING,
                         float(limits[name])))
    if ref.get("probe") is not None:
        routing = (info or {}).get("routing") or {}
        gain, alpha = routing.get("sr_gain"), routing.get("alpha")
        rows.append(("probe_gain_gap_db", abs(gain - ref["probe"]["gain"])
                     if gain is not None else MISSING, float(limits["probe_gain_gap_db"])))
        rows.append(("probe_alpha_gap", abs(alpha - ref["probe"]["alpha"])
                     if alpha is not None else MISSING, float(limits["probe_alpha_gap"])))
    return rows


def worst(per_image: List[List[Tuple[str, float, float]]]) -> List[Tuple[str, float, float]]:
    """One row per number over several checked images: the largest value
    (a number an image lacks reads as missing)."""
    names = list(dict.fromkeys(n for rows in per_image for n, _v, _l in rows))
    out = []
    for name in names:
        found = [(v, lim) for rows in per_image for n, v, lim in rows if n == name]
        value = max(v for v, _l in found) if len(found) == len(per_image) else MISSING
        out.append((name, value, found[0][1]))
    return out


def verdict(rows) -> bool:
    return all(v <= lim for _n, v, lim in rows)


def as_dict(rows) -> Dict[str, Dict[str, float]]:
    return {n: {"value": v, "limit": lim} for n, v, lim in rows}
