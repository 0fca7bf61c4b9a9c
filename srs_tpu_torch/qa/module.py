"""QualityAssessmentModule (port of ``srs_tpu/qa/module.py:35-270``):
full-reference and no-reference evaluation with the reference's keys,
level labels and overall score, every metric computed on the module's
device. ``evaluate_commercial`` is not ported yet (ROADMAP Queue 1).

The LPIPS level cut-offs are swapped for the calibrated values in
``srs_tpu/qa/data/lpips_calib.json``, read by path from this checkout.
"""

from __future__ import annotations

import json
import os
from dataclasses import replace
from enum import Enum
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import QualityAssessmentConfig, QualityThresholds
from ..utils.device import resolve_device
from . import metrics as M
from . import noref as N
from .niqe import DATA_DIR, brisque_score, niqe_score

__all__ = ["AssessmentLevel", "QualityAssessmentModule"]


class AssessmentLevel(Enum):
    EXCELLENT = "excellent"
    GOOD = "good"
    FAIR = "fair"
    POOR = "poor"


def _calibrated_thresholds(t: QualityThresholds) -> QualityThresholds:
    """The packaged LPIPS calibration in place of the default LPIPS
    cut-offs; thresholds a user changed are kept."""
    d = QualityThresholds()
    if (t.lpips_excellent, t.lpips_good, t.lpips_acceptable) != (
        d.lpips_excellent, d.lpips_good, d.lpips_acceptable
    ):
        return t
    path = os.path.join(DATA_DIR, "lpips_calib.json")
    if not os.path.exists(path):
        return t
    try:
        with open(path) as f:
            c = json.load(f)
        return replace(
            t,
            lpips_excellent=float(c["lpips_excellent"]),
            lpips_good=float(c["lpips_good"]),
            lpips_acceptable=float(c["lpips_acceptable"]),
        )
    except (OSError, ValueError, KeyError):
        return t


def _fetch(vals: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """All 0-d tensors to floats in one device-to-host copy."""
    keys = list(vals)
    stacked = torch.stack([torch.as_tensor(vals[k], dtype=torch.float32).reshape(())
                           for k in keys])
    return {k: float(v) for k, v in zip(keys, stacked.cpu().numpy())}


class QualityAssessmentModule:
    """Full- and no-reference image QA on ``device`` (the card by default).

    ``lpips_model`` is an ``LPIPSMetric`` (``models/lpips.py``) or None,
    which leaves the ``lpips_*`` keys out as the reference does when its
    LPIPS cannot load."""

    def __init__(
        self,
        config: Optional[QualityAssessmentConfig] = None,
        device: str | torch.device = "cuda",
        lpips_model=None,
    ):
        self.config = config or QualityAssessmentConfig()
        self.thresholds = _calibrated_thresholds(self.config.thresholds)
        self.device = resolve_device(device)
        self._lpips = lpips_model

    def _preprocess(self, image) -> torch.Tensor:
        """float32 [0, 255] HWC on the module's device. A tensor already
        there passes through; numpy in [0, 1] is scaled to [0, 255]."""
        if isinstance(image, torch.Tensor):
            img = image if image.dim() >= 3 else image[..., None]
            return img.to(self.device, torch.float32)
        arr = np.asarray(image)
        if arr.ndim == 2:
            arr = arr[..., None]
        arr = arr.astype(np.float32)
        if arr.max() <= 1.0:
            arr = arr * 255.0
        return torch.from_numpy(arr).to(self.device)

    @staticmethod
    def _match_size(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mh, mw = min(a.shape[0], b.shape[0]), min(a.shape[1], b.shape[1])
        return a[:mh, :mw], b[:mh, :mw]

    @staticmethod
    def _level(value: float, exc: float, good: float, fair: float,
               lower_better: bool = False) -> str:
        if lower_better:
            for cut, lv in ((exc, AssessmentLevel.EXCELLENT), (good, AssessmentLevel.GOOD),
                            (fair, AssessmentLevel.FAIR)):
                if value <= cut:
                    return lv.value
            return AssessmentLevel.POOR.value
        for cut, lv in ((exc, AssessmentLevel.EXCELLENT), (good, AssessmentLevel.GOOD),
                        (fair, AssessmentLevel.FAIR)):
            if value >= cut:
                return lv.value
        return AssessmentLevel.POOR.value

    def evaluate_full_reference(self, original, upscaled) -> Dict[str, Any]:
        """Downsample comparison, PSNR, SSIM, MS-SSIM, LPIPS (vgg, alex),
        their levels and the overall score (reference qa/module.py:191-227)."""
        t = self.thresholds
        a = self._preprocess(original)
        b = self._preprocess(upscaled)
        vals: Dict[str, torch.Tensor] = dict(M.downsample_comparison(a, b))
        am, bm = self._match_size(a, b)
        vals["psnr"] = M.psnr(am, bm)
        vals["ssim"] = M.ssim(am, bm)
        vals["ms_ssim"] = M.ms_ssim(am, bm)
        if self._lpips is not None:
            vals["lpips_vgg"] = self._lpips(am, bm, net="vgg")
            vals["lpips_alex"] = self._lpips(am, bm, net="alex")
        metrics: Dict[str, Any] = _fetch(vals)
        metrics["psnr_level"] = self._level(
            metrics["psnr"], t.psnr_excellent, t.psnr_good, t.psnr_acceptable)
        metrics["ssim_level"] = self._level(
            metrics["ms_ssim"], t.ssim_excellent, t.ssim_good, t.ssim_acceptable)
        if self._lpips is not None:
            metrics["lpips_level"] = self._level(
                metrics["lpips_vgg"], t.lpips_excellent, t.lpips_good, t.lpips_acceptable,
                lower_better=True)
        metrics["overall_score"] = self._overall_score(metrics)
        return metrics

    @staticmethod
    def _overall_score(metrics: Dict[str, Any]) -> float:
        """mean(clamped PSNR, ms_ssim * 100, (1 - lpips_vgg) * 100)."""
        scores = []
        if "psnr" in metrics:
            scores.append(min(100.0, max(0.0, metrics["psnr"])))
        if "ms_ssim" in metrics:
            scores.append(metrics["ms_ssim"] * 100.0)
        if "lpips_vgg" in metrics:
            scores.append(max(0.0, (1.0 - metrics["lpips_vgg"]) * 100.0))
        return float(np.mean(scores)) if scores else 0.0

    def evaluate_no_reference(self, image) -> Dict[str, Any]:
        """Closed-form no-reference values, with NIQE and BRISQUE from the
        packaged models where present, and their levels (reference
        qa/module.py:241-270)."""
        t = self.thresholds
        img = self._preprocess(image)
        metrics: Dict[str, Any] = _fetch(N.no_reference_metrics(img))
        v = niqe_score(img)
        if v is not None:
            metrics["niqe"] = float(v)
        v = brisque_score(img)
        if v is not None:
            metrics["brisque"] = float(v)
        metrics["niqe_level"] = self._level(
            metrics["niqe"], t.niqe_excellent, t.niqe_good, t.niqe_acceptable, lower_better=True)
        metrics["brisque_level"] = self._level(
            metrics["brisque"], t.brisque_excellent, t.brisque_good, t.brisque_acceptable,
            lower_better=True)
        return metrics
