"""QualityAssessmentModule (port of ``srs_tpu/qa/module.py``): full-,
no-reference and commercial evaluation with the reference's keys, level
labels and overall score, every metric computed on the module's device;
the ``calculate_*`` scalars, ``downsample_bicubic``, ``batch_evaluate``
and the text and JSON reports (the same text line for line).

The LPIPS level cut-offs are swapped for the calibrated values in
``srs_tpu/qa/data/lpips_calib.json``, read by path from this checkout.
"""

from __future__ import annotations

import json
import os
from dataclasses import replace
from datetime import datetime
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import QualityAssessmentConfig, QualityThresholds
from ..ops.resize import resize_bicubic
from ..utils.device import resolve_device
from . import commercial as C
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

    # -- scalar metrics (reference qa/module.py:123-172) -------------------
    def _pair(self, img1, img2) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._match_size(self._preprocess(img1), self._preprocess(img2))

    def calculate_psnr(self, img1, img2, data_range: float = 255.0) -> float:
        return float(M.psnr(*self._pair(img1, img2), data_range))

    def calculate_ssim(self, img1, img2, multiscale: bool = True) -> float:
        """The Gaussian-windowed SSIM whatever ``multiscale`` says, as in
        the reference; true MS-SSIM is :meth:`calculate_ms_ssim`."""
        return float(M.ssim(*self._pair(img1, img2)))

    def calculate_ms_ssim(self, img1, img2) -> float:
        return float(M.ms_ssim(*self._pair(img1, img2)))

    def calculate_lpips(self, img1, img2, net: str = "vgg") -> float:
        if self._lpips is None:
            raise RuntimeError("LPIPS model not loaded")
        return float(self._lpips(*self._pair(img1, img2), net=net))

    def calculate_niqe(self, image) -> float:
        """NIQE from the packaged pristine model, else the closed form."""
        img = self._preprocess(image)
        v = niqe_score(img)
        return float(v) if v is not None else float(N.niqe(img))

    def calculate_brisque(self, image) -> float:
        """BRISQUE from the packaged regressor, else the closed form."""
        img = self._preprocess(image)
        v = brisque_score(img)
        return float(v) if v is not None else float(N.brisque(img))

    def downsample_bicubic(self, image, scale_factor: float) -> np.ndarray:
        """cv2 INTER_CUBIC downsample to ``int(size * scale_factor)``."""
        if not (0.0 < scale_factor < 1.0):
            raise ValueError(f"scale_factor must be in (0, 1), got {scale_factor}")
        img = self._preprocess(image)
        h, w = img.shape[0], img.shape[1]
        out = resize_bicubic(img, int(h * scale_factor), int(w * scale_factor))
        return out.cpu().numpy()

    def evaluate_full_reference(self, original, upscaled,
                                scale_factor: int = 4) -> Dict[str, Any]:
        """Downsample comparison, PSNR, SSIM, MS-SSIM, LPIPS (vgg, alex),
        their levels and the overall score (reference qa/module.py:191-227).
        ``scale_factor`` is accepted and unused, as in the reference."""
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

    def evaluate_commercial(self, image,
                            roi_regions: Optional[List[Dict[str, Any]]] = None
                            ) -> Dict[str, Any]:
        """The commercial metrics (``commercial.evaluate_commercial_arrays``)
        with per-ROI keys, and a ``brand_color_accuracy_i`` level for each
        brand's delta-E (reference qa/module.py:272-291)."""
        t = self.thresholds
        img = self._preprocess(image)
        metrics: Dict[str, Any] = _fetch(C.evaluate_commercial_arrays(img, roi_regions))
        for k in list(metrics):
            if k.startswith("brand_color_delta_e_"):
                idx = k.rsplit("_", 1)[1]
                metrics[f"brand_color_accuracy_{idx}"] = self._level(
                    metrics[k], t.delta_e_excellent, t.delta_e_good, t.delta_e_acceptable,
                    lower_better=True)
        return metrics

    def batch_evaluate(self, image_pairs: Sequence[Tuple[Any, Any]],
                       scale_factor: int = 4) -> List[Dict[str, Any]]:
        return [self.evaluate_full_reference(o, u, scale_factor) for o, u in image_pairs]

    # -- reports (reference qa/module.py:301-396) ----------------------------
    def generate_report(self, metrics: Dict[str, Any], report_type: str = "full",
                        output_path: Optional[str] = None) -> str:
        """``"json"`` (a timestamp and the metrics), ``"summary"`` or the
        ``"full"`` text report; written to ``output_path`` when given."""
        if report_type == "json":
            report = json.dumps({"timestamp": datetime.now().isoformat(), "metrics": metrics},
                                indent=2, ensure_ascii=False)
        elif report_type == "summary":
            report = self._summary_report(metrics)
        else:
            report = self._full_report(metrics)
        if output_path:
            with open(output_path, "w", encoding="utf-8") as f:
                f.write(report)
        return report

    @staticmethod
    def _summary_report(m: Dict[str, Any]) -> str:
        lines = ["=" * 50, "Super-Resolution QA Summary", "=" * 50, ""]
        if "psnr" in m:
            lines.append(f"PSNR:      {m['psnr']:.2f} dB")
        if "ms_ssim" in m:
            lines.append(f"MS-SSIM:   {m['ms_ssim']:.4f}")
        if "lpips_vgg" in m:
            lines.append(f"LPIPS:     {m['lpips_vgg']:.4f}")
        if "niqe" in m:
            lines.append(f"NIQE:      {m['niqe']:.2f}")
        if "overall_score" in m:
            lines.append(f"Overall:   {m['overall_score']:.2f}/100")
        lines += ["", "=" * 50]
        return "\n".join(lines)

    @staticmethod
    def _full_report(m: Dict[str, Any]) -> str:
        lines = [
            "=" * 70,
            "Super-Resolution Image Quality Assessment Report",
            "=" * 70,
            f"Generated: {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}",
            "",
        ]
        if "psnr" in m:
            lines += ["-" * 70, "[Full-Reference Metrics]", "-" * 70]
            lines.append(f"PSNR:           {m.get('psnr', 0):.2f} dB    "
                         f"[{m.get('psnr_level', 'N/A')}]")
            lines.append(f"SSIM:           {m.get('ssim', 0):.4f}")
            lines.append(f"MS-SSIM:        {m.get('ms_ssim', 0):.4f}    "
                         f"[{m.get('ssim_level', 'N/A')}]")
            if "lpips_vgg" in m:
                lines.append(f"LPIPS (VGG):    {m['lpips_vgg']:.4f}    "
                             f"[{m.get('lpips_level', 'N/A')}]")
                lines.append(f"LPIPS (Alex):   {m.get('lpips_alex', 0):.4f}")
            lines.append("")
        ds_names = ["structure_color", "mid_frequency", "high_frequency"]
        if any(f"psnr_{n}" in m for n in ds_names):
            lines += ["-" * 70, "[Multiscale Downsample Comparison]", "-" * 70]
            for n in ds_names:
                if f"psnr_{n}" in m:
                    lines.append(f"  {n}:")
                    lines.append(f"    PSNR: {m[f'psnr_{n}']:.2f} dB")
                    lines.append(f"    SSIM: {m[f'ssim_{n}']:.4f}")
            lines.append("")
        if "niqe" in m:
            lines += ["-" * 70, "[No-Reference Metrics]", "-" * 70]
            lines.append(f"NIQE:           {m['niqe']:.2f}    [{m.get('niqe_level', 'N/A')}]")
            lines.append(f"BRISQUE:        {m['brisque']:.2f}    "
                         f"[{m.get('brisque_level', 'N/A')}]")
            lines.append(f"Sharpness:      {m.get('sharpness', 0):.2f}")
            lines.append(f"Contrast:       {m.get('contrast', 0):.2f}")
            lines.append(f"Colorfulness:   {m.get('colorfulness', 0):.2f}")
            lines.append("")
        if "commercial_score" in m:
            lines += ["-" * 70, "[Commercial Advertising Assessment]", "-" * 70]
            lines.append(f"Commercial score: {m['commercial_score']:.2f}/100")
            lines.append("")
            lines.append("  Detail fidelity:")
            lines.append(f"    Global sharpness: {m.get('global_sharpness', 0):.2f}")
            lines.append(f"    HF ratio:         {m.get('high_frequency_ratio', 0):.4f}")
            lines.append("")
            lines.append("  Visual comfort:")
            lines.append(f"    Oversharpen:      {m.get('oversharpen_score', 0):.2f}/100")
            lines.append(f"    Artifacts:        {m.get('artifact_score', 0):.2f}/100")
            lines.append(f"    Noise level:      {m.get('noise_level', 0):.2f}")
            lines.append(f"    Brightness unif.: {m.get('brightness_uniformity', 0):.2f}/100")
            lines.append("")
        if "overall_score" in m:
            lines += ["-" * 70, "[Overall]", "-" * 70]
            lines.append(f"Overall quality score: {m['overall_score']:.2f}/100")
            lines.append("")
        lines += ["-" * 70, "[Levels]  excellent | good | fair | poor", "=" * 70]
        return "\n".join(lines)
