"""Content-aware tiling analysis (port of ``srs_tpu/tiling/content.py``).

``ContentAnalyzer`` builds the "forbidden zone" map that content-aware
seams avoid (``tiling/content_layout.py``): face boxes with a 20% margin,
text-like boxes, and salient pixels. Saliency (spectral residual, on
``torch.fft``) and local entropy run on the analyzer's device.

The face (Haar cascade) and text (MSER) detectors are OpenCV's. As in the
reference, they run only where ``cv2`` imports (the face detector only
where its cascade file loads), and return no boxes otherwise; the zone is
then saliency alone, which is what the reference computes on a machine
without cv2.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from ..ops.colorspace import rgb_to_gray
from ..ops.filters import box_blur, gaussian_blur
from ..utils.device import resolve_device

__all__ = ["ContentAnalyzer"]

Box = Tuple[int, int, int, int]


def _cv2():
    """OpenCV, or None where it does not import."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _spectral_residual_saliency(gray: torch.Tensor) -> torch.Tensor:
    """Spectral-residual saliency (Hou & Zhang 2007): the log-magnitude
    spectrum minus its 3x3 box mean, rebuilt through the inverse FFT,
    squared, Gaussian-blurred (11, 2.5) and normalized to [0, 1]."""
    spec = torch.fft.fft2(gray.float())
    log_mag = torch.log(torch.abs(spec) + 1e-8)
    residual = log_mag - box_blur(log_mag, 3)
    rebuilt = torch.fft.ifft2(torch.exp(torch.complex(residual, torch.angle(spec))))
    sal = gaussian_blur(torch.abs(rebuilt) ** 2, 11, 2.5)
    lo, hi = torch.min(sal), torch.max(sal)
    return (sal - lo) / torch.clamp(hi - lo, min=1e-8)


def _local_entropy(gray: torch.Tensor, window: int = 64) -> torch.Tensor:
    """Entropy of the 16-bin histogram in each ``window`` box, normalized
    to [0, 1]: one-hot bins, box means, -sum p log2 p."""
    bins = 16
    g = torch.clamp(gray.float(), 0.0, 255.0)
    idx = torch.clamp((g / 256.0 * bins).to(torch.int64), 0, bins - 1)
    onehot = torch.nn.functional.one_hot(idx, bins).float()  # (H, W, bins)
    counts = box_blur(onehot.permute(2, 0, 1), window)  # (bins, H, W)
    p = counts / torch.clamp(counts.sum(dim=0, keepdim=True), min=1e-8)
    ent = -torch.sum(p * torch.log2(torch.clamp(p, min=1e-10)), dim=0)
    return ent / np.log2(bins)


class ContentAnalyzer:
    """Forbidden-zone construction for seam-aware tile layouts, on
    ``device`` (the card by default; raises without one)."""

    def __init__(
        self,
        face_margin_ratio: float = 0.2,
        saliency_threshold: float = 0.7,
        entropy_window: int = 64,
        device: Union[str, torch.device] = "cuda",
    ):
        self.face_margin_ratio = face_margin_ratio
        self.saliency_threshold = saliency_threshold
        self.entropy_window = entropy_window
        self.device = resolve_device(device)
        self._face_cascade = None
        cv2 = _cv2()
        if cv2 is not None:
            try:
                path = cv2.data.haarcascades + "haarcascade_frontalface_default.xml"
                cascade = cv2.CascadeClassifier(path)
            except (AttributeError, cv2.error):  # no cascade data shipped
                cascade = None
            if cascade is not None and not cascade.empty():
                self._face_cascade = cascade

    def _gray(self, image: np.ndarray) -> torch.Tensor:
        return rgb_to_gray(torch.from_numpy(np.asarray(image, np.float32)).to(self.device))

    # -- OpenCV detectors (host) --------------------------------------------
    def detect_faces(self, image: np.ndarray) -> List[Box]:
        """Haar frontal-face boxes (x, y, w, h); none without cv2."""
        cv2 = _cv2()
        if cv2 is None or self._face_cascade is None:
            return []
        gray = cv2.cvtColor(np.asarray(image, np.uint8), cv2.COLOR_RGB2GRAY)
        faces = self._face_cascade.detectMultiScale(gray, 1.1, 4)
        return [tuple(int(v) for v in f) for f in faces]

    def detect_text_regions(self, image: np.ndarray) -> List[Box]:
        """MSER regions kept by size and aspect as text-like boxes
        (x, y, w, h); none without cv2."""
        cv2 = _cv2()
        if cv2 is None:
            return []
        gray = cv2.cvtColor(np.asarray(image, np.uint8), cv2.COLOR_RGB2GRAY)
        mser = cv2.MSER.create() if hasattr(cv2.MSER, "create") else cv2.MSER_create()
        regions, _ = mser.detectRegions(gray)
        boxes = []
        for r in regions:
            x, y, w, h = cv2.boundingRect(r)
            if w < 8 or h < 8 or w > gray.shape[1] // 2:
                continue
            if 0.1 < w / max(h, 1) < 15:
                boxes.append((int(x), int(y), int(w), int(h)))
        return boxes

    # -- device analyses -----------------------------------------------------
    def compute_saliency_map(self, image: np.ndarray) -> np.ndarray:
        return _spectral_residual_saliency(self._gray(image)).cpu().numpy()

    def compute_local_entropy(self, image: np.ndarray) -> np.ndarray:
        return _local_entropy(self._gray(image), self.entropy_window).cpu().numpy()

    # -- forbidden zones -------------------------------------------------------
    def forbidden_zone_map(self, image: np.ndarray) -> Tuple[np.ndarray, dict]:
        """:meth:`create_forbidden_zone_map` and the count of each kind of
        box that went into it."""
        img = np.asarray(image)
        h, w = img.shape[:2]
        zone = np.zeros((h, w), dtype=bool)
        faces = self.detect_faces(img)
        for (x, y, bw, bh) in faces:
            mx = int(bw * self.face_margin_ratio)
            my = int(bh * self.face_margin_ratio)
            zone[max(0, y - my) : min(h, y + bh + my), max(0, x - mx) : min(w, x + bw + mx)] = True
        texts = self.detect_text_regions(img)
        for (x, y, bw, bh) in texts:
            zone[y : y + bh, x : x + bw] = True
        zone |= self.compute_saliency_map(img) > self.saliency_threshold
        return zone, {"faces": len(faces), "text_boxes": len(texts)}

    def create_forbidden_zone_map(self, image: np.ndarray) -> np.ndarray:
        """Boolean (H, W) map of regions seams should avoid: face boxes
        grown by the margin, text boxes, saliency over the threshold."""
        return self.forbidden_zone_map(image)[0]

    @staticmethod
    def tile_complexity(tile: np.ndarray) -> float:
        """Grayscale standard deviation of a tile (host)."""
        gray = rgb_to_gray(torch.from_numpy(np.asarray(tile, np.float32))).numpy()
        return float(gray.std())

    @staticmethod
    def forbidden_ratio(zone: np.ndarray, x: int, y: int, w: int, h: int) -> float:
        """Fraction of a tile covered by forbidden zones."""
        region = zone[y : y + h, x : x + w]
        return float(region.mean()) if region.size else 0.0
