"""Real photographs for training, from files that installed packages
bundle (port of ``srs_tpu/models/photo_data.py``).

``PHOTO_SOURCES`` names (package, path) pairs of camera images that
sklearn, pygame, gymnasium_robotics and dm_control ship; a source whose
package or file is missing is skipped, and nothing is installed. The
packages are located without being imported.

Held out, as in the reference (``tests/test_photo_holdout.py`` holds the
reference): matplotlib's sample portrait is in no source list, and
``EVAL_HOLDOUT_SOURCES`` feeds only ``eval_photo_paths`` /
``load_eval_photos``, never the training accessors (``photo_paths``,
``load_photos``, the mosaics).

PNG files decode through the port's own decoder (``io/image.py``); PIL is
imported only for JPEG. The crops resize with cv2, imported where they
are cut. Where no photograph is found the mosaics return None and the
corpus falls through to its procedural families.
"""

from __future__ import annotations

import importlib.util
import os
from typing import List, Optional, Tuple

import numpy as np

from ..io.image import load_image

__all__ = [
    "photo_paths", "load_photos", "photo_mosaic",
    "texture_paths", "load_textures", "texture_mosaic",
    "eval_photo_paths", "load_eval_photos",
]

# (package, relative path) — real photographic content only (no renders,
# screenshots, false-color or thresholded derivatives). TRAINING POOL:
# these feed corpus mosaics and QA fitting. 14 sources since round 4
# (was 17; see EVAL_HOLDOUT_SOURCES).
PHOTO_SOURCES: List[Tuple[str, str]] = [
    ("sklearn", "datasets/images/china.jpg"),
    ("pygame", "docs/generated/_images/camera_rgb.jpg"),
    ("pygame", "docs/generated/_images/camera_average.jpg"),
    ("pygame", "docs/generated/_images/camera_background.jpg"),
    # Photographed material textures (round 3): real camera captures of
    # wood/stone/metal/leather/grass surfaces shipped as simulator assets.
    # Stationary textures carry the natural high-frequency statistics the
    # scene photos above are short on (sensor grain, organic micro-
    # contrast), which is exactly what the SR nets must hallucinate.
    ("gymnasium_robotics",
     "envs/assets/kitchen_franka/kitchen_assets/textures/white_marble_tile.png"),
    ("gymnasium_robotics",
     "envs/assets/kitchen_franka/kitchen_assets/textures/white_marble_tile2.png"),
    ("gymnasium_robotics",
     "envs/assets/kitchen_franka/kitchen_assets/textures/tile1.png"),
    ("gymnasium_robotics",
     "envs/assets/kitchen_franka/kitchen_assets/textures/marble1.png"),
    ("gymnasium_robotics",
     "envs/assets/kitchen_franka/kitchen_assets/textures/metal1.png"),
    ("gymnasium_robotics",
     "envs/assets/adroit_hand/resources/textures/skin.png"),
    ("gymnasium_robotics",
     "envs/assets/adroit_hand/resources/textures/marble.png"),
    ("gymnasium_robotics",
     "envs/assets/adroit_hand/resources/textures/foil.png"),
    ("gymnasium_robotics",
     "envs/assets/adroit_hand/resources/textures/silverRaw.png"),
    ("dm_control",
     "locomotion/arenas/assets/outdoor_natural/OutdoorGrassFloorD.png"),
]

# Texture-family subset of the TRAINING pool (round 5): the photographed
# stationary material captures. Self-similar micro-texture is the one
# distribution where every clean net measures at or below bicubic on the
# held-out panel (wood family, VERDICT r4 #7) — the generic mixes are
# dominated by scene structure, so the nets under-train on "reproduce
# stationary grain without inventing it". The "tex" corpus mix draws its
# mosaics from THIS list only (never the held-out wood captures).
TEXTURE_SOURCES: List[Tuple[str, str]] = [
    ("gymnasium_robotics",
     "envs/assets/kitchen_franka/kitchen_assets/textures/white_marble_tile.png"),
    ("gymnasium_robotics",
     "envs/assets/kitchen_franka/kitchen_assets/textures/white_marble_tile2.png"),
    ("gymnasium_robotics",
     "envs/assets/kitchen_franka/kitchen_assets/textures/tile1.png"),
    ("gymnasium_robotics",
     "envs/assets/kitchen_franka/kitchen_assets/textures/marble1.png"),
    ("gymnasium_robotics",
     "envs/assets/kitchen_franka/kitchen_assets/textures/metal1.png"),
    ("gymnasium_robotics",
     "envs/assets/adroit_hand/resources/textures/skin.png"),
    ("gymnasium_robotics",
     "envs/assets/adroit_hand/resources/textures/marble.png"),
    ("gymnasium_robotics",
     "envs/assets/adroit_hand/resources/textures/foil.png"),
    ("gymnasium_robotics",
     "envs/assets/adroit_hand/resources/textures/silverRaw.png"),
    ("dm_control",
     "locomotion/arenas/assets/outdoor_natural/OutdoorGrassFloorD.png"),
]

# EVAL PANEL (round 4): held out of every training/fitting path. Chosen
# for distribution diversity — a macro scene photo plus one whole material
# family (both wood captures travel together: a texture is stationary, so
# training on crops of one wood file would leak into evaluating the other).
# Together with matplotlib's portrait this gives a 4-image real-photo
# panel: portrait / macro flower / kitchen wood / dark wood.
EVAL_HOLDOUT_SOURCES: List[Tuple[str, str]] = [
    ("sklearn", "datasets/images/flower.jpg"),
    ("gymnasium_robotics",
     "envs/assets/kitchen_franka/kitchen_assets/textures/wood1.png"),
    ("gymnasium_robotics",
     "envs/assets/adroit_hand/resources/textures/darkwood.png"),
]

_CACHE: Optional[List[np.ndarray]] = None


def _package_dir(pkg: str) -> Optional[str]:
    """The directory of an installed package, found without importing it;
    None when it is not installed."""
    try:
        spec = importlib.util.find_spec(pkg)
    except (ImportError, ValueError):
        return None
    if spec is None or not spec.origin:
        return None
    return os.path.dirname(os.path.abspath(spec.origin))


def _resolve(sources: List[Tuple[str, str]]) -> List[str]:
    out = []
    for pkg, rel in sources:
        d = _package_dir(pkg)
        if d is None:
            continue
        p = os.path.join(d, rel)
        if os.path.isfile(p):
            out.append(p)
    return out


def photo_paths() -> List[str]:
    """TRAINING-pool photo paths that exist in this install (never the
    eval holdouts)."""
    return _resolve(PHOTO_SOURCES)


def eval_photo_paths() -> List[str]:
    """Held-out eval-panel photo paths (never used in training/fitting)."""
    return _resolve(EVAL_HOLDOUT_SOURCES)


def load_eval_photos() -> List[np.ndarray]:
    """Decoded EVAL-panel photos as float32 RGB [0,255] (not cached; the
    panel loads once per eval run)."""
    return [load_image(p) for p in eval_photo_paths()]


def load_photos() -> List[np.ndarray]:
    """Decoded photos as float32 RGB [0,255], cached in-process."""
    global _CACHE
    if _CACHE is None:
        _CACHE = [load_image(p) for p in photo_paths()]
    return _CACHE


def _rand_crop(rng: np.random.Generator, img: np.ndarray, size: int) -> Optional[np.ndarray]:
    """One augmented ``size``-square crop: random mild downscale (a
    downscaled photo is still a photo — adds scale diversity without
    inventing interpolated detail), random position, dihedral-8."""
    from .corpus import _cv2

    cv2 = _cv2()
    h, w = img.shape[:2]
    smin = size / min(h, w)
    if smin > 1.0:
        return None  # never upsample a photo into HR truth
    f = rng.uniform(max(smin, 0.45), 1.0)
    if f < 0.999:
        img = cv2.resize(img, (max(int(w * f), size), max(int(h * f), size)),
                         interpolation=cv2.INTER_AREA)
        h, w = img.shape[:2]
    y = int(rng.integers(0, h - size + 1))
    x = int(rng.integers(0, w - size + 1))
    crop = img[y : y + size, x : x + size]
    if rng.random() < 0.5:
        crop = crop[:, ::-1]
    if rng.random() < 0.5:
        crop = crop[::-1]
    if rng.random() < 0.5:
        crop = np.swapaxes(crop, 0, 1)
    return np.ascontiguousarray(crop, np.float32)


def texture_paths() -> List[str]:
    """Texture-family TRAINING paths that exist in this install (a subset
    of ``photo_paths()``; never the held-out wood captures)."""
    return _resolve(TEXTURE_SOURCES)


_TEX_CACHE: Optional[List[np.ndarray]] = None


def load_textures() -> List[np.ndarray]:
    """Decoded texture captures as float32 RGB [0,255], cached."""
    global _TEX_CACHE
    if _TEX_CACHE is None:
        _TEX_CACHE = [load_image(p) for p in texture_paths()]
    return _TEX_CACHE


def texture_mosaic(seed: int, size: int = 256) -> Optional[np.ndarray]:
    """One deterministic ``size``-square HR image of stationary material
    texture (the "tex" corpus mix's photo arm). Whole crops dominate —
    a texture's training value IS its stationarity, so 2x2 mosaics (which
    introduce artificial seam edges) are used only when no source is
    large enough for a full crop."""
    textures = load_textures()
    if not textures:
        return None
    rng = np.random.default_rng(seed)
    big = [t for t in textures if min(t.shape[:2]) >= size]
    if big:
        crop = _rand_crop(rng, big[int(rng.integers(len(big)))], size)
        if crop is not None:
            return crop
    half = size // 2
    usable = [t for t in textures if min(t.shape[:2]) >= half]
    if not usable:
        return None
    out = np.empty((size, size, 3), np.float32)
    for qy in (0, half):
        for qx in (0, half):
            src = usable[int(rng.integers(len(usable)))]
            out[qy : qy + half, qx : qx + half] = _rand_crop(rng, src, half)
    return out


def photo_mosaic(seed: int, size: int = 256) -> Optional[np.ndarray]:
    """One deterministic ``size``-square HR image of real-photo content.

    Sources large enough yield whole crops; smaller sources contribute via
    a 2x2 mosaic of half-size crops (mosaic seams are just edges — the
    *local* statistics stay photographic). Returns None when no bundled
    photos are available (caller falls back to procedural families)."""
    photos = load_photos()
    if not photos:
        return None
    rng = np.random.default_rng(seed)
    big = [p for p in photos if min(p.shape[:2]) >= size]
    if big and (rng.random() < 0.7 or not photos):
        crop = _rand_crop(rng, big[int(rng.integers(len(big)))], size)
        if crop is not None:
            return crop
    half = size // 2
    usable = [p for p in photos if min(p.shape[:2]) >= half]
    if not usable:
        return None
    out = np.empty((size, size, 3), np.float32)
    for qy in (0, half):
        for qx in (0, half):
            src = usable[int(rng.integers(len(usable)))]
            out[qy : qy + half, qx : qx + half] = _rand_crop(rng, src, half)
    return out
