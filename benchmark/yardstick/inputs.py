"""The benchmark's input recipe: a frozen copy of the photo-statistics
scene that ``bench.py`` and the port's ``bench`` subcommand render
(``render_photo(seed, 1280)[280:1000]``, a 720x1280 crop), with numpy
and cv2 only, and the pool of job inputs a run draws from it.

The drawing below is copied from the port's corpus module as it stood
when the benchmark was defined, so a later change to the program's
corpus leaves the benchmark's inputs as they are. A CPU test holds the
copy equal to the program's function.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

# The four orientations of a pool image that keep its size and its
# degradation statistics: identity, mirror left-right, mirror top-bottom,
# half turn.
ORIENTATIONS = ("id", "fh", "fv", "r180")


def _cv2():
    import cv2

    return cv2


def _palette(rng: np.random.Generator, k: int) -> np.ndarray:
    """k correlated RGB colors (float32 [0,255]) around one base hue —
    natural scenes have narrow hue spread and mid saturation, unlike the
    uniform-RGB draws of the graphic families."""
    cv2 = _cv2()

    h0 = rng.uniform(0, 180)
    hues = (h0 + rng.normal(0, 14, k)) % 180
    sats = np.clip(rng.normal(rng.uniform(30, 140), 45, k), 0, 255)
    vals = np.clip(rng.normal(rng.uniform(70, 200), 60, k), 15, 255)
    hsv = np.stack([hues, sats, vals], -1).astype(np.uint8)[None]
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)[0].astype(np.float32)


def _blob_pts(rng: np.random.Generator, cy: float, cx: float, ry: float,
              rx: float, wobble: float, nv: int = 28) -> np.ndarray:
    """Vertex ring of a boundary-warped ellipse (organic object outline)."""
    ang = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    r = np.ones(nv)
    for harm in (1, 2, 3, 5):
        r += wobble * rng.uniform(0, 1.0 / harm) * np.sin(
            harm * ang + rng.uniform(0, 2 * np.pi)
        )
    pts = np.stack([cx + rx * r * np.cos(ang), cy + ry * r * np.sin(ang)], -1)
    return pts.astype(np.int32)


def _textured_fill(rng: np.random.Generator, layer: np.ndarray,
                   alpha: np.ndarray, mask: np.ndarray, color: np.ndarray,
                   palette: np.ndarray) -> None:
    """Paint an object's interior onto (layer, alpha) under ``mask``:
    flat+shading, granule scatter (hair/foliage/fabric-like phase-coherent
    micro-structure), or warped stripes. In-place."""
    cv2 = _cv2()

    ss = layer.shape[0]
    kind = rng.integers(0, 3)
    tex = np.empty_like(layer)
    tex[:] = color
    yy, xx = np.mgrid[0:ss, 0:ss].astype(np.float32) / ss
    if kind == 0:  # shaded flat
        theta = rng.uniform(0, 2 * np.pi)
        shade = (np.cos(theta) * xx + np.sin(theta) * yy)
        amp = rng.uniform(10, 90)
        tex = np.clip(tex + (shade[..., None] - 0.5) * amp, 0, 255)
    elif kind == 1:  # granules
        n = int(rng.integers(60, 400))
        t8 = np.ascontiguousarray(tex).astype(np.uint8)
        ys, xs = np.nonzero(mask)
        if len(ys):
            pick = rng.integers(0, len(ys), n)
            rads = rng.integers(1, max(2, ss // 48), n)
            for i in range(n):
                c = palette[int(rng.integers(len(palette)))]
                c = np.clip(c + rng.normal(0, 18, 3), 0, 255)
                cv2.circle(t8, (int(xs[pick[i]]), int(ys[pick[i]])),
                           int(rads[i]), tuple(int(v) for v in c), -1,
                           lineType=cv2.LINE_AA)
        tex = t8.astype(np.float32)
    else:  # warped stripes (wood / water / cloth)
        theta = rng.uniform(0, np.pi)
        freq = rng.uniform(3, 25)
        warp = rng.uniform(0, 0.35) * np.sin(
            2 * np.pi * rng.uniform(0.5, 3) * yy + rng.uniform(0, 6)
        ) * np.cos(2 * np.pi * rng.uniform(0.5, 3) * xx + rng.uniform(0, 6))
        ph = np.cos(theta) * xx + np.sin(theta) * yy + warp
        w01 = 0.5 + 0.5 * np.sin(2 * np.pi * freq * ph)
        c2 = palette[int(rng.integers(len(palette)))]
        tex = color * w01[..., None] + c2 * (1 - w01[..., None])
    m = mask[..., None].astype(np.float32) / 255.0
    np.copyto(layer, layer * (1 - m) + tex * m)
    np.maximum(alpha, mask.astype(np.float32) / 255.0, out=alpha)


def render_photo(seed: int, size: int = 256) -> np.ndarray:
    """One deterministic photo-statistics HR image (the round-3 natural
    family): layered scene with organic object outlines, per-depth
    depth-of-field blur, a camera PSF, natural correlated palettes,
    vignette/tone jitter, sensor noise and optional JPEG round-trip —
    the statistics a real photograph shows (soft edges of *varied* width,
    piecewise-smooth regions with micro-texture), which the purely sharp
    graphic families lack. Rendered at 2x then INTER_AREA-downsampled
    (optical band-limit). The on-device nets train mostly on this family
    plus real bundled photos (photo_data.py) so their priors transfer to
    photographs (the reference's remote models are photo-trained,
    super_resolution_module.py:561-711)."""
    cv2 = _cv2()

    rng = np.random.default_rng(seed)
    ss = size * 2
    pal = _palette(rng, 8)

    # background: two palette colors, diagonal gradient (sky/ground-ish)
    yy, xx = np.mgrid[0:ss, 0:ss].astype(np.float32) / ss
    theta = rng.uniform(0, 2 * np.pi)
    g = 0.5 + 0.5 * np.tanh((np.cos(theta) * (xx - 0.5) + np.sin(theta) * (yy - 0.5))
                            / rng.uniform(0.08, 0.6))
    bg = pal[0] * g[..., None] + pal[1] * (1 - g[..., None])
    # large-scale luminance field (clouds / walls)
    lum = cv2.GaussianBlur(rng.normal(0, 1, (ss, ss)).astype(np.float32),
                           (0, 0), rng.uniform(ss / 16, ss / 6))
    lum /= max(np.abs(lum).max(), 1e-6)
    canvas = np.clip(bg + lum[..., None] * rng.uniform(8, 50), 0, 255)

    # depth bins back-to-front; blur = dof * |z - focus|
    focus = rng.uniform(0, 1)
    dof = rng.uniform(0, 10) * (ss / 512.0)
    sigma_bg = dof * abs(0.0 - focus)
    if sigma_bg > 0.25:
        canvas = cv2.GaussianBlur(canvas, (0, 0), sigma_bg)
    for z in (0.3, 0.65, 1.0):
        n_obj = int(rng.integers(1, 5))
        layer = np.zeros((ss, ss, 3), np.float32)
        alpha = np.zeros((ss, ss), np.float32)
        for _ in range(n_obj):
            mask = np.zeros((ss, ss), np.uint8)
            cy, cx = rng.uniform(-0.1, 1.1, 2) * ss
            ry = rng.uniform(0.05, 0.45) * ss
            rx = ry * rng.uniform(0.4, 2.5)
            pts = _blob_pts(rng, cy, cx, ry, rx, rng.uniform(0.05, 0.5))
            cv2.fillPoly(mask, [pts], 255, lineType=cv2.LINE_AA)
            color = np.clip(pal[int(rng.integers(len(pal)))] + rng.normal(0, 12, 3), 0, 255)
            _textured_fill(rng, layer, alpha, mask, color.astype(np.float32), pal)
        sigma = dof * abs(z - focus)
        if sigma > 0.25:
            layer = cv2.GaussianBlur(layer, (0, 0), sigma)
            alpha = cv2.GaussianBlur(alpha, (0, 0), sigma)
        a = np.clip(alpha, 0, 1)[..., None]
        canvas = canvas * (1 - a) + layer * a

    # camera PSF + vignette + tone jitter
    canvas = cv2.GaussianBlur(canvas, (0, 0), rng.uniform(0.5, 1.5))
    r2 = (yy - 0.5) ** 2 + (xx - 0.5) ** 2
    canvas = canvas * (1 - rng.uniform(0, 0.35) * r2[..., None] * 2)
    gamma = rng.uniform(0.8, 1.25)
    canvas = np.clip(canvas, 0, 255)
    canvas = 255.0 * (canvas / 255.0) ** gamma
    canvas = np.clip(canvas * rng.uniform(0.94, 1.06, 3), 0, 255)

    img = cv2.resize(canvas.astype(np.float32), (size, size),
                     interpolation=cv2.INTER_AREA)

    # sensor noise: mostly luma-correlated
    sig = rng.uniform(0.3, 3.0)
    n_l = rng.normal(0, sig, (size, size, 1)).astype(np.float32)
    n_c = rng.normal(0, sig * 0.4, (size, size, 3)).astype(np.float32)
    img = np.clip(img + n_l + n_c, 0, 255)

    if rng.random() < 0.35:  # in-camera JPEG statistics
        q = int(rng.integers(70, 96))
        ok, buf = cv2.imencode(".jpg", img[..., ::-1].astype(np.uint8),
                               [int(cv2.IMWRITE_JPEG_QUALITY), q])
        if ok:
            img = cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1].astype(np.float32)
    return np.ascontiguousarray(img, np.float32)


def orient(img: np.ndarray, how: str) -> np.ndarray:
    """``img`` in one of :data:`ORIENTATIONS`, contiguous float32."""
    if how == "fh":
        img = img[:, ::-1]
    elif how == "fv":
        img = img[::-1]
    elif how == "r180":
        img = img[::-1, ::-1]
    elif how != "id":
        raise ValueError(f"unknown orientation {how!r}")
    return np.ascontiguousarray(img, np.float32)


def render_crop(seed: int, size: int, rows: Sequence[int]) -> np.ndarray:
    """``render_photo(seed, size)[rows[0]:rows[1]]`` as float32."""
    return np.ascontiguousarray(render_photo(seed, size)[int(rows[0]):int(rows[1])],
                                np.float32)


def _digest(recipe: dict) -> str:
    key = f"{recipe['size']}:{recipe['rows'][0]}:{recipe['rows'][1]}"
    return hashlib.sha256(key.encode()).hexdigest()[:12]


def load_pool(recipe: dict, cache_dir: str, threads: int = 3) -> Dict[int, np.ndarray]:
    """{render seed: image} for every seed of ``recipe["pool"]``, rendered
    once per checkout into ``cache_dir`` (a fixed directory) and read back
    from there by later runs. A file that does not read back whole is
    rendered again."""
    os.makedirs(cache_dir, exist_ok=True)
    tag = _digest(recipe)
    out: Dict[int, np.ndarray] = {}
    missing: List[int] = []
    for s in recipe["pool"]:
        path = os.path.join(cache_dir, f"photo-{tag}-{int(s)}.npy")
        try:
            out[int(s)] = np.load(path)
        except (OSError, ValueError):
            missing.append(int(s))

    def render(s: int) -> Tuple[int, np.ndarray]:
        img = render_crop(s, int(recipe["size"]), recipe["rows"])
        path = os.path.join(cache_dir, f"photo-{tag}-{s}.npy")
        tmp = f"{path}.part.npy"
        np.save(tmp, img)
        os.replace(tmp, path)
        return s, img

    if missing:
        with ThreadPoolExecutor(max(1, min(threads, len(missing)))) as pool:
            for s, img in pool.map(render, missing):
                out[s] = img
    return out


def job_order(pool_seeds: Sequence[int], seed: int, n_jobs: int) -> List[Tuple[int, str]]:
    """(render seed, orientation) of each of ``n_jobs`` jobs for the run
    seed ``seed``. Every run does the same work in another order: jobs
    go through the pool in rounds, each round holding every pool image
    once, the first pool image first (the checked image, so the checked
    file's size does not move with the seed) and the others in an order
    drawn from ``seed``; each job's orientation is drawn from ``seed``."""
    rng = np.random.default_rng(int(seed) % (2**63))
    first, rest = int(pool_seeds[0]), [int(s) for s in pool_seeds[1:]]
    jobs: List[Tuple[int, str]] = []
    while len(jobs) < n_jobs:
        order = [first] + [rest[i] for i in rng.permutation(len(rest))]
        for s in order:
            jobs.append((s, ORIENTATIONS[int(rng.integers(len(ORIENTATIONS)))]))
    return jobs[:n_jobs]


def checked_jobs(ranges: Sequence[Sequence[int]], seed: int) -> List[int]:
    """The window's checked jobs, sorted: one job index drawn from
    ``seed`` in each inclusive range ``[lo, hi]`` (a range of one job
    gives that job), on a stream of its own apart from :func:`job_order`'s."""
    rng = np.random.default_rng([int(seed) % (2**63), 1])
    return sorted({int(rng.integers(int(lo), int(hi) + 1)) for lo, hi in ranges})
