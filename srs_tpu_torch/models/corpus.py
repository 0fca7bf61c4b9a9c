"""Procedural HR training corpus (port of ``srs_tpu/models/corpus.py``,
a copy of its numpy and cv2 drawing).

The corpus is synthesized, weighted toward content where super-resolution
is learnable: anti-aliased edges, glyphs and text, line art, smooth
shaded regions, oriented patterns, and photo-statistics scenes
(``render_photo``); random-phase 1/f noise stays a minor component (its
detail cannot be recovered from the downsample). ``render_any`` mixes the
families by ``CORPUS_MIXES``; the photo arms take real photographs from
``photo_data.py`` where installed packages bundle them, and fall through
to the procedural families where none is found.

Everything is seeded numpy on the host. The drawing uses cv2, imported
inside the functions that draw, as the reference does; without cv2 they
raise an ``ImportError`` that names it. Nothing else of the port needs
cv2: the trainer takes any corpus array, and zssr and
``train_from_images`` never render one.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CORPUS_MIXES", "make_corpus", "render_any", "render_image", "render_natural",
           "render_photo"]


def _cv2():
    """cv2, or an ImportError that says the corpus needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the procedural corpus draws with cv2 (opencv-python), which is "
                          "not installed; train on a corpus array of your own, or on "
                          "image files (train_from_images)") from e
    return cv2


def _fractal_noise(rng: np.random.Generator, size: int, alpha: float) -> np.ndarray:
    """1/f^alpha spectrum noise, [size, size, 3] in [0, 255]."""
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.rfftfreq(size)[None, :]
    radius = np.sqrt(fy * fy + fx * fx)
    radius[0, 0] = 1.0
    amp = radius ** (-alpha)
    amp[0, 0] = 0.0
    out = np.empty((size, size, 3), np.float32)
    base = None
    corr = rng.uniform(0.3, 0.95)  # inter-channel correlation (natural images)
    for c in range(3):
        phase = rng.uniform(0, 2 * np.pi, amp.shape)
        spec = amp * np.exp(1j * phase)
        ch = np.fft.irfft2(spec, s=(size, size)).astype(np.float32)
        if base is None:
            base = ch
        else:
            ch = corr * base + (1 - corr) * ch
        lo, hi = ch.min(), ch.max()
        out[..., c] = (ch - lo) / max(hi - lo, 1e-8)
    lo = rng.uniform(0, 80)
    hi = rng.uniform(160, 255)
    return out * (hi - lo) + lo


def _voronoi(rng: np.random.Generator, size: int, ncells: int) -> np.ndarray:
    """Flat colored cells with sharp boundaries (cartoon/graphic stats)."""
    pts = rng.uniform(0, size, (ncells, 2)).astype(np.float32)
    colors = rng.uniform(0, 255, (ncells, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    best = np.full((size, size), np.inf, np.float32)
    idx = np.zeros((size, size), np.int32)
    for i, (py, px) in enumerate(pts):
        d = (yy - py) ** 2 + (xx - px) ** 2
        mask = d < best
        best[mask] = d[mask]
        idx[mask] = i
    return colors[idx]


def _gratings(rng: np.random.Generator, size: int) -> np.ndarray:
    """Sum of oriented sinusoids (controlled mid/high frequency content)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((size, size), np.float32)
    for _ in range(rng.integers(2, 5)):
        theta = rng.uniform(0, np.pi)
        freq = rng.uniform(4, size / 5.0)
        phase = rng.uniform(0, 2 * np.pi)
        img += rng.uniform(0.3, 1.0) * np.sin(
            2 * np.pi * freq * (np.cos(theta) * xx + np.sin(theta) * yy) + phase
        )
    img = (img - img.min()) / max(img.max() - img.min(), 1e-8)
    tint = rng.uniform(0.4, 1.0, 3).astype(np.float32)
    return img[..., None] * tint * 255.0


def _draw_overlays(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Anti-aliased shapes, strokes and text at 2x then area-downsample."""
    cv2 = _cv2()

    size = img.shape[0]
    big = cv2.resize(img, (size * 2, size * 2), interpolation=cv2.INTER_CUBIC)
    # cv2 5.x text/drawing requires 8U; the corpus is HR ground truth so
    # 8-bit quantization here is harmless (outputs are 8/16-bit anyway).
    big = np.ascontiguousarray(np.clip(big, 0, 255)).astype(np.uint8)
    for _ in range(rng.integers(3, 10)):
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        kind = rng.integers(0, 4)
        if kind == 0:
            c = (int(rng.integers(0, 2 * size)), int(rng.integers(0, 2 * size)))
            cv2.circle(big, c, int(rng.integers(6, size // 2)), color,
                       int(rng.choice([-1, 2, 4])), lineType=cv2.LINE_AA)
        elif kind == 1:
            p0 = (int(rng.integers(0, 2 * size)), int(rng.integers(0, 2 * size)))
            p1 = (int(rng.integers(0, 2 * size)), int(rng.integers(0, 2 * size)))
            cv2.rectangle(big, p0, p1, color, int(rng.choice([-1, 2, 4])),
                          lineType=cv2.LINE_AA)
        elif kind == 2:
            p0 = (int(rng.integers(0, 2 * size)), int(rng.integers(0, 2 * size)))
            p1 = (int(rng.integers(0, 2 * size)), int(rng.integers(0, 2 * size)))
            cv2.line(big, p0, p1, color, int(rng.integers(1, 6)),
                     lineType=cv2.LINE_AA)
        else:
            txt = "".join(chr(int(c)) for c in rng.integers(33, 126, rng.integers(3, 9)))
            org = (int(rng.integers(0, 2 * size)), int(rng.integers(20, 2 * size)))
            cv2.putText(big, txt, org, cv2.FONT_HERSHEY_SIMPLEX,
                        float(rng.uniform(0.6, 2.5)), color,
                        int(rng.integers(1, 4)), lineType=cv2.LINE_AA)
    return cv2.resize(big, (size, size), interpolation=cv2.INTER_AREA).astype(np.float32)


def _gradient(rng: np.random.Generator, size: int) -> np.ndarray:
    """Smooth linear/radial shading + soft elliptical blobs (photo-like
    out-of-focus regions: trivially learnable, teaches the net restraint)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    theta = rng.uniform(0, 2 * np.pi)
    field = np.cos(theta) * xx + np.sin(theta) * yy
    c0 = rng.uniform(0, 255, 3).astype(np.float32)
    c1 = rng.uniform(0, 255, 3).astype(np.float32)
    img = field[..., None] * (c1 - c0) + c0
    for _ in range(rng.integers(2, 7)):
        cy, cx = rng.uniform(0, 1, 2)
        sy, sx = rng.uniform(0.03, 0.3, 2)
        rot = rng.uniform(0, np.pi)
        dy, dx = yy - cy, xx - cx
        u = np.cos(rot) * dx + np.sin(rot) * dy
        v = -np.sin(rot) * dx + np.cos(rot) * dy
        blob = np.exp(-(u * u / (2 * sx * sx) + v * v / (2 * sy * sy)))
        col = rng.uniform(0, 255, 3).astype(np.float32)
        a = rng.uniform(0.3, 0.9)
        img = img * (1 - a * blob[..., None]) + col * a * blob[..., None]
    return img


def _document(rng: np.random.Generator, size: int) -> np.ndarray:
    """Text-page composition: dense glyph lines + rules/boxes on a near-
    uniform background — the strongest SR-learnable content (glyph strokes
    have phase-aligned edges bicubic blurs in a systematic, invertible way)."""
    cv2 = _cv2()

    light = rng.random() < 0.75
    bg = rng.uniform(200, 255, 3) if light else rng.uniform(0, 60, 3)
    fg_lo, fg_hi = (0, 90) if light else (170, 255)
    big = np.full((size * 2, size * 2, 3), bg, np.float32).astype(np.uint8)
    fonts = [cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_COMPLEX,
             cv2.FONT_HERSHEY_TRIPLEX, cv2.FONT_HERSHEY_PLAIN,
             cv2.FONT_HERSHEY_DUPLEX]
    y = int(rng.integers(10, 40))
    while y < 2 * size - 10:
        fs = float(rng.uniform(0.5, 1.6))
        col = tuple(int(v) for v in rng.uniform(fg_lo, fg_hi, 3))
        n_ch = int(rng.integers(8, 30))
        txt = "".join(chr(int(c)) for c in rng.integers(33, 126, n_ch))
        cv2.putText(big, txt, (int(rng.integers(0, size // 2)), y),
                    fonts[int(rng.integers(0, len(fonts)))], fs, col,
                    int(rng.integers(1, 3)), lineType=cv2.LINE_AA)
        y += int(20 * fs + rng.integers(4, 16))
    for _ in range(rng.integers(0, 4)):  # rules / boxes
        col = tuple(int(v) for v in rng.uniform(fg_lo, fg_hi, 3))
        p0 = (int(rng.integers(0, 2 * size)), int(rng.integers(0, 2 * size)))
        p1 = (int(rng.integers(0, 2 * size)), int(rng.integers(0, 2 * size)))
        if rng.random() < 0.5:
            cv2.line(big, p0, p1, col, int(rng.integers(1, 4)), lineType=cv2.LINE_AA)
        else:
            cv2.rectangle(big, p0, p1, col, int(rng.integers(1, 4)), lineType=cv2.LINE_AA)
    return cv2.resize(big, (size, size), interpolation=cv2.INTER_AREA).astype(np.float32)


def _pattern(rng: np.random.Generator, size: int) -> np.ndarray:
    """Hard-edged periodic structure: checkers / rings / stripe bundles."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    kind = rng.integers(0, 3)
    if kind == 0:  # rotated checkerboard
        theta = rng.uniform(0, np.pi)
        f = rng.uniform(4, 24)
        u = np.cos(theta) * xx + np.sin(theta) * yy
        v = -np.sin(theta) * xx + np.cos(theta) * yy
        img = (np.sin(2 * np.pi * f * u) * np.sin(2 * np.pi * f * v) > 0).astype(np.float32)
    elif kind == 1:  # concentric rings
        cy, cx = rng.uniform(0.2, 0.8, 2)
        r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        img = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(8, 40) * r)
        if rng.random() < 0.5:
            img = (img > 0.5).astype(np.float32)
    else:
        return _gratings(rng, size)
    c0 = rng.uniform(0, 255, 3).astype(np.float32)
    c1 = rng.uniform(0, 255, 3).astype(np.float32)
    return img[..., None] * (c1 - c0) + c0


def render_image(seed: int, size: int = 256) -> np.ndarray:
    """One deterministic HR image, [size, size, 3] float32 in [0, 255].

    Class mix weighted toward SR-learnable structure (edges/glyphs/line
    art); renders at a jittered supersize then area-downsamples half the
    time to diversify band-limit/aliasing statistics (pure at-size renders
    share one phase structure, which lets a capable net memorize the
    generator instead of learning generic detail priors)."""
    cv2 = _cv2()

    rng = np.random.default_rng(seed)
    ss = size if rng.random() < 0.5 else int(size * rng.uniform(1.25, 2.0))
    u = rng.random()
    if u < 0.26:  # graphic: flat cells + overlays
        img = _voronoi(rng, ss, int(rng.integers(6, 30)))
        img = _draw_overlays(rng, img)
    elif u < 0.50:  # document / text page
        img = _document(rng, ss)
    elif u < 0.70:  # photo-like shading + some sharp foreground
        img = _gradient(rng, ss)
        if rng.random() < 0.7:
            img = _draw_overlays(rng, img)
        if rng.random() < 0.4:  # low-contrast film-grain texture
            img = 0.9 * img + 0.1 * _fractal_noise(rng, ss, rng.uniform(1.2, 2.0))
    elif u < 0.88:  # periodic pattern
        img = _pattern(rng, ss)
        if rng.random() < 0.5:
            img = _draw_overlays(rng, img)
    else:  # textured (kept minor: random phase is unlearnable)
        img = _fractal_noise(rng, ss, rng.uniform(1.0, 2.2))
        if rng.random() < 0.7:
            img = _draw_overlays(rng, img)
    if ss != size:
        img = cv2.resize(
            np.ascontiguousarray(img, np.float32), (size, size),
            interpolation=cv2.INTER_AREA,
        )
    return np.clip(img, 0.0, 255.0).astype(np.float32)


def render_natural(seed: int, size: int = 256) -> np.ndarray:
    """One deterministic *natural-statistics* image: 1/f^a spectrum base
    (the classic natural-image power-law) with phase-coherent overlays for
    edge structure. This is the pristine family for the packaged NIQE
    model (qa/niqe.py): published NIQE is defined as deviation from
    pristine *natural* NSS — hard-edged synthetic graphics (documents,
    checkers) have non-natural statistics that blurring moves *toward*
    Gaussian, so they cannot serve as a pristine reference."""
    _cv2()  # _draw_overlays draws with it

    rng = np.random.default_rng(seed)
    img = _fractal_noise(rng, size, rng.uniform(1.0, 1.8))
    img = _draw_overlays(rng, img)
    return np.clip(img, 0.0, 255.0).astype(np.float32)


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


# Corpus family mixes. "proc" is the round-1/2 procedural corpus (kept as
# the stable held-out eval distribution, train.eval_on_holdout); "v3"
# (round 3) weights toward photo statistics: the generalization gap to
# real photographs was the round-2 verdict's top finding. "v4" = v3 with
# a larger real-photo share and a JPEG round-trip applied to the final HR:
# consumer photographs ARE JPEGs, so the HR truth an SR system is scored
# against carries compression statistics the net must reproduce, and the
# LR it receives is a downsample OF that compressed signal — a clean-HR
# corpus mismatches both ends of the pair.
CORPUS_MIXES = ("proc", "v3", "v4", "photo", "p70", "tex")


def render_any(seed: int, size: int = 256, mix: str = "proc") -> np.ndarray:
    """One deterministic corpus image under a family mix."""
    if mix == "proc":
        return render_image(seed, size)
    if mix == "tex":
        # Texture-tier fine-tune mix (round 5, VERDICT r4 #7): 90%
        # photographed stationary material captures (photo_data
        # TEXTURE_SOURCES — never the held-out wood family) + 10% clean
        # procedural replay to keep edge/glyph behavior from drifting.
        # No JPEG round-trip: the texture captures (and the held-out wood
        # panel) are PNG camera data, and the failure being fixed is
        # hallucinated high frequencies, not compression statistics.
        rng = np.random.default_rng(seed ^ 0x5F375A86)
        if rng.random() < 0.90:
            from .photo_data import texture_mosaic

            img = texture_mosaic(seed, size)
            if img is not None:
                return img
        return render_image(seed, size)
    if mix not in ("v3", "v4", "photo", "p70"):
        raise ValueError(f"unknown corpus mix {mix!r}; known: {CORPUS_MIXES}")
    rng = np.random.default_rng(seed ^ 0x5F375A86)
    u = rng.random()
    img = None
    took_photo = False
    # "photo": real-photo mosaics only (fine-tune mix; diversity comes
    # from crop/scale/dihedral augmentation). "p70" = rehearsal fine-tune
    # mix: 70% photo mosaics + 30% CLEAN render_image replay — photo-only
    # fine-tunes cost ~1.1 dB on the procedural eval panel (catastrophic
    # forgetting); the replay arm pins the panel while the photo arm
    # teaches natural statistics.
    photo_share = {"v4": 0.40, "photo": 1.01, "p70": 0.70}.get(mix, 0.30)
    if u < photo_share:  # real bundled photographs (never the held-out eval photo)
        from .photo_data import photo_mosaic

        img = photo_mosaic(seed, size)
        if img is None:
            u = 0.5  # no photos installed: fall through to render_photo
        else:
            took_photo = True
    if img is None:
        if mix == "p70":  # replay arm: the eval-panel distribution itself
            img = render_image(seed, size)
        elif u < 0.62:
            img = render_photo(seed, size)
        elif u < 0.72:
            img = render_natural(seed, size)
        else:
            img = render_image(seed, size)
    if (mix in ("v4", "photo") or (mix == "p70" and took_photo)) and rng.random() < 0.55:
        cv2 = _cv2()

        q = int(rng.integers(70, 96))
        ok, buf = cv2.imencode(".jpg", img[..., ::-1].astype(np.uint8),
                               [int(cv2.IMWRITE_JPEG_QUALITY), q])
        if ok:
            img = cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1].astype(np.float32)
    return np.ascontiguousarray(img, np.float32)


def make_corpus(n: int, size: int = 256, seed: int = 0, mix: str = "proc") -> np.ndarray:
    """[n, size, size, 3] float32 HR images. Different ``seed`` ranges give
    disjoint train/held-out sets (train uses seed..seed+n-1)."""
    return np.stack([render_any(seed + i, size, mix) for i in range(n)])
