"""The plain reference of the served path, in PyTorch and numpy only.

From the same input and the same store files as the program, it works
out again what the program's ``process()`` produces for one image of a
configuration: the degradation estimate and the SR-gain probe (route and
alpha), the ladder, the net of each step (per-scale selection from the
store's ``EVAL.json``, fusion's members from its ``FUSION.json``), the
tile layout and the mirror-padded tiles, the nets (EDSR, RCAN, ESPCN,
the bicubic base, the dihedral ensemble, fusion's weighted sum), the
Laplacian canvas-pyramid blend with ramp weights, the crop and the
bicubic resize to the target, the 8-bit quantize, and the QA report's
full-reference values on the input-size proxy (PSNR, SSIM, MS-SSIM and
both LPIPS distances, the LPIPS features read from the store's files by
the reader below). It follows the published arithmetic (cv2's bicubic
and pyramid rules, EDSR/RCAN/ESPCN as the configuration's widths state
them), one step at a time, with no kernels, no banding and no batching.

``precision`` names the variant. "tf32", the reference: the nets'
convolutions in float32 with TF32 (a 10-bit mantissa, above the
configuration's bfloat16) and everything else in float32, QA in float64.
"fp32": the same with TF32 off. "fp8", the control: every convolution's
input and weight rounded to float8 e4m3 (per-tensor scale), the step
below the configuration's bfloat16, and QA in float32 with TF32, the
step below its float32. Two planted faults, at the reference's
precision, serve the check's readings: "half_tiles" serves half of the
tiles by bicubic alone (work left out), "one_pass" runs each dihedral
member once (passes left out).
"""

from __future__ import annotations

import json
import math
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_A = -0.75  # cv2's bicubic coefficient
_G = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)
QUALITY_CANDIDATES = ("edsr_xl", "edsr_l", "edsr_m", "rcan", "espcn")
RESOLUTION_PRESETS = {"100MP": (12245, 8163), "150MP": (15000, 10000),
                      "200MP": (17320, 11547)}


# -- the store's file format ---------------------------------------------------

def read_store_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``.srsw`` file: b"SRSW", u32 version, u64 header length, a JSON
    header listing each tensor's key, dtype, shape and byte-plane ranges
    ``[offset, length, deflated]`` into the data that follows. A 4-byte
    tensor is its four byte planes, lowest first."""
    with open(path, "rb") as f:
        blob = f.read()
    magic, _version, hlen = struct.unpack_from("<4sIQ", blob, 0)
    if magic != b"SRSW":
        raise ValueError(f"{path}: not a store file")
    start = struct.calcsize("<4sIQ")
    header = json.loads(blob[start:start + hlen])
    data = memoryview(blob)[start + hlen:]
    out = {}
    for e in header["tensors"]:
        dtype = np.dtype({"float32": "<f4", "int64": "<i8", "int32": "<i4"}[e["dtype"]])
        n = int(np.prod(e["shape"])) if e["shape"] else 1
        planes = []
        for off, length, deflated in e["planes"]:
            raw = bytes(data[off:off + length])
            planes.append(np.frombuffer(zlib.decompress(raw) if deflated else raw, np.uint8))
        if len(planes) == dtype.itemsize:
            arr = np.stack(planes, axis=1).reshape(-1).view(dtype)
        else:
            arr = planes[0].view(dtype)
        out[e["key"]] = torch.from_numpy(arr[:n].reshape(e["shape"]).copy())
    return out


class Store:
    """The store directory: nets by (name, scale), read once each."""

    def __init__(self, path: str, device):
        self.path, self.device = path, device
        self._nets: Dict[Tuple[str, int], Dict[str, torch.Tensor]] = {}

    def has(self, name: str, scale: int) -> bool:
        return os.path.isfile(os.path.join(self.path, f"{name}_x{scale}.srsw"))

    def state(self, name: str, scale: int) -> Dict[str, torch.Tensor]:
        key = (name, int(scale))
        if key not in self._nets:
            sd = read_store_file(os.path.join(self.path, f"{name}_x{scale}.srsw"))
            self._nets[key] = {k: v.to(self.device, torch.float32) for k, v in sd.items()}
        return self._nets[key]

    def json(self, name: str) -> dict:
        with open(os.path.join(self.path, name)) as f:
            return json.load(f)


# -- cv2 bicubic ---------------------------------------------------------------

def cubic_taps(f: np.ndarray) -> np.ndarray:
    a = _A
    w0 = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a
    w1 = ((a + 2) * f - (a + 3)) * f * f + 1
    w2 = ((a + 2) * (1 - f) - (a + 3)) * (1 - f) * (1 - f) + 1
    return np.stack([w0, w1, w2, 1.0 - w0 - w1 - w2], -1).astype(np.float32)


def resize_axis(x: torch.Tensor, axis: int, m: int) -> torch.Tensor:
    """cv2 INTER_CUBIC along ``axis`` to ``m`` samples: source coordinate
    (o + 0.5) * n / m - 0.5, four Keys taps, replicated borders, no
    antialiasing."""
    n = x.shape[axis]
    if n == m:
        return x
    src = (np.arange(m, dtype=np.float64) + 0.5) * (n / m) - 0.5
    base = np.floor(src)
    w = torch.from_numpy(cubic_taps(src - base)).to(x.device)
    out = None
    for t in range(4):
        idx = torch.from_numpy(np.clip(base.astype(np.int64) + t - 1, 0, n - 1)).to(x.device)
        shape = [1] * x.dim()
        shape[axis] = m
        term = x.index_select(axis, idx) * w[:, t].reshape(shape)
        out = term if out is None else out + term
    return out


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., H, W, C) to (..., h, w, C)."""
    return resize_axis(resize_axis(x, x.dim() - 3, h), x.dim() - 2, w)


# -- pyramids (cv2 pyrDown / pyrUp, BORDER_REFLECT_101) -------------------------

def _reflect101(j: np.ndarray, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros_like(j)
    period = 2 * (n - 1)
    j = np.abs(j) % period
    return np.where(j >= n, period - j, j)


def pyr_down_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    i = np.arange((n + 1) // 2)
    out = None
    for k, g in enumerate(_G):
        idx = torch.from_numpy(_reflect101(2 * i + k - 2, n)).to(x.device)
        term = x.index_select(axis, idx) * g
        out = term if out is None else out + term
    return out


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    return pyr_down_axis(pyr_down_axis(x, x.dim() - 3), x.dim() - 2)


def pyr_up_axis(x: torch.Tensor, axis: int, m: int) -> torch.Tensor:
    """cv2 pyrUp along ``axis`` to ``m`` samples: the signal with zeros
    between samples, filtered by 2 * (1, 4, 6, 4, 1) / 16, with the
    source's REFLECT_101 border on the left and its last sample repeated
    on the right."""
    n = x.shape[axis]
    ext = torch.cat([x.narrow(axis, min(1, n - 1), 1), x, x.narrow(axis, n - 1, 1)], axis)
    left, mid, right = ext.narrow(axis, 0, n), ext.narrow(axis, 1, n), ext.narrow(axis, 2, n)
    even = (left + 6.0 * mid + right) / 8.0
    odd = (mid + right) / 2.0
    shape = list(x.shape)
    shape[axis] = 2 * n
    return torch.stack([even, odd], axis + 1).reshape(shape).narrow(axis, 0, m)


def pyr_up(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return pyr_up_axis(pyr_up_axis(x, x.dim() - 3, h), x.dim() - 2, w)


def pyr_down_1d(v: np.ndarray) -> np.ndarray:
    """pyrDown along the last axis of [N, L] profiles."""
    n = v.shape[-1]
    i = np.arange((n + 1) // 2)
    out = np.zeros(v.shape[:-1] + (len(i),), np.float64)
    for k, g in enumerate(_G):
        out += v[..., _reflect101(2 * i + k - 2, n)] * g
    return out.astype(np.float32)


# -- the nets ------------------------------------------------------------------

def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    amax = float(t.abs().max())
    if amax == 0.0:
        return t
    s = 448.0 / amax
    return (t * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class Nets:
    """Plain forward passes of the configuration's nets on NHWC float32
    [0, 255] batches, bicubic-residual: output = bicubic(x) + 255 *
    net((x / 255 - 0.5))."""

    def __init__(self, store: Store, specs: Dict[str, dict], precision: str = "tf32"):
        self.store, self.specs, self.precision = store, specs, precision
        self.fault: Optional[str] = None

    def _conv(self, h, sd, key, pad):
        w, b = sd[f"{key}.weight"], sd[f"{key}.bias"]
        if self.precision == "fp8":
            h, w = _fp8(h), _fp8(w)
        return F.conv2d(h, w, b, padding=pad)

    def forward(self, name: str, scale: int, x: torch.Tensor) -> torch.Tensor:
        spec, sd = self.specs[name], self.store.state(name, scale)
        factors, s = [], int(scale)
        for f in (2, 3):
            while s % f == 0:
                factors.append(f)
                s //= f
        base = resize(x, x.shape[1] * scale, x.shape[2] * scale)
        h = (x / 255.0 - 0.5).permute(0, 3, 1, 2)
        if spec["kind"] == "espcn":
            h = F.relu(self._conv(F.relu(self._conv(h, sd, "conv_in", 2)), sd, "conv_mid", 1))
            for i, f in enumerate(factors[:-1]):
                h = F.relu(F.pixel_shuffle(self._conv(h, sd, f"up_convs.{i}", 1), f))
            r = self._conv(h, sd, "conv_out", 1)
        else:
            res_scale = float(spec.get("res_scale", 0.1))
            h0 = self._conv(h, sd, "head", 1)
            h = h0
            for i in range(int(spec["blocks"])):
                y = self._conv(F.relu(self._conv(h, sd, f"blocks.{i}.conv0", 1)), sd,
                               f"blocks.{i}.conv1", 1)
                if spec["kind"] == "rcan":
                    g = y.mean(dim=(2, 3), keepdim=True)
                    g = F.relu(self._conv(g, sd, f"blocks.{i}.att0", 0))
                    y = y * torch.sigmoid(self._conv(g, sd, f"blocks.{i}.att1", 0))
                h = h + y * res_scale
            h = self._conv(h, sd, "body_out", 1) + h0
            for i, f in enumerate(factors[:-1]):
                h = F.pixel_shuffle(self._conv(h, sd, f"up_convs.{i}", 1), f)
            r = self._conv(h, sd, "tail", 1)
        r = F.pixel_shuffle(r, factors[-1])
        return base + r.permute(0, 2, 3, 1) * 255.0

    def run(self, name: str, scale: int, x: torch.Tensor, passes: int) -> torch.Tensor:
        """One tile's net output, averaged over the 8 dihedral transforms
        when ``passes`` is 8."""
        if passes == 1:
            return self.forward(name, scale, x)
        acc = None
        for k in range(4):
            for flip in (False, True):
                t = torch.rot90(x, k, dims=(1, 2))
                if flip:
                    t = t.flip(2)
                o = self.forward(name, scale, t.contiguous())
                if flip:
                    o = o.flip(2)
                o = torch.rot90(o, -k, dims=(1, 2))
                acc = o if acc is None else acc + o
        return acc / 8.0


# -- routing -------------------------------------------------------------------

def degradation(img: torch.Tensor, noise_threshold=2.5, band_floor=0.75) -> dict:
    """Noise (Immerkaer's residual over the 60% flattest pixels) and the
    HF/MF band ratio of the luma (Gaussian sigmas 1 and 2, cv2's kernel
    sizes 9 and 17, REFLECT_101)."""
    luma = img @ torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=img.device)
    c = luma[1:-1, 1:-1]
    resp = (4 * c - 2 * (luma[:-2, 1:-1] + luma[2:, 1:-1] + luma[1:-1, :-2] + luma[1:-1, 2:])
            + luma[:-2, :-2] + luma[:-2, 2:] + luma[2:, :-2] + luma[2:, 2:])
    gmag = ((luma[1:-1, 2:] - luma[1:-1, :-2]).abs()
            + (luma[2:, 1:-1] - luma[:-2, 1:-1]).abs()).cpu().numpy().reshape(-1)
    absr = resp.abs().cpu().numpy().reshape(-1)
    flat = gmag <= np.percentile(gmag, 60)
    noise = float(np.median(absr[flat] if flat.any() else absr)) / (6.0 * 0.6745)

    def blur(x, k, sigma):
        i = np.arange(k, dtype=np.float64) - (k - 1) / 2
        g = np.exp(-(i * i) / (2 * sigma * sigma))
        g = torch.from_numpy((g / g.sum()).astype(np.float32)).to(x.device)
        for axis in (0, 1):
            n = x.shape[axis]
            out = None
            for t in range(k):
                idx = torch.from_numpy(_reflect101(np.arange(n) + t - k // 2, n)).to(x.device)
                term = x.index_select(axis, idx) * g[t]
                out = term if out is None else out + term
            x = out
        return x

    b1, b2 = blur(luma, 9, 1.0), blur(luma, 17, 2.0)
    band = float((luma - b1).double().std(correction=0)) / max(
        float((b1 - b2).double().std(correction=0)), 1e-6)
    reason = "noise" if noise >= noise_threshold else "blur" if band <= band_floor else "clean"
    return {"noise_sigma": noise, "band_ratio": band, "degraded": reason != "clean",
            "reason": reason}


def probe(img: torch.Tensor, nets: Nets, name: str, scale: int, crop: int = 192):
    """(gain dB, alpha), or None where no crop fits: five crops downscaled
    by box means, through the net and through bicubic; the median gain
    over bicubic and the pooled least-squares shrinkage, clipped to [0, 1]."""
    h, w = img.shape[:2]
    fits = [r - r % scale for r in (crop, 128, 96) if h >= r - r % scale and w >= r - r % scale]
    if not fits:
        return None  # the probe declines on an input smaller than every crop
    c = fits[0]
    pos = [((h - c) // 4, (w - c) // 4), ((h - c) // 4, 3 * (w - c) // 4),
           (3 * (h - c) // 4, (w - c) // 4), (3 * (h - c) // 4, 3 * (w - c) // 4),
           ((h - c) // 2, (w - c) // 2)]
    hr = torch.stack([img[y:y + c, x:x + c] for y, x in pos])
    lr = hr.reshape(5, c // scale, scale, c // scale, scale, 3).mean(dim=(2, 4))
    out = nets.forward(name, scale, lr).clamp(0, 255)
    bic = resize(lr, c, c).clamp(0, 255)
    d = out - bic
    m_net = ((out - hr) ** 2).mean(dim=(1, 2, 3)).double().clamp(min=1e-12)
    m_bic = ((bic - hr) ** 2).mean(dim=(1, 2, 3)).double().clamp(min=1e-12)
    num = ((hr - bic) * d).mean(dim=(1, 2, 3)).double()
    den = (d * d).mean(dim=(1, 2, 3)).double()
    gain = float(np.median((10.0 * torch.log10(m_bic / m_net)).cpu().numpy()))
    alpha = float(np.clip(float(num.sum()) / max(float(den.sum()), 1e-9), 0.0, 1.0))
    return gain, alpha


def scale_ladder(total: float, trained: set, max_undershoot: float = 0.88) -> List[int]:
    """The {2,3,4} passes whose product lands nearest ``total``: a
    quadratic penalty on overshoot, and on undershoot down to 0.88 of it
    (times 1.05), 4 times for each untrained step, 1.02 per step."""
    best = (float("inf"), [4, 4, 4, 4])

    def score(prod, steps):
        if prod >= total:
            s = (prod / total) ** 2
        elif prod < total * max_undershoot:
            return float("inf")
        else:
            s = (total / prod) ** 2 * 1.05
        for st in steps:
            if st not in trained:
                s *= 4.0
        return s * 1.02 ** len(steps)

    def rec(prod, steps):
        nonlocal best
        s = score(prod, steps)
        if steps and s < best[0]:
            best = (s, list(steps))
        if prod >= total * 4:
            return
        for f in (2, 3, 4):
            rec(prod * f, steps + [f])

    rec(1.0, [])
    return best[1]


def target_size(w: int, h: int, target: str) -> Tuple[int, int]:
    if target in RESOLUTION_PRESETS:
        tw, th = RESOLUTION_PRESETS[target]
        if w / h > tw / th:
            th = int(tw / (w / h))
        else:
            tw = int(th * (w / h))
        return tw, th
    tw, th = (int(v) for v in target.lower().split("x"))
    return tw, th


def select_net(store: Store, scale: int, default: str) -> str:
    """The trained quality net with the best ``photo_panel`` mean delta in
    the store's EVAL.json at ``scale`` (the configured net first on ties)."""
    ledger = store.json("EVAL.json")
    best, best_delta = None, float("-inf")
    for name in (default,) + tuple(n for n in QUALITY_CANDIDATES if n != default):
        delta = ((ledger.get(f"{name}_x{scale}") or {}).get("photo_panel") or {}).get(
            "mean_delta")
        if delta is None or delta <= best_delta or not store.has(name, scale):
            continue
        best, best_delta = name, float(delta)
    return best or default


def fusion_members(store: Store, scale: int) -> Optional[List[Tuple[str, float]]]:
    """FUSION.json's members at ``scale`` that the store holds (and
    bicubic), their weights renormalised; None without two such nets."""
    entry = store.json("FUSION.json").get(f"x{scale}")
    if not entry:
        return None
    kept = [(m, float(w)) for m, w in zip(entry["members"], entry["weights"])
            if m == "bicubic" or store.has(m.rstrip("+"), scale)]
    total = sum(w for _, w in kept)
    if sum(m != "bicubic" for m, _ in kept) < 2 or abs(total) <= 0.25:
        return None
    return [(m, w / total) for m, w in kept]


# -- layout, blend, finalize ---------------------------------------------------

def layout(w: int, h: int, block: int, overlap_ratio: float, step_multiple: int = 32) -> dict:
    overlap = int(block * overlap_ratio)
    step = block - overlap
    if step_multiple > 1 and step > step_multiple:
        step = step // step_multiple * step_multiple
        overlap = block - step
    nx = max(1, math.ceil((w - overlap) / step))
    ny = max(1, math.ceil((h - overlap) / step))
    pos, ov = [], []
    for r in range(ny):
        for c in range(nx):
            pos.append((r * step, c * step))
            ov.append((overlap if r > 0 else 0, overlap if r < ny - 1 else 0,
                       overlap if c > 0 else 0, overlap if c < nx - 1 else 0))
    return {"block": block, "overlap": overlap, "step": step, "nx": nx, "ny": ny,
            "padded_w": (nx - 1) * step + block, "padded_h": (ny - 1) * step + block,
            "positions": pos, "overlaps": ov}


def tiles_of(img: torch.Tensor, lo: dict) -> torch.Tensor:
    """Mirror-pad (numpy's "reflect") to the grid and cut the tiles."""
    h, w = img.shape[:2]
    rows = np.pad(np.arange(h), (0, lo["padded_h"] - h), mode="reflect")
    cols = np.pad(np.arange(w), (0, lo["padded_w"] - w), mode="reflect")
    p = img.index_select(0, torch.from_numpy(rows).to(img.device))
    p = p.index_select(1, torch.from_numpy(cols).to(img.device))
    b = lo["block"]
    return torch.stack([p[y:y + b, x:x + b] for y, x in lo["positions"]])


def _ramp(n: int, lo: int, hi: int) -> np.ndarray:
    w = np.ones(n, np.float32)
    if lo > 0:
        w[:lo] *= np.linspace(0, 1, lo, dtype=np.float32)
    if hi > 0:
        w[-hi:] *= np.linspace(1, 0, hi, dtype=np.float32)
    return w


def _v2(n: int) -> int:
    v = 0
    while n % 2 == 0:
        n //= 2
        v += 1
    return v


def blend(up: List[torch.Tensor], lo: dict, scale: int, levels: int) -> torch.Tensor:
    """The Burt-Adelson canvas blend of the upscaled tiles: each tile's
    Laplacian levels weighted by the pyramid of its ramp profiles,
    accumulated at its position, normalised per level, and collapsed."""
    b = lo["block"] * scale
    pos = np.asarray(lo["positions"]) * scale
    ov = np.asarray(lo["overlaps"]) * scale
    if len(up) > 1:
        align = min(_v2(int(p)) for p in pos.reshape(-1) if int(p) != 0)
        cap = max(1, int(np.log2(max(lo["overlap"] * scale, 4))) - 1)
        levels = max(1, min(levels, align + 1, cap))
    wy = np.stack([_ramp(b, int(o[0]), int(o[1])) for o in ov])
    wx = np.stack([_ramp(b, int(o[2]), int(o[3])) for o in ov])
    py, px = [wy], [wx]
    dev = up[0].device
    # each tile's Gaussian pyramid
    gauss = []
    for t in up:
        g = [t]
        for _ in range(levels - 1):
            hh, ww = g[-1].shape[0], g[-1].shape[1]
            if min(hh, ww) < 2 or min((hh + 1) // 2, (ww + 1) // 2) < 2:
                break
            g.append(pyr_down(g[-1]))
        gauss.append(g)
    n_lv = len(gauss[0])
    for _ in range(n_lv - 1):
        py.append(pyr_down_1d(py[-1]))
        px.append(pyr_down_1d(px[-1]))
    ch, cw = lo["padded_h"] * scale, lo["padded_w"] * scale
    canvas = []
    for i in range(n_lv):
        num = torch.zeros((ch, cw, 3), dtype=torch.float32, device=dev)
        den = torch.zeros((ch, cw, 1), dtype=torch.float32, device=dev)
        for t, g in enumerate(gauss):
            gi = g[i]
            th_, tw_ = gi.shape[0], gi.shape[1]
            lap = gi if i == n_lv - 1 else gi - pyr_up(g[i + 1], th_, tw_)
            wgt = (torch.from_numpy(py[i][t]).to(dev)[:, None, None]
                   * torch.from_numpy(px[i][t]).to(dev)[None, :, None])
            y0 = min(max(int(pos[t, 0]) // 2 ** i, 0), ch - th_)
            x0 = min(max(int(pos[t, 1]) // 2 ** i, 0), cw - tw_)
            num[y0:y0 + th_, x0:x0 + tw_] += lap * wgt
            den[y0:y0 + th_, x0:x0 + tw_] += wgt
        canvas.append(num / den.clamp(min=1e-8))
        ch, cw = (ch + 1) // 2, (cw + 1) // 2
    x = canvas[-1]
    for i in range(n_lv - 2, -1, -1):
        x = canvas[i] + pyr_up(x, canvas[i].shape[0], canvas[i].shape[1])
        canvas[i] = None
    return x


# -- the QA report's full-reference values ----------------------------------------

_C1, _C2 = (0.01 * 255.0) ** 2, (0.03 * 255.0) ** 2
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
# LPIPS feature stacks: widths and 3x3 convolutions per stage, each stage
# a feature, a 2x2 mean pool (floor) between stages.
LPIPS_ARCHS = {"vgg": ((64, 128, 256, 512, 512), (2, 2, 3, 3, 3)),
               "alex": ((64, 192, 384, 256, 256), (1, 1, 1, 1, 1))}


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return min(10.0 * math.log10(255.0 ** 2 / max(mse, 1e-10)), 100.0)


def _gray(x: torch.Tensor) -> torch.Tensor:
    """cv2's RGB2GRAY weights, (H, W, 3) to (1, 1, H, W)."""
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[None, None]


def _gauss11(x: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur(11, sigma 1.5), BORDER_REFLECT_101, on (1, 1, H, W)."""
    i = np.arange(11, dtype=np.float64) - 5
    g = np.exp(-(i * i) / (2 * 1.5 * 1.5))
    g = torch.from_numpy(g / g.sum()).to(x.device, x.dtype)
    for axis, shape in ((2, (1, 1, 11, 1)), (3, (1, 1, 1, 11))):
        n = x.shape[axis]  # the border folds as often as a small side needs
        idx = torch.from_numpy(_reflect101(np.arange(-5, n + 5), n)).to(x.device)
        x = F.conv2d(x.index_select(axis, idx), g.reshape(shape))
    return x


def _ssim_terms(x, y):
    """(luminance x contrast-structure map, contrast-structure map)."""
    mx, my = _gauss11(x), _gauss11(y)
    sx = _gauss11(x * x) - mx * mx
    sy = _gauss11(y * y) - my * my
    sxy = _gauss11(x * y) - mx * my
    cs = (2 * sxy + _C2) / (sx + sy + _C2)
    return (2 * mx * my + _C1) / (mx * mx + my * my + _C1) * cs, cs


def ssim(a: torch.Tensor, b: torch.Tensor) -> float:
    """Gaussian-windowed SSIM of the grey images, the map's mean inside a
    border of 5."""
    m, _cs = _ssim_terms(_gray(a), _gray(b))
    return float(m[..., 5:-5, 5:-5].mean())


def ms_ssim(a: torch.Tensor, b: torch.Tensor, levels: int = 5) -> float:
    """Multi-scale SSIM (Wang et al. 2003): the contrast-structure mean at
    each of the first four scales and the SSIM mean at the fifth, each
    clipped at 0, to Wang's weights; 2x2 mean-pool decimation (floor)."""
    x, y = _gray(a), _gray(b)
    out = 1.0
    for lv in range(levels):
        m, cs = _ssim_terms(x, y)
        v = (m if lv == levels - 1 else cs).mean().clamp(min=0.0)
        out = out * float(v) ** _MSSSIM_WEIGHTS[lv]
        if lv < levels - 1:
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
    return out


def lpips(a: torch.Tensor, b: torch.Tensor, sd: Dict[str, torch.Tensor], net: str) -> float:
    """LPIPS: the mean over the stages of the spatial mean of the squared
    difference of the channel-normalised features, inputs scaled to
    [-1, 1]."""
    widths, reps = LPIPS_ARCHS[net]
    dt = a.dtype

    def feats(x):
        h = (x / 127.5 - 1.0).permute(2, 0, 1)[None]
        out = []
        for s in range(len(widths)):
            for r in range(reps[s]):
                h = F.relu(F.conv2d(h, sd[f"stages.{s}.{r}.weight"].to(dt),
                                    sd[f"stages.{s}.{r}.bias"].to(dt), padding=1))
            out.append(h)
            if s < len(widths) - 1:
                h = F.avg_pool2d(h, 2)
        return out

    total = 0.0
    for fx, fy in zip(feats(a), feats(b)):
        d = (fx * torch.rsqrt((fx * fx).sum(1, keepdim=True) + 1e-10)
             - fy * torch.rsqrt((fy * fy).sum(1, keepdim=True) + 1e-10))
        total += float((d * d).sum(1).mean())
    return total / len(widths)


def qa(img: torch.Tensor, proxy: torch.Tensor, store: Store, dtype: torch.dtype) -> dict:
    """The report's full-reference values of ``proxy`` against the input
    ``img`` (both (H, W, 3) in [0, 255]), computed in ``dtype``."""
    a, b = img.to(dtype), proxy.to(dtype)
    out = {"psnr": psnr(a, b), "ssim": ssim(a, b), "ms_ssim": ms_ssim(a, b)}
    for net in LPIPS_ARCHS:
        sd = read_store_file(os.path.join(store.path, f"lpips_{net}.srsw"))
        sd = {k: v.to(a.device) for k, v in sd.items()}
        out[f"lpips_{net}"] = lpips(a, b, sd, net)
    return out


# -- the whole image -------------------------------------------------------------

PRECISIONS = ("tf32", "fp32", "fp8", "half_tiles", "one_pass")


def run(image: np.ndarray, config: dict, store_dir: str, device,
        precision: str = "tf32") -> dict:
    """What ``process()`` should produce for ``image`` under ``config``:
    the route, the layout, the 8-bit output (a uint8 numpy array), the
    QA report's full-reference values (``qa``), and the probe's gain and
    alpha where it runs."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    pc = config["pipeline"]
    store = Store(store_dir, device)
    nets = Nets(store, config["nets"], "fp8" if precision == "fp8" else "tf32")
    nets.fault = precision if precision in ("half_tiles", "one_pass") else None
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    # TF32 reaches only the nets' convolutions: every other step here is
    # elementwise, and the one matmul (the luma) stays in float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = precision != "fp32"
    try:
        with torch.inference_mode():
            return _run(image, pc, config, store, nets, device,
                        torch.float32 if precision == "fp8" else torch.float64)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _run(image, pc, config, store, nets, device, qa_dtype) -> dict:
    img = torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(device)
    h, w = img.shape[:2]
    tw, th = target_size(w, h, pc.get("target_resolution", "100MP"))
    total = max(tw / w, th / h)
    provider = pc.get("provider", "quality")
    quality = pc.get("quality_model", "edsr_xl")
    routed = provider in ("quality", "seedream", "hybrid", "fusion") and pc.get(
        "auto_route", True)
    out: dict = {"target": [th, tw], "degradation": None, "probe": None}
    model = None
    if routed:
        out["degradation"] = degradation(img)
        robust = pc.get("robust_model", "edsr_l_robust")
        if out["degradation"]["degraded"] and store.has(robust, 2):
            model = robust
    name_at = (lambda s: model) if model else (
        (lambda s: select_net(store, s, quality)) if pc.get("per_scale_selection", True)
        else (lambda s: quality))
    trained = {s for s in (2, 3, 4) if store.has(name_at(s), s)}
    ladder = scale_ladder(total, trained)
    if routed and model is None and ladder:
        found = probe(img, nets, name_at(ladder[0]), ladder[0])
        if found is not None:
            out["probe"] = {"gain": found[0], "alpha": found[1]}
            if found[0] < float(pc.get("sr_gain_floor", 0.0)):
                provider = "shrink"
    steps = []
    for s in ladder:
        fused = fusion_members(store, s) if provider == "fusion" and model is None else None
        if fused is not None:
            steps.append([(m.rstrip("+"), 8 if m.endswith("+") else 1, wt) for m, wt in fused])
        else:
            steps.append([(name_at(s), 8 if pc.get("self_ensemble") else 1, 1.0)])
    if provider == "fusion" and not any(len(st) > 1 for st in steps):
        provider = "quality"
    out["route"] = {"provider": provider, "model": model, "ladder": ladder,
                    "steps": [[[m, p] for m, p, _ in st if m != "bicubic"] for st in steps]}
    lo = layout(w, h, int(pc.get("block_size", 512)), float(pc.get("overlap_ratio", 0.2)))
    out["layout"] = {"num_tiles": lo["nx"] * lo["ny"], "block": lo["block"],
                     "overlap": lo["overlap"]}
    # the shrink route: bicubic + alpha * (net - bicubic), alpha to 3 places
    alpha = round(out["probe"]["alpha"], 3) if provider == "shrink" else None
    up = []
    all_tiles = tiles_of(img, lo)
    for i, tile in enumerate(all_tiles):
        x = tile[None]
        bicubic_only = nets.fault == "half_tiles" and i >= len(all_tiles) // 2
        for s, members in zip(ladder, steps):
            acc = None
            for m, passes, wt in members:
                if nets.fault == "one_pass":
                    passes = 1
                if m == "bicubic" or bicubic_only:
                    y = resize(x, x.shape[1] * s, x.shape[2] * s)
                else:
                    y = nets.run(m, s, x, passes)
                if alpha is not None:
                    bic = resize(x, x.shape[1] * s, x.shape[2] * s)
                    y = bic + alpha * (y.clamp(0, 255) - bic)
                acc = y * wt if acc is None else acc + y * wt
            x = acc.clamp(0, 255)
        up.append(x[0])
    net_scale = int(np.prod(ladder)) if ladder else 1
    canvas = blend(up, lo, net_scale, int(pc.get("num_pyramid_levels", 6)))
    del up
    crop = canvas[:min(canvas.shape[0], h * net_scale), :min(canvas.shape[1], w * net_scale)]
    final = resize(crop, th, tw)
    out["tiff"] = torch.round(final).clamp(0, 255).to(torch.uint8).cpu().numpy()
    proxy = resize(crop, h, w).clamp(0, 255)
    del canvas, crop, final
    out["qa"] = qa(img, proxy, store, qa_dtype)
    return out
