"""Port parity: image IO (srs_tpu_torch.io.image) against PIL and the JAX
package's ``srs_tpu.io.image``.

The PNG decoder must give exactly what PIL's ``convert("RGB")`` gives (no
tolerance): on files PIL writes (gray, gray+alpha, RGB, RGBA, palette at
1, 2, 4 and 8 bits, 1-bit and 16-bit gray) and on files written here with
a chosen filter per row (every filter type, bit depths 8 and 16, all five
colour types, odd widths), which PIL reads too. The encoder round-trips
exactly, and PIL reads its files as written.
"""

import builtins
import io
import struct
import sys
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from srs_tpu.io.image import image_size as jax_image_size
from srs_tpu.io.image import load_image as jax_load_image
from srs_tpu_torch.io.image import (
    decode_png,
    encode_png,
    image_size,
    load_image,
    save_image,
)
from srs_tpu_torch.io.native import read_tiff

SIZES = [(1, 1), (7, 13), (16, 33), (5, 64)]  # (h, w): odd and even widths


def _pixels(h, w, c, seed, hi=256):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 37 + yy * 11)[..., None] + 50 * np.arange(c)
    return ((base + rng.integers(0, 40, (h, w, c))) % hi).astype(np.int64)


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def _filtered_png(samples, bits, ctype, filters, palette=None, interlace=0):
    """A PNG whose row r uses filter ``filters[r % len(filters)]``."""
    h, w, c = samples.shape
    if bits == 16:
        rows = samples.astype(">u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
    elif bits == 8:
        rows = samples.astype(np.uint8).reshape(h, -1)
    else:
        per = 8 // bits
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = samples[..., 0]
        groups = padded.reshape(h, -1, per)
        shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint8)
        rows = (groups << shifts).sum(-1).astype(np.uint8)
    bpp = max(1, c * bits // 8)
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r in range(h):
        x = rows[r].astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        cc = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        f = filters[r % len(filters)]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) // 2
        else:
            p = a + prev - cc
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - cc)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, cc))
        out.append(bytes([f]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = x
    parts = [b"\x89PNG\r\n\x1a\n",
             _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, ctype, 0, 0, interlace))]
    if palette is not None:
        parts.append(_chunk(b"PLTE", palette.astype(np.uint8).tobytes()))
    parts += [_chunk(b"IDAT", zlib.compress(b"".join(out))), _chunk(b"IEND", b"")]
    return b"".join(parts)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "1", "I;16", "P2", "P4", "P16",
                                  "P256"])
@pytest.mark.parametrize("size", SIZES)
def test_decoder_matches_pil_on_files_pil_writes(mode, size):
    h, w = size
    if mode.startswith("P"):
        colors = int(mode[1:])
        im = Image.fromarray(_pixels(h, w, 1, 1, colors)[..., 0].astype(np.uint8), "P")
        pal = np.random.default_rng(2).integers(0, 256, (colors, 3)).astype(np.uint8)
        im.putpalette(pal.tobytes())
    elif mode == "1":
        im = Image.fromarray(_pixels(h, w, 1, 1)[..., 0].astype(np.uint8) > 127)
    elif mode == "I;16":
        im = Image.fromarray((_pixels(h, w, 1, 1, 65536)[..., 0] // 97).astype(np.uint16))
    else:
        c = len(mode)
        im = Image.fromarray(_pixels(h, w, c, 1).astype(np.uint8).squeeze(-1) if c == 1
                             else _pixels(h, w, c, 1).astype(np.uint8), mode)
    buf = io.BytesIO()
    im.save(buf, format="PNG", compress_level=3)
    data = buf.getvalue()
    np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))


# (colour type, bit depths): gray, RGB, palette, gray+alpha, RGBA
COLOUR_TYPES = [(0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)),
                (6, (8, 16))]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("ctype,bits", [(c, b) for c, bs in COLOUR_TYPES for b in bs])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_decoder_matches_pil_for_every_filter(ctype, bits, filters):
    h, w = 9, 13
    samples = _pixels(h, w, CHANNELS[ctype], 3, 1 << bits)
    palette = None
    if ctype == 3:
        # fewer entries than indices: indices past the palette read black
        palette = np.random.default_rng(4).integers(0, 256, (max(1, (1 << bits) - 1), 3))
    data = _filtered_png(samples, bits, ctype, filters, palette)
    np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))


def test_adam7_raises_and_names_it():
    data = _filtered_png(_pixels(4, 4, 3, 0), 8, 2, (0,), interlace=1)
    with pytest.raises(ValueError, match="Adam7"):
        decode_png(data)


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 13, 3), (20, 31), (40, 64, 3)])
def test_encoder_round_trip_and_pil_reads_it(shape):
    img = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    data = encode_png(img)
    rgb = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    np.testing.assert_array_equal(decode_png(data), rgb)
    np.testing.assert_array_equal(_pil_rgb(data), rgb)


def test_load_image_reads_png_without_pil(tmp_path, monkeypatch):
    img = _pixels(17, 23, 3, 5).astype(np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(img).save(path)
    ref = np.asarray(jax_load_image(path))
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL made unimportable for this test")
        return real_import(name, *args, **kwargs)

    for mod in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    got = load_image(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert image_size(path) == (23, 17)
    with pytest.raises(RuntimeError, match="PIL"):
        save_image(str(tmp_path / "x.jpg"), img)


def test_load_image_matches_reference_on_other_formats(tmp_path):
    img = _pixels(12, 9, 3, 6).astype(np.uint8)
    path = str(tmp_path / "x.bmp")
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(load_image(path), np.asarray(jax_load_image(path)))
    assert image_size(path) == jax_image_size(path) == (9, 12)


@pytest.mark.parametrize("ext,bit_depth", [(".png", 8), (".tiff", 8), (".tif", 16)])
def test_save_image_round_trip(tmp_path, ext, bit_depth):
    img = np.random.default_rng(1).uniform(-10, 265, (11, 19, 3)).astype(np.float32)
    path = str(tmp_path / f"o{ext}")
    assert save_image(path, img, bit_depth=bit_depth) == path
    q8 = np.clip(img, 0, 255).astype(np.uint8)
    if ext == ".png":
        np.testing.assert_array_equal(load_image(path), q8.astype(np.float32))
    elif bit_depth == 16:
        want = (np.clip(img.astype(np.float64), 0, 255) / 255.0 * 65535.0 + 0.5).astype(np.uint16)
        np.testing.assert_array_equal(read_tiff(path), want)
    else:
        np.testing.assert_array_equal(read_tiff(path), q8)


def test_save_image_jpeg_goes_through_pil(tmp_path):
    img = np.full((16, 16, 3), 128, np.uint8)
    path = str(tmp_path / "o.jpg")
    save_image(path, img)
    with Image.open(path) as im:
        assert im.format == "JPEG" and im.size == (16, 16)


def test_decodes_720p_paeth_png_in_under_2s():
    """Average and Paeth are serial along a row: the decoder walks
    anti-diagonals. A 720x1280 RGB PNG with those filters decodes in
    under 2 s on the host."""
    img = _pixels(720, 1280, 3, 7).astype(np.uint8)
    data = _filtered_png(img, 8, 2, (4, 3))
    t0 = time.perf_counter()
    out = decode_png(data)
    elapsed = time.perf_counter() - t0
    np.testing.assert_array_equal(out, img)
    assert elapsed < 2.0, elapsed
