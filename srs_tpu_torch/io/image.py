"""Host-side image IO (port of ``srs_tpu/io/image.py:25-69``).

The card's machine has no PIL, so PNG is read and written here with the
standard library's ``zlib`` and numpy:

- :func:`load_image` decodes every non-interlaced PNG (gray, gray+alpha,
  RGB, RGBA and palette images; bit depths 1 to 16; all five row
  filters) to exactly what PIL's ``convert("RGB")`` gives, as float32.
  Other formats go through PIL, imported only then.
- :func:`save_image` writes ``.tif``/``.tiff`` through the port's native
  writer, ``.png`` through a zlib encoder at level 3 (the reference's PIL
  ``compress_level=3``), and anything else as JPEG through PIL.
- :func:`image_size` reads a PNG's IHDR or a TIFF's first IFD, or asks PIL.

Arrays are RGB float32 in [0, 255] throughout the port.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

__all__ = ["load_image", "save_image", "image_size", "decode_png", "encode_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _SIGNATURE


def _chunks(data: bytes):
    """(type, payload) of each chunk, up to IEND, CRCs checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG ends without IEND")


def _header(payload: bytes) -> Tuple[int, int, int, int]:
    w, h, bits, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", payload)
    if ctype not in _CHANNELS or bits not in _DEPTHS[ctype]:
        raise ValueError(f"PNG: invalid colour type {ctype} with bit depth {bits}")
    if comp != 0 or filt != 0:
        raise ValueError("PNG: unknown compression or filter method")
    if interlace == 1:
        raise ValueError("PNG: Adam7-interlaced files are not supported")
    return w, h, bits, ctype


def _unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` (h rows of 1 + row_bytes bytes).

    Byte (r, x) depends on (r, x - bpp), (r - 1, x) and (r - 1, x - bpp),
    so Average and Paeth are serial along a row and down a column. Seen as
    an [h, row_bytes / bpp, bpp] grid of pixels, every pixel on one
    anti-diagonal (row + pixel = d) depends only on earlier diagonals: the
    loop walks the h + w - 1 diagonals, each one vectorised over its rows
    and the pixel's bytes, each row by its own filter type."""
    rows = raw.reshape(h, row_bytes + 1)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    w = row_bytes // bpp
    data = rows[:, 1:].reshape(h, w, bpp).astype(np.int16)
    # out[r + 1, j + 1] is pixel (r, j); row 0 and column 0 stay zero
    out = np.zeros((h + 1, w + 1, bpp), np.int16)
    if not ((ftype == 3) | (ftype == 4)).any():
        # None, Sub and Up only: row by row, Sub as a running sum mod 256
        for r in range(h):
            x = data[r]
            if ftype[r] == 1:
                x = np.cumsum(x, axis=0, dtype=np.int64)
            elif ftype[r] == 2:
                x = x + out[r, 1:]
            out[r + 1, 1:] = x & 0xFF
        return out[1:, 1:].astype(np.uint8).reshape(h, row_bytes)
    ft = ftype.astype(np.int16)[:, None]
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        j = d - r
        a = out[r + 1, j]  # left
        b = out[r, j + 1]  # up
        c = out[r, j]  # up-left
        f = ft[r]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0))))
        out[r + 1, j + 1] = (data[r, j] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, row_bytes)


def decode_png(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 array that PIL's ``Image.open(...).convert("RGB")``
    gives for a non-interlaced PNG. 16-bit samples keep their high byte,
    except 16-bit gray, which PIL clips to 255; sub-byte gray scales to
    0-255; palette indices past the palette read black; alpha and tRNS are
    dropped, as PIL's conversion does."""
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = _header(payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise ValueError("PNG: missing IHDR or IDAT")
    w, h, bits, ctype = header
    ch = _CHANNELS[ctype]
    row_bytes = (w * ch * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (row_bytes + 1):
        raise ValueError("PNG: image data is truncated")
    flat = _unfilter(raw[: h * (row_bytes + 1)], h, row_bytes, max(1, ch * bits // 8))
    if bits == 16:
        s = flat.reshape(h, w, ch, 2)
        samples = s[..., 0] if ctype != 0 else np.where(
            s[..., 0] > 0, 255, s[..., 1]).astype(np.uint8)
    elif bits == 8:
        samples = flat.reshape(h, w, ch)
    else:
        per = 8 // bits
        vals = np.unpackbits(flat, axis=1).reshape(h, row_bytes * per, bits)
        weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
        samples = (vals * weights).sum(-1, dtype=np.uint8)[:, :w, None]
        if ctype == 0:
            samples = samples * np.uint8(255 // ((1 << bits) - 1))
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        lut = np.zeros((256, 3), np.uint8)
        lut[: len(palette)] = palette[:256]
        return lut[samples[..., 0]]
    if ch <= 2:  # gray, gray + alpha
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def encode_png(image: np.ndarray, level: int = 3) -> bytes:
    """8-bit PNG (gray for (H, W), RGB for (H, W, 3)) of a uint8 array,
    every row unfiltered, deflated at ``level``."""
    arr = np.ascontiguousarray(image, np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        ctype = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"encode_png: expected (H, W) or (H, W, 3), got {arr.shape}")
    h, w = arr.shape[:2]
    raw = np.zeros((h, 1 + arr[0].size), np.uint8)
    raw[:, 1:] = arr.reshape(h, -1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)

    return b"".join([
        _SIGNATURE,
        chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)),
        chunk(b"IDAT", zlib.compress(raw.tobytes(), level)),
        chunk(b"IEND", b""),
    ])


def load_image(path: str) -> np.ndarray:
    """RGB float32 (H, W, 3) in [0, 255]."""
    if _is_png(path):
        with open(path, "rb") as f:
            return decode_png(f.read()).astype(np.float32)
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None  # print-grade outputs exceed PIL's default
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32)


def save_image(path: str, image: np.ndarray, quality: int = 95, bit_depth: int = 8) -> str:
    """Save by extension: .tiff/.tif -> the native deflate TIFF (8 or 16
    bits; float input in [0, 255], 16-bit rescaled from that range), .png
    -> 8-bit PNG, else JPEG through PIL (reference io/image.py:34-63)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    lower = path.lower()
    arr = np.asarray(image)
    if lower.endswith((".tiff", ".tif")):
        from .native import TiffStreamWriter

        if arr.ndim == 2:
            arr = arr[..., None]
        if bit_depth == 16:
            if arr.dtype != np.uint16:
                arr = (np.clip(arr.astype(np.float64), 0, 255) / 255.0 * 65535.0
                       + 0.5).astype(np.uint16)
        elif arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        h, w, c = arr.shape
        with TiffStreamWriter(path, h, w, channels=c, bit_depth=bit_depth) as writer:
            writer.write(arr)
        return path
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    if lower.endswith(".png"):
        with open(path, "wb") as f:
            f.write(encode_png(arr, level=3))
        return path
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("PIL unavailable: JPEG output needs it; use .png or .tiff") from e
    Image.fromarray(arr).save(path, quality=quality)
    return path


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) without decoding pixel data."""
    if _is_png(path):
        with open(path, "rb") as f:
            head = f.read(33)
        w, h = struct.unpack_from(">II", head, 16)
        return w, h
    with open(path, "rb") as f:
        is_tiff = f.read(4) == b"II*\x00"
    if is_tiff:  # the port's writer; the card has no PIL
        from .native import tiff_size

        return tiff_size(path)
    from PIL import Image

    with Image.open(path) as im:
        return im.size
