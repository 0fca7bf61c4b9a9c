"""Result page (port of ``srs_tpu/webui/pages/result_page.py``): the
output beside the input, the QA report's metrics, and the export.

``build_export`` re-encodes the pipeline's output as the selectors ask,
with the port's own codecs: TIFF (8 or 16 bits) through the native
writer, PNG through the port's encoder, and JPEG through PIL, the only
format that needs it; without PIL a JPEG export raises.
"""

from __future__ import annotations

import os
import tempfile
from typing import Tuple

import numpy as np

from ..session import get_state

__all__ = ["EXPORT_FORMATS", "COLOR_SPACES", "BIT_DEPTHS", "read_output", "build_export",
           "render"]

EXPORT_FORMATS = ["tiff", "png", "jpeg"]
COLOR_SPACES = ["sRGB", "AdobeRGB", "ProPhoto"]
BIT_DEPTHS = [8, 16]


def read_output(path: str) -> np.ndarray:
    """The pipeline's output as RGB float32 in [0, 255]: a TIFF through
    ``read_tiff`` (16-bit divided by 257), a PNG through the port's
    decoder, another format through PIL."""
    if path.lower().endswith((".tiff", ".tif")):
        from ...io.native import read_tiff

        raw = read_tiff(path)
        arr = raw.astype(np.float32)
        if raw.dtype == np.uint16:
            arr /= 257.0
        return arr[..., :3] if arr.shape[2] >= 3 else np.repeat(arr, 3, axis=2)
    from ...io.image import load_image

    return load_image(path)


def build_export(path: str, fmt: str, color_space: str, bit_depth: int,
                 quality: int = 95) -> Tuple[bytes, str]:
    """(file bytes, suggested file name) of the output at ``path``
    converted to ``color_space`` and encoded as ``fmt``. 16 bits need a
    TIFF; PNG and JPEG exports are 8-bit."""
    from ...ops.colorspace import convert_profile

    if fmt == "jpeg":
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError("JPEG export needs PIL, which is not installed; "
                               "export TIFF or PNG") from e
    arr = read_output(path)
    if color_space != "sRGB":
        arr = convert_profile(arr, color_space)
    stem = os.path.splitext(os.path.basename(path))[0]
    suffix = "" if color_space == "sRGB" else f"_{color_space.lower()}"
    if fmt == "tiff":
        from ...io.native import write_tiff

        with tempfile.NamedTemporaryFile(suffix=".tiff", delete=False) as tmp:
            tmp_path = tmp.name
        try:
            write_tiff(tmp_path, arr, bit_depth=bit_depth if bit_depth in (8, 16) else 8)
            with open(tmp_path, "rb") as f:
                return f.read(), f"{stem}{suffix}.tiff"
        finally:
            os.unlink(tmp_path)
    img8 = np.clip(arr, 0, 255).astype(np.uint8)
    if fmt == "jpeg":
        import io

        buf = io.BytesIO()
        Image.fromarray(img8).save(buf, format="JPEG", quality=int(quality))
        return buf.getvalue(), f"{stem}{suffix}.jpg"
    from ...io.image import encode_png

    return encode_png(img8), f"{stem}{suffix}.png"


def _preview(arr: np.ndarray, side: int = 1400) -> np.ndarray:
    step = max(1, -(-max(arr.shape[:2]) // side))
    return np.clip(arr[::step, ::step], 0, 255).astype(np.uint8)


def render() -> None:
    import streamlit as st

    st.header("4. Result")
    path = get_state("result_path")
    if not path or not os.path.exists(path):
        st.info("No result yet.")
        return

    out = read_output(path)
    oh, ow = out.shape[:2]
    src = get_state("uploaded_image")
    c1, c2 = st.columns(2)
    if src is not None:
        sw, sh = (src.shape[1], src.shape[0]) if isinstance(src, np.ndarray) else src.size
        c1.image(src, caption=f"Input {sw}x{sh}")
    c2.image(_preview(out), caption=f"Output {ow}x{oh} ({ow * oh / 1e6:.0f} MP, preview)")

    report = get_state("qa_report")
    if report:
        st.subheader("Quality metrics")
        cols = st.columns(5)
        for col, (label, key, fmt) in zip(cols, [
            ("PSNR", "psnr", "{:.2f} dB"),
            ("SSIM", "ssim", "{:.4f}"),
            ("MS-SSIM", "ms_ssim", "{:.4f}"),
            ("NIQE", "niqe", "{:.2f}"),
            ("Overall", "overall_score", "{:.1f}/100"),
        ]):
            if key in report:
                col.metric(label, fmt.format(report[key]))
        with st.expander("Full QA report"):
            st.json(report)

    st.subheader("Export")
    fmt = st.selectbox("Format", EXPORT_FORMATS)
    color_space = st.selectbox("Color space", COLOR_SPACES)
    bit_depth = st.selectbox("Bit depth", BIT_DEPTHS)
    quality = st.slider("Quality", 60, 100, 95) if fmt == "jpeg" else 95
    if st.button("Prepare download"):
        data, name = build_export(path, fmt, color_space, int(bit_depth), quality)
        st.download_button("Save file", data, file_name=name)
