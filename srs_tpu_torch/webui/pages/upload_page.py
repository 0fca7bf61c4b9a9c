"""Upload page (port of ``srs_tpu/webui/pages/upload_page.py``): the
upload, the image's metadata and the crop presets of the region of
interest."""

from __future__ import annotations

import io

import numpy as np

from ..session import set_state

__all__ = ["ALLOWED_FORMATS", "crop_presets", "extract_image_info", "render"]

ALLOWED_FORMATS = ["jpg", "jpeg", "png", "tiff", "tif", "raw", "cr2", "nef", "arw"]

_MODES = {1: "L", 3: "RGB", 4: "RGBA"}


def crop_presets(width: int, height: int) -> dict:
    """center/full/1:1 crop rectangles (x, y, w, h)."""
    side = min(width, height)
    return {
        "full": (0, 0, width, height),
        "center": (width // 4, height // 4, width // 2, height // 2),
        "1:1": ((width - side) // 2, (height - side) // 2, side, side),
    }


def extract_image_info(image, file_name: str = "", file_bytes: int = 0) -> dict:
    """The reference's metadata of a PIL image, or the same keys of an
    (H, W) / (H, W, C) array (mode from the channels, no format, no
    EXIF): the card's machine has no PIL."""
    if isinstance(image, np.ndarray):
        h, w = image.shape[:2]
        mode, fmt = _MODES.get(1 if image.ndim == 2 else image.shape[2]), None
    else:
        w, h, mode, fmt = image.width, image.height, image.mode, image.format
    info = {
        "name": file_name,
        "size_bytes": file_bytes,
        "width": w,
        "height": h,
        "megapixels": round(w * h / 1e6, 2),
        "mode": mode,
        "format": fmt,
    }
    if not isinstance(image, np.ndarray):
        exif = image.getexif()
        if exif:
            info["exif"] = {str(k): str(v)[:80] for k, v in list(exif.items())[:20]}
    return info


def render() -> None:
    import streamlit as st
    from PIL import Image

    st.header("1. Upload Image")
    up = st.file_uploader("Input image", type=ALLOWED_FORMATS)
    if up is None:
        st.info("Upload a 720p-4K image to super-resolve to print grade.")
        return
    img = Image.open(io.BytesIO(up.getvalue())).convert("RGB")
    info = extract_image_info(img, up.name, len(up.getvalue()))
    set_state("uploaded_image", img)
    set_state("image_info", info)

    c1, c2 = st.columns([2, 1])
    with c1:
        st.image(img, caption=f"{info['width']}x{info['height']} ({info['megapixels']} MP)")
    with c2:
        st.json({k: v for k, v in info.items() if k != "exif"})

    st.subheader("Region of interest")
    presets = crop_presets(info["width"], info["height"])
    choice = st.selectbox("Crop preset", list(presets.keys()), index=0)
    x, y, w, h = presets[choice]
    x = st.slider("x", 0, info["width"] - 1, x)
    y = st.slider("y", 0, info["height"] - 1, y)
    w = st.slider("w", 1, info["width"] - x, w)
    h = st.slider("h", 1, info["height"] - y, h)
    set_state("crop_region", (x, y, w, h))
    if (x, y, w, h) != presets["full"]:
        st.image(img.crop((x, y, x + w, y + h)), caption="ROI preview")
