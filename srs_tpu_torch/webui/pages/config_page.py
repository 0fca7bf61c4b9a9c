"""Config page (port of ``srs_tpu/webui/pages/config_page.py``): the
resolution presets, the tile and overlap sliders, the provider, net and
blend selectors, the advanced knobs, the live estimate, and the start
button, held back while the tile count exceeds the maximum."""

from __future__ import annotations

from ...config import RESOLUTION_PRESETS
from ...models.prompts import PromptTemplateManager
from ..estimator import calculate_estimates
from ..session import get_state, set_state

__all__ = ["PRESETS", "PROVIDERS", "QUALITY_NETS", "BLENDS", "render"]

PRESETS = ["100MP", "150MP", "200MP", "custom"]
# The reference's order: the quality net (with the self-ensemble toggle
# for the best result), fusion, hybrid, fast, bicubic, and zssr.
PROVIDERS = ["quality", "fusion", "hybrid", "fast", "bicubic", "zssr"]
QUALITY_NETS = ["edsr_xl", "edsr_l", "edsr_l_robust", "edsr_m", "rcan", "espcn"]
BLENDS = ["laplacian", "multi_band", "weighted", "feather", "gradient_domain", "poisson"]


def _index(options, value, fallback: int = 0) -> int:
    return options.index(value) if value in options else fallback


def render() -> None:
    import streamlit as st

    st.header("2. Configure")
    info = get_state("image_info")
    if info is None:
        st.warning("Upload an image first.")
        return

    st.subheader("Target resolution")
    preset = st.radio("Preset", PRESETS, horizontal=True,
                      index=_index(PRESETS, get_state("target_resolution", "100MP")))
    if preset == "custom":
        cw = st.number_input("width", 1000, 30000, 12245)
        ch = st.number_input("height", 1000, 30000, 8163)
        set_state("target_resolution", f"{cw}x{ch}")
        target_pixels = cw * ch
    else:
        set_state("target_resolution", preset)
        tw, th = RESOLUTION_PRESETS[preset]
        target_pixels = tw * th
    set_state("target_pixels", target_pixels)

    st.subheader("Tiling")
    tile = st.slider("Tile size", 512, 4096, get_state("tile_size", 1024), step=128)
    overlap = st.slider("Overlap %", 10, 30, int(get_state("overlap_ratio", 0.2) * 100)) / 100.0
    max_tiles = st.slider("Max tiles", 4, 256, get_state("max_tiles", 64))
    set_state("tile_size", tile)
    set_state("overlap_ratio", overlap)
    set_state("max_tiles", max_tiles)

    st.subheader("Model")
    model = st.selectbox("Provider", PROVIDERS,
                         index=_index(PROVIDERS, get_state("model_version", "quality")))
    best = st.checkbox(
        "Best quality: self-ensemble (\"+\", 8 dihedral passes; "
        "about x2.9 the time of one pass on the card)",
        value=bool(get_state("self_ensemble", False)),
    )
    set_state("self_ensemble", best)
    qnet = st.selectbox(
        "Quality net (fallback; each ladder step serves the panel-best "
        "trained net at that scale)", QUALITY_NETS,
        index=_index(QUALITY_NETS, get_state("quality_model", "edsr_xl")),
    )
    fusion = st.selectbox("Fusion algorithm", BLENDS, index=0)
    cats = PromptTemplateManager.list_categories()
    category = st.selectbox("Industry template", cats,
                            index=_index(cats, get_state("prompt_category", "general"),
                                         cats.index("general")))
    set_state("model_version", model)
    set_state("quality_model", qnet)
    set_state("fusion_algorithm", fusion)
    set_state("prompt_category", category)

    with st.expander("Advanced"):
        set_state("guidance_scale", st.slider("Guidance", 1.0, 20.0,
                                              get_state("guidance_scale", 7.5)))
        set_state("num_steps", st.slider("Refinement steps", 0, 100, get_state("num_steps", 50)))
        set_state("seed", st.number_input("Seed (-1 = content hash)", -1, 2**31 - 1,
                                          get_state("seed", -1)))
        set_state("negative_prompt", st.text_input("Negative prompt",
                                                   get_state("negative_prompt", "")))

    est = calculate_estimates(info["width"], info["height"], target_pixels, tile, overlap,
                              self_ensemble=best)
    st.subheader("Estimate")
    c1, c2, c3 = st.columns(3)
    c1.metric("Scale", f"{est['scale_factor']:.1f}x")
    c2.metric("Tiles", f"{est['tiles_x']}x{est['tiles_y']} = {est['num_tiles']}")
    c3.metric("Est. time", f"{est['estimated_seconds']:.0f} s")

    if est["num_tiles"] > max_tiles:
        st.error(f"Tile count {est['num_tiles']} exceeds max {max_tiles}; raise max or "
                 "tile size.")
    elif st.button("Start processing", type="primary"):
        set_state("processing", True)
        set_state("cancelled", False)
        if hasattr(st, "switch_page"):
            st.switch_page("monitor")
