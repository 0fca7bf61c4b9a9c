"""Web UI theme (port of ``srs_tpu/webui/styles.py``): the CSS injected
through ``st.markdown`` where Streamlit is present."""

from __future__ import annotations

__all__ = ["CUSTOM_CSS", "apply_custom_css", "get_card_style", "get_button_style"]

CUSTOM_CSS = """
<style>
.stApp { background: linear-gradient(160deg, #0f1220 0%, #171a2e 60%, #1c2040 100%); }
section[data-testid="stSidebar"] { background: #12152a; }
h1, h2, h3 { color: #e8eaf6; }
.block-container { padding-top: 2rem; }
.srs-card {
  background: rgba(255,255,255,0.04); border: 1px solid rgba(255,255,255,0.08);
  border-radius: 12px; padding: 1rem 1.25rem; margin-bottom: 1rem;
}
.srs-metric { font-size: 1.6rem; font-weight: 600; color: #8ab4ff; }
.stButton > button {
  background: linear-gradient(90deg, #3b5bdb, #4dabf7); color: white;
  border: none; border-radius: 8px;
}
</style>
"""


def apply_custom_css() -> None:
    """Inject the CSS; nothing without Streamlit."""
    try:
        import streamlit as st
    except ImportError:
        return
    st.markdown(CUSTOM_CSS, unsafe_allow_html=True)


def get_card_style() -> str:
    return "srs-card"


def get_button_style() -> str:
    return "stButton"
