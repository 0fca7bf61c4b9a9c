"""The web UI's shell (port of ``srs_tpu/webui/app.py``): page settings,
the sidebar's navigation and status (agents online, queue depth, the
CUDA devices), the header and the page router.

Run with ``python -m srs_tpu_torch webui`` or ``streamlit run
srs_tpu_torch/webui/app.py``; both need Streamlit. The module imports
without it.
"""

from __future__ import annotations

__all__ = ["PAGES", "device_caption", "main"]

PAGES = ["Upload", "Configure", "Monitor", "Result", "Advanced"]


def device_caption() -> str:
    """The sidebar's device line: the CUDA devices torch sees."""
    import torch

    if not torch.cuda.is_available():
        return "Devices: 0 CUDA (jobs need a card)"
    return f"Devices: {torch.cuda.device_count()} ({torch.cuda.get_device_name(0)})"


def main() -> None:
    import streamlit as st

    # absolute: ``streamlit run`` executes this file as a script
    from srs_tpu_torch.webui.pages import (advanced_page, config_page, monitor_page,
                                           result_page, upload_page)
    from srs_tpu_torch.webui.session import get_state, initialize_session_state
    from srs_tpu_torch.webui.styles import apply_custom_css

    st.set_page_config(
        page_title="srs-tpu | Super-Resolution",
        page_icon="SR",
        layout="wide",
        initial_sidebar_state="expanded",
    )
    initialize_session_state()
    apply_custom_css()

    with st.sidebar:
        st.title("srs-tpu")
        st.caption("Print-grade super-resolution on an NVIDIA H100")
        page = st.radio("Navigate", PAGES)
        pipe = get_state("_pipeline")
        if pipe is not None and pipe.scheduler is not None:
            stats = pipe.scheduler.get_statistics()
            st.metric("Agents online", stats["agents"]["online"])
            st.metric("Queue depth", stats["queue"]["depth"])
        st.caption(device_caption())

    st.title("Ultra-Resolution Image Generation")
    st.caption("tile -> super-resolve -> blend -> assess, end to end on the card")

    router = {
        "Upload": upload_page.render,
        "Configure": config_page.render,
        "Monitor": monitor_page.render,
        "Result": result_page.render,
        "Advanced": advanced_page.render,
    }
    router[page]()


if __name__ == "__main__":
    main()
