"""The web UI (port of ``srs_tpu/webui``): five Streamlit pages over the
port's pipeline on the card.

Every module imports without Streamlit and without PIL: Streamlit is
imported inside ``render``/``main`` and guarded in ``session.py``, PIL
only where a JPEG is written or a PIL image is handed in. The logic
behind the pages (the session state, the estimator, the crop presets,
``monitor_page``'s worker and ``result_page.build_export``) runs
headless. ``python -m srs_tpu_torch webui`` starts the app where
Streamlit is installed.
"""
