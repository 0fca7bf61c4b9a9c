"""Web UI session state (port of ``srs_tpu/webui/session.py``): the
reference's keys and defaults, init/get/set/reset and
``get_config_summary``, backed by Streamlit's ``session_state`` when
Streamlit imports, else by a plain dict (headless use and tests)."""

from __future__ import annotations

from typing import Any, Dict

try:
    import streamlit as st

    _HAS_ST = True
except ImportError:
    _HAS_ST = False

__all__ = ["DEFAULT_SESSION_STATE", "initialize_session_state", "get_state", "set_state",
           "reset_session_state", "get_config_summary"]

DEFAULT_SESSION_STATE: Dict[str, Any] = {
    # upload
    "uploaded_image": None,
    "image_info": None,
    "crop_region": None,
    # config
    "tile_size": 1024,
    "overlap_ratio": 0.20,
    "target_pixels": 100_000_000,
    "target_resolution": "100MP",
    "max_tiles": 64,
    "model_version": "quality",
    "fusion_algorithm": "laplacian",
    "guidance_scale": 7.5,
    "num_steps": 50,
    "seed": -1,
    "negative_prompt": "",
    "prompt_category": "general",
    # processing flags
    "processing": False,
    "paused": False,
    "cancelled": False,
    "progress": 0.0,
    "current_stage": "",
    "result_path": None,
    "qa_report": None,
    "task_history": [],
}

_fallback_state: Dict[str, Any] = {}


def _state() -> Dict[str, Any]:
    return st.session_state if _HAS_ST else _fallback_state


def initialize_session_state() -> None:
    s = _state()
    for k, v in DEFAULT_SESSION_STATE.items():
        if k not in s:
            s[k] = v


def get_state(key: str, default: Any = None) -> Any:
    return _state().get(key, DEFAULT_SESSION_STATE.get(key, default))


def set_state(key: str, value: Any) -> None:
    _state()[key] = value


def reset_session_state() -> None:
    s = _state()
    for k, v in DEFAULT_SESSION_STATE.items():
        s[k] = v


def get_config_summary() -> Dict[str, Any]:
    keys = ("tile_size", "overlap_ratio", "target_resolution", "model_version",
            "fusion_algorithm", "guidance_scale", "num_steps", "seed", "prompt_category")
    return {k: get_state(k) for k in keys}
