"""Monitor page (port of ``srs_tpu/webui/pages/monitor_page.py``): the
job's stage and progress, the scheduler's statistics and the live log.

``start_worker`` drives the port's ``process()`` in a worker thread
(``_run_pipeline``), on the card unless the job's state names another
``device``; a failure is recorded in the state (``current_stage`` =
"failed: ..."), as in the reference. The log buffer listens on the
pipeline's logger, ``srs_tpu_torch.pipeline``, from INFO up. ``cancel``
is the Cancel button: ``pipe.cancel()`` stops the job at its next stage
boundary.

``_worker`` and ``_log_buffer`` are module state shared by every
session of the process, as in the reference.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from typing import Optional

import numpy as np

from ..session import get_config_summary, get_state, set_state

__all__ = ["start_worker", "cancel", "render"]

_PIPELINE_LOGGER = "srs_tpu_torch.pipeline"
_worker: Optional[threading.Thread] = None
_log_buffer: list = []


class _BufferHandler(logging.Handler):
    """Keeps the last 500 (time, level, message) records in ``_log_buffer``."""

    def emit(self, record):
        _log_buffer.append((time.strftime("%H:%M:%S"), record.levelname, record.getMessage()))
        del _log_buffer[:-500]


def _run_pipeline(image, cfg_state: dict) -> None:
    """One job on the session's settings: the reference's configuration
    (its tile capped at 1024, ``PipelineConfig``'s defaults otherwise),
    written to ``cfg_state["output_path"]`` (a TIFF in the temporary
    directory by default)."""
    from ...pipeline import PipelineConfig, SuperResolutionPipeline

    try:
        set_state("current_stage", "initializing")
        cfg = PipelineConfig(
            block_size=min(cfg_state["tile_size"], 1024),
            overlap_ratio=cfg_state["overlap_ratio"],
            target_resolution=cfg_state["target_resolution"],
            provider=cfg_state["model_version"],
            quality_model=cfg_state.get("quality_model", "edsr_xl"),
            blend_method=cfg_state["fusion_algorithm"],
            self_ensemble=bool(cfg_state.get("self_ensemble", False)),
            # the industry template steers the conditioned polish
            prompt_category=cfg_state.get("prompt_category"),
            device=cfg_state.get("device", "cuda"),
        )
        pipe = SuperResolutionPipeline(cfg)
        set_state("_pipeline", pipe)
        set_state("current_stage", "processing")
        out_path = cfg_state.get("output_path",
                                 os.path.join(tempfile.gettempdir(), "srs_webui_output.tiff"))
        result = pipe.process(np.asarray(image, np.float32), out_path)
        set_state("result_path", result.output_path)
        set_state("qa_report", result.quality_report)
        set_state("progress", 1.0)
        set_state("current_stage", "done" if result.success else f"failed: {result.error_message}")
    except Exception as e:  # noqa: BLE001 - the state records it, as in the reference
        set_state("current_stage", f"failed: {e}")
    finally:
        set_state("processing", False)


def start_worker(image, cfg_state: dict) -> None:
    """Run ``_run_pipeline`` in a daemon thread (``_worker``), with the log
    buffer on the pipeline's logger (one handler, added once)."""
    global _worker
    log = logging.getLogger(_PIPELINE_LOGGER)
    if not any(isinstance(h, _BufferHandler) for h in log.handlers):
        log.addHandler(_BufferHandler(logging.INFO))
    if not log.isEnabledFor(logging.INFO):
        log.setLevel(logging.INFO)
    _worker = threading.Thread(target=_run_pipeline, args=(image, cfg_state), daemon=True)
    _worker.start()


def cancel() -> None:
    """The Cancel button: the running job stops at its next stage boundary
    with a failed result that names the cancel."""
    set_state("cancelled", True)
    pipe = get_state("_pipeline")
    if pipe is not None:
        pipe.cancel()
        set_state("current_stage", "cancelling...")


def render() -> None:
    import streamlit as st

    st.header("3. Monitor")
    if not get_state("processing") and get_state("result_path") is None:
        st.info("Start a job from the Configure page.")
        return

    if get_state("processing") and (_worker is None or not _worker.is_alive()):
        img = get_state("uploaded_image")
        if img is not None:
            cfg = dict(get_config_summary())
            cfg["self_ensemble"] = get_state("self_ensemble")
            start_worker(img, cfg)

    st.subheader("Stage")
    st.write(get_state("current_stage") or "queued")
    st.progress(float(get_state("progress") or 0.0))

    pipe = get_state("_pipeline")
    if pipe is not None and pipe.scheduler is not None:
        stats = pipe.scheduler.get_statistics()
        st.subheader("Scheduler")
        c1, c2, c3, c4 = st.columns(4)
        c1.metric("Agents online", stats["agents"]["online"])
        c2.metric("Queue depth", stats["queue"]["depth"])
        c3.metric("Completed", stats["counters"]["completed"])
        c4.metric("Retried", stats["counters"]["retried"])

    st.subheader("Logs")
    for ts, level, msg in _log_buffer[-30:]:
        st.text(f"{ts} [{level}] {msg}")

    c1, c2 = st.columns(2)
    if c1.button("Cancel"):
        cancel()
    c2.button("Refresh")  # Streamlit reruns the page on any interaction
