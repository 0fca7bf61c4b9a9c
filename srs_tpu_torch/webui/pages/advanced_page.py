"""Advanced page (port of ``srs_tpu/webui/pages/advanced_page.py``): the
scheduler's task queue, the task history with a status filter, and the
system settings, with a button that saves the scheduler's checkpoint."""

from __future__ import annotations

from ..session import get_state

__all__ = ["render"]


def render() -> None:
    import pandas as pd
    import streamlit as st

    st.header("5. Advanced")

    st.subheader("Batch queue")
    pipe = get_state("_pipeline")
    rows = []
    if pipe is not None and pipe.scheduler is not None:
        rows = [{"task": t.task_id[:8], "status": t.status.value,
                 "priority": round(t.priority, 1), "vip": t.vip_level.name,
                 "retries": t.retry_count, "scale": t.scale_factor}
                for t in list(pipe.scheduler._tasks.values())[:200]]
    if rows:
        st.dataframe(pd.DataFrame(rows))
    else:
        st.info("No tasks yet.")

    st.subheader("Task history")
    history = get_state("task_history") or []
    level = st.selectbox("Filter status", ["all", "success", "failed", "degraded"])
    shown = [h for h in history if level == "all" or h.get("status") == level]
    if shown:
        st.dataframe(pd.DataFrame(shown))
    else:
        st.caption("Empty.")

    st.subheader("System settings")
    st.checkbox("Enable QA stage", value=True, key="adv_enable_qa")
    st.checkbox("Content-aware tiling", value=False, key="adv_content_aware")
    st.number_input("Max concurrent device batches", 1, 128, 30, key="adv_max_concurrent")
    if st.button("Save scheduler checkpoint") and pipe is not None and pipe.scheduler:
        path = pipe.scheduler.save_checkpoint()
        st.success(f"Checkpoint saved: {path}")
