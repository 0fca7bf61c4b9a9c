"""The five pages of the web UI (port of ``srs_tpu/webui/pages``)."""

from . import advanced_page, config_page, monitor_page, result_page, upload_page

__all__ = ["advanced_page", "config_page", "monitor_page", "result_page", "upload_page"]
