"""Logging configuration (port of ``srs_tpu/utils/logging.py``): one setup
function for the ``srs_tpu_torch`` logger tree, to stdout and an optional
file."""

from __future__ import annotations

import logging
import sys
from typing import Optional

__all__ = ["setup_logging"]

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def setup_logging(
    level: int = logging.INFO,
    log_file: Optional[str] = "super_resolution.log",
    stream: bool = True,
) -> logging.Logger:
    """Configure the port's logger tree (its handlers replaced) and return
    its root logger, ``srs_tpu_torch``."""
    logger = logging.getLogger("srs_tpu_torch")
    logger.setLevel(level)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter(_FORMAT)
    if stream:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(fmt)
        logger.addHandler(h)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
