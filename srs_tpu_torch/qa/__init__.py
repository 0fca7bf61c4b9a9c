"""Quality assessment (port of ``srs_tpu/qa``).

The reference's exports (``srs_tpu/qa/__init__.py``) are bound on first
access (PEP 562).
"""

import importlib

_EXPORTS = {"QualityAssessmentModule": "module", "AssessmentLevel": "module"}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
