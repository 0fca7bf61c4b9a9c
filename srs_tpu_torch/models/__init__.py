"""SR nets, their registry and the SR engine (port of ``srs_tpu.models``).

The reference's exports (``srs_tpu/models/__init__.py``) are bound on
first access (PEP 562), so importing the package loads none of its
modules.
"""

import importlib

_EXPORTS = {
    "EDSR": "nets",
    "ESPCN": "nets",
    "RCAN": "nets",
    "back_project": "nets",
    "depth_to_space": "nets",
    "PromptTemplateManager": "prompts",
    "MODEL_REGISTRY": "registry",
    "build_model": "registry",
    "SuperResolutionModule": "sr_module",
    "SuperResolutionResult": "sr_module",
    "UpscaleConfig": "sr_module",
    "UpscaleProvider": "sr_module",
    "VeImageXTemplate": "sr_module",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
