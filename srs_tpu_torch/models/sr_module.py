"""SR engine, quality branch (port of ``srs_tpu/models/sr_module.py``).

Ported: ``scale_ladder`` (reference 124-174), per-scale selection
(``select_quality_model``, ``_resolve``, ``resolve_ladder_models``,
207-245), ``route_for`` (315-327), the net cache ``_net`` and
``trained_scales`` (653-665), and the ``quality``, ``bicubic`` and
``shrink`` branches of ``upscale_tiles`` (672-751), with back-projection
(IBP) for untrained nets. Other providers, the self-ensemble and
conditioning are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.resize import resize_bicubic_up
from ..utils.device import resolve_device
from .nets import back_project
from .registry import build_model
from .routing import route_quality_model
from .selection import panel_best_model

__all__ = ["scale_ladder", "SuperResolutionModule"]


def scale_ladder(
    total: float,
    max_undershoot: float = 0.88,
    trained: Optional[set] = None,
) -> list:
    """Ladder of {2,3,4}x net passes landing nearest ``total``.

    Undershoot down to ``max_undershoot * total`` (finished by the final
    bicubic) costs a quadratic penalty, as overshoot does; each untrained
    step multiplies the score by 4; ties prefer fewer steps. [] when
    ``total <= 1``.
    """
    if total <= 1.0:
        return []
    best: Tuple[float, list] = (float("inf"), [4, 4, 4, 4])

    def score(prod: float, steps: list) -> float:
        if prod >= total:
            s = (prod / total) ** 2
        elif prod < total * max_undershoot:
            return float("inf")
        else:
            s = (total / prod) ** 2 * 1.05
        if trained is not None:
            for st in steps:
                if st not in trained:
                    s *= 4.0
        return s * (1.02 ** len(steps))

    def rec(prod: float, steps: list):
        nonlocal best
        s_here = score(prod, steps)
        if steps and s_here < best[0]:
            best = (s_here, list(steps))
        if prod >= total * 4:
            return
        for s in (2, 3, 4):
            steps.append(s)
            rec(prod * s, steps)
            steps.pop()

    rec(1.0, [])
    return best[1]


class SuperResolutionModule:
    """Quality-tier SR engine over NHWC tile batches on ``device`` (the
    card by default; raises without one).

    ``weights`` maps ``(net name, scale)`` to a state dict; a net with
    weights counts as trained. With ``config.per_scale_selection`` each
    ladder step serves the panel-best trained net at its scale
    (``models/selection.py``); with ``config.auto_route`` damaged inputs
    serve the robust net when it is trained (``models/routing.py``)."""

    def __init__(
        self,
        config: Optional[ModelConfig] = None,
        weights: Optional[Mapping[Tuple[str, int], Mapping[str, torch.Tensor]]] = None,
        device: str | torch.device = "cuda",
    ):
        self.config = config or ModelConfig()
        self.weights = dict(weights or {})
        self.device = resolve_device(device)
        self._nets: Dict[Tuple[str, int], torch.nn.Module] = {}
        # bfloat16 nets of the SR-gain probe, built from the same weights
        self.probe_nets: Dict = {}

    def is_trained(self, name: str, scale: int) -> bool:
        return (name, scale) in self.weights

    def select_quality_model(self, scale: int) -> str:
        """The quality net for one ladder step (reference sr_module.py:207-223)."""
        name = self.config.quality_model
        if not self.config.per_scale_selection:
            return name
        return panel_best_model(scale, name, self.is_trained, self.config.checkpoint_dir)

    def _resolve(self, scale: int, model: Optional[str]) -> str:
        """Explicit ``model`` (the router's pick) > per-scale selection >
        the configured net."""
        return model if model is not None else self.select_quality_model(scale)

    def resolve_ladder_models(self, ladder, model: Optional[str] = None) -> List[str]:
        """The net each ladder step serves (reference sr_module.py:234-245;
        the port's providers that serve a net all serve the quality net)."""
        return [self._resolve(int(s), model) for s in ladder]

    def route_for(self, image) -> Tuple[Optional[str], Any]:
        """(robust net or None, degradation estimate) for this input; (None,
        None) with routing off (reference sr_module.py:315-327)."""
        if not self.config.auto_route:
            return None, None
        name, est = route_quality_model(
            image, self.config.quality_model, self.config.robust_model,
            self.is_trained, device=self.device,
        )
        return (name if name != self.config.quality_model else None), est

    def _net(self, scale: int, model: Optional[str] = None) -> torch.nn.Module:
        key = (self._resolve(scale, model), scale)
        if key not in self._nets:
            self._nets[key], _ = build_model(
                key[0], scale, self.weights.get(key),
                dtype=self.config.compute_dtype,
                params_dtype=self.config.params_dtype,
                device=self.device,
            )
        return self._nets[key]

    def _net_trained(self, scale: int, model: Optional[str] = None) -> bool:
        return self.is_trained(self._resolve(scale, model), scale)

    def trained_scales(self, model: Optional[str] = None) -> set:
        """Integer scales {2,3,4} whose serving net has weights (reference
        sr_module.py:653-665)."""
        return {s for s in (2, 3, 4) if self._net_trained(s, model)}

    def upscale_tiles(
        self,
        tiles: torch.Tensor,
        scale: int,
        provider: str = "quality",
        steps: int = 0,
        model: Optional[str] = None,
        alpha: float = 1.0,
    ) -> torch.Tensor:
        """[N,B,B,C] float32 [0,255] batch -> [N,B*s,B*s,C].

        ``quality``: the net (clipped to [0,255]); ``steps`` back-projection
        steps apply to untrained nets only, as in the reference.
        ``bicubic``: the bicubic upscale, unclipped.
        ``shrink``: ``clip(bic + alpha * (net - bic))`` with the probe's
        per-job ``alpha`` (reference sr_module.py:686-702)."""
        if provider == "bicubic":
            return resize_bicubic_up(tiles, scale)
        if provider == "shrink":
            net_out = self.upscale_tiles(tiles, scale, steps=steps, model=model)
            bic = resize_bicubic_up(tiles, scale)
            return (bic + float(np.float32(alpha)) * (net_out - bic)).clamp_(0, 255)
        if provider != "quality":
            raise NotImplementedError(f"provider {provider!r} is not ported yet")
        out = self._net(scale, model)(tiles)
        if steps > 0 and not self._net_trained(scale, model):
            out = back_project(out, tiles, scale, steps=steps)
        return out.clamp_(0, 255)
