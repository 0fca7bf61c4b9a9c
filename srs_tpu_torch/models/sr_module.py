"""SR engine, quality branch (port of ``srs_tpu/models/sr_module.py``).

Ported: ``scale_ladder`` (reference 124-174), the net cache ``_net`` and
``trained_scales``, and the ``quality`` branch of ``upscale_tiles``
(672-751). Other providers, the self-ensemble and conditioning are not
ported yet; back-projection (IBP) for untrained nets raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..config import ModelConfig
from ..utils.device import resolve_device
from .registry import build_model

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
    weights counts as trained."""

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

    def _name(self, model: Optional[str]) -> str:
        return model if model is not None else self.config.quality_model

    def _net(self, scale: int, model: Optional[str] = None) -> torch.nn.Module:
        key = (self._name(model), scale)
        if key not in self._nets:
            self._nets[key], _ = build_model(
                key[0], scale, self.weights.get(key),
                dtype=self.config.compute_dtype,
                params_dtype=self.config.params_dtype,
                device=self.device,
            )
        return self._nets[key]

    def _net_trained(self, scale: int, model: Optional[str] = None) -> bool:
        return (self._name(model), scale) in self.weights

    def trained_scales(self, model: Optional[str] = None) -> set:
        """Integer scales {2,3,4} whose serving net has weights."""
        return {s for s in (2, 3, 4) if self._net_trained(s, model)}

    def upscale_tiles(
        self,
        tiles: torch.Tensor,
        scale: int,
        steps: int = 0,
        model: Optional[str] = None,
    ) -> torch.Tensor:
        """The quality net (``model`` or the configured one) over a
        [N,B,B,C] float32 [0,255] batch -> [N,B*s,B*s,C], clipped to
        [0,255]. ``steps`` back-projection steps apply to untrained nets
        only, as in the reference; they are not ported yet."""
        if steps > 0 and not self._net_trained(scale, model):
            raise NotImplementedError(
                "back_project (IBP) for untrained nets is queued (ROADMAP Queue 1): "
                "hand the net's weights in, or set ibp_steps=0"
            )
        return self._net(scale, model)(tiles).clamp_(0, 255)
