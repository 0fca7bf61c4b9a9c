"""SR engine (port of ``srs_tpu/models/sr_module.py``).

The batch path the pipeline runs, ``upscale_tiles`` (reference 672-751),
serves every provider:

- ``quality``: the quality net of the step (per-scale selection,
  ``select_quality_model`` 207-223), back-projection (IBP) for untrained
  nets;
- ``fast``: the fast net (``config.fast_model``), IBP likewise;
- ``hybrid``: the quality net, then the scale-1 polish (``espcn_polish``)
  when the net is untrained and the polish trained, then IBP;
- ``fusion``: the weighted sum of the FUSION.json members trained here
  (``_fusion_for`` 287-313; ``name+`` members as their self-ensemble),
  falling back to ``quality`` where fewer than two are trained; each
  member's pass is a span ``super_resolution/<member>@x<scale>`` of the
  current job's record (``utils/profiling.span``, with device seconds on
  a card), as is the one net's pass of every other provider (``<net>+``
  under the self-ensemble);
- ``bicubic`` and ``shrink`` (``bicubic + alpha * (net - bicubic)``);
- ``zssr``: the net ``zssr_prepare`` (reference 612-650) tuned on the
  input itself, at the scale it was tuned for, with no IBP and no
  self-ensemble; at another scale the quality net serves, as for
  ``quality``;

with the dihedral self-ensemble (``_dihedral_ensemble`` 101-121) when
``config.self_ensemble`` is on, and the prompt-conditioned polish
(``_conditioned`` 753-780) when a category is asked for and
``("cond_polish", 1)`` is trained (handed in, saved or stored).

The single-image API (reference 51-99, 329-609) serves arrays, tensors
and, where PIL is installed, PIL images: ``upscale_seedream``,
``upscale_veimagex``, ``hybrid_upscale`` with its ``processing_history``,
the ``upscale`` dispatcher, ``retry_with_backoff`` and
``_deterministic_seed``; ``seed_generator`` takes the place of the
reference's ``fold_seed`` (a ``torch.Generator`` seeded from the content
hash).

Weights are handed in, else read from ``config.checkpoint_dir``, where
the port's trainer saves them (``{name}_x{scale}.pt``,
``registry.load_checkpoint``), else from the store of trained weights
(``registry.PACKAGED_CHECKPOINT_DIR``), as the reference reads its
packaged checkpoints (registry.py:134); any of these counts as trained.
A net with none of them is served untrained, with IBP, and a warning
names it once per process.
"""

from __future__ import annotations

import hashlib
import io
import logging
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

try:
    from PIL import Image
except ImportError:
    Image = None

from ..config import ModelConfig
from ..ops.resize import resize_bicubic, resize_bicubic_up
from ..utils import profiling
from ..utils.device import resolve_device
from .conditioning import cond_vector
from .fusion import load_fusion
from .nets import back_project
from .prompts import PromptTemplateManager
from .registry import TrainedWeights, build_model
from .routing import route_quality_model
from .selection import panel_best_model

__all__ = [
    "UpscaleProvider",
    "VeImageXTemplate",
    "UpscaleConfig",
    "SuperResolutionResult",
    "scale_ladder",
    "SuperResolutionModule",
]

logger = logging.getLogger(__name__)

# (name, scale) of the untrained nets served so far, each warned of once
_WARNED_UNTRAINED: set = set()

# Providers whose nets are the quality tier's; ``fast`` and ``veimagex``
# serve the fast net (reference sr_module.py:735-741).
QUALITY_ROLE = ("quality", "seedream", "hybrid", "fusion", "shrink", "zssr")


class UpscaleProvider(Enum):
    """Providers of the single-image API (reference sr_module.py:51-60);
    ``seedream`` and ``veimagex`` are the quality and fast tiers."""

    SEEDREAM = "seedream"
    VEIMAGEX = "veimagex"
    HYBRID = "hybrid"
    QUALITY = "quality"
    FAST = "fast"
    BICUBIC = "bicubic"


class VeImageXTemplate(Enum):
    """Fast-tier templates (reference sr_module.py:63-68)."""

    AI_SUPER_RESOLUTION = "system_workflow_ai_super_resolution"  # 2x
    STANDARD_SR = "system_workflow_sr"  # 1.5-4x
    FAST_SR = "system_workflow_fast_sr"  # the scale-1 polish


@dataclass
class UpscaleConfig:
    """(reference sr_module.py:71-82)."""

    provider: UpscaleProvider = UpscaleProvider.SEEDREAM
    target_scale: float = 2.0
    strength: float = 0.5
    num_inference_steps: int = 30
    seed: Optional[int] = None
    quality: int = 95
    preserve_style: bool = True
    category: str = "general"


@dataclass
class SuperResolutionResult:
    """(reference sr_module.py:85-95). ``image`` is a PIL image for PIL
    input, else a float32 numpy array in [0, 255]."""

    image: Any
    original_size: Tuple[int, int]  # (width, height)
    upscaled_size: Tuple[int, int]
    scale_factor: float
    provider: str
    processing_time: float
    metadata: Dict[str, Any] = field(default_factory=dict)


def _dihedral_ensemble(net: Callable[[torch.Tensor], torch.Tensor],
                       tiles: torch.Tensor) -> torch.Tensor:
    """EDSR's "+" mode: the net averaged over the 8 dihedral transforms of a
    square tile batch [N, B, B, C], one pass at a time."""
    acc = None
    for k in range(4):
        for flip in (False, True):
            t = torch.rot90(tiles, k, dims=(1, 2))
            if flip:
                t = t.flip(2)
            o = net(t.contiguous())
            if flip:
                o = o.flip(2)
            o = torch.rot90(o, -k, dims=(1, 2))
            acc = o.clone() if acc is None else acc.add_(o)
    return acc.div_(8.0)


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
    """SR engine over NHWC batches on ``device`` (the card by default;
    raises without one).

    ``weights`` maps ``(net name, scale)`` to a state dict; a net with
    weights counts as trained (``("espcn_polish", 1)`` for the hybrid
    polish, ``("cond_polish", 1)`` for the conditioned polish). The
    state dicts the trainer saved in ``config.checkpoint_dir``, then the
    store's, join them (``registry.TrainedWeights``; handed-in weights
    win). With
    ``config.per_scale_selection`` each quality step serves the panel-best
    trained net at its scale (``models/selection.py``); with
    ``config.auto_route`` damaged inputs serve the robust net when it is
    trained (``models/routing.py``)."""

    MAX_RETRIES = 3
    RETRY_BASE_DELAY = 1.0
    RETRY_MAX_DELAY = 8.0

    def __init__(
        self,
        config: Optional[ModelConfig] = None,
        weights: Optional[Mapping[Tuple[str, int], Mapping[str, torch.Tensor]]] = None,
        device: str | torch.device = "cuda",
    ):
        self.config = config or ModelConfig()
        self.weights = TrainedWeights(weights, self.config.checkpoint_dir)
        self.device = resolve_device(device)
        self._nets: Dict[Tuple[str, int], torch.nn.Module] = {}
        # scale -> [(member, weight)] served by ``fusion``, or None
        self._fusion_cache: Dict[int, Optional[List[Tuple[str, float]]]] = {}
        # bfloat16 nets of the SR-gain probe, built from the same weights
        self.probe_nets: Dict = {}
        self._digests: Dict[Tuple[str, int], str] = {}
        # scale -> the net zssr_prepare tuned there (in the compute type), and its record
        self.zssr_nets: Dict[int, torch.nn.Module] = {}
        self.zssr_info: Dict[int, Dict[str, Any]] = {}

    # -- nets ---------------------------------------------------------------
    def is_trained(self, name: str, scale: int) -> bool:
        return (name, scale) in self.weights

    @staticmethod
    def role(provider: str) -> str:
        """The tier whose nets ``provider`` serves: "quality" or "fast"."""
        return "quality" if provider in QUALITY_ROLE else "fast"

    def select_quality_model(self, scale: int) -> str:
        """The quality net for one ladder step (reference sr_module.py:206-222)."""
        name = self.config.quality_model
        if not self.config.per_scale_selection:
            return name
        return panel_best_model(scale, name, self.is_trained, self.config.checkpoint_dir,
                                ensemble=self.config.self_ensemble)

    def _resolve(self, role: str, scale: int, model: Optional[str]) -> str:
        """Explicit ``model`` (the router's pick, a fusion member) >
        per-scale selection (quality) or the fast net (fast)."""
        if model is not None:
            return model
        if role == "quality":
            return self.select_quality_model(scale)
        return self.config.fast_model

    def resolve_ladder_models(self, ladder, provider: str = "quality",
                              model: Optional[str] = None) -> List[str]:
        """The net each ladder step serves (reference sr_module.py:234-245)."""
        return [self._resolve(self.role(provider), int(s), model) for s in ladder]

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

    def _key(self, role: str, scale: int, model: Optional[str]) -> Tuple[str, int]:
        if role == "polish":
            return "espcn_polish", 1
        if role == "cond_polish":
            return "cond_polish", 1
        return self._resolve(role, scale, model), scale

    def _net(self, role: str, scale: int, model: Optional[str] = None) -> torch.nn.Module:
        """The net of ``role`` ("quality", "fast", "polish" or
        "cond_polish") at ``scale``, built once from its weights."""
        key = self._key(role, scale, model)
        if key not in self._nets:
            if key not in self.weights and key not in _WARNED_UNTRAINED:
                _WARNED_UNTRAINED.add(key)
                logger.warning("%s_x%d: no trained weights handed in, saved or in the store; "
                               "serving the untrained net (bicubic, with IBP)", *key)
            self._nets[key], _ = build_model(
                key[0], key[1], self.weights.get(key),
                dtype=self.config.compute_dtype,
                params_dtype=self.config.params_dtype,
                device=self.device,
            )
        return self._nets[key]

    def weights_digest(self, name: str, scale: int) -> str:
        """md5 of the weights of ``(name, scale)`` (each entry's name,
        dtype and bytes, in key order), or "untrained"; computed once."""
        key = (name, scale)
        if key not in self._digests:
            state = self.weights.get(key)
            if state is None:
                self._digests[key] = "untrained"
            else:
                h = hashlib.md5()
                for k in sorted(state):
                    t = state[k].detach().reshape(-1).contiguous().cpu()
                    h.update(f"{k}:{t.dtype}:".encode())
                    h.update(t.view(torch.uint8).numpy().tobytes())
                self._digests[key] = h.hexdigest()
        return self._digests[key]

    def _net_trained(self, role: str, scale: int, model: Optional[str] = None) -> bool:
        return self.is_trained(*self._key(role, scale, model))

    def trained_scales(self, provider: str = "quality", model: Optional[str] = None) -> set:
        """Integer scales {2,3,4} whose serving net for ``provider`` has
        weights (reference sr_module.py:653-670)."""
        role = self.role(provider)
        return {s for s in (2, 3, 4) if self._net_trained(role, s, model)}

    def _fusion_for(self, scale: int) -> Optional[List[Tuple[str, float]]]:
        """[(member, weight)] that ``fusion`` serves at ``scale``, or None
        (reference sr_module.py:287-313). Members without weights are
        dropped (an untrained net is bicubic, which would double-count the
        bicubic member) and the rest renormalised; fusion needs two trained
        members and |sum of kept weights| > 0.25."""
        if scale in self._fusion_cache:
            return self._fusion_cache[scale]
        resolved = None
        loaded = load_fusion(scale, self.config.checkpoint_dir)
        if loaded is not None:
            kept = [(m, w) for m, w in zip(*loaded)
                    if m == "bicubic" or self.is_trained(m.rstrip("+"), scale)]
            total = sum(w for _, w in kept)
            if sum(m != "bicubic" for m, _ in kept) >= 2 and abs(total) > 0.25:
                resolved = [(m, w / total) for m, w in kept]
        self._fusion_cache[scale] = resolved
        return resolved

    def step_members(self, scale: int, provider: str,
                     model: Optional[str] = None) -> List[Tuple[str, int]]:
        """The nets ``upscale_tiles`` runs for ``provider`` at ``scale``, each
        with its passes (8 for a dihedral "+" pass): the fusion members
        (bicubic left out), or the tier's net and, on the hybrid path, the
        polish (``espcn_polish``). The conditioned polish is not listed."""
        if provider == "bicubic":
            return []
        if provider == "zssr" and scale in self.zssr_nets:
            return [(self.zssr_info[scale]["base"], 1)]
        ens = 8 if self.config.self_ensemble else 1
        fused = self._fusion_for(scale) if provider == "fusion" and model is None else None
        if fused is not None:
            return [(m.rstrip("+"), 8 if m.endswith("+") else ens)
                    for m, _ in fused if m != "bicubic"]
        role = self.role(provider)
        members = [(self._resolve(role, scale, model), ens)]
        if (provider == "hybrid" and not self._net_trained(role, scale, model)
                and self._net_trained("polish", 1)):
            members.append(("espcn_polish", 1))
        return members

    def conditions(self, category: Optional[str]) -> bool:
        """Whether ``category`` runs the conditioned polish: a category asked
        for and ``("cond_polish", 1)`` trained."""
        return category is not None and self.is_trained("cond_polish", 1)

    def build_nets(self, ladder, provider: str, model: Optional[str] = None,
                   category: Optional[str] = None) -> None:
        """Build every net ``upscale_tiles`` will serve on ``ladder``."""
        for s in ladder:
            if provider == "zssr" and int(s) in self.zssr_nets:
                continue  # the tuned net is built
            for name, _passes in self.step_members(int(s), provider, model):
                role = "polish" if name == "espcn_polish" else self.role(provider)
                self._net(role, int(s), name)
        if self.conditions(category):
            self._net("cond_polish", 1)

    # -- the batch path -----------------------------------------------------
    def _pass(self, net, tiles: torch.Tensor, ensemble: bool) -> torch.Tensor:
        if ensemble and tiles.shape[1] == tiles.shape[2]:
            return _dihedral_ensemble(net, tiles)
        return net(tiles)

    def upscale_tiles(
        self,
        tiles: torch.Tensor,
        scale: int,
        provider: str = "quality",
        steps: int = 0,
        model: Optional[str] = None,
        category: Optional[str] = None,
        alpha: float = 1.0,
    ) -> torch.Tensor:
        """[N,B,B,C] float32 [0,255] batch -> [N,B*s,B*s,C], clipped to
        [0, 255] except for ``bicubic``.

        ``steps`` back-projection steps apply to untrained nets only, as in
        the reference. ``model`` pins the net (the router's pick; with
        ``fusion`` it serves that net alone). ``category`` applies the
        conditioned polish after the step. ``alpha`` is the ``shrink``
        provider's per-job shrinkage."""
        if provider == "bicubic":
            return self._conditioned(resize_bicubic_up(tiles, scale), category)
        if provider == "shrink":
            net_out = self.upscale_tiles(tiles, scale, steps=steps, model=model)
            bic = resize_bicubic_up(tiles, scale)
            out = (bic + float(np.float32(alpha)) * (net_out - bic)).clamp_(0, 255)
            return self._conditioned(out, category)
        if provider == "zssr" and scale in self.zssr_nets:
            # trained on the input itself: no IBP, no ensemble
            return self._conditioned(self.zssr_nets[scale](tiles).clamp_(0, 255), category)
        ensemble = self.config.self_ensemble
        if provider == "fusion" and model is None:
            fused = self._fusion_for(scale)
            if fused is not None:
                out = None
                for name, w in fused:
                    # one span per member and step, its weighted sum included
                    with profiling.span(f"super_resolution/{name}@x{scale}", tiles.device):
                        if name == "bicubic":
                            y = resize_bicubic_up(tiles, scale)
                        else:
                            net = self._net("quality", scale, model=name.rstrip("+"))
                            y = self._pass(net, tiles, ensemble or name.endswith("+"))
                        y = y * w
                        out = y if out is None else out.add_(y)
                return self._conditioned(out.clamp_(0, 255), category)
            provider = "quality"  # fewer than two trained members at this scale
        role = self.role(provider)
        name = self._resolve(role, scale, model)
        plus = "+" if ensemble and tiles.shape[1] == tiles.shape[2] else ""
        # the pass as one span, named as fusion names its members
        with profiling.span(f"super_resolution/{name}{plus}@x{scale}", tiles.device):
            out = self._pass(self._net(role, scale, model), tiles, ensemble)
        trained = self._net_trained(role, scale, model)
        if provider == "hybrid" and not trained and self._net_trained("polish", 1):
            # the polish cleans up untrained (bicubic-tier) outputs; after a
            # trained net it costs PSNR (reference sr_module.py:543-561)
            out = self._net("polish", 1)(out)
        if steps > 0 and not trained:
            out = back_project(out, tiles, scale, steps=steps)
        return self._conditioned(out.clamp_(0, 255), category)

    # -- zero-shot SR --------------------------------------------------------
    def zssr_base(self, scale: int) -> Tuple[str, float]:
        """(net zssr tunes, its learning rate) at ``scale``: the quality net
        when it is trained there, at 1e-4 (its corpus prior, tuned
        gently), else the fast net, at 1e-4 if trained and 5e-4 if not
        (the from-scratch rate) (reference sr_module.py:634-640)."""
        base = (self.config.quality_model if self.is_trained(self.config.quality_model, scale)
                else self.config.fast_model)
        return base, (1e-4 if self.is_trained(base, scale) else 5e-4)

    def zssr_prepare(
        self,
        image,
        scale: int = 2,
        steps: int = 150,
        patch: int = 48,
        batch: int = 8,
        lr: Optional[float] = None,
    ) -> None:
        """Tune a copy of the base net (:meth:`zssr_base`) on ``image`` (an
        (H, W, C) array or tensor in [0, 255]) for ``steps`` steps
        (``models/train.zssr_finetune``: its own area-degraded patches,
        seed 0), then keep it for ``provider="zssr"`` at ``scale`` until
        the next call at that scale. Float32 master weights train, the
        convolutions run in ``compute_dtype``; the tuned net serves in the
        compute type like any other. The base's weights are unchanged.
        Trains with gradients on even when called inside
        ``torch.inference_mode`` (``process()`` is). Its base, learning
        rate, steps, seconds and first and last loss go to
        ``zssr_info[scale]``."""
        from .train import zssr_finetune

        t0 = time.time()
        base, default_lr = self.zssr_base(scale)
        lr = default_lr if lr is None else lr
        losses: Dict[int, torch.Tensor] = {}

        def on_step(step: int, metrics: Dict[str, torch.Tensor]) -> None:
            if step in (0, steps - 1):
                losses[step] = metrics["loss"]

        with torch.inference_mode(False), torch.enable_grad():
            img = self._to_batch(image)[0][0].clone()
            net, _ = build_model(base, scale, self.weights.get((base, scale)),
                                 dtype=self.config.compute_dtype,
                                 params_dtype=self.config.params_dtype, device=self.device,
                                 master_weights=True)
            tuned = zssr_finetune(net, img, scale=scale, steps=steps, patch=patch, batch=batch,
                                  lr=lr, on_step=on_step)
            serving, _ = build_model(base, scale, tuned.state_dict(),
                                     dtype=self.config.compute_dtype,
                                     params_dtype=self.config.params_dtype, device=self.device)
        self.zssr_nets[scale] = serving
        self.zssr_info[scale] = {
            "base": base, "base_trained": self.is_trained(base, scale), "lr": lr,
            "steps": steps, "patch": patch, "batch": batch,
            "first_loss": float(losses[0]) if 0 in losses else None,
            "last_loss": float(losses[steps - 1]) if steps - 1 in losses else None,
            "seconds": time.time() - t0,
        }

    def _conditioned(self, out: torch.Tensor, category: Optional[str]) -> torch.Tensor:
        """The prompt-conditioned polish of ``out`` for ``category``,
        clipped to [0, 255]; ``out`` itself when no category is asked for
        or the polish is untrained."""
        if not self.conditions(category):
            return out
        net = self._net("cond_polish", 1)
        return net(out, cond_vector(category, out.device)).clamp_(0, 255)

    # -- the single-image API -------------------------------------------------
    def _to_batch(self, image) -> Tuple[torch.Tensor, bool, bool]:
        """([N,H,W,C] float32 [0,255] on the device, was_pil, had_batch)."""
        was_pil = Image is not None and isinstance(image, Image.Image)
        if was_pil:
            image = np.asarray(image.convert("RGB"), np.float32)
        x = torch.as_tensor(np.asarray(image, np.float32) if not isinstance(image, torch.Tensor)
                            else image).to(self.device, torch.float32)
        had_batch = x.dim() == 4
        return (x if had_batch else x[None]), was_pil, had_batch

    @staticmethod
    def _from_batch(x: torch.Tensor, was_pil: bool, had_batch: bool):
        arr = np.clip(x.cpu().numpy(), 0, 255)
        if not had_batch:
            arr = arr[0]
        if was_pil:
            return Image.fromarray(arr.astype(np.uint8))
        return arr.astype(np.float32)

    def _run_net(self, x: torch.Tensor, role: str, scale: float) -> Tuple[torch.Tensor, bool]:
        """The ladder of net passes for ``scale`` (preferring trained
        steps), then bicubic to the exact size. Returns (out, whether every
        step served trained weights): IBP applies only when not
        (reference sr_module.py:352-379)."""
        target_h = int(round(x.shape[1] * scale))
        target_w = int(round(x.shape[2] * scale))
        trained = {s for s in (2, 3, 4) if self._net_trained(role, s)}
        steps = scale_ladder(scale, trained=trained)
        cur = x
        for s in steps:
            cur = self._net(role, s)(cur)
        if cur.shape[1] != target_h or cur.shape[2] != target_w:
            cur = resize_bicubic(cur, target_h, target_w)
        return cur, bool(steps) and all(s in trained for s in steps)

    def _deterministic_seed(self, image, block_id: str = "") -> int:
        """Content-hash seed (reference sr_module.py:382-398): md5 of a
        64x64 thumbnail (PIL images: its PNG; arrays: the bicubic resize
        cast to uint8) and ``block_id``."""
        if Image is not None and isinstance(image, Image.Image):
            buf = io.BytesIO()
            thumb = image.copy()
            thumb.thumbnail((64, 64))
            thumb.save(buf, format="PNG")
            img_hash = hashlib.md5(buf.getvalue()).hexdigest()
        else:
            arr = torch.as_tensor(np.asarray(image, np.float32)
                                  if not isinstance(image, torch.Tensor) else image)
            if arr.dim() < 3:
                arr = arr.reshape((1,) * (3 - arr.dim()) + tuple(arr.shape))
            small = resize_bicubic(arr.float().cpu(), 64, 64).numpy().astype(np.uint8)
            img_hash = hashlib.md5(small.tobytes()).hexdigest()
        seed_hash = hashlib.md5(f"{block_id}:{img_hash}".encode()).hexdigest()
        return int(seed_hash[:8], 16) % (2**31)

    def seed_generator(self, image, block_id: str = "") -> torch.Generator:
        """A ``torch.Generator`` on the module's device seeded from the
        content hash: the same input and ``block_id`` give the same draws."""
        return torch.Generator(self.device).manual_seed(self._deterministic_seed(image, block_id))

    def retry_with_backoff(self, func: Callable, *args, **kwargs):
        """``func`` retried up to ``MAX_RETRIES`` times, sleeping 2^attempt
        seconds (capped) after each failure; the last failure is raised
        (reference sr_module.py:406-415)."""
        last_exc: Optional[Exception] = None
        for attempt in range(self.MAX_RETRIES):
            try:
                return func(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - parity: retry any failure
                last_exc = e
                time.sleep(min(self.RETRY_BASE_DELAY * (2**attempt), self.RETRY_MAX_DELAY))
        raise last_exc  # type: ignore[misc]

    def _result(self, out: torch.Tensor, x: torch.Tensor, was_pil: bool, had_batch: bool,
                provider: str, t0: float, metadata: Dict[str, Any]) -> SuperResolutionResult:
        return SuperResolutionResult(
            image=self._from_batch(out, was_pil, had_batch),
            original_size=(int(x.shape[2]), int(x.shape[1])),
            upscaled_size=(int(out.shape[2]), int(out.shape[1])),
            scale_factor=float(out.shape[1] / x.shape[1]),
            provider=provider,
            processing_time=time.time() - t0,
            metadata=metadata,
        )

    @torch.inference_mode()
    def upscale_seedream(
        self,
        image,
        prompt: str = "",
        strength: float = 0.5,
        target_scale: float = 2.0,
        seed: Optional[int] = None,
        num_inference_steps: int = 30,
        block_id: str = "",
        category: Optional[str] = None,
    ) -> SuperResolutionResult:
        """Quality tier (reference sr_module.py:418-467): the quality
        ladder, ``num_inference_steps`` IBP steps of size ``strength`` for
        untrained ladders, then the conditioned polish for ``category``."""
        t0 = time.time()
        x, was_pil, had_batch = self._to_batch(image)
        if seed is None:
            seed = self._deterministic_seed(image, block_id)
        out, ladder_trained = self._run_net(x, "quality", target_scale)
        eff_scale = out.shape[1] / x.shape[1]
        if ladder_trained:
            num_inference_steps = 0
        if num_inference_steps > 0 and float(eff_scale).is_integer() and eff_scale > 1:
            out = back_project(out, x, int(eff_scale), steps=min(num_inference_steps, 50),
                               strength=float(np.clip(strength, 0.05, 1.0)))
        out = out.clamp(0, 255)
        conditioned = self._conditioned(out, category)
        return self._result(conditioned, x, was_pil, had_batch, UpscaleProvider.SEEDREAM.value,
                            t0, {"seed": seed, "prompt": prompt, "steps": num_inference_steps,
                                 "strength": strength, "model": self.config.quality_model,
                                 "conditioned": conditioned is not out, "category": category})

    @torch.inference_mode()
    def upscale_veimagex(
        self,
        image,
        template: VeImageXTemplate = VeImageXTemplate.AI_SUPER_RESOLUTION,
        scale_factor: float = 2.0,
    ) -> SuperResolutionResult:
        """Fast tier (reference sr_module.py:469-491); ``FAST_SR`` at 1.0x is
        the polish pass."""
        t0 = time.time()
        x, was_pil, had_batch = self._to_batch(image)
        if template == VeImageXTemplate.FAST_SR and abs(scale_factor - 1.0) < 1e-6:
            out = self._net("polish", 1)(x)
        else:
            out, _ = self._run_net(x, "fast", scale_factor)
        return self._result(out.clamp(0, 255), x, was_pil, had_batch,
                            UpscaleProvider.VEIMAGEX.value, t0,
                            {"template": template.value, "model": self.config.fast_model})

    def hybrid_upscale(
        self,
        image,
        target_scale: float = 4.0,
        category: str = "general",
        block_id: str = "",
    ) -> SuperResolutionResult:
        """Three stages (reference sr_module.py:493-573): a fast 2x
        prefilter, the quality tier (the fast tier if it fails), then the
        1.0x polish when it is trained and the main stage was not a trained
        quality net; each stage in ``processing_history``."""
        t0 = time.time()
        history: List[Dict[str, Any]] = []
        current = image
        remaining = target_scale
        if target_scale >= 2.0:
            try:
                r1 = self.retry_with_backoff(self.upscale_veimagex, current,
                                             VeImageXTemplate.AI_SUPER_RESOLUTION, 2.0)
                current = r1.image
                remaining = target_scale / r1.scale_factor
                history.append({"stage": "fast_prefilter", "scale": r1.scale_factor,
                                "time": r1.processing_time})
            except Exception as e:  # noqa: BLE001 - parity: the prefilter is optional
                history.append({"stage": "fast_prefilter", "skipped": str(e)})

        prompt = PromptTemplateManager.build_prompt(category)
        from_trained_quality = False
        if remaining > 1.0 + 1e-6:
            try:
                r2 = self.retry_with_backoff(self.upscale_seedream, current, prompt, 0.5,
                                             remaining, None, 30, block_id, category=category)
                current = r2.image
                history.append({"stage": "quality_main", "scale": r2.scale_factor,
                                "time": r2.processing_time})
                from_trained_quality = bool(self.trained_scales("quality"))
            except Exception as e:  # noqa: BLE001 - parity: fall back to the fast tier
                r2 = self.upscale_veimagex(current, VeImageXTemplate.STANDARD_SR, remaining)
                current = r2.image
                history.append({"stage": "quality_fallback_fast", "scale": r2.scale_factor,
                                "time": r2.processing_time, "reason": str(e)})

        if not self._net_trained("polish", 1):
            history.append({"stage": "fast_polish", "skipped": "untrained"})
        elif from_trained_quality:
            history.append({"stage": "fast_polish", "skipped": "no_gain_after_trained_quality"})
        else:
            r3 = self.upscale_veimagex(current, VeImageXTemplate.FAST_SR, 1.0)
            current = r3.image
            history.append({"stage": "fast_polish", "scale": 1.0, "time": r3.processing_time})

        x0 = self._to_batch(image)[0]
        xn = self._to_batch(current)[0]
        return SuperResolutionResult(
            image=current,
            original_size=(int(x0.shape[2]), int(x0.shape[1])),
            upscaled_size=(int(xn.shape[2]), int(xn.shape[1])),
            scale_factor=float(xn.shape[1] / x0.shape[1]),
            provider=UpscaleProvider.HYBRID.value,
            processing_time=time.time() - t0,
            metadata={"processing_history": history, "category": category},
        )

    @torch.inference_mode()
    def _bicubic(self, image, s: float) -> SuperResolutionResult:
        t0 = time.time()
        x, was_pil, had_batch = self._to_batch(image)
        if float(s).is_integer():
            out = resize_bicubic_up(x, int(s))
        else:
            out = resize_bicubic(x, int(round(x.shape[1] * s)), int(round(x.shape[2] * s)))
        return self._result(out.clamp(0, 255), x, was_pil, had_batch, "bicubic", t0, {})

    def upscale(self, image, config: Optional[UpscaleConfig] = None) -> SuperResolutionResult:
        """Dispatch on ``config.provider`` (reference sr_module.py:576-609)."""
        cfg = config or UpscaleConfig()
        provider = cfg.provider
        if provider in (UpscaleProvider.SEEDREAM, UpscaleProvider.QUALITY):
            return self.upscale_seedream(
                image, PromptTemplateManager.build_prompt(cfg.category), cfg.strength,
                cfg.target_scale, cfg.seed, cfg.num_inference_steps, category=cfg.category)
        if provider in (UpscaleProvider.VEIMAGEX, UpscaleProvider.FAST):
            return self.upscale_veimagex(image, VeImageXTemplate.STANDARD_SR, cfg.target_scale)
        if provider == UpscaleProvider.BICUBIC:
            return self._bicubic(image, cfg.target_scale)
        return self.hybrid_upscale(image, cfg.target_scale, cfg.category)
