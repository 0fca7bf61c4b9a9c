"""Analytic FLOP counting for the SR nets and MFU (port of
``srs_tpu/utils/flops.py``).

Every registry CNN (ESPCN, EDSR, RCAN) runs each convolution at the
input's resolution and ends in a pixel shuffle, so the convolutions of
one pass cost ``2 * sum(kh * kw * cin * cout)`` FLOP per input pixel (a
multiply-add is 2 FLOP). :func:`conv_flops_per_pixel` sums that over a
state dict: 4-D convolution weights ``[cout, cin, kh, kw]`` and 2-D
linear weights, the same products as the reference's flax kernels.
Back-projection, the blend and the resizes are left out, as in the
reference: they move bytes, not tensor-core work. HAT counts its own
(``nets.HAT.flops_per_pixel``): its linear layers and convolutions at the
resolution each runs at, and its attention's two products.

MFU = counted FLOP / seconds / the card's peak. The peaks are NVIDIA's
published dense bfloat16 rates (data sheets, without sparsity) at the
part's full power limit; an unknown card is counted at the H100 SXM's
rate, with its name echoed in the result so a misread shows.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional, Tuple, Union

__all__ = ["conv_flops_per_pixel", "ladder_flops", "multipass_ladder_flops",
           "chip_peak_flops", "mfu"]

# Dense bfloat16 peak FLOP/s by card name, most specific first.
_PEAKS = (
    ("h100 pcie", 756e12),
    ("h100 nvl", 835e12),
    ("h100", 989e12),  # SXM: "NVIDIA H100 80GB HBM3"
    ("h200", 989e12),  # H200 and GH200
    ("a100", 312e12),
)
_DEFAULT_PEAK = 989e12


def chip_peak_flops(device: Optional[Union[str, int, Any]] = None) -> Tuple[float, str]:
    """(peak bfloat16 FLOP/s, card name in lower case) of ``device``: a
    card's name, a device (``torch.device``, index or "cuda:N"), or None
    for the first card ("cpu" when torch sees none)."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        kind = device
    else:
        import torch

        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        dev = torch.device(device)
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    kind = kind.lower()
    for key, peak in _PEAKS:
        if key in kind:
            return peak, kind
    return _DEFAULT_PEAK, kind


def conv_flops_per_pixel(params: Mapping[str, Any]) -> float:
    """``2 * prod(shape)`` summed over the 4-D (convolution) and 2-D
    (linear) weights of a state dict or module, per input pixel."""
    if hasattr(params, "state_dict"):
        params = params.state_dict()
    total = 0.0
    for value in params.values():
        shape = tuple(getattr(value, "shape", ()))
        if len(shape) in (2, 4):
            n = 1
            for d in shape:
                n *= int(d)
            total += 2.0 * n
    return total


def _net_flops_per_pixel(name: str, scale: int) -> float:
    """:func:`conv_flops_per_pixel` of the registry net ``name`` at
    ``scale``, or the net's own count where it has one (HAT: its bias
    tables are no linear layers, and its attention products are no
    weights); the shapes do not depend on the weights, so the net is built
    without storage."""
    import torch

    from ..models.registry import _make

    with torch.device("meta"):
        net = _make(name, int(scale), torch.float32)
    if hasattr(net, "flops_per_pixel"):
        return float(net.flops_per_pixel())
    return conv_flops_per_pixel(net)


def ladder_flops(
    model_name: str,
    ladder: List[int],
    block: int,
    n_tiles: int,
    models: Optional[List[str]] = None,
) -> float:
    """Convolution FLOP of one net pass per ladder step over the tile
    batch (step i sees ``block * prod(ladder[:i])``). ``models`` gives each
    step's net when selection served a mixed ladder
    (``last_run_info["models"]``)."""
    total = 0.0
    res = block
    for i, s in enumerate(ladder):
        name = models[i] if models and i < len(models) else model_name
        total += _net_flops_per_pixel(name, s) * res * res * n_tiles
        res *= int(s)
    return total


def multipass_ladder_flops(
    step_members: List[List],
    ladder: List[int],
    block: int,
    n_tiles: int,
) -> float:
    """Convolution FLOP of a multi-pass ladder (self-ensemble, fusion):
    ``step_members`` is ``last_run_info["step_members"]``, per step a list
    of ``[net, passes]`` (8 for a dihedral member), so 8 passes count 8
    times."""
    total = 0.0
    res = block
    for s, members in zip(ladder, step_members):
        for name, passes in members:
            total += passes * _net_flops_per_pixel(name, s) * res * res * n_tiles
        res *= int(s)
    return total


def mfu(flops: float, seconds: float, device: Optional[Union[str, int, Any]] = None) -> dict:
    """{"sr_tflops", "mfu_pct", "chip_kind"} for a measured stage."""
    peak, kind = chip_peak_flops(device)
    return {
        "sr_tflops": round(flops / 1e12, 2),
        "mfu_pct": round(100.0 * flops / max(seconds, 1e-9) / peak, 2),
        "chip_kind": kind,
    }
