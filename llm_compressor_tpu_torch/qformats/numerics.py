"""Element-wise rounding (port of ``qformats/numerics.py``).

Integer quantization rounds half-to-even: ``torch.round`` is the same
function as ``jnp.round``. The floating-point element quantizer that the
fp/MX/NVFP formats need is not ported yet (ROADMAP.md, queue A item 2).
"""

from __future__ import annotations

import torch

from .formats import FormatParams


def round_half_even(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest, ties to even (reference 'even')."""
    return torch.round(x)


def quantize_elemwise(x: torch.Tensor, params: FormatParams, round: str = "nearest",
                      saturate_normals: bool = True, allow_denorm: bool = True):
    raise NotImplementedError(
        "floating-point element formats (fp4/fp8/MX/NVFP4) are not ported "
        "yet: ROADMAP.md queue A item 2")
