"""Element-wise quantization numerics (port of ``qformats/numerics.py``).

The float element quantizer shared by the fp / MX / NVFP formats, in f32
math: a value is scaled so that ``mbits`` bits (sign and implicit one
included) sit left of the binary point, rounded, and scaled back.

The per-element exponent is taken exactly (``torch.frexp``). The JAX
package takes ``floor(log2(|x|))``, which its f32 ``log2`` rounds up to k
for the few values within some f32 ulps below 2**k. Round-to-nearest
(either tie rule) lands such a value on 2**k from either exponent, so
"nearest" and "even" give the JAX package's bits; "floor" differs there.
"""

from __future__ import annotations

import torch

from .formats import FormatParams


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest, ties away from zero (reference 'nearest')."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def round_half_even(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest, ties to even (reference 'even'), as the JAX
    package writes it: exact .5 ties step down to the even neighbour."""
    absx = torch.abs(x)
    mask = (torch.remainder(absx - 0.5, 2.0) == 0).to(x.dtype)
    return torch.sign(x) * (torch.floor(absx + 0.5) - mask)


def round_floor(x: torch.Tensor) -> torch.Tensor:
    """Round toward zero (reference 'floor': sign * floor(abs))."""
    return torch.sign(x) * torch.floor(torch.abs(x))


_ROUND = {"nearest": round_half_away, "even": round_half_even, "floor": round_floor}


def quantize_elemwise(x: torch.Tensor, params: FormatParams, round: str = "nearest",
                      saturate_normals: bool = True, allow_denorm: bool = True):
    """Quantize ``x`` element-wise to the format of ``params``.

    ``x`` is already scaled into the format's range (callers divide by the
    group scale first). Math in f32, result cast back to ``x.dtype``;
    inf / NaN pass through."""
    round_fn = _ROUND[round]
    a = x.float()
    ebits, mbits, max_norm = params.ebits, params.mbits, params.max_norm
    shift = 2.0 ** (mbits - 2)

    out = a
    if not allow_denorm and ebits > 0:
        min_norm = 2.0 ** (2 - 2 ** (ebits - 1))
        out = torch.where(torch.abs(a) >= min_norm, a, torch.zeros_like(a))

    if ebits > 0:
        # private exponent floor(log2|x|), clipped at the minimum normal
        # exponent so that subnormals round on the fixed denormal grid
        safe = torch.abs(a) + (a == 0).float()
        private_exp = (torch.frexp(safe).exponent - 1).float()
        private_exp = torch.clamp_min(private_exp, float(-(2 ** (ebits - 1)) + 2))
        pscale = torch.exp2(private_exp)
        rounded = round_fn(out / pscale * shift)
        out = rounded * pscale / shift
    else:
        out = round_fn(out * shift) / shift

    if saturate_normals or ebits == 0:
        out = torch.clamp(out, -max_norm, max_norm)
    else:
        out = torch.where(torch.abs(out) > max_norm, torch.sign(out) * float("inf"), out)
    out = torch.where(torch.isfinite(a), out, a)
    return out.to(x.dtype)
