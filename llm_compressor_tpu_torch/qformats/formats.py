"""Numeric element-format registry (port of ``qformats/formats.py``).

Static Python only: the same format parameters as the JAX package, so
scales and codes come out bit-identical. ``mbits`` counts the sign bit and
the implicit one; integer formats use the shifted-mantissa form, so the
restrictive integer range is ``max_norm * 2**(mbits-2)`` = +-7 (int4) and
+-127 (int8).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from functools import lru_cache

FP32_MIN_NORMAL = 2.0 ** -126   # the smallest normal float32


class ElemFormat(enum.Enum):
    int4 = "int4"
    int8 = "int8"
    fp4_e2m1 = "fp4_e2m1"
    fp8_e4m3 = "fp8_e4m3"
    fp8_e5m2 = "fp8_e5m2"

    @staticmethod
    def from_any(fmt: "str | ElemFormat") -> "ElemFormat":
        if isinstance(fmt, ElemFormat):
            return fmt
        try:
            return ElemFormat(fmt.lower())
        except ValueError as e:
            raise ValueError(f"Unknown element format: {fmt!r}") from e

    @property
    def bits(self) -> int:
        """Storage bits per element."""
        return {"int4": 4, "int8": 8, "fp4_e2m1": 4, "fp8_e4m3": 8, "fp8_e5m2": 8}[self.value]


@dataclass(frozen=True)
class FormatParams:
    ebits: int       # exponent bits (0 for ints)
    mbits: int       # mantissa bits incl. sign + implicit one
    emax: int        # max normal exponent
    max_norm: float  # largest representable magnitude
    min_norm: float  # smallest normal magnitude (0 for ints)

    @property
    def int_max(self) -> int:
        """Restrictive-range integer max (7 for int4, 127 for int8)."""
        return int(round(self.max_norm * 2 ** (self.mbits - 2)))


def _min_norm(ebits: int) -> float:
    return 0.0 if ebits == 0 else 2.0 ** (2 - 2 ** (ebits - 1))


@lru_cache(maxsize=None)
def format_params(fmt: "str | ElemFormat") -> FormatParams:
    fmt = ElemFormat.from_any(fmt)
    if fmt == ElemFormat.int4:
        ebits, mbits, emax = 0, 4, 0
    elif fmt == ElemFormat.int8:
        ebits, mbits, emax = 0, 8, 0
    elif fmt == ElemFormat.fp4_e2m1:
        ebits, mbits = 2, 3
        emax = 2 ** (ebits - 1)
    elif fmt == ElemFormat.fp8_e4m3:
        ebits, mbits = 4, 5
        emax = 2 ** (ebits - 1)
    else:  # fp8_e5m2
        ebits, mbits = 5, 4
        emax = 2 ** (ebits - 1) - 1

    if fmt == ElemFormat.fp8_e4m3:
        max_norm = 2.0**emax * 1.75  # E4M3 trades the top NaN codes for range
    else:
        max_norm = 2.0**emax * float(2 ** (mbits - 1) - 1) / 2 ** (mbits - 2)
    return FormatParams(ebits, mbits, emax, max_norm, _min_norm(ebits))
