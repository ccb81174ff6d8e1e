"""ctypes bindings for the native host library (port of ``utils/native.py``
over the repo's own ``native/llmc_host.cpp``).

Host-side weight packing for multi-GB checkpoints: group-wise int4/int8
quantization and nibble packing in the kernels' layouts — "pair planes"
(the int4 default since round 5: byte j of group pair t holds elems
(2t*g + j, (2t+1)*g + j)) or legacy "group halves" — bit-identical to
``qformats.quantize_pack`` (round half to even, the restricted range
[-7, 7], a 1e-5 scale floor). Built with ``make`` on first use; every
function has a numpy fallback, so the library is optional. Host-side
only: nothing here touches the device.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .logging import LOGGER

# the repo root's native/, beside this package
_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = _NATIVE_DIR / "libllmc_host.so"
    if not so.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except Exception as e:
            LOGGER.debug(f"native build unavailable ({e}); using numpy fallback")
            return None
    try:
        lib = ctypes.CDLL(str(so))
        i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        i8p = ctypes.POINTER(ctypes.c_int8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.quantize_int_rows.argtypes = [f32p, i64, i64, i64, ctypes.c_int, i8p, f32p]
        lib.pack_int4.argtypes = [i8p, i64, i64, i64, u8p]
        lib.unpack_int4.argtypes = [u8p, i64, i64, i64, i8p]
        lib.quantize_pack_int4.argtypes = [f32p, i64, i64, i64, u8p, f32p]
        lib.pack_int4_pairs.argtypes = [i8p, i64, i64, i64, u8p]
        lib.unpack_int4_pairs.argtypes = [u8p, i64, i64, i64, i8p]
        lib.quantize_pack_int4_pairs.argtypes = [f32p, i64, i64, i64, u8p, f32p]
        for fn in (lib.quantize_int_rows, lib.pack_int4, lib.unpack_int4,
                   lib.quantize_pack_int4, lib.pack_int4_pairs, lib.unpack_int4_pairs,
                   lib.quantize_pack_int4_pairs):
            fn.restype = None   # all return void
        _LIB = lib
    except OSError as e:
        LOGGER.debug(f"native load failed ({e}); using numpy fallback")
    return _LIB


def have_native() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def pairs_default(c: int, group: int) -> bool:
    """Mirror of qformats.qtensor.pair_planes_for's layout rule for int4."""
    return (c // group) % 2 == 0 and 2 * group <= 2048


def quantize_pack_int4(W: np.ndarray, group: int,
                       pairs: Optional[bool] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """f32 (N, C) -> (packed uint8 (N, C/2), scales f32 (N, C/g)).
    Symmetric absmax per group; ``pairs`` selects the nibble layout
    (None = the same rule quantize_pack applies: pair planes when the
    group count is even)."""
    W = np.ascontiguousarray(W, dtype=np.float32)
    n, c = W.shape
    if c % group or group % 2:
        raise ValueError(f"{c} columns do not split into groups of {group} (even)")
    if pairs is None:
        pairs = pairs_default(c, group)
    if pairs and (c // group) % 2:
        raise ValueError(f"pair planes need an even group count, not {c // group}")
    lib = _load()
    packed = np.empty((n, c // 2), dtype=np.uint8)
    scales = np.empty((n, c // group), dtype=np.float32)
    if lib is not None:
        fn = lib.quantize_pack_int4_pairs if pairs else lib.quantize_pack_int4
        fn(_ptr(W, ctypes.c_float), n, c, group,
           _ptr(packed, ctypes.c_uint8), _ptr(scales, ctypes.c_float))
        return packed, scales
    # numpy fallback
    blk = W.reshape(n, c // group, group)
    amax = np.abs(blk).max(-1)
    scales[:] = np.maximum(amax / 7.0, 1e-5)
    q = np.clip(np.round(blk / scales[..., None]), -7, 7).astype(np.int8)
    if pairs:
        qp = q.reshape(n, c // (2 * group), 2, group)
        lo = (qp[:, :, 0, :] + 8).astype(np.uint8)
        hi = (qp[:, :, 1, :] + 8).astype(np.uint8)
    else:
        half = group // 2
        lo = (q[..., :half] + 8).astype(np.uint8)
        hi = (q[..., half:] + 8).astype(np.uint8)
    packed[:] = (lo | (hi << 4)).reshape(n, c // 2)
    return packed, scales


def unpack_int4(packed: np.ndarray, group: int,
                pairs: Optional[bool] = None) -> np.ndarray:
    """uint8 (N, C/2) -> int8 codes (N, C) in [-7, 7]."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    n, c2 = packed.shape
    c = c2 * 2
    if pairs is None:
        pairs = pairs_default(c, group)
    lib = _load()
    out = np.empty((n, c), dtype=np.int8)
    if lib is not None:
        fn = lib.unpack_int4_pairs if pairs else lib.unpack_int4
        fn(_ptr(packed, ctypes.c_uint8), n, c, group,
           _ptr(out, ctypes.c_int8))
        return out
    if pairs:
        p = packed.reshape(n, c // (2 * group), group)
        lo = (p & 0x0F).astype(np.int8) - 8
        hi = (p >> 4).astype(np.int8) - 8
        return np.stack([lo, hi], axis=2).reshape(n, c)
    half = group // 2
    p = packed.reshape(n, c // group, half)
    lo = (p & 0x0F).astype(np.int8) - 8
    hi = (p >> 4).astype(np.int8) - 8
    return np.concatenate([lo, hi], axis=-1).reshape(n, c)
