"""``.npz`` archives whose fp8 members numpy cannot describe.

The JAX package writes ``packed.npz`` with ``np.savez``, fp8 codes
included: an ``ml_dtypes`` float8 array goes into its ``.npy`` header as
``'<V1'`` (e4m3fn) or ``'<f1'`` (e5m2). Without ``ml_dtypes`` numpy reads
the first as raw void bytes and refuses the second, and ``np.load`` refuses
``'<f1'`` even with it. These helpers write such members with the same
header and read every member's bytes, the 1-byte float members as uint8
(the caller views them as the fp8 type it knows they hold). Everything else
is ``np.savez`` / ``np.load``'s own format.
"""

from __future__ import annotations

import ast
import zipfile
from typing import Dict, Optional

import numpy as np

# the .npy header descr of the JAX package's fp8 codes, by torch dtype name
FP8_DESCR = {"float8_e4m3fn": "<V1", "float8_e5m2": "<f1"}
_ONE_BYTE_FLOATS = {"<V1", "|V1", "<f1", "|f1"}


def save_npz(path, arrays: Dict[str, np.ndarray], descr: Optional[Dict[str, str]] = None) -> None:
    """``np.savez(path, **arrays)``, except that a member named in ``descr``
    (a uint8 array) is written under that header descr."""
    descr = descr or {}
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, a in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                if name in descr:
                    a = np.ascontiguousarray(a)
                    if a.dtype.itemsize != 1:
                        raise TypeError(f"{name}: descr {descr[name]!r} needs 1-byte codes")
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": descr[name], "fortran_order": False, "shape": a.shape})
                    f.write(a.tobytes())
                else:
                    np.lib.format.write_array(f, np.asanyarray(a), allow_pickle=False)


def _read_member(raw: bytes) -> np.ndarray:
    if raw[:6] != b"\x93NUMPY":
        raise ValueError("not a .npy member")
    major = raw[6]
    size = 2 if major == 1 else 4
    hlen = int.from_bytes(raw[8:8 + size], "little")
    start = 8 + size + hlen
    head = ast.literal_eval(raw[8 + size:start].decode("latin1"))
    if head["fortran_order"]:
        raise ValueError("Fortran-ordered members are not read")
    dt = np.dtype(np.uint8) if head["descr"] in _ONE_BYTE_FLOATS else np.dtype(head["descr"])
    if dt.hasobject:
        raise ValueError("object members are not read")
    return np.frombuffer(raw, dtype=dt, offset=start,
                         count=int(np.prod(head["shape"], dtype=np.int64))
                         ).reshape(head["shape"]).copy()


def load_npz(path) -> Dict[str, np.ndarray]:
    """Every member of an ``.npz`` archive by name (without ``.npy``); a
    1-byte float or void member comes back as its uint8 bytes."""
    with zipfile.ZipFile(path) as zf:
        return {n[:-4]: _read_member(zf.read(n)) for n in zf.namelist() if n.endswith(".npy")}
