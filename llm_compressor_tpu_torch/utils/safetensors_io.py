"""The safetensors file format, read and written with torch alone (the JAX
package uses the ``safetensors`` package, which the card's machine lacks).

A file is an 8-byte little-endian header length, a JSON header of
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` of strings, padded with spaces to a multiple of
8 bytes, then the tensors' raw little-endian bytes, back to back. The writer
orders entries as the ``safetensors`` package does (wider dtypes first,
then by name), so each tensor starts on a multiple of its own width.
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Dict, Optional

import torch

READ_DTYPES = {"F32": torch.float32, "BF16": torch.bfloat16, "F16": torch.float16,
               "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64}
# what the writer takes, widest first (the package's order of entries)
WRITE_DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16"}
_HEADER_MAX = 100_000_000   # the package refuses larger headers


def save_file(tensors: Dict[str, torch.Tensor], path, metadata: Optional[dict] = None) -> None:
    """Write ``tensors`` (float32 or bfloat16, on any device) to ``path``.
    Each tensor is copied to the host on its own as it is written."""
    rank = {dt: i for i, dt in enumerate(WRITE_DTYPES)}
    for name, t in tensors.items():
        if t.dtype not in WRITE_DTYPES:
            raise TypeError(f"{name}: {t.dtype} is not written (only {list(WRITE_DTYPES)})")
    names = sorted(tensors, key=lambda k: (rank[tensors[k].dtype], k))
    header: dict = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in names:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": WRITE_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in names:
            t = tensors[name].detach().contiguous().reshape(-1)
            f.write(t.view(torch.uint8).cpu().numpy().data)


def _read_header(path) -> tuple:
    """(the header's tensor entries, offset of the data)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", raw)
        if n > _HEADER_MAX:
            raise ValueError(f"{path}: header of {n} bytes")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path) -> Dict[str, torch.Tensor]:
    """Every tensor of ``path``, on the host. The file is mapped once
    (``torch.from_file``, private pages); each tensor is a view of the
    mapping, copied only where its bytes are not aligned to its width."""
    header, start = _read_header(path)
    size = Path(path).stat().st_size
    buf = torch.from_file(str(path), shared=False, size=size, dtype=torch.uint8)
    out = {}
    for name, e in header.items():
        if e["dtype"] not in READ_DTYPES:
            raise TypeError(f"{path}: {name} has dtype {e['dtype']}, not one of "
                            f"{list(READ_DTYPES)}")
        dt = READ_DTYPES[e["dtype"]]
        b, end = e["data_offsets"]
        width = torch.empty((), dtype=dt).element_size()
        if not 0 <= b <= end <= size - start or end - b != math.prod(e["shape"]) * width:
            raise ValueError(f"{path}: {name}'s bytes [{b}, {end}) do not hold "
                             f"{e['dtype']} {e['shape']} inside the file")
        raw = buf[start + b:start + end]
        if (start + b) % width:
            raw = raw.clone()
        out[name] = raw.view(dt).reshape(e["shape"])
    return out
