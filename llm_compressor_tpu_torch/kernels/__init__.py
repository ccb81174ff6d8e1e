"""kernels — hand-written Hopper kernels with their plain PyTorch versions.

B1 ``w4a8_matmul.matmul_stacked``, B2 ``w4a8_matmul.gateup_silu``,
B3 ``w4a8_matmul.matmul_flat``, B4
``decode_attention.decode_attention_append``, B5
``dequant_matmul.dequant_matmul_codes``, B6
``decode_attention.decode_attention_stats``, B7
``decode_attention.decode_attention``, B8 ``decode_attention.fresh_write``,
B9 ``w4a8_matmul.matmul_actq`` and B10 ``hadamard.hadamard_transform``;
sources in ``../csrc``.
Importing this package builds nothing: a kernel is compiled at its first
launch (``_build.py``).
"""

from . import decode_attention, dequant_matmul, hadamard, w4a8_matmul
from .hadamard import hadamard_transform

_WRAPPERS = {
    "w4a8_stacked": (w4a8_matmul, "matmul_stacked"),
    "w4a8_gateup": (w4a8_matmul, "gateup_silu"),
    "w4a8_flat": (w4a8_matmul, "matmul_flat"),
    "decode_attention_append": (decode_attention, "decode_attention_append"),
    "dequant_matmul": (dequant_matmul, "dequant_matmul_codes"),
    "decode_attention_stats": (decode_attention, "decode_attention_stats"),
    "decode_attention": (decode_attention, "decode_attention"),
    "fresh_write": (decode_attention, "fresh_write"),
    "w4a8_actq": (w4a8_matmul, "matmul_actq"),
    "hadamard": (hadamard, "hadamard_transform"),
}


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last :func:`reset_counts`."""
    return {k: getattr(mod, fn).launches for k, (mod, fn) in _WRAPPERS.items()}


def reset_counts() -> None:
    for mod, fn in _WRAPPERS.values():
        getattr(mod, fn).launches = 0


def add_counts(counts: dict) -> None:
    """Add ``counts`` (name -> launches, as :func:`launch_counts` names them)
    to the counters. The wrappers count at call time, so a CUDA graph
    (``engine/graph.py``) takes back what its capture counted, where
    nothing ran, and adds it at each replay."""
    for k, n in counts.items():
        mod, fn = _WRAPPERS[k]
        getattr(mod, fn).launches += n
