"""kernels — hand-written Hopper kernels with their plain PyTorch versions.

B1 ``w4a8_matmul.matmul_stacked``, B2 ``w4a8_matmul.gateup_silu``,
B3 ``w4a8_matmul.matmul_flat``, B4
``decode_attention.decode_attention_append`` and B5
``dequant_matmul.dequant_matmul_codes``; sources in ``../csrc``.
Importing this package builds nothing: a kernel is compiled at its first
launch (``_build.py``).
"""

from . import decode_attention, dequant_matmul, w4a8_matmul


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last :func:`reset_counts`."""
    return {
        "w4a8_stacked": w4a8_matmul.matmul_stacked.launches,
        "w4a8_gateup": w4a8_matmul.gateup_silu.launches,
        "w4a8_flat": w4a8_matmul.matmul_flat.launches,
        "decode_attention_append": decode_attention.decode_attention_append.launches,
        "dequant_matmul": dequant_matmul.dequant_matmul_codes.launches,
    }


def reset_counts() -> None:
    w4a8_matmul.matmul_stacked.launches = 0
    w4a8_matmul.gateup_silu.launches = 0
    w4a8_matmul.matmul_flat.launches = 0
    decode_attention.decode_attention_append.launches = 0
    dequant_matmul.dequant_matmul_codes.launches = 0
