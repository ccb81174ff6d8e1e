"""Device selection and matmul precision (float32 and the accumulation of
bf16 products), shared by the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: the
    port never falls back to the CPU on its own; callers that want the CPU
    (the tests) ask for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matmuls in full float32 inside the block: TF32 off
    (``torch.backends.cuda.matmul.allow_tf32`` False), the previous setting
    restored after. The calibration statistics and the GPTQ updates run
    under it, as the JAX package runs them at ``"highest"`` precision: TF32
    keeps about three decimal digits, which degrades the Hessians'
    conditioning and GPTQ's error feedback."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@contextlib.contextmanager
def full_f32_accumulation():
    """bf16 matmuls accumulate and reduce in float32 inside the block:
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    False, the previous setting restored after. PyTorch leaves it True,
    which lets cuBLAS add split-K partials in bf16; the JAX package asks
    for float32 accumulation (``preferred_element_type=jnp.float32``), and
    ``prefill``'s bf16 projections run under this."""
    cm = torch.backends.cuda.matmul
    prev = cm.allow_bf16_reduced_precision_reduction
    cm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        cm.allow_bf16_reduced_precision_reduction = prev
