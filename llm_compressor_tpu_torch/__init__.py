"""llm_compressor_tpu_torch — the PyTorch/CUDA port of ``llm_compressor_tpu``.

Sub-packages mirror the JAX package's names (``qformats``, ``models``,
``algorithms``, ``kernels``, ``engine``) so each module's counterpart is
easy to find. The port imports ``torch`` only: never ``jax`` and nothing of
the JAX package. Hand-written Hopper kernels live under ``csrc/`` and are
built on first use (``kernels/_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
