"""The port stands alone: importing it loads neither JAX nor the JAX
package, its entry points default to the card and raise without one, and
a kernel build without nvcc raises instead of falling back."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from llm_compressor_tpu_torch import device as tdevice
from llm_compressor_tpu_torch.kernels import _build
from torch_port_util import one_torch_thread  # noqa: F401

MODULES = [
    "llm_compressor_tpu_torch", "llm_compressor_tpu_torch.qformats",
    "llm_compressor_tpu_torch.models", "llm_compressor_tpu_torch.algorithms",
    "llm_compressor_tpu_torch.kernels", "llm_compressor_tpu_torch.engine",
    "llm_compressor_tpu_torch.convert", "llm_compressor_tpu_torch.capture",
    "llm_compressor_tpu_torch.utils", "llm_compressor_tpu_torch.kernels.hadamard",
    "llm_compressor_tpu_torch.algorithms.gptq", "llm_compressor_tpu_torch.algorithms.obs",
    "llm_compressor_tpu_torch.algorithms.spinquant",
]


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_out(module):
    # a fresh interpreter: this test process has JAX loaded already
    code = (f"import sys, {module}; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'llm_compressor_tpu' or m.startswith('llm_compressor_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_default_to_card(monkeypatch):
    from llm_compressor_tpu_torch import engine, models
    from llm_compressor_tpu_torch.kernels import hadamard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.init_cache(1, 1, 8, 1, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.init_params(models.tiny_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hadamard.hadamard_matrix(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hadamard.random_hadamard_matrix(64, torch.Generator().manual_seed(0))
    assert tdevice.resolve_device("cpu").type == "cpu"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
