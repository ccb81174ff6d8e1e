"""The port stands alone: importing it loads neither JAX nor the JAX
package (nor ``safetensors``, ``ml_dtypes`` or ``transformers``, which the
card's machine lacks, also while it writes and reads checkpoints), its
entry points default to the card and raise without one, and a kernel
build without nvcc raises instead of falling back."""

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
    "llm_compressor_tpu_torch.utils.safetensors_io", "llm_compressor_tpu_torch.models.params",
    "llm_compressor_tpu_torch.models.config", "llm_compressor_tpu_torch.engine.generate",
    "llm_compressor_tpu_torch.algorithms.awq", "llm_compressor_tpu_torch.algorithms.smoothquant",
    "llm_compressor_tpu_torch.algorithms.gptaq", "llm_compressor_tpu_torch.algorithms.sparsegpt",
    "llm_compressor_tpu_torch.algorithms.wanda", "llm_compressor_tpu_torch.algorithms.ria",
    "llm_compressor_tpu_torch.algorithms.magnitude", "llm_compressor_tpu_torch.evalx",
    "llm_compressor_tpu_torch.evalx.sparsity",
]
FORBIDDEN = ("jax", "llm_compressor_tpu", "safetensors", "ml_dtypes", "transformers")
_CHECK = ("bad = [m for m in sys.modules if m.split('.')[0] in {forbidden}]; "
          "print(bad); sys.exit(1 if bad else 0)").format(forbidden=set(FORBIDDEN))


def _fresh(code: str):
    # a fresh interpreter: this test process has JAX loaded already
    root = Path(__file__).resolve().parent.parent
    return subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_out(module):
    res = _fresh(f"import sys, {module}; " + _CHECK)
    assert res.returncode == 0, res.stdout + res.stderr


CHECKPOINT_RUN = """
import json, sys, tempfile
import numpy as np
from pathlib import Path
from llm_compressor_tpu_torch import algorithms, engine, models, qformats
from llm_compressor_tpu_torch.utils import safetensors_io
d = Path(tempfile.mkdtemp())
cfg = models.tiny_config("llama", num_layers=1, vocab_size=256)
qcfg = qformats.build_quant_config("fp8_e4m3-g[32]-rw", None, None, "int8-g[32]-rw")
p = models.init_params(cfg, device="cpu")
hf = {"model_type": "llama", "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
      "num_hidden_layers": 1, "num_attention_heads": 4, "num_key_value_heads": 2,
      "head_dim": 16, "tie_word_embeddings": True}
(d / "hf").mkdir()
(d / "hf" / "config.json").write_text(json.dumps(hf))
safetensors_io.save_file({"model.embed_tokens.weight": p["embed"]["weight"]},
                         d / "hf" / "model.safetensors")
models.load_hf_checkpoint(d / "hf", dtype="float32", device="cpu")
algorithms.rtn(p, cfg, qcfg)
algorithms.pack_model(p, cfg, qcfg)
models.save_compressed(p, cfg, d / "out", hf_config=hf)
p = models.load_compressed(d / "out", cfg, qcfg, device="cpu")
class Tok:
    eos_token_id = None
    encode = staticmethod(lambda t: list(t.encode()))
    decode = staticmethod(lambda ids, skip_special_tokens=True: "".join(map(chr, ids)))
engine.generate_text(p, cfg, Tok(), "hi", max_new_tokens=2, qcfg=qcfg, use_chat_template=False)
"""


def test_checkpoint_run_leaves_other_packages_out():
    """Writing and reading both checkpoint kinds (fp8 codes included) and
    ``generate_text`` load no package the card's machine lacks."""
    res = _fresh(CHECKPOINT_RUN + _CHECK)
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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.load_params_from_state_dict(models.tiny_config(), {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.load_compressed("missing", models.tiny_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.load_hf_checkpoint("missing")
    assert tdevice.resolve_device("cpu").type == "cpu"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
