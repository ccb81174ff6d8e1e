"""The port's CLI (``llm_compressor_tpu_torch.cli``) on tiny offline models,
on the CPU (``--cpu``): the seven tests of ``tests/test_cli.py`` against
the port, its parser and tables against the JAX package's, and a run
without ``--cpu`` and without a card, which raises before it writes
anything."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from llm_compressor_tpu.cli import args as jargs
from llm_compressor_tpu.cli import main as jmain
from llm_compressor_tpu_torch.cli import args as targs
from llm_compressor_tpu_torch.cli import main as tmain
from llm_compressor_tpu_torch.cli.args import build_parser
from llm_compressor_tpu_torch.cli.main import run_pipeline
from torch_port_util import one_torch_thread  # noqa: F401


def _args(*extra, cpu=True):
    return build_parser().parse_args([
        "--tiny", "--arch", "llama", "--calib-num", "4", "--seq-len", "32",
        "--tasks", "ppl", *(["--cpu"] if cpu else []), *extra,
    ])


def test_rtn_pipeline(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    r = run_pipeline(_args("--quantize", "--quant-method", "rtn",
                           "--weight", "int4-g[32]-rw"))
    assert "ppl.wikitext2" in r and r["ppl.wikitext2"] > 0
    assert (tmp_path / "experiments/exp/results.json").exists()
    assert (tmp_path / "experiments/exp/run.log").exists()


def test_prune_pipeline(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    r = run_pipeline(_args("--prune", "--prune-method", "magnitude",
                           "--sparsity", "0.3"))
    assert 0.25 < r["sparsity"] < 0.35


def test_profile_pipeline(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    r = run_pipeline(_args("--profile", "--weight", "int4-g[32]-rw",
                           "--act-in", "int8-g[-1]-rw"))
    csv = tmp_path / "experiments/exp/stats.csv"
    assert r == {"stats_csv": str(csv.relative_to(tmp_path))}
    lines = csv.read_text().strip().splitlines()
    assert lines[0].split(",")[0].strip() == "Op Name"
    # weight rows + activation rows for a 2-layer gated llama + lm_head
    assert len(lines) > 20


def test_save_and_reload(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run_pipeline(_args("--quantize", "--quant-method", "rtn",
                       "--weight", "int8-g[-2]-cw",
                       "--save-path", str(tmp_path / "out")))
    from llm_compressor_tpu_torch.utils.safetensors_io import load_file

    sd = load_file(tmp_path / "out/model.safetensors")
    assert "model.layers.0.self_attn.q_proj.weight" in sd
    assert "model.embed_tokens.weight" in sd


def test_calib_dataset_per_method(tmp_path, monkeypatch):
    """Each algorithm calibrates on the reference's corpus: pile-val for
    AWQ/AWQ+ stage-1/SmoothQuant (awq/core.py:38), C4 for Wanda/RIA/SparseGPT
    (wanda/core.py:34), wikitext-2 for GPTQ/GPTAQ and AWQ+ stage-2
    (gptq/core.py:36, awq_plus/core.py:155)."""
    M = tmain
    assert M.CALIB_DATASET["awq"] == M.CALIB_DATASET["smoothquant"] == "pileval"
    assert (M.CALIB_DATASET["wanda"] == M.CALIB_DATASET["ria"]
            == M.CALIB_DATASET["sparsegpt"] == "c4")
    assert M.CALIB_DATASET["gptq"] == M.CALIB_DATASET["gptaq"] == "wikitext2"

    monkeypatch.chdir(tmp_path)
    calls = []
    real = M._calib_tokens

    def spy(args, cfg, dataset):
        calls.append(dataset)
        return real(args, cfg, dataset)

    monkeypatch.setattr(M, "_calib_tokens", spy)

    run_pipeline(_args("--quantize", "--quant-method", "awq",
                       "--weight", "int4-g[32]-rw"))
    assert calls == ["pileval"]

    calls.clear()
    run_pipeline(_args("--prune", "--prune-method", "wanda"))
    assert calls == ["c4"]

    calls.clear()
    run_pipeline(_args("--quantize", "--quant-method", "awq_plus",
                       "--weight", "int4-g[32]-rw"))
    assert calls == ["pileval", "wikitext2"]


def test_tinychat_serves_compressed(tmp_path, monkeypatch):
    """tinychat chats with the params the pipeline compressed: with --pack,
    the served tree holds packed QTensors on the run's device."""
    from llm_compressor_tpu_torch.examples import tinychat
    from llm_compressor_tpu_torch.qformats import QTensor

    monkeypatch.chdir(tmp_path)
    args = tinychat.build_chat_parser().parse_args([
        "--tiny", "--arch", "llama", "--calib-num", "2", "--seq-len", "16",
        "--quantize", "--quant-method", "rtn", "--weight", "int4-g[32]-rw",
        "--pack", "--cpu",
    ])
    cfg, params, qcfg = tinychat.prepare(args)
    w = params["layers"][0]["attn"]["q"]["weight"]
    assert isinstance(w, QTensor) and w.codes.device.type == "cpu"
    assert args.tasks == ""


def test_packed_save_load_roundtrip(tmp_path):
    """Packed checkpoint round trip: the loaded QTensors give the quantized
    forward bitwise."""
    from llm_compressor_tpu_torch import algorithms as alg
    from llm_compressor_tpu_torch.models import (
        forward, init_params, load_compressed, save_compressed, tiny_config,
    )
    from llm_compressor_tpu_torch.qformats import QTensor, build_quant_config

    cfg = tiny_config("llama", hidden_size=128, intermediate_size=256,
                      num_heads=4, num_kv_heads=4, head_dim=32)
    params = init_params(cfg, seed=0, device="cpu")
    qcfg = build_quant_config("int4-g[128]-rw", "int8-g[-1]-rw", None, None)
    alg.rtn(params, cfg, qcfg)
    alg.pack_model(params, cfg, qcfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8)))
    ref = forward(params, cfg, toks, qcfg)

    save_compressed(params, cfg, tmp_path / "ckpt")
    params2 = load_compressed(tmp_path / "ckpt", cfg, qcfg, device="cpu")
    assert isinstance(params2["layers"][0]["attn"]["q"]["weight"], QTensor)
    assert torch.equal(forward(params2, cfg, toks, qcfg), ref)


def _actions(parser):
    return [(tuple(a.option_strings), a.dest, a.default, a.type, a.choices, a.nargs,
             a.const, a.required, type(a).__name__) for a in parser._actions]


def test_parser_matches_jax():
    """Flag by flag: option strings, dest, default, type, choices (and the
    action's kind, nargs, const, required) equal the JAX package's; tinychat's
    parser too."""
    assert _actions(targs.build_parser()) == _actions(jargs.build_parser())
    jchat = importlib.util.spec_from_file_location(
        "jax_tinychat", Path(__file__).resolve().parents[1] / "examples" / "tinychat.py")
    mod = importlib.util.module_from_spec(jchat)
    jchat.loader.exec_module(mod)
    from llm_compressor_tpu_torch.examples import tinychat

    assert _actions(tinychat.build_chat_parser()) == _actions(mod.build_chat_parser())


def test_tables_match_jax():
    assert tmain.CALIB_DATASET == jmain.CALIB_DATASET
    assert tmain._OFFLINE_SEED == jmain._OFFLINE_SEED


def test_make_exp_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    d = targs.make_exp_dir(_args("--exp", "e1"))
    assert d.is_dir() and d.resolve() == (tmp_path / "experiments" / "e1").resolve()


def test_without_card_raises_before_writing(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline(_args("--quantize", "--quant-method", "rtn", cpu=False))
    assert list(tmp_path.iterdir()) == []
