"""The port's ``cli.main.run_pipeline`` against the JAX package's, on the
CPU (``--tiny --dtype float32 --cpu``), from the same initial params: the
port's ``_load_model`` returns the JAX CLI's draw, handed over as numpy
(``torch_port_util.cli_hand_over``).

* Dispatch: every quantization and pruning method with both packages'
  ``algorithms`` functions and ``capture_layer0`` replaced by spies. The
  recorded calls are equal: their order, the corpus named, the calibration
  tokens bitwise and every argument.
* RTN W4A8 (int4-g32 weights, int8 per-token activations) on all nine
  architectures, packed and saved: ``model.safetensors`` and
  ``packed.npz`` bitwise equal. Perplexity within 2e-3 relative, the W4A8
  bound of ``tests/test_torch_ppl.py`` (its 1e-5 holds for float models):
  an ulp of difference moves an int8 activation code across a .5
  boundary (measured: at most 6.4e-5, OPT).
* GPTQ, Wanda 50 % then RTN, and SpinQuant-Hadamard through the CLI:
  perplexity within 2e-3 relative (measured: at most 7.6e-5, SpinQuant;
  the GPTQ chain is not bitwise, ROADMAP C's C1), sparsity equal.
  SpinQuant starts from the JAX package's Hadamard draws (handed over as
  in ``tests/test_torch_spinquant_opt.py``).
* SpinQuant's checkpoint from an HF directory (16 x 64 calibration
  tokens): the same files as the JAX package's, the stale ``config.json``
  included (ROADMAP C, the JAX package's checkpoint faults): reloaded,
  both take the embedding as the head. Packed codes: at most 1 % of a
  weight's bytes differ and its saved weight within 2 % relative L2
  (measured: every code equal but 0.22 % of layer 1's down_proj bytes,
  1.24 % L2: GPTQ's error feedback carries a flipped code along the row).
* ``--profile``: the same ``stats.csv`` rows, to the bounds of
  ``tests/test_torch_profiler.py``.
"""

import importlib
import json

import jax
import numpy as np
import pytest
import torch

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import capture as jcap
from llm_compressor_tpu.cli import args as jargs
from llm_compressor_tpu.cli import main as jmain
from llm_compressor_tpu.kernels import hadamard as jh
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import capture as tcap
from llm_compressor_tpu_torch.cli import args as targs
from llm_compressor_tpu_torch.cli import main as tmain
from test_torch_profiler import _check_csv
from torch_port_util import (  # noqa: F401
    ARCHS, cli_hand_over, one_torch_thread, word_corpus, word_tokenizer,
)

tsq = importlib.import_module("llm_compressor_tpu_torch.algorithms.spinquant")
W4A8 = ["--weight", "int4-g[32]-rw", "--act-in", "int8-g[-1]-rw"]
QUANT = ("rtn", "smoothquant", "gptq", "awq", "awq_plus", "spinquant-had", "spinquant-opt",
         "gptaq")
PRUNE = ("magnitude", "wanda", "sparsegpt", "ria")


def _flags(*extra, arch="llama"):
    return ["--tiny", "--arch", arch, "--dtype", "float32", "--cpu", "--calib-num", "4",
            "--seq-len", "16", *extra]


def _run_both(tmp_path, monkeypatch, flags, return_state=False):
    """JAX's run_pipeline in ``tmp_path/jax``, then the port's in
    ``tmp_path/port`` (each its own ``experiments/``); ``{save}`` in the
    flags is each run's own directory."""
    out = []
    for name, args_mod, main_mod in (("jax", jargs, jmain), ("port", targs, tmain)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        args = args_mod.build_parser().parse_args(
            [f.replace("{save}", str(d / "out")) for f in flags])
        out.append(main_mod.run_pipeline(args, return_state=return_state))
    return out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

class _Ctx:
    def __init__(self, tokens, chunk):
        self.tokens, self.chunk = np.asarray(tokens), chunk


def _norm(x):
    """A package-free record of one argument."""
    if isinstance(x, _Ctx):
        return ("ctx", x.tokens.dtype.str, x.tokens.shape, x.tokens.tobytes(), x.chunk)
    if isinstance(x, (np.ndarray, jax.Array, torch.Tensor)):
        a = np.asarray(x)
        return ("array", a.dtype.str, a.shape, a.tobytes())
    if isinstance(x, dict):
        return "params" if "layers" in x else ("dict", len(x))
    if type(x).__name__ == "ModelConfig":
        return ("cfg", x.arch, x.num_layers, x.hidden_size, x.tie_word_embeddings)
    if type(x).__name__ == "QuantConfig":
        return ("qcfg", repr(x))
    return x


def _spy(monkeypatch, alg_mod, cap_mod, main_mod, calls):
    def make(name):
        def spy(*args, **kwargs):
            calls.append((name, [_norm(a) for a in args],
                          {k: _norm(v) for k, v in sorted(kwargs.items())}))
            return args[1] if name == "spinquant" else None
        return spy

    for name in ("rtn", "smoothquant", "gptq", "awq", "awq_plus", "gptaq", "spinquant",
                 "magnitude", "wanda", "sparsegpt", "ria", "pack_model"):
        monkeypatch.setattr(alg_mod, name, make(name))
    monkeypatch.setattr(cap_mod, "capture_layer0",
                        lambda params, cfg, tokens, chunk=8: _Ctx(tokens, chunk))
    real = main_mod._calib_tokens

    def corpus(args, cfg, dataset):
        calls.append(("corpus", dataset))
        return real(args, cfg, dataset)

    monkeypatch.setattr(main_mod, "_calib_tokens", corpus)


@pytest.mark.parametrize("flags", [
    ("--quantize", "--quant-method", m, "--w-clip", "--sq-alpha", "0.7",
     "--rotation-path", "rot") for m in QUANT] + [
    ("--prune", "--prune-method", m, "--sparsity", "0.4", "--ria-alpha", "0.3")
    for m in PRUNE], ids=QUANT + PRUNE)
def test_dispatch_matches_jax(flags, tmp_path, monkeypatch):
    cli_hand_over(monkeypatch)
    jcalls, tcalls = [], []
    _spy(monkeypatch, jalg, jcap, jmain, jcalls)
    _spy(monkeypatch, talg, tcap, tmain, tcalls)
    want, got = _run_both(tmp_path, monkeypatch,
                          _flags(*W4A8, "--tasks", "", "--head", "int8-g[32]-rw", *flags))
    assert tcalls == jcalls
    assert [c[0] for c in jcalls if c[0] != "corpus"] == [flags[2].split("-")[0]]
    assert got == want


# ---------------------------------------------------------------------------
# numbers
# ---------------------------------------------------------------------------

def _same_files(jdir, tdir, bitwise=True):
    from safetensors.numpy import load_file

    assert sorted(p.name for p in jdir.iterdir()) == sorted(p.name for p in tdir.iterdir())
    js, ts = load_file(str(jdir / "model.safetensors")), load_file(str(tdir / "model.safetensors"))
    assert sorted(js) == sorted(ts)
    for k in js:
        assert js[k].dtype == ts[k].dtype and js[k].shape == ts[k].shape, k
        if bitwise:
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    if (jdir / "packed.npz").exists():
        jn, tn = np.load(jdir / "packed.npz"), np.load(tdir / "packed.npz")
        assert sorted(jn.files) == sorted(tn.files)
        for k in jn.files:
            assert jn[k].dtype == tn[k].dtype and jn[k].shape == tn[k].shape, k
            if bitwise:
                np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)
    return js, ts


@pytest.mark.parametrize("arch", ARCHS)
def test_rtn_pack_save_matches_jax(arch, tmp_path, monkeypatch):
    cli_hand_over(monkeypatch)
    want, got = _run_both(tmp_path, monkeypatch, _flags(
        "--quantize", "--quant-method", "rtn", *W4A8, "--tasks", "ppl", "--pack",
        "--save-path", "{save}", arch=arch))
    assert set(got) == set(want) == {"ppl.wikitext2"}
    np.testing.assert_allclose(got["ppl.wikitext2"], want["ppl.wikitext2"], rtol=2e-3)
    _same_files(tmp_path / "jax" / "out", tmp_path / "port" / "out")
    for name in ("results.json", "run.log"):
        assert (tmp_path / "port" / "experiments" / "exp" / name).exists()


def _jax_rotations(cfg, seed=0):
    """JAX's Hadamard draws of ``spinquant(seed=0)`` (algorithms/spinquant.py)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    R1 = np.asarray(jh.random_hadamard_matrix(cfg.hidden_size, k1), np.float64)
    R2s = [np.asarray(jh.random_hadamard_matrix(cfg.head_dim, k), np.float64)
           for k in jax.random.split(k2, cfg.num_layers)]
    return R1, R2s


def _hand_over_rotations(monkeypatch):
    def draws(cfg, seed, device):
        R1, R2s = _jax_rotations(cfg, seed)
        return (torch.from_numpy(R1).to(device),
                [torch.from_numpy(r).to(device) for r in R2s])

    monkeypatch.setattr(tsq, "hadamard_rotations", draws)


@pytest.mark.parametrize("flags", [
    ("--quantize", "--quant-method", "gptq"),
    ("--prune", "--prune-method", "wanda", "--sparsity", "0.5", "--quantize",
     "--quant-method", "rtn"),
    ("--quantize", "--quant-method", "spinquant-had"),
], ids=["gptq", "wanda_rtn", "spinquant_had"])
def test_calibrated_pipeline_matches_jax(flags, tmp_path, monkeypatch):
    cli_hand_over(monkeypatch)
    _hand_over_rotations(monkeypatch)
    want, got = _run_both(tmp_path, monkeypatch, _flags(*W4A8, "--tasks", "ppl", *flags))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["ppl.wikitext2"], want["ppl.wikitext2"], rtol=2e-3)
    if "sparsity" in want:
        assert got["sparsity"] == want["sparsity"]


def _hf_dir(path, seed=0):
    """A tiny tied Llama as an HF directory (float32 weights, the JAX
    package's init) with a word-level tokenizer, and a text corpus."""
    from llm_compressor_tpu import models as jm
    from llm_compressor_tpu_torch import models as tm
    from llm_compressor_tpu_torch.convert import params_from_numpy
    from torch_port_util import jax_to_numpy

    jcfg = jm.tiny_config("llama", tie_word_embeddings=True)
    tcfg = tm.tiny_config("llama", tie_word_embeddings=True)
    tree = jax_to_numpy(jm.init_params(jcfg, jax.random.PRNGKey(seed)))
    tm.save_compressed(params_from_numpy(tree, "cpu"), tcfg, path,
                       hf_config=tm.to_hf_config(tcfg))
    word_tokenizer(path)
    corpus = path.parent / "corpus.txt"
    corpus.write_text(word_corpus(3000, seed))
    return corpus


def test_spinquant_checkpoint_matches_jax(tmp_path, monkeypatch):
    """``spinquant-had --save-path`` from an HF directory: the files and
    names of the JAX package's, ``config.json`` and the tokenizer byte for
    byte. SpinQuant unties the head, but the saved ``config.json`` is the
    loaded one, which says tied: both packages reload the checkpoint with
    the embedding as the head (ROADMAP C, reproduced on purpose)."""
    from llm_compressor_tpu.models import load_hf_checkpoint as j_load
    from llm_compressor_tpu_torch.models import load_hf_checkpoint as t_load

    _hand_over_rotations(monkeypatch)
    model = tmp_path / "hf"
    corpus = _hf_dir(model)
    (want, jstate), (got, tstate) = _run_both(tmp_path, monkeypatch, [
        "--model", str(model), "--dtype", "float32", "--cpu", "--calib-num", "16",
        "--seq-len", "64", "--calib-dataset", str(corpus), "--tasks", "",
        "--quantize", "--quant-method", "spinquant-had", *W4A8, "--pack",
        "--save-path", "{save}"], return_state=True)
    assert got == want == {}
    assert not jstate["cfg"].tie_word_embeddings and not tstate["cfg"].tie_word_embeddings
    jdir, tdir = tmp_path / "jax" / "out", tmp_path / "port" / "out"
    js, ts = _same_files(jdir, tdir, bitwise=False)
    for name in ("config.json", "tokenizer.json", "tokenizer_config.json",
                 "special_tokens_map.json"):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    assert (tdir / "config.json").read_bytes() == (model / "config.json").read_bytes()
    assert json.loads((tdir / "config.json").read_text())["tie_word_embeddings"] is True
    # the float leaves (rotated embedding and head, norms folded to 1) agree;
    # the packed linears' codes may differ where the GPTQ chains round apart
    for k in ("model.embed_tokens.weight", "lm_head.weight", "model.norm.weight"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-6, err_msg=k)
    jn, tn = np.load(jdir / "packed.npz"), np.load(tdir / "packed.npz")
    for k in jn.files:
        if k.endswith(".codes"):
            w = k[:-len(".codes")]
            assert np.mean(jn[k] != tn[k]) <= 0.01, k
            assert np.linalg.norm(ts[w] - js[w]) <= 0.02 * np.linalg.norm(js[w]), w
    # the fault: reloaded, the head is the embedding, not the rotated head saved
    # (SpinQuant recentres the embedding, not the head)
    assert np.abs(js["lm_head.weight"] - js["model.embed_tokens.weight"]).max() > 1e-4
    jcfg, jp = j_load(jdir, dtype="float32")
    tcfg, tp = t_load(tdir, dtype="float32", device="cpu")
    assert jcfg.tie_word_embeddings and tcfg.tie_word_embeddings
    assert "lm_head" not in jp and "lm_head" not in tp


def test_profile_matches_jax(tmp_path, monkeypatch):
    cli_hand_over(monkeypatch)
    want, got = _run_both(tmp_path, monkeypatch, _flags(
        "--profile", *W4A8, "--head", "int8-g[32]-rw"))
    assert got == want == {"stats_csv": "experiments/exp/stats.csv"}
    _check_csv(tmp_path / "port" / got["stats_csv"], tmp_path / "jax" / want["stats_csv"])
