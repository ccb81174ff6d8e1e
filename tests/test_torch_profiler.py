"""The port's per-op profiler (``evalx.profile_model``), the attention taps
it reads, and the SQNR-driven MPQ plans built from its CSV (``evalx.mpq``)
against the JAX package's, on the same numpy inputs.

Configs: every architecture's ``tiny_config`` and OPT-350m's variant
(``torch_port_util.ALL_VARIANTS``), float32, norms and biases drawn from a
seed; W4A8 quantizers: int4-g32 weights, int8 per-token activations on
the linears and on the attention matmuls, an int8-g32 head; on Llama also
``tests/test_evalx_extras.py``'s config (no matmul quantizers). One batch
of 1 x 32 synthetic tokens.

Tolerances:
* taps (``qk_in1``, ``qk_in2``, ``qk_out``, ``sv_in1``, ``sv_in2``,
  ``sv_out`` and the linears' inputs) from ``run_layer`` against JAX's,
  each layer fed JAX's inputs: the masked scores equal (-1e9 added in
  float32), the rest within 1e-5 of the largest entry without quantizers
  (measured: at most 8.6e-7), and within 1e-2 in W4A8 (measured on seeds
  1-3: at most 6.3e-3, OPT's ``down_in``). In W4A8 an ulp of difference
  in a linear's input (its norm sums in another order) moves an int8
  activation code across a .5 boundary, which moves every later tap of
  the layer by about one code step.
* stats.csv: the same header, op names and row order; Elem and BPV
  equal; ClipError, a difference of two maxima, within 1e-5 of the row's
  |Max| (measured: at most 3.3e-7); the weight rows' other values within
  1e-4 relative of JAX's printed value (the CSV holds 5 significant
  digits: a value an ulp from a rounding boundary prints one unit of the
  fifth digit apart; measured: equal), the activation rows' within 1e-2
  (int8 code flips, as for the taps; measured: 4.8e-3 on one of OPT's
  PC99% values, at most 3.4e-5 elsewhere).
* MPQ: on a CSV the JAX package wrote, ``read_stats`` and ``select_ops``
  give JAX's rows and op lists, and ``sqnr_driven_mpq`` resolves every
  op to JAX's quantizers (``torch_port_util.jax_qspec``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import evalx as jev
from llm_compressor_tpu import models as jm
from llm_compressor_tpu.capture import pipeline as jpipe
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu.utils.dataset import synthetic_tokens
from llm_compressor_tpu_torch import evalx as tev
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.capture import pipeline as tpipe
from llm_compressor_tpu_torch.evalx import profiler as tprof
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from llm_compressor_tpu_torch.qformats import qspec_string
from torch_port_util import ALL_VARIANTS, jax_qspec, one_torch_thread, variant_pair  # noqa: F401

W4A8 = ("int4-g[32]-rw", "int8-g[-1]-rw", None, "int8-g[32]-rw")
WEIGHT_ONLY = ("int4-g[32]-rw", None, None, "int8-g[32]-rw")


def _qcfgs(acts=True):
    if acts:
        return (jbuild(*W4A8, head_act="int8-g[-1]-rw"),
                tbuild(*W4A8, head_act="int8-g[-1]-rw"))
    return jbuild(*WEIGHT_ONLY), tbuild(*WEIGHT_ONLY)


def _toks(vocab, n=1, T=32):
    return synthetic_tokens(n, T, vocab, 5)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("name", ["llama", "opt", "bloom", "gemma2"])
def test_attention_taps_match_jax(name, quantized):
    """Each layer's taps through ``run_layer``, each layer fed JAX's
    ``advance``d inputs: OPT's and BLOOM's query scaled before the QK
    matmul, BLOOM's ALiBi and Gemma2's softcap in ``qk_out``, the mask
    added; two chunks of 2 samples."""
    jcfg, tcfg, jp, tp = variant_pair(name, 1)
    jq, tq = _qcfgs() if quantized else (None, None)
    tol = 1e-2 if quantized else 1e-5
    toks = _toks(jcfg.vocab_size, n=4, T=12)
    jctx = jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks), chunk=2)
    tctx = tpipe.capture_layer0(tp, tcfg, toks, chunk=2)
    keys = tprof.TAP_KEYS
    for i in range(jcfg.num_layers):
        tctx.hidden = torch.from_numpy(np.array(jctx.hidden))
        jops, tops = jm.layer_ops(jcfg, jq, i), tm.layer_ops(tcfg, tq, i)
        jt = list(jpipe.run_layer(jctx, jp["layers"][i], i, jops, keys))
        tt = list(tpipe.run_layer(tctx, tp["layers"][i], i, tops, keys))
        assert len(jt) == len(tt) == 2
        for (_, _, jy, jtaps), (_, _, ty, ttaps) in zip(jt, tt):
            assert set(ttaps) == set(jtaps) == set(keys)
            for k in keys:
                want, got = np.asarray(jtaps[k]), ttaps[k].numpy()
                assert got.shape == want.shape and got.dtype == want.dtype, k
                if k == "qk_out":
                    masked = want < -1e8
                    np.testing.assert_array_equal(got < -1e8, masked)
                    got, want = np.where(masked, 0, got), np.where(masked, 0, want)
                assert _rel(got, want) <= tol, (name, i, k, _rel(got, want))
            assert _rel(ty.numpy(), jy) <= tol
        jpipe.advance(jctx, jp["layers"][i], i, jops)


def test_taps_leave_the_layer_unchanged():
    """Asking for every tap changes no output bit."""
    _, tcfg, _, tp = variant_pair("gemma2", 2)
    _, tq = _qcfgs()
    ctx = tpipe.capture_layer0(tp, tcfg, _toks(tcfg.vocab_size, n=2, T=12))
    ops = tm.layer_ops(tcfg, tq, 0)
    (_, _, plain, none), = tpipe.run_layer(ctx, tp["layers"][0], 0, ops)
    (_, _, tapped, taps), = tpipe.run_layer(ctx, tp["layers"][0], 0, ops, tprof.TAP_KEYS)
    assert not none and set(taps) == set(tprof.TAP_KEYS)
    assert torch.equal(plain, tapped)


def _csv_rows(path):
    lines = path.read_text().splitlines()
    return lines[0], [[c.strip() for c in ln.split(",")] for ln in lines[1:]]


def _check_csv(got_path, want_path):
    """Row-by-row comparison of two stats.csv files, to the bounds of the
    module doc."""
    gh, got = _csv_rows(got_path)
    wh, want = _csv_rows(want_path)
    assert gh == wh
    assert [r[0] for r in got] == [r[0] for r in want]
    keys = [k.strip() for k in wh.split(",")]
    for g, w in zip(got, want):
        vals = {k: (float(a), float(b)) for k, a, b in zip(keys[1:], g[1:], w[1:])}
        tol = 1e-4 if g[0].endswith(".weight") else 1e-2
        for k, (a, b) in vals.items():
            if k in ("Elem", "BPV"):
                assert a == b, (g[0], k)
            elif k == "ClipError":
                assert abs(a - b) <= 1e-5 * abs(vals["Max"][1]), (g[0], k, a, b)
            else:
                assert abs(a - b) <= tol * max(abs(a), abs(b)), (g[0], k, a, b)


@pytest.mark.parametrize("name", sorted(ALL_VARIANTS))
def test_profile_csv_matches_jax(name, tmp_path):
    jcfg, tcfg, jp, tp = variant_pair(name, 3)
    jq, tq = _qcfgs()
    toks = _toks(jcfg.vocab_size)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpath = jev.profile_model(jp, jcfg, jq, toks, save_path=str(tmp_path / "j"), verbose=False)
    tpath = tev.profile_model(tp, tcfg, tq, toks, save_path=str(tmp_path / "t"), verbose=False)
    assert tpath == tmp_path / "t" / "stats.csv"
    _check_csv(tpath, jpath)
    n_slots = len(tm.transformer.arch_slots(tcfg))
    rows = tev.read_stats(tpath)
    assert len(rows) == tcfg.num_layers * n_slots + 1 + tcfg.num_layers * (2 * n_slots + 6)


def test_profile_csv_matches_jax_weight_only(tmp_path):
    """Weight-only: dummy activation quantizers (an SQNR of 100 on their
    rows), and a second run appends to the file."""
    jcfg, tcfg, jp, tp = variant_pair("llama", 4)
    jq, tq = _qcfgs(acts=False)
    toks = _toks(jcfg.vocab_size)
    for _ in range(2):
        jpath = jev.profile_model(jp, jcfg, jq, toks, save_path=str(tmp_path), verbose=False)
    (tmp_path / "t").mkdir()
    for _ in range(2):
        tpath = tev.profile_model(tp, tcfg, tq, toks, save_path=str(tmp_path / "t"))
    _check_csv(tpath, jpath)
    rows = tev.read_stats(tpath)
    assert rows[0]["Op Name"] == "layers.0.self_attn.q_proj.weight"
    assert {r["SQNR"] for r in rows if r["Op Name"].endswith("qk_matmul.output")} == {100.0}


@pytest.fixture(scope="module")
def jax_csv(tmp_path_factory):
    d = tmp_path_factory.mktemp("prof")
    jcfg, _, jp, _ = variant_pair("llama", 0)
    jq, _ = _qcfgs()
    return jev.profile_model(jp, jcfg, jq, _toks(jcfg.vocab_size), save_path=str(d))


def test_read_stats_and_select_ops_match_jax(jax_csv):
    assert tev.read_stats(jax_csv) == jev.read_stats(jax_csv)
    rows = tev.read_stats(jax_csv)
    for suffix in (".weight", ".input", ".output", ".input2"):
        for lo, hi in ((None, None), (30.0, None), (None, 30.0), (20.0, 40.0)):
            assert tev.select_ops(rows, suffix, sqnr_below=hi, sqnr_above=lo) == \
                jev.select_ops(jev.read_stats(jax_csv), suffix, sqnr_below=hi, sqnr_above=lo)
    assert len(tev.select_ops(rows, ".weight", sqnr_below=1e9)) == 15


@pytest.mark.parametrize("floors", [(None, None), (30.0, None), (None, 20.0), (40.0, 30.0)])
def test_sqnr_driven_mpq_matches_jax(jax_csv, floors):
    """Weights below the median weight SQNR promoted; activations above a
    ceiling demoted, below a floor left unquantized."""
    ceiling, floor = floors
    rows = jev.read_stats(jax_csv)
    sq = sorted(r["SQNR"] for r in rows if r["Op Name"].endswith(".weight"))
    kw = dict(weight_sqnr_floor=sq[len(sq) // 2], act_sqnr_ceiling=ceiling,
              disable_act_sqnr_floor=floor)
    jq, tq = _qcfgs()
    jc = jev.sqnr_driven_mpq(jq, jax_csv, **kw)
    tc = tev.sqnr_driven_mpq(tq, jax_csv, **kw)
    assert list(tc.overrides) == list(jc.overrides) and tc.overrides
    cfg = tm.tiny_config("llama")
    names = [n for i in range(cfg.num_layers)
             for n in tm.transformer.op_names(cfg, i).values()] + ["lm_head"]
    for n in names:
        for cls in ("linear", "matmul", "head"):
            j, t = jc.for_op(n, cls), tc.for_op(n, cls)
            for part in ("weight", "act_in", "act_out"):
                jp_, tp_ = getattr(j, part), getattr(t, part)
                assert (None if jp_.qtype == "dummy" else jax_qspec(jp_)) == qspec_string(tp_), \
                    (n, cls, part)


EVALX_RUN = """
import sys, tempfile
import numpy as np
from llm_compressor_tpu_torch import evalx, models, qformats
from llm_compressor_tpu_torch.evalx import clip, image_reward, t2i_eval, lm_eval_bridge
cfg = models.tiny_config("llama")
p = models.init_params(cfg, device="cpu")
q = qformats.build_quant_config("int4-g[32]-rw", "int8-g[-1]-rw", None, "int8-g[32]-rw")
toks = np.arange(64, dtype=np.int32)[None] % cfg.vocab_size
evalx.evaluate(p, cfg, "ppl", token_stream=toks, seq_len=16, qcfg=q, is_check_sparsity=True)
d = tempfile.mkdtemp()
evalx.sqnr_driven_mpq(q, evalx.profile_model(p, cfg, q, toks[:, :16], save_path=d))
try:
    lm_eval_bridge.eval_qa(p, cfg, ["boolq"])
except ImportError:
    pass
"""


def test_evalx_run_leaves_other_packages_out():
    """Perplexity, the profiler and MPQ load no package the card's machine
    lacks, and the lm-eval bridge raises ImportError without ``lm_eval``
    (``tests/test_torch_imports.py``'s check, in a fresh interpreter)."""
    import test_torch_imports as ti

    res = ti._fresh(EVALX_RUN + ti._CHECK)
    assert res.returncode == 0, res.stdout + res.stderr
