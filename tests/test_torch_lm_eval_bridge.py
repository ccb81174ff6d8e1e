"""The port's lm-eval bridge (``evalx/lm_eval_bridge.py``) against the JAX
package's, offline, with the fake ``lm_eval`` module and tokenizer of
``tests/test_lm_eval_bridge.py`` (``lm_eval`` and a tokenizer download are
not available): both packages' LM adapters serve the same requests over
the same weights.

Config: the JAX ``tiny_config("llama")`` (float32), norms drawn from a
seed (``torch_port_util.variant_pair``), unquantized and W4A8 (int4-g32
weights, int8 per-token activations).

Tolerances: loglikelihoods within 1e-5 relative plus 1e-5 absolute
(float32 forwards summing in other orders; measured 4e-7 relative), the
greedy flags equal; ``generate_until``'s text equal (greedy decoding on a
float32 model: the same tokens); ``eval_qa``'s accuracies (means of the
greedy flags) equal, and the task configs set alike.
"""

import sys
from types import SimpleNamespace

import numpy as np
import pytest

from llm_compressor_tpu.evalx import evaluate as j_evaluate
from llm_compressor_tpu.evalx import lm_eval_bridge as jbridge
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu.utils.dataset import synthetic_tokens
from llm_compressor_tpu_torch.evalx import evaluate as t_evaluate
from llm_compressor_tpu_torch.evalx import lm_eval_bridge as tbridge
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from test_lm_eval_bridge import FakeTokenizer, _install_fake_lm_eval
from torch_port_util import one_torch_thread, variant_pair  # noqa: F401

W4A8 = ("int4-g[32]-rw", "int8-g[-1]-rw", None, None)
REQUESTS = [("the cat", " sat on the mat"), ("a", " bb"),
            ("a much longer context here", " ok"), ("", "x"), ("q", " z" * 40)]


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg, jp, tp = variant_pair("llama", 0)
    return jcfg, tcfg, jp, tp


@pytest.fixture
def fake_harness(monkeypatch):
    _install_fake_lm_eval()
    import transformers

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path, **kw: FakeTokenizer()))


def _lms(models, quantized, batch_size=2, max_length=2048):
    jcfg, tcfg, jp, tp = models
    jq, tq = (jbuild(*W4A8), tbuild(*W4A8)) if quantized else (None, None)
    return (jbridge.make_lm(jp, jcfg, "fake-path", jq, batch_size, max_length),
            tbridge.make_lm(tp, tcfg, "fake-path", tq, batch_size, max_length))


@pytest.mark.parametrize("max_length", [2048, 24])
@pytest.mark.parametrize("quantized", [False, True])
def test_loglikelihood_matches_jax(models, fake_harness, quantized, max_length):
    """Padded batches of 2 (a partial last one), an empty context, and a
    continuation past ``max_length`` (truncated from the left)."""
    jlm, tlm = _lms(models, quantized, max_length=max_length)
    reqs = [SimpleNamespace(args=r) for r in REQUESTS]
    want, got = jlm.loglikelihood(reqs), tlm.loglikelihood(reqs)
    assert len(got) == len(want) == len(reqs)
    for (gl, gg), (wl, wg) in zip(got, want):
        assert isinstance(gl, float) and isinstance(gg, bool)
        np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-5)
        assert gg == wg


def test_loglikelihood_rolling_matches_jax(models, fake_harness):
    jlm, tlm = _lms(models, False)
    reqs = [SimpleNamespace(args=(t,)) for t in ("roll the dice", "a b c d e f g h")]
    np.testing.assert_allclose(tlm.loglikelihood_rolling(reqs), jlm.loglikelihood_rolling(reqs),
                               rtol=1e-5, atol=1e-5)


def test_loglikelihood_batch_slices_as_jax(models):
    """``_loglikelihood_batch`` on a hand-made batch: context lengths 1 and
    3, totals 5 and 8 (zeros past them)."""
    jcfg, tcfg, jp, tp = models
    toks = synthetic_tokens(2, 8, jcfg.vocab_size, 3)
    toks[0, 5:] = 0
    want = jbridge._loglikelihood_batch(jp, jcfg, None, toks, [1, 3], [5, 8])
    got = tbridge._loglikelihood_batch(tp, tcfg, None, toks, [1, 3], [5, 8])
    for (gl, gg), (wl, wg) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-5)
        assert gg == wg


def test_generate_until_matches_jax(models, fake_harness):
    jlm, tlm = _lms(models, False)
    reqs = [SimpleNamespace(args=("hi there",)), SimpleNamespace(args=("xyz",))]
    got = tlm.generate_until(reqs)
    assert got == jlm.generate_until(reqs)
    assert all(isinstance(t, str) for t in got)


def test_eval_qa_matches_jax(models, fake_harness):
    jcfg, tcfg, jp, tp = models
    for task, shots in (("boolq", 0), ("mmlu", 5)):
        want = jbridge.eval_qa(jp, jcfg, [task], tokenizer_path="fake-path")
        made = sys.modules["lm_eval.tasks"]._made[task].config
        got = tbridge.eval_qa(tp, tcfg, [task], tokenizer_path="fake-path")
        assert got == want and 0.0 <= got[task] <= 100.0
        assert sys.modules["lm_eval.tasks"]._made[task].config == made == {
            "num_fewshot": shots, "fewshot_seed": 1234}


def test_evaluate_routes_other_tasks_to_the_bridge(models, fake_harness):
    jcfg, tcfg, jp, tp = models
    stream = synthetic_tokens(1, 1, jcfg.vocab_size, 4, eval_len=100)
    kw = dict(token_stream=stream, seq_len=32, tokenizer_path="fake-path")
    want = j_evaluate(jp, jcfg, "ppl,boolq", **kw)
    got = t_evaluate(tp, tcfg, "ppl,boolq", **kw)
    assert set(got) == set(want) == {"ppl.wikitext2", "boolq"}
    assert got["boolq"] == want["boolq"]
    np.testing.assert_allclose(got["ppl.wikitext2"], want["ppl.wikitext2"], rtol=1e-5)


def test_require_lm_eval_raises_without_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "lm_eval", None)
    with pytest.raises(ImportError, match="lm_eval is not installed"):
        tbridge._require_lm_eval()
    with pytest.raises(ImportError, match="lm_eval is not installed"):
        tbridge.eval_qa(None, None, ["boolq"])
