"""The port's perplexity (``evalx.compute_ppl``, ``evalx.evaluate``) and
the model entry points it rests on (``forward_hidden``, ``forward(...,
positions=)``) against the JAX package's, on the same numpy inputs.

Configs: every architecture's ``tiny_config`` and OPT-350m's variant
(``torch_port_util.ALL_VARIANTS``) at hidden 256, intermediate 512,
head_dim 64, vocab 512, 2 layers, float32, norms and biases drawn from a
seed. Quantized: int4-g128 weights with int8 per-token activations (on
the attention matmuls too) and an int8-g128 head with int8 activations
(W4A8), either fake-quantized by RTN or RTN'd, packed, fused and stacked
in the JAX package and handed to the port (the port's kernels run their
plain versions on the CPU; JAX's Pallas kernels run in interpret mode).
The stream: synthetic tokens, 4 windows of 32 and 5 tokens over.

Tolerances:
* ``forward_hidden`` and ``forward(positions=)`` (positions offset by 5),
  stacked and unstacked: 1e-5 of the largest entry (float32 sums in
  other orders).
* ``compute_ppl``: float, 1e-5 relative (measured: at most 4.8e-7);
  W4A8, fake-quantized or packed, 2e-3 relative: an int8 activation code
  (the attention probs' and operands' codes too) that an ulp moves across
  a .5 boundary changes a target's CE, and a stream of 4 x 31 targets
  averages few of them (measured over the variants here: fake at most
  4.2e-4, packed at most 8.1e-4, OPT).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import evalx as jev
from llm_compressor_tpu import models as jm
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu.utils.dataset import synthetic_tokens
from llm_compressor_tpu_torch import evalx as tev
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from torch_port_util import ALL_VARIANTS, jax_to_numpy, one_torch_thread, variant_pair  # noqa: F401

WIDTHS = dict(hidden_size=256, intermediate_size=512, head_dim=64, vocab_size=512)
QARGS = ("int4-g[128]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw")
HEAD_ACT = "int8-g[-1]-rw"
SEQ = 32
VARIANTS = sorted(ALL_VARIANTS)


def _pair(name, seed=0):
    over = dict(WIDTHS)
    if name == "opt350m":
        over["project_in_dim"] = 128
    return variant_pair(name, seed, **over)


def _stream(vocab, seed=1):
    return synthetic_tokens(1, 1, vocab, seed, eval_len=4 * SEQ + 5)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("name", VARIANTS)
def test_forward_hidden_and_positions_match_jax(name, stacked):
    jcfg, tcfg, jp, tp = _pair(name)
    if stacked:
        jp, tp = jm.stack_model(jp), tm.stack_model(tp)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    pos = np.tile(np.arange(12, dtype=np.int32) + 5, (2, 1))
    jh = jm.forward_hidden(jp, jcfg, jnp.asarray(toks), positions=jnp.asarray(pos))
    th = tm.forward_hidden(tp, tcfg, torch.from_numpy(toks), positions=torch.from_numpy(pos))
    assert th.shape == jh.shape
    assert _rel(th.numpy(), jh) <= 1e-5
    jl = jm.forward(jp, jcfg, jnp.asarray(toks), positions=jnp.asarray(pos))
    tl = tm.forward(tp, tcfg, torch.from_numpy(toks), positions=torch.from_numpy(pos))
    assert _rel(tl.numpy(), jl) <= 1e-5
    # positions 0..T-1 by default, and the offset changes the result
    t0 = tm.forward(tp, tcfg, torch.from_numpy(toks))
    assert _rel(t0.numpy(), jm.forward(jp, jcfg, jnp.asarray(toks))) <= 1e-5
    if tcfg.pos_embedding in ("rope", "learned"):
        assert not torch.allclose(t0, tl)
    # forward is forward_hidden, then head
    assert torch.equal(tl, tm.head(tp, tcfg, th))


def _quantized(name, packed):
    """(jcfg, tcfg, JAX params, port params, JAX qcfg, port qcfg): RTN in
    the JAX package, then packed, fused and stacked when ``packed`` (the
    port gets JAX's codes through ``convert.py`` and fuses and stacks them
    itself)."""
    jcfg, tcfg, jp, tp = _pair(name)
    jq, tq = jbuild(*QARGS, head_act=HEAD_ACT), tbuild(*QARGS, head_act=HEAD_ACT)
    jalg.rtn(jp, jcfg, jq, verbose=False)
    if packed:
        jalg.pack_model(jp, jcfg, jq)
    tp = params_from_numpy(jax_to_numpy(jp), "cpu")
    if packed:
        jp = jm.stack_model(jm.fuse_model(jp, jcfg, jq))
        tp = tm.stack_model(tm.fuse_model(tp, tcfg, tq))
    return jcfg, tcfg, jp, tp, jq, tq


@pytest.mark.parametrize("name", VARIANTS)
def test_compute_ppl_float_matches_jax(name):
    """Batches of 3 over 4 windows: a partial last batch."""
    jcfg, tcfg, jp, tp = _pair(name)
    stream = _stream(jcfg.vocab_size)
    want = jev.compute_ppl(jp, jcfg, stream, seq_len=SEQ, batch_size=3)
    got = tev.compute_ppl(tp, tcfg, stream, seq_len=SEQ, batch_size=3)
    assert np.isfinite(got) and got > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", VARIANTS)
def test_compute_ppl_fake_w4a8_matches_jax(name):
    """Fake-quantized W4A8, one window a batch, ``n_samples`` 3 of 4."""
    jcfg, tcfg, jp, tp, jq, tq = _quantized(name, packed=False)
    stream = _stream(jcfg.vocab_size, 2)
    want = jev.compute_ppl(jp, jcfg, stream, seq_len=SEQ, n_samples=3, qcfg=jq)
    got = tev.compute_ppl(tp, tcfg, stream, seq_len=SEQ, n_samples=3, qcfg=tq)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert got != tev.compute_ppl(tp, tcfg, stream, seq_len=SEQ, n_samples=4, qcfg=tq)


@pytest.mark.parametrize("name", VARIANTS)
def test_compute_ppl_packed_matches_jax(name):
    """Packed, fused and stacked W4A8, batches of 3 (a partial last one)."""
    jcfg, tcfg, jp, tp, jq, tq = _quantized(name, packed=True)
    stream = _stream(jcfg.vocab_size, 3)
    want = jev.compute_ppl(jp, jcfg, stream, seq_len=SEQ, qcfg=jq, batch_size=3)
    got = tev.compute_ppl(tp, tcfg, stream, seq_len=SEQ, qcfg=tq, batch_size=3)
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_evaluate_keys_and_raise():
    """``evaluate``'s task string: ``ppl`` under ``ppl.wikitext2`` and the
    sparsity check under ``sparsity``, as the JAX package's; ``ppl``
    without a stream raises ValueError; a failing perplexity raises again
    the error it records as ``sys.maxsize``."""
    jcfg, tcfg, jp, tp = _pair("llama")
    stream = _stream(jcfg.vocab_size, 4)
    want = jev.evaluate(jp, jcfg, "ppl", token_stream=stream, seq_len=SEQ,
                        is_check_sparsity=True)
    got = tev.evaluate(tp, tcfg, "ppl", token_stream=stream, seq_len=SEQ,
                       is_check_sparsity=True)
    assert set(got) == set(want) == {"ppl.wikitext2", "sparsity"}
    np.testing.assert_allclose(got["ppl.wikitext2"], want["ppl.wikitext2"], rtol=1e-5)
    assert got["sparsity"] == want["sparsity"]
    assert tev.evaluate(tp, tcfg, "", token_stream=stream) == {}
    with pytest.raises(ValueError, match="token_stream"):
        tev.evaluate(tp, tcfg, "ppl")
    short = stream[:, : SEQ - 1]   # no whole window: nothing to average
    with pytest.raises(ValueError):
        jev.evaluate(jp, jcfg, "ppl", token_stream=short, seq_len=SEQ)
    with pytest.raises(ValueError):
        tev.evaluate(tp, tcfg, "ppl", token_stream=short, seq_len=SEQ)


def test_compute_ppl_runs_without_grad():
    """The windows run under ``torch.inference_mode``: no graph is kept."""
    _, tcfg, _, tp = _pair("llama")
    for v in tp["embed"].values():
        v.requires_grad_()
    seen = []
    real = tev.ppl.forward

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(out.requires_grad)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tev.ppl, "forward", spy)
        assert np.isfinite(tev.compute_ppl(tp, tcfg, _stream(tcfg.vocab_size), seq_len=SEQ))
    assert seen == [False] * 4
