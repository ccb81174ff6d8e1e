"""The port's ``layer_taps`` and ``accumulate_scaler_rows`` against the JAX
package's, on every architecture's ``tiny_config`` (and OPT-350m's
post-norm variant), with the same float32 weights, norms and biases and
the same 4 x 32 calibration tokens.

Tolerances: each layer is fed the JAX package's inputs for it; the taps
within 1e-5 of their largest entry, the channel statistic sum x_c^2 / n
within 1e-5 of its largest entry (the same float32 math summed in another
order). Without activation quantizers no rounding step sits between the
two, so nothing larger can arise.

The aliasing check: the port's ``advance`` overwrites the inputs in
place, and OPT-350m's post-norm taps ``attn_in`` on the layer input
itself. Taps taken by ``layer_taps`` before an ``advance`` must still
equal JAX's afterwards, in one chunk and in several.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu.capture import pipeline as jpipe
from llm_compressor_tpu.utils.dataset import synthetic_tokens
from llm_compressor_tpu_torch.capture import pipeline as tpipe
from torch_port_util import ALL_VARIANTS, one_torch_thread, variant_pair  # noqa: F401

NAMES = list(ALL_VARIANTS)


def _contexts(name, seed=0, chunk=2, n=4):
    jcfg, tcfg, jp, tp = variant_pair(name, seed)
    toks = synthetic_tokens(n, 32, jcfg.vocab_size, seed + 1)
    jctx = jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks), chunk=chunk)
    tctx = tpipe.capture_layer0(tp, tcfg, toks, chunk=chunk)
    return jcfg, jp, tp, jctx, tctx


def _close(got, want, frac=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=frac * np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_layer_taps_match_jax(name):
    jcfg, jp, tp, jctx, tctx = _contexts(name)
    for i in range(jcfg.num_layers):
        tctx.hidden = torch.from_numpy(np.array(jctx.hidden))
        jt = jpipe.layer_taps(jctx, jp["layers"][i], i)
        tt = tpipe.layer_taps(tctx, tp["layers"][i], i)
        assert set(tt) == set(jt) == set(tpipe.TAP_KEYS)
        for k in jt:
            assert tt[k].shape == jt[k].shape
            _close(tt[k], jt[k])
        jpipe.advance(jctx, jp["layers"][i], i)


@pytest.mark.parametrize("name", NAMES)
def test_accumulate_scaler_rows_match_jax(name):
    jcfg, jp, tp, jctx, tctx = _contexts(name, seed=3)
    for i in range(jcfg.num_layers):
        tctx.hidden = torch.from_numpy(np.array(jctx.hidden))
        js = jpipe.accumulate_scaler_rows(jctx, jp["layers"][i], i, jpipe.TAP_KEYS)
        ts = tpipe.accumulate_scaler_rows(tctx, tp["layers"][i], i, tpipe.TAP_KEYS)
        assert set(ts) == set(js)
        for k in js:
            assert ts[k].dtype == torch.float32
            _close(ts[k], js[k])
        jpipe.advance(jctx, jp["layers"][i], i)


@pytest.mark.parametrize("chunk", [4, 2])
def test_opt350m_taps_survive_advance(chunk):
    """Chunk 4 runs the 4 samples as one chunk, chunk 2 as two."""
    jcfg, jp, tp, jctx, tctx = _contexts("opt350m", seed=5, chunk=chunk)
    assert not jcfg.do_layer_norm_before
    for i in range(jcfg.num_layers):
        jt = jpipe.layer_taps(jctx, jp["layers"][i], i)
        tt = tpipe.layer_taps(tctx, tp["layers"][i], i)
        before = tctx.hidden.clone()
        _close(tt["attn_in"], before.numpy())   # post-norm: the tap is the input itself
        jpipe.advance(jctx, jp["layers"][i], i)
        tpipe.advance(tctx, tp["layers"][i], i)
        assert not torch.equal(tctx.hidden, before)   # advance wrote over the inputs
        for k in jt:
            _close(tt[k], jt[k])
        _close(tctx.hidden, jctx.hidden)
