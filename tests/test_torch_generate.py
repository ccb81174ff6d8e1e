"""The whole slice against the JAX package: RTN -> pack -> fuse -> stack,
prefill into an int8 KV cache, then greedy decode — the JAX side through
``prefill`` + ``decode_greedy_steps`` (its W4A8 and fused-append attention
kernels in interpret mode), the port through its kernels' plain versions.

Config: hidden 256, intermediate 512, 4 heads / 2 KV heads, head_dim 64,
2 layers, vocab 512, float32, int4-g128 weights with int8 per-token acts,
an int8-g128 lm_head with int8 acts, ``max_len`` 128. The port receives the
JAX package's packed params (``convert.py``) and fuses and stacks them
itself.

Tolerances:
* tokens: equal. The JAX logits' top-2 gap (from ``decode_step``, which
  decodes the same tokens) is asserted above 1e-3 at every step, so an
  ulp-level difference cannot decide a near-tie.
* prefill logits: atol 1e-4 * max|logit| (f32 summation order).
* cache codes in the written window: at most one code step on at most
  0.1 % of entries — the k/v projections sum their f32 group parts in
  another order, which can move a value across a .5 rounding boundary.
* cache scales: rtol 1e-5 (same cause).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import models as jm
from llm_compressor_tpu.engine import decode_greedy_steps as j_greedy, init_cache as j_init
from llm_compressor_tpu.engine import prefill as j_prefill
from llm_compressor_tpu.engine import kvcache as jkv
from llm_compressor_tpu.engine.generate import decode_step as j_step
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu_torch import engine as te
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.engine import kvcache as tkv
from llm_compressor_tpu_torch.engine.kvcache import to_jax_layout
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from torch_port_util import jax_to_numpy, one_torch_thread  # noqa: F401

CFG = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2,
           head_dim=64, num_layers=2, vocab_size=512)
QARGS = ("int4-g[128]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw")
B, T, N_STEPS, MAX_LEN = 2, 6, 4, 128


@pytest.fixture(scope="module")
def slice_runs():
    jcfg, tcfg = jm.tiny_config("llama", **CFG), tm.tiny_config("llama", **CFG)
    jq = jbuild(*QARGS, head_act="int8-g[-1]-rw")
    tq = tbuild(*QARGS, head_act="int8-g[-1]-rw")
    p = jm.init_params(jcfg, jax.random.PRNGKey(0))
    jalg.rtn(p, jcfg, jq, verbose=False)
    jalg.pack_model(p, jcfg, jq)
    tp = tm.stack_model(tm.fuse_model(params_from_numpy(jax_to_numpy(p), "cpu"), tcfg, tq))
    p = jm.stack_model(jm.fuse_model(p, jcfg, jq))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)

    def j_prefilled():
        cache = j_init(jcfg.num_layers, B, MAX_LEN, jcfg.num_kv_heads, jcfg.head_dim,
                       quantized=True)
        logits, cache = j_prefill(p, jnp.asarray(toks), cache, cfg=jcfg, qcfg=jq)
        return logits, cache

    j_logits, cache = j_prefilled()
    tok0 = jnp.argmax(j_logits, -1).astype(jnp.int32)[:, None]
    j_toks, j_cache = j_greedy(p, tok0, cache, n=N_STEPS, cfg=jcfg, qcfg=jq)
    # per-step logits for the top-2 gap (decode_step decodes the same tokens)
    gaps = [np.asarray(j_logits)]
    _, cache = j_prefilled()
    tok = tok0
    for _ in range(N_STEPS - 1):
        logits, cache = j_step(p, tok, cache, cfg=jcfg, qcfg=jq)
        gaps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]

    tcache = te.init_cache(tcfg.num_layers, B, MAX_LEN, tcfg.num_kv_heads, tcfg.head_dim,
                           device="cpu")
    t_logits, tcache = te.prefill(tp, torch.from_numpy(toks), tcache, cfg=tcfg, qcfg=tq)
    ttok0 = torch.argmax(t_logits, -1).to(torch.int32)[:, None]
    t_toks, tcache = te.decode_greedy_steps(tp, ttok0, tcache, n=N_STEPS, cfg=tcfg, qcfg=tq)
    return dict(j_logits=np.asarray(j_logits), t_logits=t_logits.numpy(),
                j_tok0=np.asarray(tok0), t_tok0=ttok0.numpy(), gaps=gaps,
                j_toks=np.asarray(j_toks), t_toks=t_toks.numpy(),
                j_cache={k: np.asarray(getattr(j_cache, k))
                         for k in ("k", "v", "k_scale", "v_scale", "lengths")},
                t_cache=to_jax_layout(tcache))


def test_reference_has_no_near_ties(slice_runs):
    for logits in slice_runs["gaps"]:
        top2 = np.sort(logits, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-3


def test_prefill_logits(slice_runs):
    j, t = slice_runs["j_logits"], slice_runs["t_logits"]
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * np.abs(j).max())


def test_greedy_tokens_equal(slice_runs):
    np.testing.assert_array_equal(slice_runs["t_tok0"], slice_runs["j_tok0"])
    np.testing.assert_array_equal(slice_runs["t_toks"], slice_runs["j_toks"])


@pytest.mark.parametrize("name", ["k", "v"])
def test_cache_codes(slice_runs, name):
    w = slice(0, T + N_STEPS)
    a = slice_runs["j_cache"][name][..., w].astype(np.int32)
    b = slice_runs["t_cache"][name][..., w].astype(np.int32)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_array_equal(slice_runs["t_cache"]["lengths"],
                                  slice_runs["j_cache"]["lengths"])


@pytest.mark.parametrize("name", ["k_scale", "v_scale"])
def test_cache_scales(slice_runs, name):
    w = slice(0, T + N_STEPS)
    np.testing.assert_allclose(slice_runs["t_cache"][name][..., w],
                               slice_runs["j_cache"][name][..., w], rtol=1e-5, atol=0)


def test_kv_row_quant_matches_jax():
    """The cache's row quantizer: codes and scales bitwise equal to the JAX
    one under jit, where the decode and prefill paths run it."""
    x = np.random.default_rng(4).normal(size=(2, 5, 2, 64)).astype(np.float32)
    jc, js = jax.jit(jkv._quant_i8)(jnp.asarray(x))          # (B, KV, D, T), (B, KV, 1, T)
    tc, ts = tkv._quant_i8(torch.from_numpy(x))             # (B, KV, T, D), (B, KV, T)
    np.testing.assert_array_equal(np.swapaxes(np.asarray(jc), -1, -2), tc.numpy())
    np.testing.assert_array_equal(np.asarray(js)[:, :, 0], ts.numpy())


def test_kv_layout_round_trip():
    """to_jax_layout gives the JAX cache's shapes, and from_jax_layout
    inverts it exactly."""
    rng = np.random.default_rng(5)
    L_, B_, KV_, S_, D_ = 2, 3, 2, 16, 64
    cache = tkv.KVCache(
        k=torch.from_numpy(rng.integers(-127, 128, (L_, B_, KV_, S_, D_)).astype(np.int8)),
        v=torch.from_numpy(rng.integers(-127, 128, (L_, B_, KV_, S_, D_)).astype(np.int8)),
        k_scale=torch.from_numpy(rng.random((L_, B_, KV_, S_)).astype(np.float32)),
        v_scale=torch.from_numpy(rng.random((L_, B_, KV_, S_)).astype(np.float32)),
        lengths=torch.tensor([3, 0, 16], dtype=torch.int32))
    j = to_jax_layout(cache)
    ref = j_init(L_, B_, S_, KV_, D_, quantized=True)
    for name in ("k", "v", "k_scale", "v_scale", "lengths"):
        assert j[name].shape == getattr(ref, name).shape
    back = tkv.from_jax_layout(**j, device="cpu")
    for name in ("k", "v", "k_scale", "v_scale", "lengths"):
        assert torch.equal(getattr(back, name), getattr(cache, name))
