"""Architecture variants beyond each ``tiny_config`` against the JAX
package: Phi with ``qk_layernorm`` and a tied head, Phi at Phi-2's partial
rotary (0.4 of the head dim), OPT without biases, OPT post-norm without
``project_in``, BLOOM with 6 and with 12 heads (ALiBi slopes of a head
count that is not a power of two), Qwen2 with per-layer windows, Llama
with head_dim 24 (not the hidden size over the heads), Gemma3 at 3 layers
(local, global, local) and Gemma2 without softcaps.

Each: float32 weights from the JAX package's ``init_params``, norms and
biases drawn from a seed, handed over as numpy. ``forward`` within 1e-6 of
JAX's logits (the same float32 math in another summation order). Then the
serving path in each package, stacked params over a bf16 KV cache:
``prefill`` and ``decode_step`` fed JAX's greedy tokens, the argmax equal
wherever JAX's top-2 gap exceeds 0.1; ``decode_greedy_steps`` then gives
JAX's greedy tokens in every row up to that row's first step with a gap
at or under 0.1. The serving weights are drawn at scale 0.1 (``init_params``'
0.02 leaves the tiny models' logits under 1, and most top-2 gaps under
0.1): most of the tokens are then confident, which the test asserts.

Logits: where q, k and v are unfused linears with biases (Phi, OPT with
biases, Qwen2), the two packages add a row's products in another order,
one float32 k or v value can round to the other side of a bf16 step in
the cache, and every later logit reads it (measured up to 2e-4 when
probing these variants): the logits are held at 5e-4. The same can happen
wherever a k or v row is not bitwise JAX's (here Gemma2 without softcaps
reads 8.6e-5, Llama at head_dim 24 3.3e-5), so every variant is held
there.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import models as jm
from llm_compressor_tpu.engine import decode_greedy_steps as j_greedy
from llm_compressor_tpu.engine import init_cache as j_init
from llm_compressor_tpu.engine import prefill as j_prefill
from llm_compressor_tpu.engine.generate import decode_step as j_step
from llm_compressor_tpu_torch import engine as te
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.convert import params_from_numpy
from torch_port_util import jax_to_numpy, one_torch_thread, randomize  # noqa: F401

# name -> (arch, tiny_config overrides)
VARIANTS = {
    "phi_qk_layernorm_tied": ("phi", dict(qk_layernorm=True, tie_word_embeddings=True)),
    "phi_partial_rotary": ("phi", dict(partial_rotary_factor=0.4)),
    "opt_no_bias": ("opt", dict(attention_bias=False, attention_out_bias=False,
                                mlp_bias=False)),
    "opt_post_norm": ("opt", dict(do_layer_norm_before=False)),
    "bloom_6_heads": ("bloom", dict(num_heads=6, num_kv_heads=6, hidden_size=96)),
    "bloom_12_heads": ("bloom", dict(num_heads=12, num_kv_heads=12, hidden_size=192)),
    "qwen2_layer_windows": ("qwen2", dict(num_layers=3, sliding_window=6, layer_types=(
        "sliding_attention", "full_attention", "sliding_attention"))),
    "llama_head_dim_24": ("llama", dict(head_dim=24)),
    "gemma3_3_layers": ("gemma3", dict(num_layers=3)),
    "gemma2_no_softcaps": ("gemma2", dict(attn_logit_softcapping=None,
                                          final_logit_softcapping=None)),
}
NAMES = list(VARIANTS)
B, T, STEPS, MAX_LEN, GAP, LOGIT_TOL = 3, 12, 10, 32, 0.1, 5e-4


def _pair(name, seed=0, scale=0.02):
    arch, over = VARIANTS[name]
    jcfg, tcfg = jm.tiny_config(arch, **over), tm.tiny_config(arch, **over)
    tree = jax_to_numpy(jm.init_params(jcfg, jax.random.PRNGKey(seed), scale=scale))
    tree = randomize(tree, seed + 1)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _tokens(cfg, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def test_variants_are_what_they_say():
    """Each override took: the config differs from its architecture's
    ``tiny_config`` where the name says."""
    tiny = {n: tm.tiny_config(VARIANTS[n][0]) for n in NAMES}
    cfg = {n: _pair(n)[1] for n in NAMES}
    phi = cfg["phi_qk_layernorm_tied"]
    assert phi.qk_layernorm and phi.tie_word_embeddings
    assert cfg["phi_partial_rotary"].rotary_dim == 6 != tiny["phi_partial_rotary"].rotary_dim
    assert not any((cfg["opt_no_bias"].attention_bias, cfg["opt_no_bias"].mlp_bias))
    opt = cfg["opt_post_norm"]
    assert not opt.do_layer_norm_before and opt.project_in_dim is None
    assert [cfg["qwen2_layer_windows"].layer_window(i) for i in range(3)] == [6, 0, 6]
    assert cfg["llama_head_dim_24"].head_dim * 4 != cfg["llama_head_dim_24"].hidden_size
    assert cfg["gemma2_no_softcaps"].attn_logit_softcapping is None


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    jcfg, tcfg, p, tp = _pair(name)
    toks = _tokens(jcfg)
    want = np.asarray(jm.forward(p, jcfg, jnp.asarray(toks)))
    got = tm.forward(tp, tcfg, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _jax_serve(jcfg, p, toks):
    """JAX's prefill, then decode_step on its own greedy tokens: (the logits
    of the prefill and of each step, the fed tokens), and its
    decode_greedy_steps from the same prefill."""
    p = jm.stack_model(p)
    new = lambda: j_init(jcfg.num_layers, B, MAX_LEN, jcfg.num_kv_heads, jcfg.head_dim)
    logits, cache = j_prefill(p, jnp.asarray(toks), new(), cfg=jcfg)
    out, fed = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(jnp.asarray(out[-1]), -1).astype(jnp.int32)[:, None]
        fed.append(np.asarray(tok))
        lg, cache = j_step(p, tok, cache, cfg=jcfg)
        out.append(np.asarray(lg))
    logits, cache = j_prefill(p, jnp.asarray(toks), new(), cfg=jcfg)
    tok0 = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    greedy, _ = j_greedy(p, tok0, cache, n=STEPS, cfg=jcfg)
    return out, fed, np.concatenate([np.asarray(tok0), np.asarray(greedy)], 1)


def _port_serve(tcfg, tp, toks, fed):
    tp = tm.stack_model(tp)
    new = lambda: te.init_cache(tcfg.num_layers, B, MAX_LEN, tcfg.num_kv_heads, tcfg.head_dim,
                                device="cpu")
    logits, cache = te.prefill(tp, torch.from_numpy(toks), new(), cfg=tcfg)
    out = [logits.numpy()]
    for tok in fed:
        lg, cache = te.decode_step(tp, torch.from_numpy(tok.copy()), cache, cfg=tcfg)
        out.append(lg.numpy())
    logits, cache = te.prefill(tp, torch.from_numpy(toks), new(), cfg=tcfg)
    tok0 = torch.argmax(logits, -1).to(torch.int32)[:, None]
    greedy, _ = te.decode_greedy_steps(tp, tok0, cache, n=STEPS, cfg=tcfg)
    return out, torch.cat([tok0, greedy], 1).numpy()


@pytest.mark.parametrize("name", NAMES)
def test_serving_matches_jax(name):
    jcfg, tcfg, p, tp = _pair(name, seed=3, scale=0.1)
    toks = _tokens(jcfg, seed=4)
    want, fed, j_tokens = _jax_serve(jcfg, p, toks)
    got, t_tokens = _port_serve(tcfg, tp, toks, fed)
    sure = []
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_TOL)
        top2 = np.sort(b, -1)[:, -2:]
        sure.append(top2[:, 1] - top2[:, 0] > GAP)
        np.testing.assert_array_equal(np.argmax(a, -1)[sure[-1]], np.argmax(b, -1)[sure[-1]])
    assert np.mean(sure) > 0.5
    prefix = np.cumprod(np.stack(sure, 1), 1).astype(bool)   # (B, STEPS + 1)
    np.testing.assert_array_equal(t_tokens[prefix], j_tokens[prefix])
