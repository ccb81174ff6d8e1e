"""The batcher's chunk prefill in the form its CUDA graph takes, on the CPU,
against the JAX package: the admission on one static mini cache a
chunk-count class, with another admission's rows copied out and back in
as ``_admit`` interleaves admissions of one class, gives the JAX batcher's
ids on prompts of every class; ``_prefill_chunk`` with ``start`` and
``last_idx`` as 0-d tensors (the graph's inputs) gives bitwise the logits
and cache of the same chunk run with Python ints, and JAX's jitted
``_prefill_chunk``'s logits and cache.

Config: the tiny float32 Llama (hidden 64, 2 layers, vocab 256), random
weights from ``PRNGKey(0)`` handed to the port as numpy. Tolerances: ids
equal; tensor against int ``start`` bitwise (logits, codes, scales,
values); against JAX, logits within 2e-5 of max |logit| (the two
packages' f32 sum orders) and the cache's int8 codes within one step
(a sum-order difference may move a rounding), its values and scales
within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_compressor_tpu.engine import ContinuousBatcher as JBatcher
from llm_compressor_tpu.engine import batching as jbatching
from llm_compressor_tpu.engine import kvcache as jkv
from llm_compressor_tpu.models import init_params as j_init_params
from llm_compressor_tpu.models import tiny_config as j_tiny
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.engine import ContinuousBatcher
from llm_compressor_tpu_torch.engine import batching as tbatching
from llm_compressor_tpu_torch.engine import kvcache as tkv
from llm_compressor_tpu_torch.models import head, tiny_config
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from torch_port_util import jax_to_numpy, one_torch_thread  # noqa: F401

# int8 per-token acts on every matmul: over an int8 cache the decode runs on
# the codes (B4's plain version)
ACTS_I8 = (None, "int8-g[-1]-rw", None, None)
# (quantized KV cache, int8 acts)
SERVING = [(False, False), (True, True)]


@pytest.fixture(scope="module")
def model():
    jcfg = j_tiny("llama")
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tiny_config("llama"), params_from_numpy(jax_to_numpy(jp), "cpu")


class _Watched(ContinuousBatcher):
    """Records each hand-over of a class's static cache from one admission
    mid-prompt to another: (class, the admission copied out, the one
    copied in or started)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.swaps = []

    def _mini(self, n, p):
        holder = self._holder.get(n)
        if holder is not None and holder is not p:
            self.swaps.append((n, holder.req.uid, None if p is None else p.req.uid))
        return super()._mini(n, p)


@pytest.mark.parametrize("quantized_kv,acts", SERVING)
def test_every_class_interleaved_matches_jax(model, quantized_kv, acts):
    """max_len 24 and chunk 4: classes 1-6. Four prompts of class 3 fill
    the four slots and admit round-robin while nothing decodes, so each
    chunk hands the class's one cache to the next admission; the others
    (one or two of every class) admit one chunk per decode step, shortest
    remaining first, and two of class 5 hand it over to each other too.
    The ids equal the JAX batcher's, which gives every admission a new
    mini cache."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(11)
    lens = [9, 10, 11, 12, 3, 22, 17, 19, 6, 14, 1, 23, 20, 7]
    prompts = [rng.integers(0, tcfg.vocab_size, (t,)).astype(np.int32) for t in lens]
    kw = dict(batch_slots=4, max_len=24, prefill_chunk=4, quantized_kv=quantized_kv)
    j = JBatcher(jp, jcfg, **kw, **(dict(qcfg=jbuild(*ACTS_I8)) if acts else {}))
    t = _Watched(tp, tcfg, **kw, **(dict(qcfg=tbuild(*ACTS_I8)) if acts else {}))
    assert t.chunk_classes == 6 and {-(-n // 4) for n in lens} == set(range(1, 7))
    for p in prompts:
        assert j.submit(p, max_new_tokens=3) == t.submit(p, max_new_tokens=3)
    jres, tres = j.run(), t.run()
    assert set(jres) == set(tres) == set(range(1, len(lens) + 1))
    for uid in jres:
        np.testing.assert_array_equal(tres[uid], np.asarray(jres[uid]), err_msg=f"req {uid}")
    # three round-robin rounds over the four class-3 prompts: every chunk
    # of the first two but the very first hands the cache over (in the
    # third, each admission finishes and frees it for the next); requests
    # 7 and 8 (class 5) take it from each other at each of their chunks
    assert [s for s in t.swaps if s[0] == 3] == [(3, 1, 2), (3, 2, 3), (3, 3, 4), (3, 4, 1)] * 2
    assert [s for s in t.swaps if s[0] != 3] == [(5, 7, 8), (5, 8, 7)] * 4
    assert not t._holder and sorted(t._minis) == sorted({-(-n // 4) for n in lens})
    assert all(m.max_len == n * 4 for n, m in t._minis.items())


def test_warmup_makes_every_class_then_serves(model):
    """``warmup`` runs every class's chunk on its static cache (eagerly on
    the CPU: one class, the graphs are the card's) and leaves no holder;
    the admissions after it start on zeroed rows, and the ids equal the
    JAX batcher's after its own warmup."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, tcfg.vocab_size, (t,)).astype(np.int32) for t in (5, 13, 6)]
    kw = dict(batch_slots=2, max_len=20, prefill_chunk=4, quantized_kv=True)
    j, t = JBatcher(jp, jcfg, **kw), ContinuousBatcher(tp, tcfg, **kw)
    for eng in (j, t):
        eng.warmup()
        for p in prompts:
            eng.submit(p, max_new_tokens=4)
    assert list(t._minis) == [1] and not t._holder and not t.graph
    assert bool(t._minis[1].k.any())             # the warm-up's scratch rows
    jres, tres = j.run(), t.run()
    for uid in jres:
        np.testing.assert_array_equal(tres[uid], np.asarray(jres[uid]), err_msg=f"req {uid}")


def _chunks(T, C, seed, vocab):
    rng = np.random.default_rng(seed)
    padded = np.zeros((1, -(-T // C) * C), np.int32)
    padded[0, :T] = rng.integers(0, vocab, (T,))
    return [(padded[:, o:o + C], o, max(0, min(T - 1 - o, C - 1)))
            for o in range(0, padded.shape[1], C)]


@pytest.mark.parametrize("quantized_kv,acts", SERVING)
def test_tensor_start_and_last_idx_bitwise(model, quantized_kv, acts):
    """A 10-token prompt in three chunks of 4 on one mini cache of 12 rows,
    through ``_prefill_chunk`` with 0-d tensors, against the same chunks
    with Python ints through the code as it ran them before (a slice write
    at ``start``, the row taken by index): logits and cache bitwise; and
    against JAX's jitted ``_prefill_chunk`` on the same chunks."""
    jcfg, jp, tcfg, tp = model
    qcfg, jq = (tbuild(*ACTS_I8), jbuild(*ACTS_I8)) if acts else (None, None)
    C = 4
    new = lambda: tkv.init_cache(tcfg.num_layers, 1, 3 * C, tcfg.num_kv_heads, tcfg.head_dim,
                                 quantized=quantized_kv, device="cpu")
    got_cache, want_cache = new(), new()
    jc = jkv.init_cache(jcfg.num_layers, 1, 3 * C, jcfg.num_kv_heads, jcfg.head_dim,
                        quantized=quantized_kv)
    for toks, start, last_idx in _chunks(10, C, 13, tcfg.vocab_size):
        tt = torch.from_numpy(toks)
        got = tbatching._prefill_chunk(tp, tt, got_cache, torch.tensor(start),
                                       torch.tensor(last_idx), cfg=tcfg, qcfg=qcfg)
        with torch.inference_mode():
            h = tbatching._forward_cached(tp, tcfg, tt, want_cache, qcfg, start=start)
            want = head(tp, tcfg, h, qcfg)[:, last_idx, :]
        assert got.shape == (1, tcfg.vocab_size) and torch.equal(got, want)
        jlast, jc = jbatching._prefill_chunk(jp, jnp.asarray(toks), jc, jnp.int32(start),
                                             jnp.int32(last_idx), cfg=jcfg, qcfg=jq)
        jlast = np.asarray(jlast)
        np.testing.assert_allclose(got.numpy(), jlast, rtol=0,
                                   atol=2e-5 * float(np.abs(jlast).max()))
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(got_cache, name), getattr(want_cache, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    theirs, ours = jkv_layout(jc), tkv.to_jax_layout(got_cache)
    for name in ("k", "v"):
        if quantized_kv:
            step = np.abs(ours[name].astype(np.int32) - theirs[name].astype(np.int32))
            assert step.max() <= 1, name
        else:
            np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-5, atol=0, err_msg=name)
    if quantized_kv:
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-5, atol=0, err_msg=name)


def jkv_layout(jc) -> dict:
    """A JAX cache's arrays as numpy, a float cache's values as float32."""
    vals = lambda a: np.asarray(a if jc.quantized else jnp.asarray(a, jnp.float32))
    return {"k": vals(jc.k), "v": vals(jc.v),
            "k_scale": None if jc.k_scale is None else np.asarray(jc.k_scale),
            "v_scale": None if jc.v_scale is None else np.asarray(jc.v_scale)}


@pytest.mark.parametrize("quantized", [False, True])
def test_append_prefill_tensor_start(quantized):
    """``append_prefill`` at a 0-d tensor ``start`` (``index_copy_``) writes
    bitwise what it writes at the same Python int (a slice): codes,
    scales, values; the rows around stay."""
    g = torch.Generator().manual_seed(5)
    L, KV, S, D, T = 2, 2, 12, 16, 4
    k, v = torch.randn(1, T, KV, D, generator=g), torch.randn(1, T, KV, D, generator=g)
    caches = [tkv.init_cache(L, 1, S, KV, D, quantized=quantized, device="cpu") for _ in range(2)]
    for c in caches:
        for t in (c.k, c.v):
            t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(6)).to(t.dtype))
    tkv.append_prefill(caches[0], 1, k, v, 4)
    tkv.append_prefill(caches[1], 1, k, v, torch.tensor(4))
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(caches[0], name), getattr(caches[1], name)
        assert (a is None and b is None) or torch.equal(a, b), name
