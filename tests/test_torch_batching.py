"""Continuous batching against the JAX package: the same requests through
the JAX ``ContinuousBatcher`` and the port's give the same ids, with
requests of different lengths interleaved (mirrors ``test_batching.py``);
``write_slot`` and the dropped writes past the cache against the JAX
functions.

Config: the tiny float32 Llama (hidden 64, 2 layers, vocab 256), random
weights from ``PRNGKey(0)`` handed to the port as numpy. Tolerances: ids
equal; ``write_slot`` and ``append_decode`` on the same inputs bitwise
(codes, scales, bf16 values).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu.engine import ContinuousBatcher as JBatcher
from llm_compressor_tpu.engine import kvcache as jkv
from llm_compressor_tpu.models import init_params as j_init_params
from llm_compressor_tpu.models import tiny_config as j_tiny
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.engine import ContinuousBatcher, generate
from llm_compressor_tpu_torch.engine import kvcache as tkv
from llm_compressor_tpu_torch.kernels import decode_attention as tda
from llm_compressor_tpu_torch.models import tiny_config
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from torch_port_util import jax_to_numpy, one_torch_thread  # noqa: F401

# int8 per-token acts on every matmul, float weights: over an int8 cache the
# decode attention runs on the codes (B4's plain version; JAX's XLA codes path)
ACTS_I8 = (None, "int8-g[-1]-rw", None, None)


@pytest.fixture(scope="module")
def model():
    jcfg = j_tiny("llama")
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tiny_config("llama"), params_from_numpy(jax_to_numpy(jp), "cpu")


def _both(model, requests, jax_kw=None, **kw):
    """Run ``requests`` ((tokens, submit kwargs) pairs) through the JAX and
    the port batcher built with ``kw`` -> (JAX results, port results)."""
    jcfg, jp, tcfg, tp = model
    jax_kw = dict(kw, **(jax_kw or {}))
    j, t = JBatcher(jp, jcfg, **jax_kw), ContinuousBatcher(tp, tcfg, **kw)
    for toks, sub in requests:
        assert j.submit(toks, **sub) == t.submit(toks, **sub)
    return j.run(), t.run()


def _same(jres, tres):
    assert set(jres) == set(tres)
    for uid in jres:
        np.testing.assert_array_equal(tres[uid], np.asarray(jres[uid]), err_msg=f"req {uid}")


@pytest.mark.parametrize("chunk", [4, 128])
def test_matches_standalone_greedy(model, chunk):
    """chunk=4 admits in 2-4 chunks, chunk=128 in one; the ids equal the
    JAX batcher's and the port's standalone greedy ``generate``."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, (t,)).astype(np.int32) for t in (5, 9, 13)]
    new = 6
    jres, tres = _both(model, [(p, dict(max_new_tokens=new)) for p in prompts],
                       batch_slots=2, max_len=64, prefill_chunk=chunk)
    _same(jres, tres)
    for uid, p in enumerate(prompts, start=1):
        alone = generate(tp, tcfg, p[None, :], max_new_tokens=new)[0, len(p):]
        np.testing.assert_array_equal(tres[uid], alone, err_msg=f"req {uid}")


def test_more_requests_than_slots(model):
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 256, (4 + i,)).astype(np.int32), dict(max_new_tokens=3))
            for i in range(5)]
    jres, tres = _both(model, reqs, batch_slots=2, max_len=64)
    _same(jres, tres)
    assert len(tres) == 5 and all(len(v) == 3 for v in tres.values())


def test_quantized_kv_batching(model):
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, 256, (6,)).astype(np.int32), dict(max_new_tokens=4))]
    jres, tres = _both(model, reqs, batch_slots=2, max_len=64, quantized_kv=True,
                       prefill_chunk=4)
    _same(jres, tres)
    assert len(tres) == 1 and len(list(tres.values())[0]) == 4


def _stepwise(model, build, script):
    """Drive a JAX and a port batcher through the same ``script(eng)``;
    every slot's generated ids must agree after each call it makes."""
    jcfg, jp, tcfg, tp = model
    out = []
    for eng in (JBatcher(jp, jcfg, **build), ContinuousBatcher(tp, tcfg, **build)):
        out.append(script(eng))
    jlog, tlog = out
    assert jlog == tlog


def test_long_prompt_does_not_stall_decode(model):
    """Admission is chunked: while a long prompt prefills, the active slot
    still generates one token per step."""
    def script(eng):
        rng = np.random.default_rng(3)
        log = []
        eng.submit(rng.integers(0, 256, (3,)).astype(np.int32), max_new_tokens=32)
        assert eng.step()                    # short admitted + first decode
        req = eng.slot_req[0]
        n0 = len(req.generated)
        u_long = eng.submit(rng.integers(0, 256, (20,)).astype(np.int32), max_new_tokens=2)
        for i in range(5):                   # 20 tokens = 5 chunks of 4
            assert eng.step()
            assert len(req.generated) == n0 + i + 1, "active slot frozen during admission"
            log.append(list(map(int, req.generated)))
        assert any(r is not None and r.uid == u_long for r in eng.slot_req)
        res = eng.run()
        return log, {u: list(map(int, v)) for u, v in res.items()}

    _stepwise(model, dict(batch_slots=2, max_len=64, prefill_chunk=4), script)


def test_short_admitted_before_long(model):
    """Shortest remaining prompt first: a short prompt never queues behind
    a long one mid-prefill."""
    def script(eng):
        rng = np.random.default_rng(4)
        eng.submit(rng.integers(0, 256, (3,)).astype(np.int32), max_new_tokens=32)
        assert eng.step()                    # slot 0 decoding
        u_long = eng.submit(rng.integers(0, 256, (16,)).astype(np.int32), max_new_tokens=2)
        u_short = eng.submit(rng.integers(0, 256, (4,)).astype(np.int32), max_new_tokens=2)
        assert eng.step()                    # one admission chunk: the short prompt's
        uids = [r.uid for r in eng.slot_req if r is not None]
        assert u_short in uids and u_long not in uids
        res = eng.run()
        assert all(len(res[u]) == 2 for u in (u_long, u_short))
        return {u: list(map(int, v)) for u, v in res.items()}

    _stepwise(model, dict(batch_slots=3, max_len=64, prefill_chunk=4), script)


def test_admission_mini_cache_right_sized(model):
    """A pending mini cache is chunk-rounded to the prompt, not max_len:
    at most 1.25x the prompt's own K/V plus one chunk of rounding."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(6)
    C, T = 4, 18                                        # 5 chunks of 4 -> 20
    toks = rng.integers(0, tcfg.vocab_size, (T,)).astype(np.int32)
    eng = ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=512, quantized_kv=True,
                            prefill_chunk=C)
    uid = eng.submit(toks, max_new_tokens=2)
    eng._start_pending()
    (pend,) = eng.pending.values()
    mini_cols = pend.mini.max_len
    assert mini_cols == -(-T // C) * C
    kv_bytes = lambda c: sum(a.numel() * a.element_size()
                             for a in (c.k, c.v, c.k_scale, c.v_scale) if a is not None)
    per_col = kv_bytes(pend.mini) / mini_cols
    assert kv_bytes(pend.mini) <= 1.25 * T * per_col + C * per_col
    assert mini_cols < eng.max_len
    tres = eng.run()
    jres, _ = _both(model, [(toks, dict(max_new_tokens=2))], batch_slots=2, max_len=512,
                    quantized_kv=True, prefill_chunk=C)
    assert list(tres) == [uid] and len(tres[uid]) == 2
    _same(jres, tres)


def test_warmup_then_serve(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, (10,)).astype(np.int32)
    res = []
    for eng in (JBatcher(jp, jcfg, batch_slots=2, max_len=64, quantized_kv=True,
                         prefill_chunk=8),
                ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=64, quantized_kv=True,
                                  prefill_chunk=8)):
        eng.warmup()
        uid = eng.submit(toks, max_new_tokens=3)
        res.append(eng.run())
        assert list(res[-1]) == [uid] and len(res[-1][uid]) == 3
    _same(*res)
    assert eng.decode_steps == 2          # the first token comes from the prefill


@pytest.mark.parametrize("quantized_kv,acts", [(False, False), (True, True)])
def test_slot_at_max_len_decodes_on(model, quantized_kv, acts):
    """A request that fills the cache retires at ``max_len`` and its slot
    decodes on, inactive, at position ``max_len`` while the other request
    runs: both packages drop that write (float attention over a bf16
    cache; over an int8 cache with int8 acts, the codes path, B4's plain
    version in the port), give the same ids, and the retired slot's
    cache rows stay as they were."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(7)
    short = rng.integers(0, 256, (12,)).astype(np.int32)
    other = rng.integers(0, 256, (5,)).astype(np.int32)
    kw = dict(batch_slots=2, max_len=16, quantized_kv=quantized_kv, prefill_chunk=16)
    qk = dict(qcfg=tbuild(*ACTS_I8)) if acts else {}
    jqk = dict(qcfg=jbuild(*ACTS_I8)) if acts else {}
    j, t = JBatcher(jp, jcfg, **kw, **jqk), ContinuousBatcher(tp, tcfg, **kw, **qk)
    for eng in (j, t):
        eng.submit(short, max_new_tokens=32)
        eng.submit(other, max_new_tokens=10)
    rows, after = None, 0
    while t.step():
        j.step()
        if t.slot_req[0] is None:                      # the short request retired
            if rows is None:
                assert int(t.cache.lengths[0]) == kw["max_len"]
                rows = [getattr(t.cache, n)[:, 0].clone() for n in ("k", "v")]
            after += 1
    assert j.step() is False and after >= 3
    assert all(torch.equal(getattr(t.cache, n)[:, 0], a) for n, a in zip(("k", "v"), rows))
    for eng in (j, t):
        for s in range(2):
            if eng.slot_req[s] is not None:
                eng._retire(s)
    _same(j.finished, t.finished)
    assert len(t.finished[1]) == kw["max_len"] - len(short) and len(t.finished[2]) == 10


def test_tensor_parallel_raises(model):
    _, _, tcfg, tp = model
    with pytest.raises(NotImplementedError, match="item 11"):
        ContinuousBatcher(tp, tcfg, tp_mesh=object())


# ---------------------------------------------------------------------------
# write_slot and the dropped writes, against the JAX functions
# ---------------------------------------------------------------------------

L, B, KV, S, D = 2, 3, 2, 8, 16


def _caches(quantized, seed):
    """The same random cache in both packages' layouts."""
    rng = np.random.default_rng(seed)
    if quantized:
        j = dict(k=rng.integers(-127, 128, (L, B, KV, D, S)).astype(np.int8),
                 v=rng.integers(-127, 128, (L, B, KV, D, S)).astype(np.int8),
                 k_scale=rng.random((L, B, KV, 1, S)).astype(np.float32),
                 v_scale=rng.random((L, B, KV, 1, S)).astype(np.float32))
    else:
        vals = lambda: np.asarray(jnp.asarray(rng.normal(size=(L, B, KV, D, S)), jnp.bfloat16))
        j = dict(k=vals(), v=vals(), k_scale=None, v_scale=None)
    lengths = np.asarray([3, S - 1, S], np.int32)
    jc = jkv.KVCache(**{n: None if a is None else jnp.asarray(a) for n, a in j.items()},
                     lengths=jnp.asarray(lengths), quantized=quantized)
    return jc, tkv.from_jax_layout(**j, lengths=lengths, device="cpu")


def _same_cache(jc, tc):
    t = tkv.to_jax_layout(tc)
    for n in ("k", "v", "k_scale", "v_scale", "lengths"):
        a = getattr(jc, n)
        if a is None:
            assert t[n] is None
            continue
        np.testing.assert_array_equal(t[n], np.asarray(a).astype(t[n].dtype), err_msg=n)


@pytest.mark.parametrize("quantized", [False, True])
def test_write_slot_matches_jax(quantized):
    """A single-slot cache of T rows spliced into slot 1 (and, for the int8
    cache, its scales, as the JAX batcher splices them)."""
    jc, tc = _caches(quantized, 0)
    mj, mt = _caches(quantized, 1)
    T = 5
    sl = lambda a: None if a is None else a[:, :1, ..., :T]
    mj = jkv.KVCache(k=sl(mj.k), v=sl(mj.v), k_scale=sl(mj.k_scale), v_scale=sl(mj.v_scale),
                     lengths=mj.lengths[:1], quantized=quantized)
    jc = jkv.write_slot(jc, 1, mj.k[:, 0], mj.v[:, 0], L)
    if quantized:
        jc = jc.replace(
            k_scale=jax.lax.dynamic_update_slice(jc.k_scale, mj.k_scale[:, 0][:, None],
                                                 (0, 1, 0, 0, 0)),
            v_scale=jax.lax.dynamic_update_slice(jc.v_scale, mj.v_scale[:, 0][:, None],
                                                 (0, 1, 0, 0, 0)))
    m = tkv.KVCache(k=mt.k[:, :1, :, :T], v=mt.v[:, :1, :, :T],
                    k_scale=None if mt.k_scale is None else mt.k_scale[:, :1, :, :T],
                    v_scale=None if mt.v_scale is None else mt.v_scale[:, :1, :, :T],
                    lengths=mt.lengths[:1])
    tkv.write_slot(tc, 1, m.k[:, 0], m.v[:, 0],
                   *((m.k_scale[:, 0], m.v_scale[:, 0]) if quantized else ()))
    _same_cache(jc, tc)
    with pytest.raises(ValueError, match="does not fit"):
        tkv.write_slot(tc, 0, torch.zeros_like(tc.k[:, 0, :, :1]).expand(L, KV, S + 1, D),
                       torch.zeros_like(tc.v[:, 0, :, :1]).expand(L, KV, S + 1, D),
                       *((tc.k_scale[:, 0, :, :1].expand(L, KV, S + 1),) * 2 if quantized
                         else ()))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("T", [1, 3])
def test_append_decode_drops_writes_past_the_cache(quantized, T):
    """Writes at lengths (3, S - 1, S) + [0, T): the ones at S and past it
    are dropped by JAX's scatter and by the port, bitwise the same cache
    (the slot at S - 1 keeps its own write there)."""
    jc, tc = _caches(quantized, 2)
    rng = np.random.default_rng(3)
    k = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    pos = np.asarray(jc.lengths)[:, None] + np.arange(T)[None, :]
    layer = 1
    jc = jax.jit(jkv.append_decode, static_argnums=1)(jc, layer, jnp.asarray(k), jnp.asarray(v),
                                                       jnp.asarray(pos if T > 1 else pos[:, 0]))
    tkv.append_decode(tc, layer, torch.from_numpy(k), torch.from_numpy(v),
                      torch.from_numpy(pos if T > 1 else pos[:, 0]).int())
    _same_cache(jc, tc)


def test_b4_plain_drops_position_past_the_cache():
    """B4's plain version, as the kernel: a slot whose position lies
    outside the cache writes nothing and gets NaN; the others are
    unaffected."""
    g = torch.Generator().manual_seed(1)
    Bq, r, Sq = 2, 4, 32
    q = torch.randn(Bq, KV, r, D, generator=g)
    kc = torch.randint(-127, 128, (Bq, KV, Sq, D), generator=g, dtype=torch.int8)
    vc = torch.randint(-127, 128, (Bq, KV, Sq, D), generator=g, dtype=torch.int8)
    ks, vs = torch.rand(Bq, KV, Sq, generator=g) * 0.02, torch.rand(Bq, KV, Sq, generator=g) * 0.02
    nk, ns = torch.ones((Bq, KV, D), dtype=torch.int8), torch.ones((Bq, KV))
    before = [t.clone() for t in (kc, vc, ks, vs)]
    pos = torch.tensor([Sq, 5], dtype=torch.int32)
    out = tda.decode_attention_append(q, nk, nk, ns, ns, kc, vc, ks, vs, pos, scale=0.125)
    assert bool(out[0].isnan().all()) and bool(out[1].isfinite().all())
    for a, b in zip((kc, vc, ks, vs), before):
        assert torch.equal(a[0], b[0])
    assert bool((kc[1, :, 5] == 1).all()) and bool((ks[1, :, 5] == 1).all())
