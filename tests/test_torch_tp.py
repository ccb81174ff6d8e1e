"""Tensor-parallel serving against the JAX package (mirrors
``tests/test_tp_shardmap.py``, every case): the port's ranks run in
spawned gloo processes (``parallel/launch.py``, the rank side in
``tests/torch_tp_ranks.py``, which imports no JAX), the JAX package's
single-device and ``shard_map`` runs on this process's 8 virtual CPU
devices. The params are the JAX package's (``init_params`` from the JAX
test's keys), handed over as numpy; the tokens come from the JAX test's
numpy seeds.

The cases of one world size share one spawn (a module fixture), so each
world starts once: 4 ranks for the 2 x 2 and 1 x 4 meshes, 2 for the rest.

Tolerances (JAX's own bounds, ``tests/test_tp_shardmap.py``): the port's
TP logits against JAX's TP and against the port's single-device run,
rtol = atol = 2e-4 for the float32 configs over a float32 cache, 2e-3 for
packed W4A8 and the MPQ stack over an int8 cache; every rank's logits
equal rank 0's bitwise (each gathers the same blocks); batcher ids
bitwise. The spec trees equal JAX's ``PartitionSpec``s leaf for leaf on
the ``tiny_config`` of every architecture, stacked, packed W4A8 and fused
with ``shards=2`` (JAX's ``scales_t`` leaf has no counterpart: the port
keeps no transposed strip). ``_shard_interleave``, ``fuse_model(shards=2)``
and ``_unpair_odd_row_shards`` bitwise against JAX.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import models as jm
from llm_compressor_tpu import parallel as jpar
from llm_compressor_tpu.engine import decode_step as j_step
from llm_compressor_tpu.engine import init_cache as j_init
from llm_compressor_tpu.engine import prefill as j_prefill
from llm_compressor_tpu.engine.batching import ContinuousBatcher as JBatcher
from llm_compressor_tpu.models import transformer as jtr
from llm_compressor_tpu.parallel import tp as jtp
from llm_compressor_tpu.qformats import ElemFormat as JElem
from llm_compressor_tpu.qformats import Quantizer as JQuantizer
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu.qformats import quantize_pack as j_pack
from llm_compressor_tpu.qformats.config import register_4_to_8bit as j_4to8
from llm_compressor_tpu.qformats.qtensor import dequantize as j_dequant
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.convert import params_from_numpy, qtensor_from_numpy
from llm_compressor_tpu_torch.models import transformer as ttr
from llm_compressor_tpu_torch.parallel import launch, tp as ttp
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from llm_compressor_tpu_torch.qformats.qtensor import dequantize as t_dequant
from torch_port_util import (ARCHS, jax_spec_leaves, jax_to_numpy, one_torch_thread,  # noqa: F401
                             port_spec_leaves, tree_copy)
import torch_tp_ranks

W4A8 = ("int4-g[32]-rw", "int8-g[-1]-rw", None, None)
MPQ = ("int4-g[-1]-rw", "int8-g[-1]-rw", None, None)
MPQ_NAMES = [f"layers.{i}.self_attn.q_proj.weight" for i in (0, 1)]
DECODE = [("llama", 2, 2), ("llama", 1, 4), ("qwen2", 2, 2), ("phi", 1, 2), ("bloom", 1, 4)]


def _jax_model(arch, seed, cfg_kw=None, qargs=None, mpq=False, pack=True):
    cfg = jm.tiny_config(arch, dtype="float32", **(cfg_kw or {}))
    params = jm.init_params(cfg, jax.random.PRNGKey(seed))
    qcfg = None
    if qargs is not None:
        qcfg = jbuild(*qargs)
        if mpq:
            qcfg = j_4to8(qcfg, MPQ_NAMES)
        jalg.rtn(params, cfg, qcfg)
        if pack:
            jalg.pack_model(params, cfg, qcfg)
    return cfg, params, qcfg


def _case(kind, arch, seed, n_data=1, n_model=2, cfg_kw=None, qargs=None, mpq=False,
          pack=True, toks_shape=(2, 8), **extra):
    """(the JAX model, the case as the ranks take it)."""
    cfg, params, qcfg = _jax_model(arch, seed, cfg_kw, qargs, mpq, pack)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, toks_shape).astype(np.int32)
    case = dict(kind=kind, arch=arch, cfg=dict(cfg_kw or {}), params=jax_to_numpy(params),
                qargs=qargs, mpq=MPQ_NAMES if mpq else None, n_data=n_data, n_model=n_model,
                toks=toks, quantized_kv=qargs is not None, **extra)
    return (cfg, params, qcfg), case


def _decode_case(arch, n_data, n_model):
    kv = {"num_kv_heads": 4} if n_model == 4 else {}
    return _case("serve", arch, 0, n_data, n_model, cfg_kw=kv, toks_shape=(2 * n_data, 8))


def _cases_2():
    cases = {f"decode-{a}-{d}-{m}": _decode_case(a, d, m) for a, d, m in DECODE if d * m == 2}
    cases["packed"] = _case("serve", "llama", 1, qargs=W4A8, toks_shape=(2, 6))
    cases["gemma2"] = _case("serve", "gemma2", 4)
    cases["mpq"] = _case("serve", "llama", 5, cfg_kw={"num_layers": 4}, qargs=MPQ, mpq=True,
                         pack=False, toks_shape=(2, 6))
    cases["fused"] = _case("serve", "llama", 2, qargs=W4A8, toks_shape=(2, 6), shards=2)
    rng = np.random.default_rng(6)
    cases["batcher"] = _case("batcher", "llama", 6, prompts=[
        rng.integers(0, 256, (n,)).astype(np.int32) for n in (5, 9)])
    cases["refusals"] = _case("refusals", "llama", 0)
    rng = np.random.default_rng(8)
    cases["row_parallel"] = (None, dict(
        kind="row_parallel", qargs=("int4-g[128]-rw", "int8-g[-1]-rw", None, None),
        x=rng.normal(size=(8, 512)).astype(np.float32),
        w=rng.normal(0, 0.05, size=(128, 512)).astype(np.float32),
        bias=rng.normal(0, 0.1, size=(128,)).astype(np.float32)))
    return cases


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    cases = _cases_2()
    res = launch.run(torch_tp_ranks.run_cases, 2, str(tmp_path_factory.mktemp("store")),
                     ({k: c for k, (_, c) in cases.items()},), timeout=300)
    return cases, res


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases = {f"decode-{a}-{d}-{m}": _decode_case(a, d, m) for a, d, m in DECODE if d * m == 4}
    res = launch.run(torch_tp_ranks.run_cases, 4, str(tmp_path_factory.mktemp("store")),
                     ({k: c for k, (_, c) in cases.items()},), timeout=300)
    return cases, res


def _jax_single(model, toks, quantized_kv):
    """JAX's single-device prefill and decode step (``_reference`` of the
    JAX test)."""
    cfg, params, qcfg = model
    params = jm.stack_model(tree_copy(params))
    cache = j_init(cfg.num_layers, toks.shape[0], 16, cfg.num_kv_heads, cfg.head_dim,
                   dtype=jnp.float32, quantized=quantized_kv)
    logits, cache = j_prefill(params, jnp.asarray(toks), cache, cfg=cfg, qcfg=qcfg)
    step, _ = j_step(params, jnp.asarray(toks[:, :1]), cache, cfg=cfg, qcfg=qcfg)
    return np.asarray(logits), np.asarray(step)


def _jax_tp(model, case):
    """JAX's ``shard_map`` prefill and decode step on the case's mesh."""
    cfg, params, qcfg = model
    n_data, n_model, shards = case["n_data"], case["n_model"], case.get("shards", 0)
    mesh = jpar.make_mesh(n_data=n_data, n_model=n_model,
                          devices=jax.devices()[:n_data * n_model])
    params = tree_copy(params)
    if shards:
        params = jm.fuse_model(params, cfg, qcfg, shards=shards)
    sp = jpar.tp_shard_params(jm.stack_model(params), cfg, mesh, fused=bool(shards))
    pre, dec = jpar.tp_serve_fns(sp, cfg, mesh, qcfg=qcfg, fused=bool(shards))
    toks = case["toks"]
    cache = jpar.tp_init_cache(cfg, mesh, toks.shape[0], 16, quantized=case["quantized_kv"],
                               dtype=jnp.float32)
    logits, cache = pre(sp, jnp.asarray(toks), cache)
    step, _ = dec(sp, jnp.asarray(toks[:, :1]), cache)
    return np.asarray(logits), np.asarray(step)


def _check_serve(cases, res, name, tol):
    model, case = cases[name]
    r0 = res[0][name]
    for r in res[1:]:                     # every rank holds the same gathered logits
        for a, b in zip(r[name]["tp"], r0["tp"]):
            np.testing.assert_array_equal(a, b)
    B, KV = case["toks"].shape[0], model[0].num_kv_heads
    assert (r0["cache_batch"], r0["cache_heads"]) == (B // case["n_data"], KV // case["n_model"])
    jtp_out = _jax_tp(model, case)
    jsingle = _jax_single(model, case["toks"], case["quantized_kv"])
    for got, want_tp, want_single, port_single in zip(r0["tp"], jtp_out, jsingle, r0["single"]):
        np.testing.assert_allclose(got, want_tp, rtol=tol, atol=tol)
        np.testing.assert_allclose(got, port_single, rtol=tol, atol=tol)
        np.testing.assert_allclose(port_single, want_single, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch,n_data,n_model", DECODE)
def test_tp_decode_matches_single_device(arch, n_data, n_model, request):
    cases, res = request.getfixturevalue("world4" if n_data * n_model == 4 else "world2")
    _check_serve(cases, res, f"decode-{arch}-{n_data}-{n_model}", 2e-4)


def test_tp_packed_w4a8_matches_single_device(world2):
    """Packed int4 weights, int8 per-token acts (the row-parallel scales
    from the all-reduced absmax) and an int8 KV cache."""
    _check_serve(*world2, "packed", 2e-3)


def test_tp_sliding_window_arch_matches_single_device(world2):
    """Gemma2: sliding windows, softcaps, per-layer ropes and windows."""
    _check_serve(*world2, "gemma2", 2e-4)


def test_tp_mpq_segmented_stack_matches_single_device(world2):
    """An MPQ stack of two runs of layers (``scan_segments``)."""
    assert len(jtr.scan_segments(world2[0]["mpq"][0][0], world2[0]["mpq"][0][2])) == 2
    _check_serve(*world2, "mpq", 2e-3)


def test_tp_interleave_fused_matches_single_device(world2):
    """``fuse_model(shards=2)`` + ``fused=True``: fused q|k|v and gate|up
    (B2's fused path on each rank's own [gate_s | up_s])."""
    _check_serve(*world2, "fused", 2e-3)


def test_tp_continuous_batching_matches_single_device(world2):
    """The TP batcher's ids equal the single-device batchers' (the port's
    and JAX's) and JAX's TP batcher's, bitwise; over gloo ``graph=True``
    raises, in the batcher and in ``tp_serve_fns``."""
    cases, res = world2
    (cfg, params, qcfg), case = cases["batcher"]

    def run(p, tp_mesh=None):
        eng = JBatcher(p, cfg, batch_slots=2, max_len=32, prefill_chunk=8, tp_mesh=tp_mesh)
        for pr in case["prompts"]:
            eng.submit(pr, max_new_tokens=4)
        return eng.run()

    stacked = jm.stack_model(tree_copy(params))
    ref = run(stacked)
    mesh = jpar.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    jtp_ids = run(jpar.tp_shard_params(stacked, cfg, mesh), tp_mesh=mesh)
    for r in res:
        out = r["batcher"]
        assert set(out["tp"]) == set(out["single"]) == set(ref) == set(jtp_ids)
        for uid in ref:
            for got in (out["tp"][uid], out["single"][uid], np.asarray(jtp_ids[uid])):
                np.testing.assert_array_equal(got, np.asarray(ref[uid]))
        assert len(out["graph_errors"]) == 2
        assert all("needs NCCL with a card a rank" in (e or "") for e in out["graph_errors"])


@pytest.mark.parametrize("route", ["B1", "B3", "float"])
def test_row_parallel_matches_single_device(world2, route):
    """A row-parallel projection on each rank's half of the contraction
    dim, through B1's route (a stacked layer), B3's (flat packed weights)
    and the float weight's (int8 fake-quantized acts): the act scale comes
    from the whole row (an all-reduce of the max), so each rank's int8
    codes are the single device's slice and its scale the single device's,
    bitwise; the summed partials plus the bias (added once, after the sum)
    equal the single-device output to float32 sum order, 1e-5 of its
    largest value. An act scale of the local half alone moves it by about
    1e-2."""
    for r in world2[1]:
        got, want = r["row_parallel"][route]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        codes, scale, want_codes, want_scale = r["row_parallel"]["acts"]
        np.testing.assert_array_equal(codes, want_codes)
        np.testing.assert_array_equal(scale, want_scale)


def test_tp_rejects_plain_fused_and_indivisible(world2):
    assert ttp.tp_supported(tm.tiny_config("bloom"), 2)
    assert not ttp.tp_supported(tm.tiny_config("bloom", num_heads=4, num_kv_heads=4), 8)
    for arch, n in (("bloom", 2), ("bloom", 8), ("llama", 2), ("llama", 4), ("gemma", 4)):
        assert ttp.tp_supported(tm.tiny_config(arch), n) == jtp.tp_supported(
            jm.tiny_config(arch), n)
    for r in world2[1]:
        out = r["refusals"]
        assert "fuse_model(shards=n_model)" in out["plain_fused"]
        assert "fuse_model(shards=n_model)" in out["plain_fused_serve"]
        assert "not TP-shardable" in out["indivisible"]
    cfg = tm.tiny_config("llama")
    p = tm.stack_model(tm.fuse_model(tm.init_params(cfg, device="cpu"), cfg))
    with pytest.raises(ValueError, match="shards=n_model"):
        ttp.tp_param_specs(p, 2)


def test_pair_planes_unpair_on_odd_row_shard():
    """Pair-planes int4 in a row-parallel slot whose per-shard group count
    would be odd goes to group halves (bitwise JAX's bytes, the same
    values); even splits and column slots keep their pair planes."""
    rng = np.random.default_rng(0)
    q = JQuantizer(qtype="int", fmt=JElem.int4, group_size=32)
    W = rng.normal(0, 0.1, size=(64, 192)).astype(np.float32)   # G = 6
    jqt = j_pack(q, jnp.asarray(W))
    qt = qtensor_from_numpy(jax_to_numpy(jqt), "cpu")
    assert qt.pair_planes
    tree = {"mlp": {"down": {"weight": qt}, "up": {"weight": qt}}}
    jtree = {"mlp": {"down": {"weight": jqt}, "up": {"weight": jqt}}}
    assert ttp._unpair_odd_row_shards(tree, 3)["mlp"]["down"]["weight"].pair_planes
    out2 = ttp._unpair_odd_row_shards(tree, 2)
    conv = out2["mlp"]["down"]["weight"]
    assert not conv.pair_planes and out2["mlp"]["up"]["weight"].pair_planes
    jconv = jtp._unpair_odd_row_shards(jtree, 2)["mlp"]["down"]["weight"]
    np.testing.assert_array_equal(conv.codes.numpy(), np.asarray(jconv.codes))
    np.testing.assert_array_equal(t_dequant(conv).numpy(), np.asarray(j_dequant(jqt)))
    layers = {"layers": [tree, tree]}        # the unstacked form as well
    assert not ttp._unpair_odd_row_shards(layers, 2)["layers"][1]["mlp"]["down"][
        "weight"].pair_planes


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_shard_interleave_matches_jax(shards):
    rng = np.random.default_rng(shards)
    arrs = [rng.normal(size=(n, 3)).astype(np.float32) for n in (8, 4, 4)]
    got = ttr._shard_interleave([torch.from_numpy(a) for a in arrs], shards)
    want = jtr._shard_interleave([jnp.asarray(a) for a in arrs], shards)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _leaves(tree, path=()):
    """(path, tensor) pairs of a port params tree, QTensors by field."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif hasattr(tree, "codes"):
        for f in ("codes", "scales", "zeros"):
            if getattr(tree, f) is not None:
                yield path + (f,), getattr(tree, f)
    elif tree is not None:
        yield path, tree


@pytest.mark.parametrize("arch,qargs", [("llama", W4A8), ("qwen2", None), ("phi", None)])
def test_fuse_model_shards_matches_jax(arch, qargs):
    """``fuse_model(shards=2)``: every fused leaf (codes, scales, weights,
    Qwen2's and Phi's biases) bitwise JAX's, with its shapes."""
    cfg, jp, jq = _jax_model(arch, 3, qargs=qargs)
    tcfg = tm.tiny_config(arch)
    tq = None if qargs is None else tbuild(*qargs)
    tp = ttr.fuse_model(params_from_numpy(jax_to_numpy(jp), "cpu"), tcfg, tq, shards=2)
    jf = jax_to_numpy(jm.fuse_model(jp, cfg, jq, shards=2))
    want = dict(_leaves(params_from_numpy(jf, "cpu")))
    got = dict(_leaves(tp))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=str(k))
    lp = tp["layers"][0]
    if qargs is not None:
        jw = jf["layers"][0]["attn"]["qkv_cat"]["weight"]
        assert lp["attn"]["qkv_cat"]["weight"].shape == tuple(jw["shape"])
        assert lp["attn"]["qkv_cat"]["weight"].blocked_shape == tuple(jw["blocked_shape"])
    with pytest.raises(ValueError, match="not divisible by shards=3"):
        ttr.fuse_model(params_from_numpy(jax_to_numpy(_jax_model(arch, 3)[1]), "cpu"), tcfg,
                       shards=3)


def _same_specs(port_tree, jax_tree):
    port, want = port_spec_leaves(port_tree), jax_spec_leaves(jax_tree)
    strips = {k for k in want if k[-1] == "scales_t"}
    assert {k[:-1] + ("scales",) for k in strips} <= set(port)
    want = {k: v for k, v in want.items() if k not in strips}
    assert port == want


@pytest.mark.parametrize("arch", ARCHS + ("llama_w4a8",))
def test_tp_param_specs_match_jax(arch):
    """``tp_param_specs`` of the stacked params and of ``fuse_model(shards=2)``
    params (``fused=True``) leaf for leaf against JAX's, at 2 shards."""
    a = arch.split("_")[0]
    qargs = W4A8 if arch.endswith("w4a8") else None
    cfg, jp, jq = _jax_model(a, 7, qargs=qargs)
    tp = params_from_numpy(jax_to_numpy(jp), "cpu")
    tcfg, tq = tm.tiny_config(a), None if qargs is None else tbuild(*qargs)
    _same_specs(ttp.tp_param_specs(tm.stack_model(tp), 2),
                jtp.tp_param_specs(jm.stack_model(tree_copy(jp)), 2))
    _same_specs(
        ttp.tp_param_specs(tm.stack_model(ttr.fuse_model(tp, tcfg, tq, shards=2)), 2, fused=True),
        jtp.tp_param_specs(jm.stack_model(jm.fuse_model(jp, cfg, jq, shards=2)), 2, fused=True))


def test_tp_cache_specs():
    """The cache specs name the same axes as JAX's, on the port's (L, B,
    KV, S, D) layout (JAX: (L, B, KV, D, S) with (L, B, KV, 1, S) scales)."""
    from llm_compressor_tpu_torch.engine import init_cache

    c = init_cache(2, 2, 8, 2, 16, quantized=True, device="cpu")
    s, b = ttp.tp_cache_specs(c), ttp.tp_batch_cache_specs(c)
    assert (s.k, s.k_scale, s.lengths) == ((None, "data", "model", None, None),
                                           (None, "data", "model", None), ("data",))
    assert (b.v, b.v_scale, b.lengths) == ((None, None, "model", None, None),
                                           (None, None, "model", None), ())
    jc = j_init(2, 2, 8, 2, 16, quantized=True)
    assert tuple(jtp.tp_cache_specs(jc).k)[:3] == s.k[:3]
    assert tuple(jtp.tp_batch_cache_specs(jc).k)[:3] == b.k[:3]
    assert ttp.tp_cache_specs(init_cache(2, 2, 8, 2, 16, device="cpu")).k_scale is None
