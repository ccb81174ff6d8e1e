"""The names and options that close the port's surface against the JAX
package (``tests/test_torch_surface.py`` keeps the two equal), each
against the JAX function on the same numpy inputs.

Tolerances: integer results are bitwise (byte counts, ``is_int``, packed
trees, stacked trees, the clip search's slots, the engine's B4 routing).
``quantize_dequant`` with given scales and zeros is bitwise against
JAX's, which is jitted, for int, fp, MX and NVFP quantizers. The Hessians
and the layer outputs of ``accumulate_hessian`` are within 1e-5 of their
largest entry, ``tests/test_torch_capture.py``'s bound for the same
float32 math summed in another order.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import models as jm
from llm_compressor_tpu import qformats as jq
from llm_compressor_tpu.capture import pipeline as jpipe
from llm_compressor_tpu.qformats import formats as jformats
from llm_compressor_tpu.utils.dataset import synthetic_tokens
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import engine as te
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch import qformats as tq
from llm_compressor_tpu_torch.capture import pipeline as tpipe
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.qformats import formats as tformats
from torch_port_util import (  # noqa: F401
    ALL_VARIANTS,
    ARCHS,
    jax_to_numpy,
    one_torch_thread,
    variant_pair,
)

jawq = importlib.import_module("llm_compressor_tpu.algorithms.awq")
tawq = importlib.import_module("llm_compressor_tpu_torch.algorithms.awq")
tgen = importlib.import_module("llm_compressor_tpu_torch.engine.generate")

W4A8 = ("int4-g[32]-rw", "int8-g[-1]-rw", None, "int8-g[32]-rw")


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _np(a) -> np.ndarray:
    """A JAX array or tensor as numpy: fp8 as its bytes, bf16 as float32."""
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            a = a.view(torch.uint8)
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    if a.dtype.name.startswith("float8"):
        return a.view(np.uint8)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _port_tree(tree):
    """A port params tree as ``jax_to_numpy`` gives a JAX one (fp8 codes as
    bytes; a QTensor as its field dict, without the JAX-only ``dtype``)."""
    if isinstance(tree, tq.QTensor):
        return {"codes": _np(tree.codes), "scales": _np(tree.scales),
                "zeros": None if tree.zeros is None else _np(tree.zeros),
                "shape": tuple(tree.shape), "blocked_shape": tuple(tree.blocked_shape),
                "group_axis": tree.group_axis, "ngroups_axis": tree.ngroups_axis,
                "pair_planes": tree.pair_planes,
                "qspec": tq.config.qspec_string(tree.quantizer)}
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_port_tree(v) for v in tree]
    return _np(tree)


def _assert_same(got, want, path="params"):
    """Leaf by leaf, bitwise; a JAX QTensor's ``dtype`` has no field in the
    port (its leaves carry their dtype)."""
    if isinstance(want, dict):
        want = {k: v for k, v in want.items() if k != "dtype"}
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}.{i}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, _np(want), err_msg=path)
    else:
        assert got == want, (path, got, want)


# ---------------------------------------------------------------------------
# qformats: QTensor.nbytes, ElemFormat.is_int, FP32_EXPONENT_BIAS,
# quantize_dequant(scales=, zeros=)
# ---------------------------------------------------------------------------

NBYTES_SPECS = [f"{f}-g[128]-{zp}rw" for f in ("int4", "int8", "fp4_e2m1", "fp8_e4m3",
                                                 "fp8_e5m2") for zp in ("", "zp-")]


@pytest.mark.parametrize("shape", [(64, 512), (64, 384)], ids=["even_groups", "odd_groups"])
@pytest.mark.parametrize("spec", NBYTES_SPECS)
def test_qtensor_nbytes_matches_jax(spec, shape):
    """Every element format, with and without a zero point, in both int4
    layouts (pair planes at an even group count, group halves at an odd
    one): the port's bytes are JAX's, and they are what the checkpoint
    writes for the tensor (codes, scales, zeros)."""
    x = _x(shape)
    a = jq.quantize_pack(jq.parse_qspec(spec), jnp.asarray(x))
    b = tq.quantize_pack(tq.parse_qspec(spec), torch.from_numpy(x))
    assert b.pair_planes == a.pair_planes == (spec.startswith("int4-") and shape[1] == 512)
    written = sum(_np(t).nbytes for t in (b.codes, b.scales, b.zeros) if t is not None)
    assert b.nbytes == a.nbytes == written


def test_stacked_nbytes_matches_jax():
    """The sum of ``nbytes`` over a fused, stacked W4A8 tree equals JAX's
    (whose transposed ``scales_t`` strip it does not count either)."""
    jcfg, tcfg, jp, _ = variant_pair("llama", 3)
    jqc, tqc = jq.build_quant_config(*W4A8), tq.build_quant_config(*W4A8)
    jalg.rtn(jp, jcfg, jqc, verbose=False)
    jalg.pack_model(jp, jcfg, jqc)
    tp = tm.stack_model(tm.fuse_model(params_from_numpy(jax_to_numpy(jp), "cpu"), tcfg, tqc))
    jp = jm.stack_model(jm.fuse_model(jp, jcfg, jqc))
    jleaves = jax.tree_util.tree_leaves(jp, is_leaf=lambda n: isinstance(n, jq.QTensor))

    def port_leaves(node):
        if isinstance(node, dict):
            return [q for v in node.values() for q in port_leaves(v)]
        return [node] if isinstance(node, tq.QTensor) else []

    got = port_leaves(tp)
    assert len(got) == sum(isinstance(q, jq.QTensor) for q in jleaves) == 5
    assert sum(q.nbytes for q in got) == sum(q.nbytes for q in jleaves
                                             if isinstance(q, jq.QTensor))


def test_elem_format_is_int_and_bias():
    assert tformats.FP32_EXPONENT_BIAS == jformats.FP32_EXPONENT_BIAS == 127
    assert tformats.FP32_MIN_NORMAL == jformats.FP32_MIN_NORMAL
    assert [m.value for m in tformats.ElemFormat] == [m.value for m in jformats.ElemFormat]
    for m in tformats.ElemFormat:
        assert m.is_int == jformats.ElemFormat(m.value).is_int


QDQ_SPECS = ["int4-g[32]-rw", "int4-g[32]-zp-rw", "int8-g[-1]-rw", "fp8_e4m3-g[32]-rw",
             "fp8_e4m3-g[32]-zp-rw", "mxfp4_e2m1-g[32]-rw", "mxint8-g[32]-zp-rw",
             "nvfp4_e2m1-g[16]-rw", "nvfp4_e2m1-g[16]-zp-rw"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", QDQ_SPECS)
def test_quantize_dequant_given_params_bitwise(spec, dtype):
    """With the scales and zeros of ``find_params`` (and with those scales
    times 1.25, which no solve gives) the port equals JAX's jitted
    ``quantize_dequant`` bitwise; the given params are used, not solved
    again."""
    x32 = _x((16, 128), 5)
    jx = jnp.asarray(x32).astype(dtype)
    tx = torch.from_numpy(x32).to(getattr(torch, dtype))
    jqz, tqz = jq.parse_qspec(spec), tq.parse_qspec(spec)
    s, z = (np.array(a) for a in jq.find_params(jqz, jx))
    for scale in (1.0, 1.25):
        js, ts = jnp.asarray(s * scale), torch.from_numpy(s * scale)
        want = jq.quantize_dequant(jqz, jx, js, jnp.asarray(z))
        got = tq.quantize_dequant(tqz, tx, ts, torch.from_numpy(z))
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(_np(got), _np(want))
    solved = tq.quantize_dequant(tqz, tx)
    assert not torch.equal(got, solved)


# ---------------------------------------------------------------------------
# algorithms: pack_model(pack_head=), CLIP_SKIP_SUBSTRINGS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_pack_model_dense_head_matches_jax(arch):
    """RTN W4A8 by the JAX package, handed over, then ``pack_model(...,
    pack_head=False)`` in each: the trees equal leaf by leaf, bitwise, and
    the head is left dense, tied (no ``lm_head`` added) or not."""
    jcfg, tcfg, jp, _ = variant_pair(arch, 4)
    jqc, tqc = jq.build_quant_config(*W4A8), tq.build_quant_config(*W4A8)
    jalg.rtn(jp, jcfg, jqc, verbose=False)
    tp = params_from_numpy(jax_to_numpy(jp), "cpu")
    jalg.pack_model(jp, jcfg, jqc, pack_head=False)
    talg.pack_model(tp, tcfg, tqc, pack_head=False)
    _assert_same(_port_tree(tp), jax_to_numpy(jp))
    assert ("lm_head" in tp) == (not tcfg.tie_word_embeddings)
    head = tp["lm_head" if "lm_head" in tp else "embed"]["weight"]
    assert isinstance(head, torch.Tensor)
    assert isinstance(tp["layers"][0]["attn"]["o"]["weight"], tq.QTensor)


@pytest.mark.parametrize("arch", ["llama", "bloom", "phi"])
def test_clip_skip_substrings(arch, monkeypatch):
    """The port exports JAX's tuple, and its clip search runs on exactly
    the slots the tuple does not name (BLOOM's fused qkv among them)."""
    assert tawq.CLIP_SKIP_SUBSTRINGS == jawq.CLIP_SKIP_SUBSTRINGS
    searched = []
    monkeypatch.setattr(tawq, "_auto_clip",
                        lambda lp, cfg, qcfg, i, slot, *a, **kw: searched.append((i, slot)))
    cfg = tm.tiny_config(arch)
    qcfg = tq.build_quant_config("int4-g[32]-rw", None, None, None)
    p = tm.init_params(cfg, seed=9, device="cpu")
    ctx = tpipe.capture_layer0(p, cfg, synthetic_tokens(4, 16, cfg.vocab_size, 10), chunk=4)
    talg.awq(p, cfg, ctx, qcfg)
    slots = tm.arch_slots(cfg)
    want = [(i, s) for i in range(cfg.num_layers) for s in slots
            if s not in tawq.CLIP_SKIP_SUBSTRINGS]
    assert searched == want
    assert all(tawq._clip_skip(s) == jawq._clip_skip(s) for s in slots)
    assert any(s in tawq.CLIP_SKIP_SUBSTRINGS for s in slots)


# ---------------------------------------------------------------------------
# capture: accumulate_hessian(collect_outputs=)
# ---------------------------------------------------------------------------


def _close(got, want, frac=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=frac * np.abs(want).max())


@pytest.mark.parametrize("name", list(ALL_VARIANTS))
def test_accumulate_hessian_returns_jax_pair(name):
    """(hessians, outs): with ``collect_outputs`` the layer's outputs over
    every chunk, concatenated, within 1e-5 of JAX's, as the Hessians;
    without it, None in the pair."""
    jcfg, tcfg, jp, tp = variant_pair(name, 11)
    toks = synthetic_tokens(6, 16, jcfg.vocab_size, 12)
    jctx = jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks), chunk=4)
    tctx = tpipe.CalibContext(cfg=tcfg, hidden=torch.from_numpy(np.array(jctx.hidden)),
                              positions=torch.from_numpy(np.array(jctx.positions)), chunk=4)
    jH, jouts = jpipe.accumulate_hessian(jctx, jp["layers"][0], 0, jpipe.TAP_KEYS,
                                         collect_outputs=True)
    tH, touts = tpipe.accumulate_hessian(tctx, tp["layers"][0], 0, tpipe.TAP_KEYS,
                                         collect_outputs=True)
    assert set(tH) == set(jH)
    for k in jH:
        _close(tH[k], jH[k])
    assert touts.shape == tuple(jouts.shape) == (6, 16, jcfg.hidden_size)
    _close(touts, jouts)
    want = torch.cat([y for _, _, y, _ in tpipe.run_layer(tctx, tp["layers"][0], 0)], 0)
    assert torch.equal(touts, want)
    H, outs = tpipe.accumulate_hessian(tctx, tp["layers"][0], 0, ("attn_in",))
    assert outs is None and torch.equal(H["attn_in"], tH["attn_in"])


# ---------------------------------------------------------------------------
# models: stack_layers; the engine's attention gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama", "bloom"])
def test_stack_layers_matches_jax(arch):
    """Packed W4A8 layers stacked: every leaf equal to JAX's (its stacked
    QTensors keep the per-layer static fields, as the port's do)."""
    jcfg, tcfg, jp, _ = variant_pair(arch, 14)
    jqc, tqc = jq.build_quant_config(*W4A8), tq.build_quant_config(*W4A8)
    jalg.rtn(jp, jcfg, jqc, verbose=False)
    jalg.pack_model(jp, jcfg, jqc)
    tp = params_from_numpy(jax_to_numpy(jp), "cpu")
    _assert_same(_port_tree(tm.stack_layers(tp)), jax_to_numpy(jm.transformer.stack_layers(jp)))
    assert set(tm.stack_model(tp)) == set(tp) - {"layers"} | {"layers_stacked"}


GATE_CFGS = {a: {} for a in ARCHS} | {"llama_head_dim_24": {"head_dim": 24}}


@pytest.mark.parametrize("name", list(GATE_CFGS))
def test_engine_follows_the_gates(name, monkeypatch):
    """The port's gates in place of JAX's ``append_supported`` /
    ``supported``: a W4A8 decode step over an int8 cache of 40 rows (JAX's
    B4 gate asks S % 128 == 0, and head_dim % 8 == 0, which head dim 24
    meets) runs B4 on every architecture but BLOOM, whose ALiBi keeps its
    scores on the float path, and ``fresh_path_ok`` (the side-block modes)
    says the same for stacked params over that cache."""
    arch = name.split("_")[0]
    cfg = tm.tiny_config(arch, **GATE_CFGS[name])
    qcfg = tq.build_quant_config(*W4A8, head_act="int8-g[-1]-rw")
    p = tm.stack_model(tm.fuse_model(tm.init_params(cfg, seed=15, device="cpu"), cfg, qcfg))
    calls = []
    real = tgen.decode_attention_append
    monkeypatch.setattr(tgen, "decode_attention_append",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    S = 40
    cache = te.init_cache(cfg.num_layers, 2, S, cfg.num_kv_heads, cfg.head_dim, quantized=True,
                          device="cpu")
    toks = torch.from_numpy(np.random.default_rng(16).integers(0, 256, (2, 5)).astype(np.int32))
    logits, cache = te.prefill(p, toks, cache, cfg=cfg, qcfg=qcfg)
    assert not calls
    te.decode_step(p, toks[:, :1], cache, cfg=cfg, qcfg=qcfg)
    assert len(calls) == (0 if arch == "bloom" else cfg.num_layers)
    assert tgen.fresh_path_ok(p, cfg, cache, qcfg) == (arch != "bloom")
