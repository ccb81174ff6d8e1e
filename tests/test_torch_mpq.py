"""Mixed precision (MPQ) against the JAX package: the override registry
(``register_4_to_8bit``, ``register_8_to_4bit``, ``register_org_config``),
the runs of equal layers (``scan_segments``, ``uniform_layers``,
``quant_uniform``) and the side-block eligibility that walks them, and a
two-class model served in both packages.

Tolerances: override tables, resolved quantizers, runs and eligibility
equal. The two-class model (W4A8 with two layers promoted to int8 weights,
an int8 KV cache): prefill and decode logits within rtol = atol = 2e-4 of
the JAX package's per-layer (unstacked) run, the bound
``tests/test_scan_layers.py:107-147`` holds JAX's own stacked run to; the
same greedy tokens.
"""

from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import models as jm
from llm_compressor_tpu import qformats as jq
from llm_compressor_tpu.engine import decode_step as j_step
from llm_compressor_tpu.engine import init_cache as j_init
from llm_compressor_tpu.engine import prefill as j_prefill
from llm_compressor_tpu.engine.generate import fresh_path_ok as j_fresh_ok
from llm_compressor_tpu.models import transformer as jtr
from llm_compressor_tpu.qformats import config as jconf
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import engine as te
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch import qformats as tq
from llm_compressor_tpu_torch.algorithms.common import get_weight
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.engine.generate import fresh_path_ok as t_fresh_ok
from llm_compressor_tpu_torch.qformats import config as tconf
from torch_port_util import jax_to_numpy, one_torch_thread  # noqa: F401

W4A8 = ("int4-g[128]-rw", "int8-g[-1]-rw", None, "int8-g[128]-rw")
LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
           "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def _qz(q) -> tuple:
    """A quantizer of either package as comparable fields."""
    return (q.qtype, None if q.fmt is None else q.fmt.value, q.group_size, q.axes,
            q.zero_point, q.mse, q.scale_ebits)


def _op(o) -> tuple:
    return tuple(_qz(getattr(o, s)) for s in ("weight", "act_in", "act_out"))


def _assert_same_config(a, b):
    for slot in ("linear", "matmul", "head"):
        assert _op(getattr(a, slot)) == _op(getattr(b, slot)), slot
    assert list(a.overrides) == list(b.overrides)
    for k in a.overrides:
        assert _op(a.overrides[k]) == _op(b.overrides[k]), k


BASES = {
    "w4a8": (W4A8, {}),
    "w4a8_mse": (W4A8, {"w_mse": True}),
    "fp4_fp8": (("fp4_e2m1-g[32]-rw", "fp8_e4m3-g[-1]-rw", "fp8_e4m3-g[-1]-rw", None), {}),
    "mx_nvfp4": (("mxint4-g[32]-rw", "nvfp4_e2m1-g[16]-rw", None, "int8-g[128]-rw"), {}),
    "int8_zp": (("int8-g[64]-zp-rw", "int4-g[32]-zp-cw", None, None), {}),
}
WEIGHT_NAMES = ["layers.0.self_attn.q_proj.weight", "layers.3.mlp.down_proj.weight",
                "layers.0.self_attn.q_proj.weight", "layers.1.mlp.up_proj.input",
                "lm_head.weight", "layers.2.self_attn.k_proj.bias", "layers.2.mlp.gate_proj"]
ACT_NAMES = ["layers.1.mlp.up_proj.input", "layers.1.mlp.up_proj.output",
             "layers.0.self_attn.q_proj.input", "layers.2.self_attn.qk_matmul.input",
             "layers.3.self_attn.sv_matmul.output", "layers.0.self_attn.q_proj.weight",
             "layers.2.mlp.down_proj"]
ORG_NAMES = ["layers.3.self_attn.sv_matmul.input", "layers.0.mlp.down_proj.input",
             "layers.1.mlp.up_proj.output", "layers.2.self_attn.o_proj.weight"]


@pytest.mark.parametrize("base", list(BASES))
def test_register_functions_match(base):
    """The three registry functions, chained, give equal override tables
    and resolve every op alike."""
    args, kw = BASES[base]
    a, b = jq.build_quant_config(*args, **kw), tq.build_quant_config(*args, **kw)
    _assert_same_config(a, b)
    for name in ("register_4_to_8bit", "register_8_to_4bit", "register_org_config"):
        names = {"register_4_to_8bit": WEIGHT_NAMES, "register_8_to_4bit": ACT_NAMES,
                 "register_org_config": ORG_NAMES}[name]
        a, b = getattr(jq, name)(a, names), getattr(tq, name)(b, names)
        _assert_same_config(a, b)
    ops = [f"layers.{i}.{n}" for i in range(4) for n in LINEARS] + \
          [f"layers.{i}.self_attn.{m}_matmul" for i in range(4) for m in ("qk", "sv")]
    for op in ops:
        cls = "matmul" if "matmul" in op else "linear"
        assert _op(a.for_op(op, cls)) == _op(b.for_op(op, cls)), op
    assert _op(a.for_op("lm_head", "head")) == _op(b.for_op("lm_head", "head"))
    assert hash(b) == hash(replace(b, overrides=dict(b.overrides)))


@pytest.mark.parametrize("spec", [None, "int4-g[128]-rw", "int8-g[-1]-zp-cw", "fp4_e2m1-g[32]-rw",
                                  "fp8_e4m3-g[128]-rw", "fp8_e5m2-g[-1]-rw",
                                  "mxint4-g[32]-rw", "mxfp8_e4m3-g[32]-rw",
                                  "nvfp4_e2m1-g[16]-rw"])
def test_bump_formats_match(spec):
    """Up and down a format in both packages; NVFP4 has no 8-bit element
    format, and both refuse to promote it."""
    a, b = jq.parse_qspec(spec, mse=True), tq.parse_qspec(spec, mse=True)
    for bump in ("_bump_fmt_up", "_bump_fmt_down"):
        try:
            want = _qz(getattr(jconf, bump)(a))
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                getattr(tconf, bump)(b)
        else:
            assert _qz(getattr(tconf, bump)(b)) == want


PLANS = {
    "none": lambda c, m: c,
    "first_two": lambda c, m: m.register_4_to_8bit(
        c, [f"layers.{i}.self_attn.q_proj.weight" for i in (0, 1)]),
    "first_and_last": lambda c, m: m.register_4_to_8bit(
        c, [f"layers.{i}.{n}.weight" for i in (0, 5) for n in LINEARS]),
    "alternating": lambda c, m: m.register_4_to_8bit(
        c, [f"layers.{i}.mlp.down_proj.weight" for i in (0, 2, 4)]),
    "acts": lambda c, m: m.register_8_to_4bit(c, ["layers.3.mlp.up_proj.input"]),
    "attention_off": lambda c, m: m.register_org_config(
        c, ["layers.2.self_attn.sv_matmul.input"]),
    "same_as_base": lambda c, m: m.register_org_config(c, ["layers.1.mlp.up_proj.output"]),
}


@pytest.mark.parametrize("plan", list(PLANS))
def test_scan_segments_match(plan):
    """The runs of equal layers, ``uniform_layers`` / ``quant_uniform``, and
    the side-block eligibility that walks the runs, as in the JAX package."""
    jcfg, tcfg = jm.tiny_config("llama", num_layers=6), tm.tiny_config("llama", num_layers=6)
    a = PLANS[plan](jq.build_quant_config(*W4A8, head_act="int8-g[-1]-rw"), jq)
    b = PLANS[plan](tq.build_quant_config(*W4A8, head_act="int8-g[-1]-rw"), tq)
    ja, tb = jtr.scan_segments(jcfg, a), tm.scan_segments(tcfg, b)
    assert [(s0, s1) for s0, s1, _ in ja] == [(s0, s1) for s0, s1, _ in tb]
    for (_, _, oa), (_, _, ob) in zip(ja, tb):
        assert tuple((s, _op(o)) for s, o in oa.linears
                     if s in tm.transformer.arch_slots(tcfg)) == \
            tuple((s, _op(o)) for s, o in ob.linears)
        assert (_op(oa.qk), _op(oa.sv)) == (_op(ob.qk), _op(ob.sv))
    assert jtr.uniform_layers(jcfg, a) == tm.uniform_layers(tcfg, b)
    assert jtr.quant_uniform(jcfg, a) == tm.quant_uniform(tcfg, b)
    assert [(s0, s1) for s0, s1, _ in tm.scan_segments(tcfg, None)] == [(0, 6)]
    # eligibility of the side-block decode, on stacked dense params
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.stack_model(params_from_numpy(jax_to_numpy(jp), "cpu"))
    jp = jm.stack_model(jp)
    for quantized in (False, True):
        jc = j_init(6, 1, 8, jcfg.num_kv_heads, jcfg.head_dim, quantized=quantized)
        tc = te.init_cache(6, 1, 8, tcfg.num_kv_heads, tcfg.head_dim, quantized=quantized,
                           device="cpu")
        assert j_fresh_ok(jp, jcfg, jc, a) == t_fresh_ok(tp, tcfg, tc, b)


CFG = dict(hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2, head_dim=32,
           num_layers=4)
B, T, STEPS, MAX_LEN = 2, 6, 3, 16


@pytest.fixture(scope="module")
def two_class():
    """W4A8 with every linear of layers 0 and 3 promoted to int8 weights,
    RTN in each package from the same weights; the JAX package serves its
    model per layer (unstacked), packed and unpacked."""
    jcfg, tcfg = jm.tiny_config("llama", **CFG), tm.tiny_config("llama", **CFG)
    names = [f"layers.{i}.{n}.weight" for i in (0, 3) for n in LINEARS]
    jqc = jq.register_4_to_8bit(jq.build_quant_config(*W4A8, head_act="int8-g[-1]-rw"), names)
    tqc = tq.register_4_to_8bit(tq.build_quant_config(*W4A8, head_act="int8-g[-1]-rw"), names)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(11))
    tp = params_from_numpy(jax_to_numpy(jp), "cpu")
    jalg.rtn(jp, jcfg, jqc, verbose=False)
    talg.rtn(tp, tcfg, tqc)
    toks = np.random.default_rng(12).integers(0, jcfg.vocab_size, (B, T + STEPS)).astype(np.int32)

    def j_run(p):
        cache = j_init(4, B, MAX_LEN, jcfg.num_kv_heads, jcfg.head_dim, quantized=True)
        logits, cache = j_prefill(p, jnp.asarray(toks[:, :T]), cache, cfg=jcfg, qcfg=jqc)
        out = [np.asarray(logits)]
        for t in range(T, T + STEPS):
            logits, cache = j_step(p, jnp.asarray(toks[:, t:t + 1]), cache, cfg=jcfg, qcfg=jqc)
            out.append(np.asarray(logits))
        return np.stack(out)

    dense_ref = j_run(jp)
    jalg.pack_model(jp, jcfg, jqc)
    return dict(tcfg=tcfg, tqc=tqc, tp=tp, toks=toks, dense_ref=dense_ref,
                packed_ref=j_run(jp), jpacked=jp)


def _t_run(r, p):
    tcfg, tqc, toks = r["tcfg"], r["tqc"], r["toks"]
    cache = te.init_cache(4, B, MAX_LEN, tcfg.num_kv_heads, tcfg.head_dim, quantized=True,
                          device="cpu")
    logits, cache = te.prefill(p, torch.from_numpy(toks[:, :T]), cache, cfg=tcfg, qcfg=tqc)
    out = [logits.numpy()]
    for t in range(T, T + STEPS):
        logits, cache = te.decode_step(p, torch.from_numpy(toks[:, t:t + 1]), cache, cfg=tcfg,
                                       qcfg=tqc)
        out.append(logits.numpy())
    return np.stack(out)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("form", ["unstacked", "stacked", "fused_stacked"])
def test_two_class_dense_matches_jax(two_class, form):
    """The fake-quantized two-class model, per layer or stacked (dense
    weights stack whatever their quantizers), against JAX per layer."""
    r = two_class
    p = _clone(r["tp"])
    if form == "fused_stacked":
        p = tm.fuse_model(p, r["tcfg"], r["tqc"])
    if form != "unstacked":
        p = tm.stack_model(p)
    got = _t_run(r, p)
    np.testing.assert_allclose(got, r["dense_ref"], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got.argmax(-1), r["dense_ref"].argmax(-1))


@pytest.mark.parametrize("fused", [False, True])
def test_two_class_packed_matches_jax(two_class, fused):
    """The packed two-class model (int4 and int8 codes) per layer, fused or
    not, against the JAX package's packed model per layer; the codes and
    scales of every linear equal the JAX package's bitwise, and the layers
    do not stack."""
    r = two_class
    p = _clone(r["tp"])
    talg.pack_model(p, r["tcfg"], r["tqc"])
    for i, lp in enumerate(p["layers"]):
        want_fmt = "int8" if i in (0, 3) else "int4"
        for s in ("q", "k", "v", "o", "gate", "up", "down"):
            qt = get_weight(lp, s)
            jw = get_weight(r["jpacked"]["layers"][i], s)
            assert qt.fmt.value == want_fmt
            np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(jw.codes))
            np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(jw.scales))
    if fused:
        p = tm.fuse_model(p, r["tcfg"], r["tqc"])
        assert "qkv_cat" in p["layers"][0]["attn"] and "gateup" in p["layers"][3]["mlp"]
    got = _t_run(r, p)
    np.testing.assert_allclose(got, r["packed_ref"], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got.argmax(-1), r["packed_ref"].argmax(-1))
    with pytest.raises(ValueError, match="MPQ"):
        tm.stack_model(p)
    assert not t_fresh_ok(p, r["tcfg"], te.init_cache(4, 1, 8, 2, 32, quantized=True,
                                                      device="cpu"), r["tqc"])


def test_two_class_packed_greedy_graphless(two_class):
    """``decode_greedy_steps`` over the unstacked packed model gives the
    tokens of the per-step loop (the in-place attention path, B4's plain
    version here)."""
    r = two_class
    p = tm.fuse_model(_clone(r["tp"]), r["tcfg"], r["tqc"])
    talg.pack_model(p, r["tcfg"], r["tqc"])
    tcfg, tqc, toks = r["tcfg"], r["tqc"], torch.from_numpy(r["toks"][:, :T])
    caches = [te.init_cache(4, B, MAX_LEN, 2, 32, quantized=True, device="cpu") for _ in "ab"]
    logits, _ = te.prefill(p, toks, caches[0], cfg=tcfg, qcfg=tqc)
    te.prefill(p, toks, caches[1], cfg=tcfg, qcfg=tqc)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    got, _ = te.decode_greedy_steps(p, tok, caches[0], n=STEPS, cfg=tcfg, qcfg=tqc)
    want = []
    for _ in range(STEPS):
        lg, _ = te.decode_step(p, tok, caches[1], cfg=tcfg, qcfg=tqc)
        tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
        want.append(tok)
    assert torch.equal(got, torch.cat(want, 1))
    assert torch.equal(caches[0].k, caches[1].k) and torch.equal(caches[0].v, caches[1].v)
