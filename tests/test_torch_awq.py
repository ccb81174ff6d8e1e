"""The port's AWQ and AWQ+ against the JAX package's, on every
architecture's ``tiny_config`` where JAX runs them (Gemma-1 raises in
both), with the same float32 weights, norms and biases, W4A8 quantizers
(int4-g32 weights, int8 per-token activations) and 4 x 32 calibration
tokens.

* ``scale_pairs``: equal on every architecture, with and without GQA.
* The scale search, pair by pair on layer 0, both packages fed the same
  features and the same layer: every grid point's loss within 1e-3 of
  JAX's (relative; the inspected modules' int8 activation codes may flip
  where float32 sums run in another order; measured at most 3.0e-4,
  BLOOM), its scales within 4e-7 of JAX's (relative: the channel mean
  sums in another order, the power is ``common.fpow``, within an ulp of
  XLA's; measured 3.3e-7, and a quarter of the entries off by ulps).
  The port's chosen grid point is JAX's, or ties with it in JAX's own
  objective within 1e-6 (relative: the MSE-tie rule of
  ``tests/test_torch_formats.py``). ``_apply_scale`` with the same
  scales is bitwise.
* The clip search on one weight against the jitted JAX
  ``_clip_search_chunk``: the chosen maxima bitwise, which holds the
  shrunk maxima ``org_max * (1 - i/20)`` bitwise (XLA computes the factor
  as one fused multiply-add, ``awq._shrink``), except a group whose two
  errors tie in JAX's own objective within 1e-6.
* The whole AWQ, teacher-forced layer by layer (its taps, searches and
  clips recorded): a layer's inputs within 1e-3 of JAX's ``advance`` of
  the layer before through its ORIGINAL weights (1e-5 for layer 0 against
  JAX's capture); its taps within 1e-5 (``attn_in``) or 5e-3 of JAX's
  ``layer_taps`` (one-step int8 activation flips ahead of the tap; after
  OPT's relu fc1 measured 3.2e-3 of the largest entry); each search and
  clip on the port's features and layer
  against JAX's functions by the rules above; then JAX's steps applying
  the port's choices give the port's AWQ'd layer bitwise.
* AWQ+: its AWQ stage as above, its GPTQ stage by
  ``torch_port_util.check_gptq_chain``.
* Mirrors of ``tests/test_pack_equiv.py::test_awq_pack_lossless``,
  ``tests/test_algorithms.py`` (``test_awq``, ``test_awq_plus``) and
  ``tests/test_algorithms_archs.py`` (``test_awq_per_arch``,
  ``test_awq_gemma1_unsupported``), on the port.
"""

import contextlib
import importlib
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu.algorithms import common as jcommon
from llm_compressor_tpu.capture import pipeline as jpipe
from llm_compressor_tpu.models import layer_ops as j_layer_ops
from llm_compressor_tpu.models.transformer import arch_slots
from llm_compressor_tpu.models.transformer import make_causal_mask as j_mask
from llm_compressor_tpu.models.transformer import rope_for_layer as j_rope
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu.qformats import parse_qspec as jparse
from llm_compressor_tpu.qformats.quantize import quantize_dequant as j_qdq
from llm_compressor_tpu.utils.dataset import synthetic_tokens
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.capture import pipeline as tpipe
from llm_compressor_tpu_torch.models import layer_ops as t_layer_ops
from llm_compressor_tpu_torch.models.transformer import make_causal_mask as t_mask
from llm_compressor_tpu_torch.models.transformer import rope_for_layer as t_rope
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from llm_compressor_tpu_torch.qformats import dequantize, quantize_dequant
from llm_compressor_tpu_torch.qformats import parse_qspec as tparse
from torch_port_util import (  # noqa: F401
    ALL_VARIANTS,
    assert_same_tree,
    check_gptq_chain,
    clone_tree,
    one_torch_thread,
    recording_gptq_chain,
    rel_err,
    to_jax,
    variant_pair,
)

jawq = importlib.import_module("llm_compressor_tpu.algorithms.awq")
tawq = importlib.import_module("llm_compressor_tpu_torch.algorithms.awq")
W4A8 = ("int4-g[32]-rw", "int8-g[-1]-rw", None, "int8-g[32]-rw")
NAMES = [n for n in ALL_VARIANTS if n != "gemma"]






@pytest.mark.parametrize("name", list(ALL_VARIANTS))
@pytest.mark.parametrize("kv", [2, 4])
def test_scale_pairs_match_jax(name, kv):
    """kv 4 = the 4 query heads: v and o square, so a v -> o pair where
    the family has one."""
    jcfg, tcfg, jp, tp = variant_pair(name, 0, num_kv_heads=kv)
    if name == "gemma":
        for fn, cfg, lp in ((jawq.scale_pairs, jcfg, jp), (tawq.scale_pairs, tcfg, tp)):
            with pytest.raises(NotImplementedError):
                fn(cfg, lp["layers"][0])
        return
    want = [tuple(vars(p).values()) for p in jawq.scale_pairs(jcfg, jp["layers"][0])]
    got = [tuple(vars(p).values()) for p in tawq.scale_pairs(tcfg, tp["layers"][0])]
    assert got == want and got


def _jax_scale_losses(jcfg, lp, ops, pair, x, cos, sin, mask, quantizers, n_grid=20):
    """JAX's own objective: ``awq._search_scale``'s loop, every point kept."""
    x_mean = jnp.mean(jnp.abs(x.astype(jnp.float32).reshape(-1, x.shape[-1])), axis=0)
    org = jawq._inspect_out(jcfg, lp, ops, pair.inspect, pair.slots[0], x, cos, sin, mask)
    losses, scales = [], []
    for r in range(n_grid):
        s = jnp.clip(x_mean ** (r / n_grid), 1e-4, None)
        s = s / jnp.sqrt(jnp.max(s) * jnp.min(s))
        lp_s = jawq._with_scaled_weights(lp, jcfg, pair.slots, s, quantizers)
        out = jawq._inspect_out(jcfg, lp_s, ops, pair.inspect, pair.slots[0], x, cos, sin, mask)
        losses.append(float(jnp.mean((org.astype(jnp.float32) - out.astype(jnp.float32)) ** 2)))
        scales.append(np.asarray(s))
    return losses, scales


def _first_min(losses):
    return min(range(len(losses)), key=lambda r: (losses[r], r))


def _check_search(jcfg, tcfg, jlp, tlp, i, pair, x_np, positions, jq, tq):
    """One pair's search on the same features and layer; returns the port's
    chosen scales (numpy)."""
    jops, tops = j_layer_ops(jcfg, jq, i), t_layer_ops(tcfg, tq, i)
    n = x_np.shape[0]
    jpos, tpos = jnp.asarray(positions[:n]), torch.from_numpy(np.array(positions[:n]))
    jcs, tcs = j_rope(jcfg, i, jpos), t_rope(tcfg, i, tpos)
    jm_, tm_ = j_mask(jcfg, i, jpos, jpos), t_mask(tcfg, i, tpos, tpos)
    jqz = {s: jcommon.weight_quantizer_for(jcfg, jq, i, s, False) for s in arch_slots(jcfg)}
    tqz = {s: talg.common.weight_quantizer_for(tcfg, tq, i, s, False) for s in arch_slots(jcfg)}
    x_np = np.array(x_np)
    jl, js = _jax_scale_losses(jcfg, jlp, jops, pair, jnp.asarray(x_np), *jcs, jm_, jqz)
    grid = tawq._scale_grid(tcfg, tlp, tops, pair, torch.from_numpy(x_np), *tcs, tm_, tqz)
    tl = [g[0] for g in grid]
    rj, rt = _first_min(jl), _first_min(tl)
    np.testing.assert_array_equal(np.asarray(jawq._search_scale(
        jcfg, jlp, jops, pair, jnp.asarray(x_np), *jcs, jm_, jqz)), js[rj])
    for r in range(len(jl)):
        assert abs(tl[r] - jl[r]) <= 1e-3 * abs(jl[r]), (pair, r, tl[r], jl[r])
        assert rel_err(grid[r][1].numpy(), js[r]) <= 4e-7, (pair, r)
    assert rt == rj or abs(jl[rt] - jl[rj]) <= 1e-6 * jl[rj], (pair, rt, rj, jl)
    chosen = tawq._search_scale(tcfg, tlp, tops, pair, torch.from_numpy(x_np), *tcs, tm_, tqz)
    assert torch.equal(chosen, grid[rt][1])
    return chosen.numpy()


@pytest.mark.parametrize("name", NAMES)
def test_search_and_apply_scale_match_jax(name):
    """Layer 0, pair by pair in order, both fed JAX's features; the port's
    scales then fold into both layers (bitwise equal afterwards) and
    divide both packages' cached features, as ``awq`` does."""
    jcfg, tcfg, jp, tp = variant_pair(name, 5)
    jq, tq = jbuild(*W4A8), tbuild(*W4A8)
    toks = synthetic_tokens(4, 32, jcfg.vocab_size, 6)
    jctx = jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks), chunk=2)
    jlp, tlp = jp["layers"][0], tp["layers"][0]
    pairs = jawq.scale_pairs(jcfg, jlp)
    keys = tuple(dict.fromkeys([p.tap for p in pairs]
                               + [jcommon.slot_tap(s) for s in arch_slots(jcfg)]))
    feats = {k: np.asarray(v) for k, v in
             jpipe.layer_taps(jctx, jlp, 0, j_layer_ops(jcfg, jq, 0), keys).items()}
    positions = np.asarray(jctx.positions)
    for pair in pairs:
        s = _check_search(jcfg, tcfg, jlp, tlp, 0, pair, feats[pair.tap], positions, jq, tq)
        jawq._apply_scale(jlp, jcfg, pair, jnp.asarray(s))
        tawq._apply_scale(tlp, tcfg, pair, torch.from_numpy(s))
        assert_same_tree(tlp, jlp)
        for slot in pair.slots:
            k = jcommon.slot_tap(slot)
            feats[k] = (feats[k].astype(np.float32) / s).astype(feats[k].dtype)


def _jax_clip_err(w, xg, i, quantizer, n_grid=20):
    """JAX's own clip objective at grid point ``i`` (a traced int, as in
    its ``fori_loop``)."""
    w32, x32 = w.astype(jnp.float32), xg.astype(jnp.float32)
    org_max = jnp.max(jnp.abs(w32), axis=-1, keepdims=True)
    org_out = jnp.einsum("tgc,ogc->otg", x32, w32)
    mv = org_max * (1.0 - i.astype(jnp.float32) / n_grid)
    cur = jnp.einsum("tgc,ogc->otg", x32, j_qdq(quantizer, jnp.clip(w32, -mv, mv)))
    return jnp.mean((cur - org_out) ** 2, axis=1)


_jax_clip_err_jit = jax.jit(_jax_clip_err, static_argnames=("quantizer", "n_grid"))


def _check_clip(w, xg, spec, got):
    """``got``: the port's best maxima (oc, n_g) for ``w`` (oc, n_g, g)."""
    q = jparse(spec)
    want = np.asarray(jawq._clip_search_chunk(jnp.asarray(w), jnp.asarray(xg), quantizer=q))
    differ = got != want
    if differ.any():
        org_max = np.abs(w).max(-1)
        errs = np.stack([np.asarray(_jax_clip_err_jit(jnp.asarray(w), jnp.asarray(xg),
                                                      jnp.int32(i), quantizer=q))
                         for i in range(10)])
        mvs = np.stack([np.asarray(jnp.asarray(org_max) * (1.0 - jnp.float32(i) / 20))
                        for i in range(10)])
        for o, g in zip(*np.nonzero(differ)):
            it = int(np.argmin(np.abs(mvs[:, o, g] - got[o, g])))
            ij = int(np.argmin(np.abs(mvs[:, o, g] - want[o, g])))
            assert abs(errs[it, o, g] - errs[ij, o, g]) <= 1e-6 * errs[ij, o, g], (o, g)
    return int(differ.sum())


@pytest.mark.parametrize("spec", ["int4-g[32]-rw", "int4-g[32]-zp-rw", "int8-g[32]-rw"])
@pytest.mark.parametrize("seed", [0, 1])
def test_clip_search_matches_jax(spec, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(64, 4, 32)) * rng.uniform(0.5, 2, (64, 4, 1))).astype(np.float32)
    w[3, 1, 5] = 8.0   # an outlier: its group clips hard
    xg = rng.normal(size=(128, 4, 32)).astype(np.float32)
    got = tawq._clip_search_chunk(torch.from_numpy(w), torch.from_numpy(xg), tparse(spec))
    assert _check_clip(w, xg, spec, got.numpy()) == 0
    best, err, err0 = tawq._clip_errors(torch.from_numpy(w), torch.from_numpy(xg), tparse(spec))
    assert torch.equal(best, got) and bool((err <= err0).all())
    if spec.startswith("int4"):   # some group clipped
        assert bool((got < torch.from_numpy(np.abs(w).max(-1))).any())


def test_clip_search_strongest_shrink_matches_jax():
    """Outliers at channels the inputs never use: most groups clip to the
    strongest shrink, i = 9, where fma(-9, f32(1/20), 1) and the twice
    rounded 1 - 9 * f32(1/20) differ; JAX's maxima are the fma's, and so
    are the port's, bitwise."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(256, 4, 32)).astype(np.float32)
    w[:, :, 5] = rng.uniform(20, 40, size=(256, 4))
    xg = rng.normal(size=(128, 4, 32)).astype(np.float32)
    xg[:, :, 5] = 0
    got = tawq._clip_search_chunk(torch.from_numpy(w), torch.from_numpy(xg),
                                  tparse("int4-g[32]-rw")).numpy()
    assert _check_clip(w, xg, "int4-g[32]-rw", got) == 0
    f32 = np.float32
    twice = np.abs(w).max(-1) * (f32(1.0) - f32(9) * (f32(1.0) / f32(20.0)))
    once = np.abs(w).max(-1) * f32(tawq._shrink(9, 20))
    telling = once != twice
    assert telling.sum() > 100 and (got[telling] == once[telling]).mean() > 0.5


def test_shrink_is_xla_fma():
    """The shrink factors: fma(-i, f32(1/20), 1), not (1 - i * f32(1/20))
    rounded twice; the two differ at some i."""
    f32 = np.float32
    rcp = f32(1.0) / f32(20.0)
    for i in range(10):
        exact = f32(np.float64(1.0) - np.float64(i) * np.float64(rcp))
        assert tawq._shrink(i, 20) == float(exact)
    assert any(float(f32(1.0) - f32(i) * rcp) != tawq._shrink(i, 20) for i in range(10))


@contextlib.contextmanager
def recording_awq():
    """Record the port AWQ's per-layer taps (inputs, the layer as it
    stands, the features), its searches' scales and its clips' maxima."""
    calls = {"taps": [], "scales": [], "clips": []}
    real_taps, real_search, real_clip = tawq.layer_taps, tawq._search_scale, tawq._auto_clip

    def taps(ctx, lp, i, ops=None, keys=tpipe.TAP_KEYS):
        out = real_taps(ctx, lp, i, ops, keys)
        calls["taps"].append(dict(layer=i, hidden=ctx.hidden.clone(), params=clone_tree(lp),
                                  positions=ctx.positions.clone(), chunk=ctx.chunk,
                                  feats={k: v.clone() for k, v in out.items()}))
        return out

    def search(*a, **kw):
        s = real_search(*a, **kw)
        calls["scales"].append(s.clone())
        return s

    def clip(lp, cfg, qcfg, i, slot, inp, mse, **kw):
        best = real_clip(lp, cfg, qcfg, i, slot, inp, mse, **kw)
        calls["clips"].append((i, slot, None if best is None else best.clone()))
        return best

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tawq, "layer_taps", taps)
        mp.setattr(tawq, "_search_scale", search)
        mp.setattr(tawq, "_auto_clip", clip)
        yield calls


def check_awq_chain(calls, jcfg, tcfg, jq, tq, tp, hidden0):
    """The recorded AWQ run against the JAX package's functions, layer by
    layer (module doc). Returns how many clip groups took the tie rule."""
    scales, clips = iter(calls["scales"]), iter(calls["clips"])
    ties = 0
    assert [c["layer"] for c in calls["taps"]] == list(range(jcfg.num_layers))
    for c in calls["taps"]:
        i = c["layer"]
        jops = j_layer_ops(jcfg, jq, i)
        if i == 0:
            assert rel_err(c["hidden"].numpy(), hidden0) <= 1e-5
        else:
            prev = calls["taps"][i - 1]
            ctx = jpipe.CalibContext(cfg=jcfg, hidden=jnp.asarray(prev["hidden"].numpy()),
                                     positions=jnp.asarray(prev["positions"].numpy()),
                                     chunk=prev["chunk"])
            jpipe.advance(ctx, to_jax(prev["params"]), i - 1, j_layer_ops(jcfg, jq, i - 1))
            assert rel_err(c["hidden"].numpy(), ctx.hidden) <= 1e-3, i
        jlp = to_jax(c["params"])
        ctx = jpipe.CalibContext(cfg=jcfg, hidden=jnp.asarray(c["hidden"].numpy()),
                                 positions=jnp.asarray(c["positions"].numpy()), chunk=c["chunk"])
        jf = jpipe.layer_taps(ctx, jlp, i, jops, tuple(c["feats"]))
        for k, v in c["feats"].items():
            assert rel_err(v.numpy(), jf[k]) <= (1e-5 if k == "attn_in" else 5e-3), (i, k)
        feats = {k: v.numpy() for k, v in c["feats"].items()}
        tlp = clone_tree(c["params"])
        positions = c["positions"].numpy()
        for pair in jawq.scale_pairs(jcfg, jlp):
            s = _check_search(jcfg, tcfg, jlp, tlp, i, pair, feats[pair.tap], positions, jq, tq)
            np.testing.assert_array_equal(next(scales).numpy(), s)
            jawq._apply_scale(jlp, jcfg, pair, jnp.asarray(s))
            tawq._apply_scale(tlp, tcfg, pair, torch.from_numpy(s))
            for slot in pair.slots:
                k = jcommon.slot_tap(slot)
                feats[k] = (feats[k].astype(np.float32) / s).astype(feats[k].dtype)
        for slot in arch_slots(jcfg):
            if jawq._clip_skip(slot):
                continue
            li, ls, best = next(clips)
            assert (li, ls) == (i, slot)
            W = np.asarray(jcommon.get_weight(jlp, slot))
            x_np = feats[jcommon.slot_tap(slot)]
            want = jawq._auto_clip(jlp, jcfg, jq, i, slot, jnp.asarray(x_np), False)
            O, C = W.shape
            g = C // best.shape[1]
            x = feats[jcommon.slot_tap(slot)].reshape(-1, C)
            x = x[::max(1, x.shape[0] // 512)]
            spec = "int4-g[32]-rw"
            assert best.shape == want.shape
            ties += _check_clip(W.reshape(O, C // g, g), x.reshape(x.shape[0], C // g, g), spec,
                                best.numpy())
            jawq._apply_clip(jlp, slot, jnp.asarray(best.numpy()))
        assert_same_tree(tp["layers"][i], jlp)
    return ties


@pytest.mark.parametrize("name", NAMES)
def test_whole_awq_matches_jax(name):
    jcfg, tcfg, jp, tp = variant_pair(name, 7)
    jq, tq = jbuild(*W4A8), tbuild(*W4A8)
    toks = synthetic_tokens(4, 32, jcfg.vocab_size, 8)
    hidden0 = np.asarray(jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks), chunk=2).hidden)
    with recording_awq() as calls:
        talg.awq(tp, tcfg, tpipe.capture_layer0(tp, tcfg, toks, chunk=2), tq, finish_rtn=False)
    assert check_awq_chain(calls, jcfg, tcfg, jq, tq, tp, hidden0) == 0


def test_whole_awq_plus_matches_jax():
    jcfg, tcfg, jp, tp = variant_pair("llama", 9)
    jq, tq = jbuild(*W4A8), tbuild(*W4A8)
    toks, gtoks = (synthetic_tokens(4, 32, jcfg.vocab_size, s) for s in (10, 11))
    hidden0 = np.asarray(jpipe.capture_layer0(jp, jcfg, jnp.asarray(toks), chunk=2).hidden)
    ghidden0 = np.asarray(jpipe.capture_layer0(jp, jcfg, jnp.asarray(gtoks)).hidden)
    book = {}
    with recording_awq() as calls, recording_gptq_chain() as gcalls:
        talg.awq_plus(tp, tcfg, tpipe.capture_layer0(tp, tcfg, toks, chunk=2),
                      tpipe.capture_layer0(tp, tcfg, gtoks), tq, scale_book=book)
    gptq_w = {(i, s): talg.common.get_weight(tp["layers"][i], s)
              for i in range(jcfg.num_layers) for s in arch_slots(jcfg)}
    # the AWQ stage's layers are the GPTQ stage's recorded inputs
    awq_params = {c["layer"]: c["params"] for c in gcalls if c["taps"] == ("attn_in",)}
    check_awq_chain(calls, jcfg, tcfg, jq, tq, {"layers": [awq_params[i] for i in range(2)]},
                    hidden0)
    check_gptq_chain(gcalls, jcfg, jq, gptq_w, book, ghidden0)


# mirrors of the JAX package's AWQ tests, on the port

def _tiny(arch="llama", seed=0):
    cfg = tm.tiny_config(arch)
    p = tm.init_params(cfg, seed=seed, device="cpu")
    toks = synthetic_tokens(4, 32, cfg.vocab_size, seed=1)
    return cfg, p, tpipe.capture_layer0(p, cfg, toks, chunk=2)


def test_awq_pack_lossless():
    cfg, p, ctx = _tiny()
    qcfg = tbuild("int4-g[32]-rw", None, None, None)
    book = {}
    talg.awq(p, cfg, ctx, qcfg, do_clip=True, scale_book=book)
    fake = {(i, s): talg.common.get_weight(lp, s).clone()
            for i, lp in enumerate(p["layers"]) for s in arch_slots(cfg)}
    talg.pack_model(p, cfg, qcfg, scale_book=book)
    for (i, s), w in fake.items():
        assert torch.equal(dequantize(talg.common.get_weight(p["layers"][i], s)), w), (i, s)


def test_awq():
    cfg, p, ctx = _tiny()
    qcfg = tbuild(*W4A8)
    toks = torch.from_numpy(synthetic_tokens(1, 16, cfg.vocab_size, seed=1))
    ref = tm.forward(p, cfg, toks)
    talg.awq(p, cfg, ctx, qcfg)
    W = talg.common.get_weight(p["layers"][0], "q")
    assert torch.allclose(quantize_dequant(qcfg.linear.weight, W), W, atol=1e-6)
    out = tm.forward(p, cfg, toks, qcfg=qcfg)
    assert float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref)) < 1.0


def test_awq_plus():
    cfg, p, ctx = _tiny()
    qcfg = tbuild(*W4A8)
    W0 = talg.common.get_weight(p["layers"][0], "q").clone()
    gctx = tpipe.capture_layer0(p, cfg, synthetic_tokens(4, 32, cfg.vocab_size, seed=1), chunk=2)
    talg.awq_plus(p, cfg, ctx, gctx, qcfg)
    assert not torch.allclose(W0, talg.common.get_weight(p["layers"][0], "q"))
    toks = torch.from_numpy(synthetic_tokens(1, 64, cfg.vocab_size, seed=7))
    assert bool(torch.isfinite(tm.forward(p, cfg, toks, qcfg=qcfg)).all())


@pytest.mark.parametrize("arch", ["opt", "phi", "gemma2"])
def test_awq_per_arch(arch):
    cfg, p, ctx = _tiny(arch)
    qcfg = tbuild("int4-g[32]-rw", "int8-g[-1]-rw", None, None)
    talg.awq(p, cfg, ctx, qcfg)
    toks = torch.from_numpy(synthetic_tokens(1, 64, cfg.vocab_size, seed=7))
    assert bool(torch.isfinite(tm.forward(p, cfg, toks, qcfg=qcfg)).all())


def test_awq_gemma1_unsupported():
    cfg, p, ctx = _tiny("gemma")
    with pytest.raises(NotImplementedError):
        talg.awq(p, cfg, ctx, tbuild("int4-g[32]-rw", "int8-g[-1]-rw", None, None))


def test_awq_timings():
    cfg, p, ctx = _tiny()
    timer = talg.PhaseTimer()
    talg.awq(p, cfg, ctx, tbuild(*W4A8), timings=timer)
    assert set(timer.seconds) == {"taps", "scale search", "clip search", "rtn"}
    assert all(v > 0 for v in timer.seconds.values())
