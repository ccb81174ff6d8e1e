"""The reference's precision comes from each configuration's ``recipe``,
and a recipe or a family that the reference does not model is refused
before any run; the decode driver's inputs repeat from ``--seed``."""

import pytest
import torch

import tiny
from portbench import harness, spec as spec_mod
from portbench.reference import model as ref

W4A8 = ref.Bits(weight=4, act=8, kv=8, head_weight=8, head_act=8, group=128, head_group=128)


@pytest.mark.parametrize("c", tiny.bench()["configs"], ids=lambda c: c["name"])
def test_configs_state_w4a8(c):
    cfg = harness.read_json(tiny.ROOT / c["file"])
    assert ref.bits_of(cfg["recipe"]) == W4A8


def test_control_lowers_every_8_bit_stage():
    assert ref.control_of(W4A8) == ref.Bits(4, 4, 4, 4, 4, 128, 128)


def recipe(**kw):
    r = harness.read_json(tiny.ROOT / "portbench/configs/qwen3_1p7b_w4a8.json")["recipe"]
    r.update(kw)
    return r


@pytest.mark.parametrize("change", [
    {"weight": "int4-g[128]-zp-rw"},            # zero points
    {"weight": "nvfp4_e2m1-g[16]-rw"},          # a float format
    {"weight": "int4-g[-1]-rw"},                # per row, not grouped
    {"act_in": "int8-g[128]-rw"},               # grouped acts
    {"head": "int8-g[128]-cw"},                 # column-wise groups
    {"kv_cache": "bf16"},                       # an unquantized cache
    {"served_dtype": "float16"},
    {"hadamard": "R1"},                         # a key the reference does not know
])
def test_unmodelled_recipe_is_refused(change):
    with pytest.raises(ValueError):
        ref.bits_of(recipe(**change))


def test_grouping_is_read():
    b = ref.bits_of(recipe(weight="int8-g[256]-rw", head="int4-g[64]-rw"))
    assert (b.weight, b.group, b.head_weight, b.head_group) == (8, 256, 4, 64)


def test_family_is_found_by_model_type():
    cfg = harness.read_json(tiny.ROOT / "portbench/configs/phi2_w4a8.json")
    s = spec_mod.spec_of(cfg)
    assert s.layernorm and s.parallel_residual and s.biases and not s.gated
    assert s.rotary_dim == 32 and s.head_dim == 80
    with pytest.raises(ValueError, match="families/opt.py"):
        spec_mod.spec_of(dict(cfg, model_type="opt"))
    with pytest.raises(ValueError):
        spec_mod.spec_of(dict(cfg, qk_layernorm=True))


def served_inputs(seed):
    """The prompts and a job's first tokens that the decode driver feeds a
    tiny cell, recorded as it feeds them."""
    from llm_compressor_tpu_torch import engine

    fed = []
    real = engine.decode_greedy_steps

    def spy(params, token, cache, **kw):
        fed.append(token.clone())
        return real(params, token, cache, **kw)

    prefill_real = engine.prefill

    def prefill(params, tokens, cache, **kw):
        fed.append(tokens.clone())
        return prefill_real(params, tokens, cache, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(engine, "decode_greedy_steps", spy)
    mp.setattr(engine, "prefill", prefill)
    try:
        harness.run_cell(tiny.bench(), "qwen3_1p7b_w4a8.decode_b1024_ctx1k", seed, 0.0, False,
                         device="cpu", adjust=tiny.shrink, log=lambda *a, **k: None)
    finally:
        mp.undo()
    return fed


def test_inputs_repeat_from_the_seed():
    big = 2**31 + 12345
    a, b, c = served_inputs(big), served_inputs(big), served_inputs(big + 1)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
