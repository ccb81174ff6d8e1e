"""Checkpoints: the port's safetensors reader and writer against the
``safetensors`` package, its ``save_compressed`` / ``load_compressed``
against the JAX package's in both directions, and its HF loading against
the JAX package's and ``transformers``.

Config: a tiny Llama (hidden 128, intermediate 256, 4 heads / 2 KV heads,
head_dim 32, 2 layers, vocab 256), float32 and bfloat16, RTN in each
package from the same initial weights, then ``pack_model``.

Formats: int4 (pair planes and group halves, with zero points), int8, fp8,
MXINT4, NVFP4 (fp4 codes, fp8 group scales) and an MPQ plan (int4 layers
and one int8 layer, each op's quantizer resolved through ``qcfg.for_op``;
its packed layers are served unstacked, in both packages).

Tolerances: none, apart from ``transformers``' logits.
* files: ``model.safetensors`` and ``packed.npz`` hold the same names,
  dtypes, shapes and bytes as the JAX package's: the safetensors file byte
  for byte, each ``.npy`` member of the archive byte for byte (fp8 codes
  under the headers ``np.savez`` gives ml_dtypes arrays).
* loading: every QTensor field equal (codes, scales, zeros, pair flag,
  shapes); a tied head, which neither package writes, packs again from the
  loaded embedding bitwise (``pack_model``); an untied head loads
  dequantized, as in the JAX package; greedy tokens equal (float32).
* fp8 codes: only the port reads them back (the JAX package's
  ``load_compressed`` raises on the ``'<V1'`` and ``'<f1'`` members its
  ``np.savez`` wrote).
* HF directories (``save_pretrained`` of a random-init ``transformers``
  Llama, one file or two shards): configs field for field and params
  bitwise equal to the JAX package's; logits within ``test_hf_parity``'s
  rtol = atol = 2e-3 of ``transformers``.
"""

import dataclasses
import json
import zipfile

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import safetensors.numpy as stnp
import torch
import transformers

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import models as jm
from llm_compressor_tpu.engine.generate import generate as j_generate
from llm_compressor_tpu.models.params import load_compressed as j_load_compressed
from llm_compressor_tpu.models.params import load_hf_checkpoint as j_load_hf
from llm_compressor_tpu.models.params import save_compressed as j_save_compressed
from llm_compressor_tpu.qformats import QTensor as JQTensor
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu.qformats import register_4_to_8bit as j_register_4_to_8bit
from llm_compressor_tpu_torch import algorithms as talg
from llm_compressor_tpu_torch import engine as te
from llm_compressor_tpu_torch import models as tm
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.qformats import QTensor, dequantize, qspec_string
from llm_compressor_tpu_torch.qformats import build_quant_config as tbuild
from llm_compressor_tpu_torch.qformats import register_4_to_8bit as t_register_4_to_8bit
from llm_compressor_tpu_torch.utils import safetensors_io
from torch_port_util import jax_to_numpy, one_torch_thread, word_tokenizer  # noqa: F401

CFG = dict(hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2, head_dim=32)
SLOTS = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
         ("mlp", "gate"), ("mlp", "up"), ("mlp", "down"))
PROMPT = np.random.default_rng(7).integers(0, 256, (2, 6)).astype(np.int32)


# ---------------------------------------------------------------------------
# safetensors_io against the safetensors package
# ---------------------------------------------------------------------------

NP_DTYPES = {"F32": np.float32, "BF16": ml_dtypes.bfloat16, "F16": np.float16,
             "I8": np.int8, "U8": np.uint8, "I32": np.int32, "I64": np.int64}


@pytest.mark.parametrize("dtype", list(NP_DTYPES))
def test_reader_reads_package_files(tmp_path, dtype):
    rng = np.random.default_rng(len(dtype))
    want = {"a.weight": (rng.normal(size=(5, 7)) * 50).astype(NP_DTYPES[dtype]),
            "b": (rng.normal(size=(3,)) * 50).astype(NP_DTYPES[dtype]),
            "c": np.zeros((0, 4), NP_DTYPES[dtype])}
    stnp.save_file(want, str(tmp_path / "x.safetensors"), metadata={"format": "np"})
    got = safetensors_io.load_file(tmp_path / "x.safetensors")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == safetensors_io.READ_DTYPES[dtype]
        assert tuple(got[k].shape) == v.shape
        assert got[k].contiguous().view(torch.uint8).numpy().tobytes() == v.tobytes()


def test_reader_refuses_other_dtypes(tmp_path):
    stnp.save_file({"x": np.zeros(3, np.float64)}, str(tmp_path / "x.safetensors"))
    with pytest.raises(TypeError, match="F64"):
        safetensors_io.load_file(tmp_path / "x.safetensors")


def test_writer_files_are_the_package_files(tmp_path):
    g = torch.Generator().manual_seed(0)
    t = {"model.norm.weight": torch.randn(16, generator=g),
         "lm_head.weight": torch.randn(8, 16, generator=g).to(torch.bfloat16),
         "model.embed_tokens.weight": torch.randn(8, 16, generator=g), "s": torch.tensor(2.5)}
    safetensors_io.save_file(t, tmp_path / "ours.safetensors", metadata={"format": "pt"})
    got = stnp.load_file(str(tmp_path / "ours.safetensors"))
    as_np = {k: v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
             if v.dtype == torch.bfloat16 else v.numpy() for k, v in t.items()}
    assert set(got) == set(as_np)
    for k, v in as_np.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert got[k].tobytes() == v.tobytes()
    stnp.save_file(as_np, str(tmp_path / "theirs.safetensors"), metadata={"format": "pt"})
    assert (tmp_path / "ours.safetensors").read_bytes() == \
        (tmp_path / "theirs.safetensors").read_bytes()
    with pytest.raises(TypeError, match="int8"):
        safetensors_io.save_file({"x": torch.zeros(2, dtype=torch.int8)}, tmp_path / "y")


# ---------------------------------------------------------------------------
# save_compressed / load_compressed in both directions
# ---------------------------------------------------------------------------

# id: (weight, act, head weight, tied)
CASES = {
    "int4_pairs_w4a8": ("int4-g[64]-rw", "int8-g[-1]-rw", "int8-g[128]-rw", True),
    "int4_halves": ("int4-g[128]-rw", "int8-g[-1]-rw", None, True),
    "int4_zp": ("int4-g[64]-zp-rw", None, None, True),
    "int8_channel": ("int8-g[-1]-rw", "int8-g[-1]-rw", None, True),
    "int8_g128_tied_head": ("int8-g[128]-rw", None, "int8-g[128]-rw", True),
    "int8_g128_untied_head": ("int8-g[128]-rw", None, "int8-g[128]-rw", False),
    "mxint4": ("mxint4-g[32]-rw", None, None, True),
    "nvfp4": ("nvfp4_e2m1-g[16]-rw", None, "int8-g[128]-rw", True),
    "mpq_int4_int8": ("int4-g[64]-rw", "int8-g[-1]-rw", "int8-g[128]-rw", True),
}
# MPQ plans: the weights promoted to 8 bits (register_4_to_8bit), by case
MPQ = {"mpq_int4_int8": [f"layers.1.{n}.weight" for n in (
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
    "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")]}
# served greedily in both packages (prefill + 3 steps); float32 only: the
# JAX package's CPU backend has no bf16 x bf16 -> f32 dot
SERVED = {("int4_pairs_w4a8", "float32"), ("int4_zp", "float32"),
          ("int8_g128_untied_head", "float32"), ("mxint4", "float32"), ("nvfp4", "float32"),
          ("mpq_int4_int8", "float32")}
FP8 = ["fp8_e4m3-g[64]-rw", "fp8_e5m2-g[64]-rw"]


def _configs(dtype, tied):
    over = dict(CFG, dtype=dtype, tie_word_embeddings=tied)
    return jm.tiny_config("llama", **over), tm.tiny_config("llama", **over)


def _packed_pair(weight, act, head, tied, dtype, seed=0, mpq=None):
    """The same initial weights, RTN and packed in each package; ``mpq``
    names the weights an MPQ plan promotes to 8 bits."""
    jcfg, tcfg = _configs(dtype, tied)
    jq, tq = jbuild(weight, act, None, head), tbuild(weight, act, None, head)
    if mpq:
        jq, tq = j_register_4_to_8bit(jq, mpq), t_register_4_to_8bit(tq, mpq)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax_to_numpy(jp), "cpu")
    jalg.rtn(jp, jcfg, jq, verbose=False)
    jalg.pack_model(jp, jcfg, jq)
    talg.rtn(tp, tcfg, tq)
    talg.pack_model(tp, tcfg, tq)
    return jcfg, tcfg, jq, tq, jp, tp


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree["weight"]


def _fields(qt) -> dict:
    """A QTensor of either package as numpy fields (fp8 codes as bytes)."""
    if isinstance(qt, JQTensor):
        d = jax_to_numpy(qt)
        codes = d["codes"].view(np.uint8) if d["codes"].dtype.itemsize == 1 and \
            d["codes"].dtype.kind not in "iu" else d["codes"]
        return dict(codes=codes, scales=d["scales"], zeros=d["zeros"], pair=d["pair_planes"],
                    shape=tuple(d["shape"]), blocked=tuple(d["blocked_shape"]),
                    axes=(d["group_axis"], d["ngroups_axis"]), qspec=d["qspec"])
    codes = qt.codes.view(torch.uint8) if qt.codes.dtype.is_floating_point else qt.codes
    return dict(codes=codes.numpy(), scales=qt.scales.numpy(),
                zeros=None if qt.zeros is None else qt.zeros.numpy(), pair=qt.pair_planes,
                shape=tuple(qt.shape), blocked=tuple(qt.blocked_shape),
                axes=(qt.group_axis, qt.ngroups_axis), qspec=qspec_string(qt.quantizer))


def _assert_same_qtensor(a, b, what):
    fa, fb = _fields(a), _fields(b)
    for k in fa:
        if isinstance(fa[k], np.ndarray) or isinstance(fb[k], np.ndarray):
            assert (fa[k] is None) == (fb[k] is None), (what, k)
            if fa[k] is not None:
                assert fa[k].dtype == fb[k].dtype, (what, k, fa[k].dtype, fb[k].dtype)
                np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{what} {k}")
        else:
            assert fa[k] == fb[k], (what, k, fa[k], fb[k])


def _assert_same_npz(a, b):
    """The same members in the same order, each ``.npy`` member the same
    bytes: header (dtype, shape) and data."""
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert za.namelist() == zb.namelist()
        for n in za.namelist():
            assert za.read(n) == zb.read(n), n


def _assert_same_files(dir_a, dir_b):
    sa = stnp.load_file(str(dir_a / "model.safetensors"))
    sb = stnp.load_file(str(dir_b / "model.safetensors"))
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype == np.float32 and sa[k].shape == sb[k].shape, k
        assert sa[k].tobytes() == sb[k].tobytes(), k
    assert (dir_a / "model.safetensors").read_bytes() == (dir_b / "model.safetensors").read_bytes()
    _assert_same_npz(dir_a / "packed.npz", dir_b / "packed.npz")
    assert json.loads((dir_a / "config.json").read_text()) == \
        json.loads((dir_b / "config.json").read_text())


def _serve_jax(jp, jcfg, jq):
    p = jm.fuse_model(jp, jcfg, jq)
    if not jq.overrides:   # packed layers of two formats do not stack
        p = jm.stack_model(p)
    return np.asarray(j_generate(p, jcfg, PROMPT, max_new_tokens=3, qcfg=jq))


def _serve_port(tp, tcfg, tq):
    p = tm.fuse_model(tp, tcfg, tq)
    if not tq.overrides:
        p = tm.stack_model(p)
    return te.generate(p, tcfg, PROMPT, max_new_tokens=3, qcfg=tq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_round_trip(tmp_path, case, dtype):
    weight, act, head, tied = CASES[case]
    jcfg, tcfg, jq, tq, jp, tp = _packed_pair(weight, act, head, tied, dtype,
                                              mpq=MPQ.get(case))
    # RTN packs the same payload in both packages (eager rounding on the
    # linears, the jitted rounding on the head)
    for i in range(jcfg.num_layers):
        for path in SLOTS:
            _assert_same_qtensor(_node(jp["layers"][i], path), _node(tp["layers"][i], path),
                                 (i, path))
    hf = tm.to_hf_config(tcfg)
    j_save_compressed(jp, jcfg, tmp_path / "jax", hf_config=hf)
    tm.save_compressed(tp, tcfg, tmp_path / "port", hf_config=hf)
    _assert_same_files(tmp_path / "jax", tmp_path / "port")
    with np.load(tmp_path / "port" / "packed.npz") as data:
        # the tied packed head is not written (the JAX package's behaviour)
        assert ("lm_head.weight.codes" in data.files) == (head is not None and not tied)

    # JAX writes, the port reads; the port writes, JAX reads
    t_loaded = tm.load_compressed(tmp_path / "jax", tcfg, tq, device="cpu")
    j_loaded = j_load_compressed(tmp_path / "port", jcfg, jq)
    for i in range(jcfg.num_layers):
        for path in SLOTS:
            want = _node(jp["layers"][i], path)
            _assert_same_qtensor(want, _node(t_loaded["layers"][i], path), (i, path))
            _assert_same_qtensor(want, _node(j_loaded["layers"][i], path), (i, path))
    for key in ("embed", "final_norm"):
        assert torch.equal(t_loaded[key]["weight"], tp[key]["weight"])
    if head is not None and tied:
        assert "lm_head" not in t_loaded and "lm_head" not in j_loaded
        talg.pack_model(t_loaded, tcfg, tq)
        _assert_same_qtensor(jp["lm_head"]["weight"], t_loaded["lm_head"]["weight"], "head")
    elif not tied:
        # the untied head comes back dequantized, in both packages
        h = t_loaded["lm_head"]["weight"]
        assert not isinstance(h, QTensor) and h.dtype == tm.params.DTYPES[dtype]
        assert torch.equal(h, dequantize(tp["lm_head"]["weight"]))
        np.testing.assert_array_equal(np.asarray(j_loaded["lm_head"]["weight"]
                                                 .astype(jnp.float32)), h.float().numpy())
    if (case, dtype) in SERVED:
        if head is not None:
            jalg.pack_model(j_loaded, jcfg, jq)
            talg.pack_model(t_loaded, tcfg, tq)
        np.testing.assert_array_equal(_serve_port(t_loaded, tcfg, tq),
                                      _serve_jax(j_loaded, jcfg, jq))


@pytest.mark.parametrize("weight", FP8)
def test_fp8_checkpoint_jax_writes_port_reads(tmp_path, weight):
    jcfg, tcfg, jq, tq, jp, tp = _packed_pair(weight, None, "int8-g[128]-rw", True, "bfloat16")
    j_save_compressed(jp, jcfg, tmp_path / "jax")
    tm.save_compressed(tp, tcfg, tmp_path / "port")
    _assert_same_npz(tmp_path / "jax" / "packed.npz", tmp_path / "port" / "packed.npz")
    t_loaded = tm.load_compressed(tmp_path / "jax", tcfg, tq, device="cpu")
    for i in range(jcfg.num_layers):
        for path in SLOTS:
            got = _node(t_loaded["layers"][i], path)
            assert got.codes.dtype == {"fp8_e4m3": torch.float8_e4m3fn,
                                       "fp8_e5m2": torch.float8_e5m2}[weight[:8]]
            _assert_same_qtensor(_node(jp["layers"][i], path), got, (i, path))
    # the JAX package cannot read the codes it wrote (ROADMAP C, kept on
    # purpose): jnp.asarray refuses e4m3's void bytes, np.load e5m2's '<f1'
    with pytest.raises((TypeError, ValueError)):
        j_load_compressed(tmp_path / "jax", jcfg, jq)


def test_save_compressed_copies_tokenizer(tmp_path):
    """``save_compressed(tokenizer_path=)`` writes the tokenizer files the
    JAX package's writes, byte for byte (a word-level tokenizer built
    here), beside the same checkpoint."""
    jcfg, tcfg = _configs("float32", True)
    word_tokenizer(tmp_path / "tok")
    tree = jax_to_numpy(jm.init_params(jcfg, jax.random.PRNGKey(0)))
    j_save_compressed(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, tmp_path / "jax",
                      tokenizer_path=str(tmp_path / "tok"))
    tm.save_compressed(params_from_numpy(tree, "cpu"), tcfg, tmp_path / "port",
                       tokenizer_path=str(tmp_path / "tok"))
    names = sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "port").iterdir())
    assert {"tokenizer.json", "tokenizer_config.json", "special_tokens_map.json"} <= set(names)
    for name in names:
        if name != "model.safetensors":
            assert ((tmp_path / "port" / name).read_bytes()
                    == (tmp_path / "jax" / name).read_bytes()), name


def test_save_compressed_bad_tokenizer_warns(tmp_path, caplog):
    """A tokenizer that cannot be loaded logs a warning and the checkpoint
    is still written (the JAX package passes over it silently)."""
    _, tcfg = _configs("float32", True)
    with caplog.at_level("WARNING", logger="llm_compressor_tpu_torch"):
        tm.save_compressed(tm.init_params(tcfg, device="cpu"), tcfg, tmp_path / "out",
                           tokenizer_path=str(tmp_path / "missing"))
    assert "tokenizer" in caplog.text and "was not copied" in caplog.text
    assert sorted(f.name for f in (tmp_path / "out").iterdir()) == ["model.safetensors"]


# ---------------------------------------------------------------------------
# HF directories written by transformers
# ---------------------------------------------------------------------------

HF_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
               rope_theta=10000.0, attn_implementation="eager",
               rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                             "high_freq_factor": 4.0, "original_max_position_embeddings": 32})


@pytest.fixture(scope="module", params=[("tied", None), ("untied", None), ("untied", "300KB")],
                ids=["tied", "untied", "untied_2_shards"])
def hf_dir(request, tmp_path_factory):
    tie, shard = request.param
    hf_cfg = transformers.LlamaConfig(**HF_TINY, tie_word_embeddings=tie == "tied")
    torch.manual_seed(0)
    model = transformers.AutoModelForCausalLM.from_config(hf_cfg).eval().to(torch.float32)
    d = tmp_path_factory.mktemp("hf")
    kw = {} if shard is None else {"max_shard_size": shard}
    model.save_pretrained(d, safe_serialization=True, **kw)
    n_files = len(list(d.glob("*.safetensors")))
    assert n_files == (1 if shard is None else 2), n_files
    return d, hf_cfg, model


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_hf_checkpoint_matches_jax(hf_dir, dtype):
    d, _, _ = hf_dir
    jcfg, jp = j_load_hf(d, dtype=dtype)
    tcfg, tp = tm.load_hf_checkpoint(d, dtype=dtype, device="cpu")
    for f in dataclasses.fields(tcfg):
        a, b = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "rope_scaling":
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    want = params_from_numpy(jax_to_numpy(jp), "cpu")
    flat = lambda t: {k: v for k, v in _flatten(t)}
    fw, fg = flat(want), flat(tp)
    assert set(fw) == set(fg)
    for k in fw:
        assert fw[k].dtype == fg[k].dtype and torch.equal(fw[k], fg[k]), k


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix, tree


def test_hf_checkpoint_logits_match_transformers(hf_dir):
    d, hf_cfg, model = hf_dir
    tokens = np.random.default_rng(0).integers(0, 256, (2, 16))
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.numpy()
    tcfg, tp = tm.load_hf_checkpoint(d, dtype="float32", device="cpu")
    assert tcfg == dataclasses.replace(tm.from_hf_config(hf_cfg), dtype="float32")
    ours = tm.forward(tp, tcfg, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-3)


def test_to_hf_config_round_trips():
    for cfg in (tm.tiny_config("llama", dtype="bfloat16"),
                tm.tiny_config("llama", tie_word_embeddings=False, dtype="bfloat16",
                               rope_scaling=tm.RopeScaling("llama3", 8.0, 1.0, 4.0, 32))):
        hf = tm.to_hf_config(cfg)
        assert tm.from_hf_config(hf) == cfg
        j = jm.from_hf_config(hf)
        for f in dataclasses.fields(cfg):
            a, b = getattr(j, f.name), getattr(cfg, f.name)
            if f.name == "rope_scaling" and a is not None:
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name


@pytest.mark.parametrize("hf", [
    transformers.LlamaConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                             num_attention_heads=4, mlp_bias=True),
], ids=["llama_mlp_bias"])
def test_from_hf_config_refuses(hf):
    """A gated MLP with biases is read by neither package."""
    with pytest.raises(NotImplementedError, match="mlp_bias"):
        tm.from_hf_config(hf)


@pytest.mark.parametrize("hf", [
    transformers.Qwen2Config(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2),
    {"model_type": "gemma", "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
     "num_hidden_layers": 2, "num_attention_heads": 4},
    transformers.LlamaConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                             num_attention_heads=4, attention_bias=True),
    transformers.OPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                           num_attention_heads=4),
    transformers.OPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                           num_attention_heads=4, ffn_dim=128, word_embed_proj_dim=32,
                           do_layer_norm_before=False),
    transformers.BloomConfig(vocab_size=256, hidden_size=64, n_layer=2, n_head=4),
    transformers.PhiConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                           num_attention_heads=4),
], ids=["qwen2", "gemma", "llama_attention_bias", "opt", "opt350m", "bloom", "phi"])
def test_from_hf_config_takes_what_jax_takes(hf):
    """Configs the port refused before it ran these architectures: read
    field for field as the JAX package reads them (a biased Llama, OPT,
    OPT-350m's project_in and post-norm, BLOOM, Phi too)."""
    a, b = jm.from_hf_config(hf), tm.from_hf_config(hf)
    for f in dataclasses.fields(b):
        assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert b.attention_bias == (b.arch != "gemma")


def test_from_hf_config_defaults_match_jax():
    hf = {"model_type": "llama", "vocab_size": 256, "hidden_size": 64,
          "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4}
    a, b = jm.from_hf_config(hf), tm.from_hf_config(hf)
    for f in dataclasses.fields(b):
        assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert b.rms_norm_eps == 1e-6 and b.num_kv_heads == 4 and b.head_dim == 16
    assert not b.tie_word_embeddings
