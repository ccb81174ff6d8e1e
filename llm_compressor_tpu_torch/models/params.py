"""Parameters: random init, HF checkpoints and the compressed checkpoint
(port of ``models/params.py``, all nine architectures).

The params layout matches the JAX package (weights in (out, in)
orientation):

    params = {"embed": {"weight"}, ["embed_ln"], ["pos_embed"],
              ["project_in"], ["project_out"],
              "layers": [{"ln1", ["ln2"] | ["pre_ffw_norm", "post_ffw_norm"],
                          ["post_attn_norm"],
                          "attn": {"q","k","v","o"} | {"qkv","o"}
                                  [+ "q_norm", "k_norm"],
                          "mlp": {"gate","up","down"} | {"fc1","fc2"}}, ...],
              ["final_norm"], ["lm_head"]}

A linear carries a ``bias`` where the config says (q/k/v: Qwen2, OPT,
BLOOM, Phi; o and fc1/fc2: OPT, BLOOM, Phi; Phi's untied lm_head), and so
does a LayerNorm. A Gemma norm's weight is stored as ``w`` of ``(1 + w)``.

A compressed checkpoint is the JAX package's, byte for byte per entry:
``model.safetensors`` holds every leaf as float32 under its HF name (packed
weights dequantized), ``packed.npz`` each packed weight's
``<hf>.weight.codes`` (int4 uint8, int8 int8, fp8 one byte under the JAX
package's ``.npy`` headers: ``utils.npz_io``), ``.scales``, ``.zeros``
(float32) and ``.pair`` (``True`` for pair-plane int4), and
``config.json`` the HF config when one is given. Two behaviours
are the JAX package's and kept: only the names of ``_hf_top_map`` and
``_hf_key_map`` are written, so a tied model's packed ``lm_head`` is not
(``pack_model`` after loading packs it again, bitwise), and
``load_compressed`` restores the layers' QTensors only, so an untied head
comes back dequantized. Unlike the JAX package, ``load_compressed`` reads
fp8 codes. Safetensors files go through ``utils.safetensors_io``.
"""

from __future__ import annotations

import json
from dataclasses import replace
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..qformats.config import QuantConfig
from ..qformats.qtensor import FP8_DTYPES, QTensor, dequantize
from ..utils.npz_io import FP8_DESCR, load_npz, save_npz
from ..utils.safetensors_io import load_file, save_file
from .config import ModelConfig, from_hf_config

Params = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def init_params(cfg: ModelConfig, seed: int = 0, scale: float = 0.02,
                device=None) -> Params:
    """Normal(0, scale) weights from ``torch.Generator(seed)``, ones for the
    norms (zeros for Gemma's ``(1 + w)`` norms), zeros for the biases, in
    ``cfg.dtype`` on ``device`` (the card unless told otherwise); the tree
    of the JAX ``init_params`` (:45-115) for every architecture.
    The draws do not equal ``jax.random``'s; tests hand the JAX package's
    params over through ``convert.py`` instead."""
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
                * scale).to(dt)

    fill = torch.zeros if cfg.norm_weight_plus_one else torch.ones

    def norm(n=cfg.hidden_size, bias=cfg.norm_type == "layernorm"):
        p = {"weight": fill((n,), dtype=dt, device=dev)}
        if bias:
            p["bias"] = torch.zeros((n,), dtype=dt, device=dev)
        return p

    def lin(out_d, in_d, bias=False):
        p = {"weight": w(out_d, in_d)}
        if bias:
            p["bias"] = torch.zeros((out_d,), dtype=dt, device=dev)
        return p

    E, I, ab, mb = cfg.hidden_size, cfg.intermediate_size, cfg.attention_bias, cfg.mlp_bias
    V = cfg.project_in_dim or E
    params: Params = {"embed": {"weight": w(cfg.vocab_size, V)}}
    if cfg.project_in_dim is not None:
        params["project_in"] = {"weight": w(E, V)}
        params["project_out"] = {"weight": w(V, E)}
    if cfg.pos_embedding == "learned":
        params["pos_embed"] = {
            "weight": w(cfg.max_position_embeddings + cfg.learned_pos_offset, E)}
    if cfg.embedding_layernorm:
        params["embed_ln"] = norm()
    layers = []
    for _ in range(cfg.num_layers):
        if cfg.fused_qkv:
            attn = {"qkv": lin(3 * cfg.q_size, E, ab)}
        else:
            attn = {"q": lin(cfg.q_size, E, ab), "k": lin(cfg.kv_size, E, ab),
                    "v": lin(cfg.kv_size, E, ab)}
        attn["o"] = lin(E, cfg.q_size, cfg.attention_out_bias)
        if cfg.qk_norm or cfg.qk_layernorm:
            attn["q_norm"] = norm(cfg.head_dim, cfg.qk_layernorm)
            attn["k_norm"] = norm(cfg.head_dim, cfg.qk_layernorm)
        if cfg.mlp_style == "gated":
            mlp = {"gate": lin(I, E, mb), "up": lin(I, E, mb), "down": lin(E, I, mb)}
        else:
            mlp = {"fc1": lin(I, E, mb), "fc2": lin(E, I, mb)}
        lp = {"ln1": norm(), "attn": attn, "mlp": mlp}
        if cfg.pre_post_ffw_norm:
            lp["pre_ffw_norm"], lp["post_ffw_norm"] = norm(), norm()
        elif not cfg.parallel_residual:
            lp["ln2"] = norm()
        if cfg.post_attn_residual_norm:
            lp["post_attn_norm"] = norm()
        layers.append(lp)
    params["layers"] = layers
    if cfg.final_norm:
        params["final_norm"] = norm()
    if not cfg.tie_word_embeddings:
        params["lm_head"] = lin(cfg.vocab_size, E, cfg.arch == "phi")
    return params


# ---------------------------------------------------------------------------
# HF checkpoint mapping
# ---------------------------------------------------------------------------


def _hf_key_map(cfg: ModelConfig, i: int) -> Dict[str, tuple]:
    """HF module name -> params path for layer ``i`` (JAX :131-201): in
    Gemma2/3 HF's ``post_attention_layernorm`` is the norm on the attention
    output, elsewhere the MLP's input norm."""
    if cfg.arch == "opt":
        p = f"model.decoder.layers.{i}"
        return {
            f"{p}.self_attn.q_proj": ("attn", "q"),
            f"{p}.self_attn.k_proj": ("attn", "k"),
            f"{p}.self_attn.v_proj": ("attn", "v"),
            f"{p}.self_attn.out_proj": ("attn", "o"),
            f"{p}.fc1": ("mlp", "fc1"),
            f"{p}.fc2": ("mlp", "fc2"),
            f"{p}.self_attn_layer_norm": ("ln1",),
            f"{p}.final_layer_norm": ("ln2",),
        }
    if cfg.arch == "bloom":
        p = f"transformer.h.{i}"
        return {
            f"{p}.self_attention.query_key_value": ("attn", "qkv"),
            f"{p}.self_attention.dense": ("attn", "o"),
            f"{p}.mlp.dense_h_to_4h": ("mlp", "fc1"),
            f"{p}.mlp.dense_4h_to_h": ("mlp", "fc2"),
            f"{p}.input_layernorm": ("ln1",),
            f"{p}.post_attention_layernorm": ("ln2",),
        }
    p = f"model.layers.{i}"
    if cfg.arch == "phi":
        m = {
            f"{p}.self_attn.q_proj": ("attn", "q"),
            f"{p}.self_attn.k_proj": ("attn", "k"),
            f"{p}.self_attn.v_proj": ("attn", "v"),
            f"{p}.self_attn.dense": ("attn", "o"),
            f"{p}.mlp.fc1": ("mlp", "fc1"),
            f"{p}.mlp.fc2": ("mlp", "fc2"),
            f"{p}.input_layernorm": ("ln1",),
        }
        if cfg.qk_layernorm:
            m[f"{p}.self_attn.q_layernorm"] = ("attn", "q_norm")
            m[f"{p}.self_attn.k_layernorm"] = ("attn", "k_norm")
        return m
    m = {
        f"{p}.self_attn.q_proj": ("attn", "q"),
        f"{p}.self_attn.k_proj": ("attn", "k"),
        f"{p}.self_attn.v_proj": ("attn", "v"),
        f"{p}.self_attn.o_proj": ("attn", "o"),
        f"{p}.mlp.gate_proj": ("mlp", "gate"),
        f"{p}.mlp.up_proj": ("mlp", "up"),
        f"{p}.mlp.down_proj": ("mlp", "down"),
        f"{p}.input_layernorm": ("ln1",),
    }
    if cfg.qk_norm:
        m[f"{p}.self_attn.q_norm"] = ("attn", "q_norm")
        m[f"{p}.self_attn.k_norm"] = ("attn", "k_norm")
    if cfg.pre_post_ffw_norm:
        m[f"{p}.post_attention_layernorm"] = ("post_attn_norm",)
        m[f"{p}.pre_feedforward_layernorm"] = ("pre_ffw_norm",)
        m[f"{p}.post_feedforward_layernorm"] = ("post_ffw_norm",)
    else:
        m[f"{p}.post_attention_layernorm"] = ("ln2",)
    return m


def _hf_top_map(cfg: ModelConfig) -> Dict[str, tuple]:
    """HF module name -> params path outside the layers (JAX :204-221)."""
    if cfg.arch == "opt":
        m = {"model.decoder.embed_tokens": ("embed",),
             "model.decoder.embed_positions": ("pos_embed",),
             "model.decoder.final_layer_norm": ("final_norm",)}
        if cfg.project_in_dim is not None:
            m["model.decoder.project_in"] = ("project_in",)
            m["model.decoder.project_out"] = ("project_out",)
    elif cfg.arch == "bloom":
        m = {"transformer.word_embeddings": ("embed",),
             "transformer.word_embeddings_layernorm": ("embed_ln",),
             "transformer.ln_f": ("final_norm",)}
    elif cfg.arch == "phi":
        m = {"model.embed_tokens": ("embed",), "model.final_layernorm": ("final_norm",)}
    else:
        m = {"model.embed_tokens": ("embed",), "model.norm": ("final_norm",)}
    if not cfg.tie_word_embeddings:
        m["lm_head"] = ("lm_head",)
    return m


def load_params_from_state_dict(cfg: ModelConfig, sd: Dict[str, Any], device=None) -> Params:
    """Map a flat HF state dict (tensors, or float numpy arrays) into the
    params tree in ``cfg.dtype`` on ``device`` (the card unless told
    otherwise). Every leaf is a copy: none aliases ``sd``."""
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]
    params: Params = {"layers": [dict() for _ in range(cfg.num_layers)]}

    def consume(mapping, tree):
        for hf_name, path in mapping.items():
            for leaf in ("weight", "bias"):
                key = f"{hf_name}.{leaf}"
                if key not in sd:
                    continue
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = torch.as_tensor(sd[key]).to(device=dev, dtype=dt, copy=True)

    consume(_hf_top_map(cfg), params)
    for i in range(cfg.num_layers):
        consume(_hf_key_map(cfg, i), params["layers"][i])
    # BLOOM's query_key_value is stored (H, 3, D) along N, the layout the
    # forward reshapes: loaded as stored (JAX :244-248)
    return params


def save_compressed(params, cfg: ModelConfig, path, hf_config: Optional[dict] = None,
                    tokenizer_path: Optional[str] = None) -> None:
    """Write the compressed checkpoint of ``params`` (unfused, unstacked) to
    the directory ``path``: ``model.safetensors``, ``packed.npz`` when a
    weight is packed, ``config.json`` when ``hf_config`` is given (see the
    module doc). Copying a tokenizer needs ``transformers``, which the port
    does not use: ``tokenizer_path`` raises."""
    if tokenizer_path is not None:
        raise NotImplementedError(
            "copying the tokenizer is not ported yet: ROADMAP.md queue A item 12")
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    sd: Dict[str, torch.Tensor] = {}
    packed: Dict[str, np.ndarray] = {}
    descr: Dict[str, str] = {}

    def emit(hf_name, node):
        for leaf in ("weight", "bias"):
            if leaf not in node:
                continue
            v = node[leaf]
            key = f"{hf_name}.{leaf}"
            if isinstance(v, QTensor):
                codes = v.codes.detach().cpu()
                if codes.dtype in FP8_DTYPES.values():
                    descr[f"{key}.codes"] = FP8_DESCR[str(codes.dtype).split(".")[-1]]
                    codes = codes.view(torch.uint8)
                packed[f"{key}.codes"] = codes.numpy()
                packed[f"{key}.scales"] = v.scales.detach().cpu().numpy()
                if v.zeros is not None:
                    packed[f"{key}.zeros"] = v.zeros.detach().cpu().numpy()
                if v.pair_planes:
                    packed[f"{key}.pair"] = np.asarray(True)
                v = dequantize(v)
            sd[key] = v.float()

    def walk(mapping, tree):
        for hf_name, p in mapping.items():
            node = tree
            for k in p:
                if k not in node:
                    break
                node = node[k]
            else:
                emit(hf_name, node)

    walk(_hf_top_map(cfg), params)
    for i in range(cfg.num_layers):
        walk(_hf_key_map(cfg, i), params["layers"][i])
    save_file(sd, path / "model.safetensors")
    if packed:
        save_npz(path / "packed.npz", packed, descr)
    if hf_config is not None:
        (path / "config.json").write_text(json.dumps(hf_config, indent=2))


def _tensor(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def load_compressed(path, cfg: ModelConfig, qcfg: Optional[QuantConfig] = None,
                    device=None) -> Params:
    """The params :func:`save_compressed` wrote, on ``device`` (the card
    unless told otherwise): the float leaves from ``model.safetensors`` in
    ``cfg.dtype``; with ``qcfg``, each layer's packed weight rebuilt from
    ``packed.npz`` as the QTensor the JAX package rebuilds (the exact
    calibrated payload, no re-quantization), its quantizer resolved per op
    through ``qcfg.for_op``, so that an MPQ plan's overrides apply. Every
    format's codes load: int4 / int8, fp8, fp4 e2m1, MX and NVFP4."""
    from ..algorithms.common import SLOT_PATH
    from ..qformats.blocking import resolve_group
    from .transformer import arch_slots, op_names

    dev = resolve_device(device)
    path = Path(path)
    sd = load_file(path / "model.safetensors")
    params = load_params_from_state_dict(cfg, sd, dev)
    packed_file = path / "packed.npz"
    if not (packed_file.exists() and qcfg is not None):
        return params
    data = load_npz(packed_file)
    for i, lp in enumerate(params["layers"]):
        names = op_names(cfg, i)
        hf_of = {v: k for k, v in _hf_key_map(cfg, i).items()}
        for slot in arch_slots(cfg):
            hf = hf_of[SLOT_PATH[slot]]
            ck, sk, zk = (f"{hf}.weight.{f}" for f in ("codes", "scales", "zeros"))
            if ck not in data:
                continue
            q = qcfg.for_op(names[slot], "linear").weight
            codes = _tensor(data[ck], dev)
            if q.fmt in FP8_DTYPES:  # read as their bytes
                codes = codes.view(FP8_DTYPES[q.fmt])
            scales = data[sk]
            shape = tuple(sd[f"{hf}.weight"].shape)
            group, _ = resolve_group(q.group_size, q.eff_axes, shape)
            n_groups = scales.shape[1] if scales.ndim >= 2 else 1
            node = lp
            for k in SLOT_PATH[slot]:
                node = node[k]
            node["weight"] = QTensor(
                codes=codes, scales=_tensor(scales, dev),
                zeros=_tensor(data[zk], dev) if zk in data else None, quantizer=q,
                shape=shape, blocked_shape=(shape[0], n_groups, group),
                group_axis=2, ngroups_axis=1, dtype=DTYPES[cfg.dtype],
                pair_planes=f"{hf}.weight.pair" in data and bool(data[f"{hf}.weight.pair"]))
    return params


def load_hf_checkpoint(path, dtype: Optional[str] = None, device=None):
    """(cfg, params) of a local HF directory of a ported architecture: ``config.json`` and
    every ``*.safetensors`` in it (shards included), on ``device`` (the
    card unless told otherwise), in ``dtype`` (the config's default,
    bfloat16, if None)."""
    dev = resolve_device(device)
    path = Path(path)
    cfg = from_hf_config(json.loads((path / "config.json").read_text()))
    if dtype is not None:
        cfg = replace(cfg, dtype=dtype)
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files in {path}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(load_file(f))
    return cfg, load_params_from_state_dict(cfg, sd, dev)
