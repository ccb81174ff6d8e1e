"""ImageReward, the back end of the text-to-image ImageReward metric (port
of ``evalx/image_reward_jax.py``; the reference scores images through the
``ImageReward`` package, reference evaluation/t2i_eval.py:196-244): the
BLIP backbone (ViT vision encoder, a BERT text encoder whose every layer
cross-attends to the image tokens) and a 5-linear MLP reward head with the
published normalization constants, as plain functions over a params dict
of float32 tensors. Only :class:`ImageRewardScorer` imports
``transformers``, for a local BERT tokenizer.

    reward(prompt, image) = (mlp(text_enc(prompt | image_tokens)[:, 0])
                             - MEAN) / STD
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from .clip import layer_norm, linear, patchify

# Published ImageReward-v1.0 normalization (ImageReward/ImageReward.py).
REWARD_MEAN = 0.16717362830052426
REWARD_STD = 1.0333394966054072


@dataclass(frozen=True)
class BlipConfig:
    # vision tower (ViT, pre-LN, fused qkv)
    v_hidden: int = 1024
    v_inter: int = 4096
    v_layers: int = 24
    v_heads: int = 16
    image_size: int = 224
    patch_size: int = 16
    # text tower (BERT post-LN + per-layer cross-attention)
    t_hidden: int = 768
    t_inter: int = 3072
    t_layers: int = 12
    t_heads: int = 12
    t_vocab: int = 30524
    t_max_pos: int = 512
    eps: float = 1e-12
    v_eps: float = 1e-5


def _mha(q, k, v, heads, mask=None):
    """(B, Tq|Tk, E) projections -> (B, Tq, E): BERT / ViT softmax
    attention."""
    B, Tq, E = q.shape
    Tk = k.shape[1]
    D = E // heads
    q = q.reshape(B, Tq, heads, D)
    k = k.reshape(B, Tk, heads, D)
    v = v.reshape(B, Tk, heads, D)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    if mask is not None:
        s = s + mask
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, Tq, E)


def _gelu(x):
    return torch.nn.functional.gelu(x)


@torch.inference_mode()
def encode_image_blip(params, pixel_values, cfg: BlipConfig):
    """(B, 3, S, S) normalized float -> every image token (B, N + 1,
    v_hidden) after the final LayerNorm (what BLIP's visual_encoder returns
    and the text tower cross-attends to)."""
    vp = params["vision"]
    px = torch.as_tensor(pixel_values, dtype=torch.float32, device=vp["class_embedding"].device)
    B = px.shape[0]
    x = patchify(px, cfg.patch_size, cfg.image_size)
    x = x @ vp["patch_embedding"]["weight"].reshape(cfg.v_hidden, -1).T
    x = x + vp["patch_embedding"]["bias"]
    cls = vp["class_embedding"].expand(B, 1, cfg.v_hidden)
    x = torch.cat([cls, x], dim=1) + vp["position_embedding"][None]
    for lp in vp["layers"]:
        h = layer_norm(x, lp["ln1"], cfg.v_eps)
        qkv = linear(h, lp["qkv"]).reshape(*h.shape[:2], 3, cfg.v_hidden)
        a = _mha(qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :], cfg.v_heads)
        x = x + linear(a, lp["proj"])
        h = layer_norm(x, lp["ln2"], cfg.v_eps)
        x = x + linear(_gelu(linear(h, lp["fc1"])), lp["fc2"])
    return layer_norm(x, vp["post_ln"], cfg.v_eps)


@torch.inference_mode()
def encode_text_blip(params, input_ids, attention_mask, image_embeds, cfg: BlipConfig):
    """The BERT post-LN text encoder; each layer: self-attention
    (bidirectional, padding masked) -> cross-attention over
    ``image_embeds`` -> FFN, each with its residual and LayerNorm
    (salesforce med.py via HF BlipTextModel). -> last_hidden_state
    (B, T, t_hidden)."""
    tp = params["text"]
    dev = tp["word_embeddings"].device
    ids = torch.as_tensor(np.asarray(input_ids), device=dev).long()
    am = torch.as_tensor(np.asarray(attention_mask), device=dev)
    B, T = ids.shape
    x = tp["word_embeddings"][ids] + tp["position_embeddings"][None, :T]
    x = layer_norm(x, tp["embed_ln"], cfg.eps)
    pad = ((1.0 - am.float()) * -1e9)[:, None, None, :]   # (B, 1, 1, T)
    for lp in tp["layers"]:
        a = _mha(linear(x, lp["q"]), linear(x, lp["k"]), linear(x, lp["v"]), cfg.t_heads,
                 mask=pad)
        x = layer_norm(x + linear(a, lp["attn_out"]), lp["attn_ln"], cfg.eps)
        c = _mha(linear(x, lp["xq"]), linear(image_embeds, lp["xk"]),
                 linear(image_embeds, lp["xv"]), cfg.t_heads)
        x = layer_norm(x + linear(c, lp["cross_out"]), lp["cross_ln"], cfg.eps)
        f = linear(_gelu(linear(x, lp["fc1"])), lp["fc2"])
        x = layer_norm(x + f, lp["ffn_ln"], cfg.eps)
    return x


def reward_scores(params, pixel_values, input_ids, attention_mask, cfg: BlipConfig) -> np.ndarray:
    """The normalized ImageReward of each pair: (B,) float32 numpy."""
    img = encode_image_blip(params, pixel_values, cfg)
    txt = encode_text_blip(params, input_ids, attention_mask, img, cfg)
    h = txt[:, 0]
    for lp in params["mlp"]:
        h = linear(h, lp)
    return ((h[:, 0] - REWARD_MEAN) / REWARD_STD).cpu().numpy()


def load_image_reward_params(sd: Dict[str, np.ndarray], cfg: BlipConfig, device=None) -> dict:
    """An ImageReward-v1.0 state dict (timm-style ``blip.visual_encoder.*``,
    med-BERT ``blip.text_encoder.*``, ``mlp.layers.*``; numpy arrays or
    tensors) as the params dict, float32 on ``device`` (the card unless
    told otherwise)."""
    dev = resolve_device(device)
    g = lambda k: torch.as_tensor(np.asarray(sd[k]), dtype=torch.float32, device=dev)  # noqa: E731

    def lin(prefix):
        d = {"weight": g(prefix + ".weight")}
        if prefix + ".bias" in sd:
            d["bias"] = g(prefix + ".bias")
        return d

    v_layers = []
    i = 0
    while f"blip.visual_encoder.blocks.{i}.norm1.weight" in sd:
        p = f"blip.visual_encoder.blocks.{i}"
        v_layers.append({
            "ln1": lin(p + ".norm1"), "ln2": lin(p + ".norm2"),
            "qkv": lin(p + ".attn.qkv"), "proj": lin(p + ".attn.proj"),
            "fc1": lin(p + ".mlp.fc1"), "fc2": lin(p + ".mlp.fc2"),
        })
        i += 1

    t_layers = []
    i = 0
    while f"blip.text_encoder.encoder.layer.{i}.attention.self.query.weight" in sd:
        p = f"blip.text_encoder.encoder.layer.{i}"
        t_layers.append({
            "q": lin(p + ".attention.self.query"),
            "k": lin(p + ".attention.self.key"),
            "v": lin(p + ".attention.self.value"),
            "attn_out": lin(p + ".attention.output.dense"),
            "attn_ln": lin(p + ".attention.output.LayerNorm"),
            "xq": lin(p + ".crossattention.self.query"),
            "xk": lin(p + ".crossattention.self.key"),
            "xv": lin(p + ".crossattention.self.value"),
            "cross_out": lin(p + ".crossattention.output.dense"),
            "cross_ln": lin(p + ".crossattention.output.LayerNorm"),
            "fc1": lin(p + ".intermediate.dense"),
            "fc2": lin(p + ".output.dense"),
            "ffn_ln": lin(p + ".output.LayerNorm"),
        })
        i += 1

    mlp_idx = sorted({int(k.split(".")[2]) for k in sd
                      if k.startswith("mlp.layers.") and k.endswith(".weight")})
    return {
        "vision": {
            "class_embedding": g("blip.visual_encoder.cls_token").reshape(1, -1),
            "position_embedding": g("blip.visual_encoder.pos_embed")[0],
            "patch_embedding": lin("blip.visual_encoder.patch_embed.proj"),
            "layers": v_layers,
            "post_ln": lin("blip.visual_encoder.norm"),
        },
        "text": {
            "word_embeddings": g("blip.text_encoder.embeddings.word_embeddings.weight"),
            "position_embeddings": g("blip.text_encoder.embeddings.position_embeddings.weight"),
            "embed_ln": lin("blip.text_encoder.embeddings.LayerNorm"),
            "layers": t_layers,
        },
        "mlp": [lin(f"mlp.layers.{i}") for i in mlp_idx],
    }


class ImageRewardScorer:
    """Score (image, prompt) pairs with a local ImageReward checkpoint (a
    ``.pt`` state dict and a local BERT tokenizer directory; no hub
    download), on ``device`` (the card unless told otherwise)."""

    def __init__(self, checkpoint_path: str, tokenizer_path: str,
                 cfg: BlipConfig = BlipConfig(), device=None):
        import transformers

        sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        self.cfg = cfg
        self.params = load_image_reward_params(sd, cfg, device)
        self.tokenizer = transformers.AutoTokenizer.from_pretrained(tokenizer_path)

    def score(self, images, prompts) -> np.ndarray:
        from .clip import preprocess_images

        px = preprocess_images(images, self.cfg.image_size)
        enc = self.tokenizer(list(prompts), padding="max_length", max_length=35,
                             truncation=True, return_tensors="np")
        return reward_scores(self.params, px, enc["input_ids"], enc["attention_mask"], self.cfg)
