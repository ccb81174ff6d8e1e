"""CLIP, the back end of the text-to-image CLIPScore metric (port of
``evalx/clip_jax.py``; the reference computes CLIPScore through
``torchmetrics``' wrapper around HF ``CLIPModel``, reference
evaluation/t2i_eval.py:246-262): the dual-tower CLIP (ViT vision encoder,
causal text encoder, quick-GELU, projection heads) as plain functions over
a params dict of float32 tensors, mapped from the HF ``CLIPModel`` state
dict. Only :class:`ClipScorer` imports ``transformers``, to read a local
checkpoint and its tokenizer.

Score semantics of torchmetrics.functional.multimodal.clip_score:
    score(img, prompt) = max(0, 100 * cos(image_embed, text_embed))
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device

# HF CLIPProcessor normalization constants (openai/clip-vit-*).
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclass(frozen=True)
class ClipTowerConfig:
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


@dataclass(frozen=True)
class ClipConfig:
    vision: ClipTowerConfig
    text: ClipTowerConfig
    image_size: int = 224
    patch_size: int = 16
    text_vocab: int = 49408
    text_max_pos: int = 77
    projection_dim: int = 512


def clip_config_from_hf(hf) -> ClipConfig:
    """From a ``transformers.CLIPConfig`` (or any object with
    ``vision_config`` / ``text_config`` / ``projection_dim``)."""
    v, t = hf.vision_config, hf.text_config
    return ClipConfig(
        vision=ClipTowerConfig(v.hidden_size, v.intermediate_size,
                               v.num_hidden_layers, v.num_attention_heads,
                               v.layer_norm_eps, v.hidden_act),
        text=ClipTowerConfig(t.hidden_size, t.intermediate_size,
                             t.num_hidden_layers, t.num_attention_heads,
                             t.layer_norm_eps, t.hidden_act),
        image_size=v.image_size, patch_size=v.patch_size,
        text_vocab=t.vocab_size, text_max_pos=t.max_position_embeddings,
        projection_dim=hf.projection_dim,
    )


def load_clip_params(sd: Dict[str, np.ndarray], cfg: ClipConfig, device=None) -> dict:
    """The flat HF ``CLIPModel`` state dict (numpy arrays or tensors) as the
    params dict, float32 on ``device`` (the card unless told otherwise).
    Linear weights stay (out, in)."""
    dev = resolve_device(device)
    g = lambda k: torch.as_tensor(np.asarray(sd[k]), dtype=torch.float32, device=dev)  # noqa: E731

    def lin(prefix):
        d = {"weight": g(prefix + ".weight")}
        if prefix + ".bias" in sd:
            d["bias"] = g(prefix + ".bias")
        return d

    def tower(prefix, n_layers):
        layers = []
        for i in range(n_layers):
            p = f"{prefix}.encoder.layers.{i}"
            layers.append({
                "ln1": lin(p + ".layer_norm1"),
                "ln2": lin(p + ".layer_norm2"),
                "q": lin(p + ".self_attn.q_proj"),
                "k": lin(p + ".self_attn.k_proj"),
                "v": lin(p + ".self_attn.v_proj"),
                "o": lin(p + ".self_attn.out_proj"),
                "fc1": lin(p + ".mlp.fc1"),
                "fc2": lin(p + ".mlp.fc2"),
            })
        return layers

    return {
        "vision": {
            "class_embedding": g("vision_model.embeddings.class_embedding"),
            "patch_embedding": g("vision_model.embeddings.patch_embedding.weight"),
            "position_embedding": g("vision_model.embeddings.position_embedding.weight"),
            "pre_ln": lin("vision_model.pre_layrnorm"),  # (sic — HF key)
            "layers": tower("vision_model", cfg.vision.num_layers),
            "post_ln": lin("vision_model.post_layernorm"),
            "projection": lin("visual_projection"),
        },
        "text": {
            "token_embedding": g("text_model.embeddings.token_embedding.weight"),
            "position_embedding": g("text_model.embeddings.position_embedding.weight"),
            "layers": tower("text_model", cfg.text.num_layers),
            "final_ln": lin("text_model.final_layer_norm"),
            "projection": lin("text_projection"),
        },
    }


def layer_norm(x, p, eps):
    """LayerNorm as the JAX towers write it: population variance, rsqrt."""
    m = torch.mean(x, dim=-1, keepdim=True)
    v = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - m) * torch.rsqrt(v + eps) * p["weight"] + p["bias"]


def linear(x, p):
    y = x @ p["weight"].T
    return y + p["bias"] if "bias" in p else y


def _act(x, kind):
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return torch.nn.functional.gelu(x)


def _encoder(layers, tc: ClipTowerConfig, x, mask=None):
    """The pre-LN transformer encoder of both towers. ``mask`` is an
    additive (1|B, 1, T, T) float mask (the text tower's causal mask)."""
    B, T, E = x.shape
    H = tc.num_heads
    D = E // H
    scale = D ** -0.5
    for lp in layers:
        h = layer_norm(x, lp["ln1"], tc.layer_norm_eps)
        q = linear(h, lp["q"]).reshape(B, T, H, D) * scale
        k = linear(h, lp["k"]).reshape(B, T, H, D)
        v = linear(h, lp["v"]).reshape(B, T, H, D)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            s = s + mask
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, E)
        x = x + linear(o, lp["o"])
        h = layer_norm(x, lp["ln2"], tc.layer_norm_eps)
        x = x + linear(_act(linear(h, lp["fc1"]), tc.hidden_act), lp["fc2"])
    return x


def patchify(pixel_values, patch: int, image_size: int):
    """(B, 3, S, S) -> (B, (S / p)^2, 3 p p): the input of the stride-p
    patch convolution as a matmul."""
    B = pixel_values.shape[0]
    gh = image_size // patch
    x = pixel_values.reshape(B, 3, gh, patch, gh, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, gh * gh, 3 * patch * patch)


@torch.inference_mode()
def encode_image(params, pixel_values, cfg: ClipConfig):
    """pixel_values (B, 3, H, W) normalized float -> L2-normalized image
    embeds (B, P)."""
    vp = params["vision"]
    tc = cfg.vision
    px = torch.as_tensor(pixel_values, dtype=torch.float32, device=vp["class_embedding"].device)
    B = px.shape[0]
    x = patchify(px, cfg.patch_size, cfg.image_size)
    x = x @ vp["patch_embedding"].reshape(tc.hidden_size, -1).T
    cls = vp["class_embedding"].expand(B, 1, tc.hidden_size)
    x = torch.cat([cls, x], dim=1) + vp["position_embedding"][None]
    x = layer_norm(x, vp["pre_ln"], tc.layer_norm_eps)
    x = _encoder(vp["layers"], tc, x)
    pooled = layer_norm(x[:, 0], vp["post_ln"], tc.layer_norm_eps)
    emb = linear(pooled, vp["projection"])
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


@torch.inference_mode()
def encode_text(params, input_ids, eot_idx, cfg: ClipConfig):
    """input_ids (B, T), eot_idx (B,) the position of each row's EOS token
    -> L2-normalized text embeds (B, P)."""
    tp = params["text"]
    tc = cfg.text
    dev = tp["token_embedding"].device
    ids = torch.as_tensor(np.asarray(input_ids), device=dev).long()
    eot = torch.as_tensor(np.asarray(eot_idx), device=dev).long()
    B, T = ids.shape
    x = tp["token_embedding"][ids] + tp["position_embedding"][None, :T]
    causal = torch.full((T, T), float("-inf"), device=dev).triu(1)
    x = _encoder(tp["layers"], tc, x, mask=causal[None, None])
    x = layer_norm(x, tp["final_ln"], tc.layer_norm_eps)
    pooled = x[torch.arange(B, device=dev), eot]
    emb = linear(pooled, tp["projection"])
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


def preprocess_images(images, image_size: int = 224) -> np.ndarray:
    """uint8 (H, W, 3) images -> (B, 3, S, S) normalized float32, as HF's
    CLIPProcessor: bicubic resize of the short side, center crop, mean/std
    normalization. Needs PIL."""
    from PIL import Image

    out = []
    for im in images:
        img = Image.fromarray(np.asarray(im, np.uint8))
        w, h = img.size
        short = min(w, h)
        nw, nh = round(w * image_size / short), round(h * image_size / short)
        img = img.resize((nw, nh), Image.BICUBIC)
        left, top = (nw - image_size) // 2, (nh - image_size) // 2
        img = img.crop((left, top, left + image_size, top + image_size))
        a = np.asarray(img, np.float32) / 255.0
        a = (a - IMAGE_MEAN) / IMAGE_STD
        out.append(a.transpose(2, 0, 1))
    return np.stack(out)


def clip_scores(params, cfg: ClipConfig, pixel_values, input_ids, eot_idx) -> np.ndarray:
    """Per-pair CLIPScore, max(0, 100 * cos) (torchmetrics semantics), as a
    float32 numpy array."""
    ie = encode_image(params, pixel_values, cfg)
    te = encode_text(params, input_ids, eot_idx, cfg)
    return torch.clamp_min(torch.sum(ie * te, dim=-1) * 100.0, 0.0).cpu().numpy()


class ClipScorer:
    """Score (image, prompt) pairs with a local HF CLIP checkpoint directory
    (no hub download), on ``device`` (the card unless told otherwise)."""

    def __init__(self, clip_path: str, device=None):
        import transformers

        hf_cfg = transformers.CLIPConfig.from_pretrained(clip_path)
        self.cfg = clip_config_from_hf(hf_cfg)
        model = transformers.CLIPModel.from_pretrained(clip_path)
        sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
        self.params = load_clip_params(sd, self.cfg, device)
        self.tokenizer = transformers.AutoTokenizer.from_pretrained(clip_path)

    def score(self, images, prompts) -> np.ndarray:
        px = preprocess_images(images, self.cfg.image_size)
        enc = self.tokenizer(list(prompts), padding="max_length",
                             max_length=self.cfg.text_max_pos,
                             truncation=True, return_tensors="np")
        ids = enc["input_ids"].astype(np.int32)
        eot = (ids == self.tokenizer.eos_token_id).argmax(axis=-1)
        return clip_scores(self.params, self.cfg, px, ids, eot)
