"""Plain float32 reference of a served integer recipe (the configuration's
``recipe``: W4A8 here), teacher-forced over whole sequences.

It reads the configuration's published shapes (``portbench/spec.py``) and
the seed-made float weights (``portbench/weights.py``), and works out
everything the recipe derives from them itself: the RTN'd weights
(symmetric absmax per group along the input dim, at the recipe's bits for
the linears and for the head; a tied table is the head's and so is
quantized as the head), the per-token activation quantizers, the int8 KV
cache and the attention's operands at the activations' bits. It imports nothing of the
program. Matmuls run in float32 with TF32 off.

The recipe's attention (the quantizer config of the matmuls: the
activation quantizer on the inputs of both attention matmuls, the second operand's groups
running across its rows, over an int8 per-token KV cache):

* prompt positions (prefill, in chunks of ``chunk`` rows where the server
  prefills so, the prompt padded with token 0 to whole chunks): q per
  (token, head) over D; the softmax probabilities per row over the keys;
  K and V from the cache, each per channel over the rows the chunk's
  window holds (the rows written so far, pad rows of the last chunk
  included);
* generated positions (one token a step, the fused-append kernel's math):
  q per (token, head); scores of the cache codes times their scales;
  ``w = exp(s - max) * v_scale`` quantized per row; the output
  ``(codes(w) . v_codes) * a / sum(exp)``.

``Bits`` states the precision of each stage (None: not quantized);
:func:`bits_of` reads it from a configuration's ``recipe`` and refuses
what the reference does not model; :func:`control_of` lowers every 8-bit
stage to 4 bits. A family whose layers this file does not model has a
reference of its own beside it (``portbench/family.py``), which may
import the quantizers and norms here (``rtn``, ``fq``, ``codes_scales``,
``rms``, ``rope``, the attention paths) so that their semantics stay one
code.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..spec import Spec


@dataclass(frozen=True)
class Bits:
    weight: Optional[int]        # linear weights, symmetric int, groups of ``group`` along K
    act: Optional[int]           # inputs of every linear and of both attention matmuls
    kv: Optional[int]            # KV cache, per (token, kv head)
    head_weight: Optional[int]   # head (and a tied embedding), groups of ``head_group``
    head_act: Optional[int]      # the head's input, per token
    group: int = 128
    head_group: int = 128


FLOAT = Bits(None, None, None, None, None)
RECIPE_KEYS = ("weight", "act_in", "head", "head_act", "kv_cache", "served_dtype")
# the quantizer strings the reference models: symmetric int4 or int8, groups
# along the row (``qformats.config``'s DSL without ``zp-``)
_INT_RW = re.compile(r"^int(?P<bits>[48])-g\[(?P<group>-1|[1-9][0-9]*)\]-rw$")
KV_INT8 = "int8-g[-1]-rw"


def _int_rw(recipe: dict, key: str, per_token: bool):
    m = _INT_RW.match(recipe[key])
    if m is None or (int(m["group"]) == -1) != per_token:
        want = "int<4|8>-g[-1]-rw" if per_token else "int<4|8>-g[<n>]-rw"
        raise ValueError(f"recipe {key} {recipe[key]!r}: the reference models {want} only")
    return int(m["bits"]), int(m["group"])


def bits_of(recipe: dict, own: Tuple[str, ...] = ()) -> Bits:
    """The precision of each stage that a configuration's ``recipe`` states.
    Refuses a recipe the reference does not model, rather than checking it
    against another one. ``own`` names the further keys that a family's
    reference models (its own ``bits_of`` reads them)."""
    if sorted(set(recipe) - set(own)) != sorted(RECIPE_KEYS):
        raise ValueError(f"recipe keys {sorted(recipe)}: the reference models "
                         f"{list(RECIPE_KEYS) + list(own)}")
    if recipe["served_dtype"] != "bfloat16":
        raise ValueError(f"served_dtype {recipe['served_dtype']!r}: the reference models bfloat16")
    if recipe["kv_cache"] != KV_INT8:
        raise ValueError(f"kv_cache {recipe['kv_cache']!r}: the reference models {KV_INT8!r} "
                         "(int8 codes, one f32 scale per token and kv head) only")
    weight, group = _int_rw(recipe, "weight", False)
    head_weight, head_group = _int_rw(recipe, "head", False)
    return Bits(weight=weight, act=_int_rw(recipe, "act_in", True)[0], kv=8,
                head_weight=head_weight, head_act=_int_rw(recipe, "head_act", True)[0],
                group=group, head_group=head_group)


def control_of(bits: Bits) -> Bits:
    """The control: every 8-bit stage of ``bits`` at 4 bits."""
    def low(b):
        return 4 if b == 8 else b

    return replace(bits, weight=low(bits.weight), act=low(bits.act), kv=low(bits.kv),
                   head_weight=low(bits.head_weight), head_act=low(bits.head_act))


@dataclass
class Sample:
    """One served sequence: ``tokens`` (T,) as fed (prompt, then every
    served token but the last), the first ``n_prefill`` of them prefilled,
    ``chunk`` the prefill's chunk rows (None: the prompt in one piece), and
    the positions ``check_from .. T-1`` whose logits chose ``targets``."""
    tokens: torch.Tensor
    n_prefill: int
    chunk: Optional[int]
    check_from: int
    targets: torch.Tensor


@contextlib.contextmanager
def strict_f32():
    """float32 matmuls in float32 (no TF32) inside the block."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd
        torch.set_float32_matmul_precision(prec)


def codes_scales(x: torch.Tensor, bits: Optional[int], dim: int):
    """Symmetric absmax quantization of ``x`` along ``dim``: integer-valued
    f32 codes in [-qmax, qmax] and the scale absmax / qmax (``x`` and 1
    where ``bits`` is None)."""
    if bits is None:
        return x, torch.ones_like(torch.amax(x, dim=dim, keepdim=True))
    qmax = 2 ** (bits - 1) - 1
    s = torch.clamp_min(torch.amax(torch.abs(x), dim=dim, keepdim=True) / qmax, 1e-8)
    return torch.clamp(torch.round(x / s), -qmax, qmax), s


def fq(x: torch.Tensor, bits: Optional[int], dim: int = -1) -> torch.Tensor:
    """Fake quantization (codes times scale) along ``dim``."""
    if bits is None:
        return x
    c, s = codes_scales(x, bits, dim)
    return c * s


def rtn(w: torch.Tensor, bits: Optional[int], group: int) -> torch.Tensor:
    """(N, K) weight, RTN'd per group of ``group`` along K, as f32 values."""
    if bits is None:
        return w.float()
    N, K = w.shape
    return fq(w.float().reshape(N, K // group, group), bits).reshape(N, K)


def rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps):
    d = x - torch.mean(x, dim=-1, keepdim=True)
    return d * torch.rsqrt(torch.mean(d * d, dim=-1, keepdim=True) + eps) * w + b


def rope(x, positions, spec: Spec):
    """Rotate-half rope on the first ``rotary_dim`` dims of (T, heads, D)."""
    rot = spec.rotary_dim
    inv = 1.0 / (spec.rope_theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                                  device=x.device) / rot))
    f = positions.float()[:, None] * inv
    emb = torch.cat([f, f], dim=-1)
    cos, sin = torch.cos(emb)[:, None], torch.sin(emb)[:, None]
    xr, rest = x[..., :rot], x[..., rot:]
    half = rot // 2
    rotated = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    return torch.cat([xr * cos + rotated * sin, rest], dim=-1)


def _layer_weights(spec: Spec, W: Dict[str, torch.Tensor], i: int, bits: Bits) -> dict:
    lw = {}
    for name in ("q", "k", "v", "o") + (("gate", "up", "down") if spec.gated else ("fc1", "fc2")):
        lw[name] = rtn(W[name][i], bits.weight, bits.group)
        if spec.biases:
            lw[name + ".b"] = W[name + ".bias"][i].float()
    for name in ("ln1", "ln2", "q_norm", "k_norm"):
        if name in W:
            lw[name] = W[name][i].float()
            if name + ".bias" in W:
                lw[name + ".b"] = W[name + ".bias"][i].float()
    return lw


def _linear(x, lw, name, bits: Bits):
    y = fq(x, bits.act) @ lw[name].t()
    return y + lw[name + ".b"] if name + ".b" in lw else y


def _norm(spec: Spec, x, lw, name):
    if spec.layernorm:
        return layer_norm(x, lw[name], lw[name + ".b"], spec.eps)
    return rms(x, lw[name], spec.eps)


def _qkv(spec: Spec, x, positions, lw, bits: Bits):
    T = x.shape[0]
    q = _linear(x, lw, "q", bits).reshape(T, spec.heads, spec.head_dim)
    k = _linear(x, lw, "k", bits).reshape(T, spec.kv_heads, spec.head_dim)
    v = _linear(x, lw, "v", bits).reshape(T, spec.kv_heads, spec.head_dim)
    if spec.qk_norm:
        q, k = rms(q, lw["q_norm"], spec.eps), rms(k, lw["k_norm"], spec.eps)
    return rope(q, positions, spec), rope(k, positions, spec), v


def _grouped(spec: Spec, q):
    """(T, H, D) -> (KV, r, T, D): head h reads kv head h // r."""
    T = q.shape[0]
    r = spec.heads // spec.kv_heads
    return q.reshape(T, spec.kv_heads, r, spec.head_dim).permute(1, 2, 0, 3)


def _ungroup(out):
    """(KV, r, T, D) -> (T, H * D)."""
    KV, r, T, D = out.shape
    return out.permute(2, 0, 1, 3).reshape(T, KV * r * D)


def _prefill_attention(spec: Spec, q, kq, vq, chunk: int, bits: Bits):
    """Prompt rows over the cache's dequantized K and V (T, KV, D), chunk by
    chunk; returns (T, H * D)."""
    T = q.shape[0]
    scale = spec.head_dim ** -0.5
    outs = []
    for c0 in range(0, T, chunk):
        c1 = c0 + chunk
        qq = _grouped(spec, fq(q[c0:c1], bits.act))                     # (KV, r, C, D)
        kk = fq(kq[:c1], bits.act, dim=0).permute(1, 0, 2)               # per channel over rows
        s = torch.einsum("krtd,ksd->krts", qq, kk) * scale
        qpos = torch.arange(c0, c1, device=q.device)[:, None]
        keep = torch.arange(c1, device=q.device)[None, :] <= qpos
        p = torch.softmax(torch.where(keep, s, torch.full_like(s, -1e9)), dim=-1)
        vv = fq(vq[:c1], bits.act, dim=0).permute(1, 0, 2)               # per channel over rows
        outs.append(_ungroup(torch.einsum("krts,ksd->krtd", fq(p, bits.act), vv)))
    return torch.cat(outs)


def _decode_attention(spec: Spec, q, k_all, v_codes, v_scale, n_pre: int, bits: Bits):
    """Generated rows (the fused-append kernel's math): q (nB, H, D) at
    positions n_pre + j over keys [0, n_pre + j]; k_all (S, KV, D) the
    cache's dequantized keys, v_codes (S, KV, D), v_scale (S, KV, 1)."""
    nB = q.shape[0]
    S = k_all.shape[0]
    qq = _grouped(spec, fq(q, bits.act))                                 # (KV, r, nB, D)
    s = torch.einsum("krtd,ksd->krts", qq, k_all.permute(1, 0, 2)) * spec.head_dim ** -0.5
    keep = (torch.arange(S, device=q.device)[None, :]
            <= n_pre + torch.arange(nB, device=q.device)[:, None])
    s = torch.where(keep, s, torch.full_like(s, -1e9))
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    w = e * v_scale[:, :, 0].t()[:, None, None, :]
    pi, a = codes_scales(w, bits.act, -1)
    out = torch.einsum("krts,ksd->krtd", pi, v_codes.permute(1, 0, 2)) * (a / e.sum(-1, keepdim=True))
    return _ungroup(out)


ACTS = {"silu": F.silu, "gelu_tanh": lambda x: F.gelu(x, approximate="tanh")}


def _mlp(spec: Spec, x, lw, bits: Bits):
    act = ACTS[spec.act]
    if spec.gated:
        m = act(_linear(x, lw, "gate", bits)) * _linear(x, lw, "up", bits)
    else:
        m = act(_linear(x, lw, "fc1", bits))
    return _linear(m, lw, "down" if spec.gated else "fc2", bits)


class _State:
    """One sample's hidden states: the padded prompt (phase A) and the
    generated positions (phase B)."""

    def __init__(self, sample: Sample, table: torch.Tensor):
        t = sample.tokens.to(table.device).long()
        n_pre = sample.n_prefill
        self.chunk = sample.chunk or n_pre
        padded = -(-n_pre // self.chunk) * self.chunk
        pa = torch.zeros(padded, dtype=torch.long, device=table.device)
        pa[:n_pre] = t[:n_pre]
        self.n_pre = n_pre
        self.pos_a = torch.arange(padded, device=table.device)
        self.pos_b = torch.arange(n_pre, t.shape[0], device=table.device)
        self.ha = table[pa]
        self.hb = table[t[n_pre:]]


def _layer(spec: Spec, st: _State, lw: dict, bits: Bits) -> None:
    xa, xb = _norm(spec, st.ha, lw, "ln1"), _norm(spec, st.hb, lw, "ln1")
    qa, ka, va = _qkv(spec, xa, st.pos_a, lw, bits)
    qb, kb, vb = _qkv(spec, xb, st.pos_b, lw, bits)
    kaq, kbq = fq(ka, bits.kv), fq(kb, bits.kv)
    vac, vas = codes_scales(va, bits.kv, -1)
    vbc, vbs = codes_scales(vb, bits.kv, -1)
    att_a = _prefill_attention(spec, qa, kaq, vac * vas, st.chunk, bits)
    n = st.n_pre
    att_b = _decode_attention(spec, qb, torch.cat([kaq[:n], kbq]), torch.cat([vac[:n], vbc]),
                              torch.cat([vas[:n], vbs]), n, bits)
    att_a, att_b = _linear(att_a, lw, "o", bits), _linear(att_b, lw, "o", bits)
    if spec.parallel_residual:
        st.ha = st.ha + att_a + _mlp(spec, xa, lw, bits)
        st.hb = st.hb + att_b + _mlp(spec, xb, lw, bits)
        return
    st.ha, st.hb = st.ha + att_a, st.hb + att_b
    st.ha = st.ha + _mlp(spec, _norm(spec, st.ha, lw, "ln2"), lw, bits)
    st.hb = st.hb + _mlp(spec, _norm(spec, st.hb, lw, "ln2"), lw, bits)


@torch.no_grad()
def logits(spec: Spec, W: Dict[str, torch.Tensor], samples: List[Sample],
           bits: Bits) -> List[torch.Tensor]:
    """Per sample, the f32 logits (T - check_from, V) of its checked
    positions, layer by layer over all samples."""
    with strict_f32():
        head_w = rtn(W["embed" if spec.tied else "lm_head"], bits.head_weight, bits.head_group)
        table = head_w if spec.tied else W["embed"].float()
        states = [_State(s, table) for s in samples]
        del table
        for i in range(spec.layers):
            lw = _layer_weights(spec, W, i, bits)
            for st in states:
                _layer(spec, st, lw, bits)
            del lw
        fn = {"final_norm": W["final_norm"].float()}
        if spec.layernorm:
            fn["final_norm.b"] = W["final_norm.bias"].float()
        out = []
        for s, st in zip(samples, states):
            rows = torch.cat([st.ha[s.check_from:st.n_pre], st.hb[max(0, s.check_from - st.n_pre):]])
            h = fq(_norm(spec, rows, fn, "final_norm"), bits.head_act)
            lg = h @ head_w.t()
            if spec.biases:
                lg = lg + W["lm_head.bias"].float()
            out.append(lg)
        return out


def widest_gap(ref: torch.Tensor, chosen: torch.Tensor) -> float:
    """The widest gap by which a chosen token's reference logit lies below
    the reference's best, over the rows of ``ref`` (n, V)."""
    best = torch.amax(ref, dim=-1)
    got = ref.gather(1, chosen.to(ref.device).long()[:, None])[:, 0]
    return float(torch.amax(best - got))
