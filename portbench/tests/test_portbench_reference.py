"""The plain reference against a frozen float forward pass written out
step by step: with quantization off, every path of the reference (the
chunked prompt, the generated positions) is the architecture's equations."""

import math

import pytest
import torch
import torch.nn.functional as F

import tiny
from portbench import harness, weights
from portbench.reference import model as ref
from portbench.spec import spec_of


def plain_forward(spec, W, tokens):
    """Logits (T, V) of a float32 forward over the whole sequence, a
    position and a head at a time."""
    T = tokens.shape[0]
    f = {k: v.float() for k, v in W.items()}
    table = f["embed"]
    h = table[tokens.long()]

    def norm(x, name, i=None):
        w = f[name] if i is None else f[name][i]
        if spec.layernorm:
            b = f[name + ".bias"] if i is None else f[name + ".bias"][i]
            mu = x.mean(-1, keepdim=True)
            var = ((x - mu) ** 2).mean(-1, keepdim=True)
            return (x - mu) / torch.sqrt(var + spec.eps) * w + b
        return x / torch.sqrt((x * x).mean(-1, keepdim=True) + spec.eps) * w

    def lin(x, name, i):
        y = x @ f[name][i].t()
        return y + f[name + ".bias"][i] if name + ".bias" in f else y

    def rot(x, p):
        r = spec.rotary_dim
        out = x.clone()
        for j in range(r // 2):
            ang = p * spec.rope_theta ** (-2 * j / r)
            a, b = x[..., j], x[..., j + r // 2]
            out[..., j] = a * math.cos(ang) - b * math.sin(ang)
            out[..., j + r // 2] = b * math.cos(ang) + a * math.sin(ang)
        return out

    D, r = spec.head_dim, spec.heads // spec.kv_heads
    for i in range(spec.layers):
        x = norm(h, "ln1", i)
        q = lin(x, "q", i).reshape(T, spec.heads, D)
        k = lin(x, "k", i).reshape(T, spec.kv_heads, D)
        v = lin(x, "v", i).reshape(T, spec.kv_heads, D)
        if spec.qk_norm:
            q = q / torch.sqrt((q * q).mean(-1, keepdim=True) + spec.eps) * f["q_norm"][i]
            k = k / torch.sqrt((k * k).mean(-1, keepdim=True) + spec.eps) * f["k_norm"][i]
        q = torch.stack([rot(q[p], p) for p in range(T)])
        k = torch.stack([rot(k[p], p) for p in range(T)])
        att = torch.zeros(T, spec.heads, D)
        for p in range(T):
            for hd in range(spec.heads):
                s = (k[:p + 1, hd // r] @ q[p, hd]) / math.sqrt(D)
                att[p, hd] = torch.softmax(s, 0) @ v[:p + 1, hd // r]
        a = lin(att.reshape(T, -1), "o", i)
        if spec.parallel_residual:
            m = lin(F.gelu(lin(x, "fc1", i), approximate="tanh"), "fc2", i)
            h = h + a + m
        else:
            h = h + a
            x2 = norm(h, "ln2", i)
            h = h + lin(F.silu(lin(x2, "gate", i)) * lin(x2, "up", i), "down", i)
    hn = norm(h, "final_norm")
    lg = hn @ (f["embed"] if spec.tied else f["lm_head"]).t()
    return lg + f["lm_head.bias"] if spec.biases else lg


@pytest.mark.parametrize("cell", ["qwen3_1p7b_w4a8.decode_b1024_ctx1k", "phi2_w4a8.decode_b256_ctx1408"])
@pytest.mark.parametrize("chunk", [None, 8])
def test_reference_is_the_architecture(cell, chunk):
    c = harness.resolve(tiny.bench(), cell)
    tiny.shrink(c)
    spec = spec_of(c.config)
    W = weights.draw(spec, 7, "cpu")
    toks = torch.randint(0, spec.vocab, (20,), generator=torch.Generator().manual_seed(3))
    n_pre = 11
    s = ref.Sample(tokens=toks, n_prefill=n_pre, chunk=chunk, check_from=0, targets=toks)
    got = ref.logits(spec, W, [s], ref.FLOAT)[0]
    want = plain_forward(spec, W, toks)
    # the prompt's rows in chunk order, then the generated rows: float32 sums in other orders
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4), (got - want).abs().max()


def test_tied_head_is_quantized_as_the_head():
    c = harness.resolve(tiny.bench(), "qwen3_1p7b_w4a8.decode_b1024_ctx1k")
    spec = spec_of(c.config)
    assert spec.tied
    w = torch.randn(4, 256)
    q = ref.rtn(w, 8, 128)
    groups = w.reshape(4, 2, 128)
    step = groups.abs().amax(-1, keepdim=True) / 127
    assert torch.allclose(q.reshape(4, 2, 128), torch.round(groups / step) * step)
