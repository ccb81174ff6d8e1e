"""SpinQuant — rotation-based outlier suppression, then GPTQ (port of
``algorithms/spinquant.py``).

Reference: spinquant/{core.py:45-165, rotation_utils.py:20-161,
fuse_norm_utils.py:5-61, optimizer.py}. Pipeline:

1. untie the embeddings (core.py:151-154);
2. fuse the RMSNorm weights into the following linears and recenter the
   embedding rows (fuse_norm_utils.py:29-61);
3. rotate: R1 (hidden x hidden) on the embedding, head, q/k/v/gate/up
   inputs and o/down outputs; a per-layer R2 (head_dim) on V's output
   rows and O's input columns, per head (rotation_utils.py:57-159);
4. GPTQ on the rotated model.

Steps 2 and 3 run in float64 on the params' device, each product cast
once to the params' dtype, as the JAX package's host float64 (the
reference's ``.double()``) does. ``mode="hadamard"`` draws randomized
orthonormal Hadamard matrices (B10, ``kernels/hadamard.py``) with signs
from a CPU ``torch.Generator`` seeded with ``seed``, so the card and the
CPU draw the same rotations (the JAX package draws from its own PRNG, so
one seed gives other signs there); a ``rotation_path`` holding ``R.npz``
(the JAX package's format) supplies them instead. ``mode="optimize"``
starts from those Hadamard draws and learns R1 and the R2s on the
unfused model before step 2: Cayley SGD on the Stiefel manifold (the
reference's SGDG, optimizer.py:47-189) through PyTorch autograd of the
straight-through-estimated quantized CE loss, whose every weight is
rotated and fake-quantized in float32 on the fly; then it saves
``R.npz`` under ``rotation_path``. Llama family only, as the reference
(core.py:63-71).
"""

from __future__ import annotations

import logging
import time
from dataclasses import replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..capture.pipeline import capture_layer0
from ..kernels.hadamard import random_hadamard_matrix
from ..models.config import ModelConfig
from ..models.transformer import forward
from ..qformats.config import QuantConfig
from ..qformats.quantize import quantize_dequant
from .common import PhaseTimer, copy_tree, get_bias, get_weight, set_bias, set_weight
from .gptq import gptq

LOGGER = logging.getLogger(__name__)


def fuse_layer_norms(params, cfg: ModelConfig) -> None:
    """Fold the RMSNorm weights into the following linears and recenter the
    embedding rows, in float64 (in place)."""
    dt = params["embed"]["weight"].dtype
    E = params["embed"]["weight"].double()
    params["embed"]["weight"] = (E - E.mean(-1, keepdim=True)).to(dt)
    del E
    for lp in params["layers"]:
        for norm_key, slots in (("ln1", ("q", "k", "v")), ("ln2", ("gate", "up"))):
            w_norm = lp[norm_key]["weight"].double()
            for slot in slots:
                set_weight(lp, slot, (get_weight(lp, slot).double() * w_norm[None, :]).to(dt))
            lp[norm_key]["weight"] = torch.ones_like(lp[norm_key]["weight"])
    if "final_norm" in params and "lm_head" in params:
        w_norm = params["final_norm"]["weight"].double()
        params["lm_head"]["weight"] = (params["lm_head"]["weight"].double()
                                       * w_norm[None, :]).to(dt)
        params["final_norm"]["weight"] = torch.ones_like(params["final_norm"]["weight"])


def _rotate_params(params, cfg: ModelConfig, R1, R2s) -> None:
    """Apply R1 and the per-layer R2s to every weight, in float64 (in
    place). ``R1`` / ``R2s`` are tensors or numpy arrays."""
    dev = params["embed"]["weight"].device
    dt = params["embed"]["weight"].dtype
    R1 = torch.as_tensor(R1, dtype=torch.float64, device=dev)
    d, kvh, H = cfg.head_dim, cfg.num_kv_heads, cfg.num_heads

    for key in ("embed", "lm_head"):
        params[key]["weight"] = (params[key]["weight"].double() @ R1).to(dt)
    for i, lp in enumerate(params["layers"]):
        for slot in ("q", "k", "v", "gate", "up"):
            set_weight(lp, slot, (get_weight(lp, slot).double() @ R1).to(dt))
        for slot in ("o", "down"):
            set_weight(lp, slot, (R1.t() @ get_weight(lp, slot).double()).to(dt))
            b = get_bias(lp, slot)
            if b is not None:
                set_bias(lp, slot, (R1.t() @ b.double()).to(dt))
        R2 = torch.as_tensor(R2s[i], dtype=torch.float64, device=dev)
        # V: rotate each head's OUTPUT rows (rotation_utils.py:113-118)
        Wv = get_weight(lp, "v").double()
        Wv = torch.einsum("hdi,de->hei", Wv.reshape(kvh, d, -1), R2).reshape(Wv.shape)
        set_weight(lp, "v", Wv.to(dt))
        # O: rotate each head's INPUT columns
        Wo = get_weight(lp, "o").double()
        Wo = torch.einsum("ohd,de->ohe", Wo.reshape(-1, H, d), R2).reshape(Wo.shape)
        set_weight(lp, "o", Wo.to(dt))


def _untie(params, cfg: ModelConfig) -> ModelConfig:
    if "lm_head" not in params:
        params["lm_head"] = {"weight": params["embed"]["weight"].clone()}
        cfg = replace(cfg, tie_word_embeddings=False)
    return cfg


def load_rotations(path, cfg: ModelConfig):
    data = np.load(Path(path))
    return data["R1"], [data[f"R2.{i}"] for i in range(cfg.num_layers)]


def save_rotations(path, R1, R2s) -> None:
    as_np = lambda r: r.cpu().numpy() if torch.is_tensor(r) else np.asarray(r)
    np.savez(Path(path), R1=as_np(R1), **{f"R2.{i}": as_np(r) for i, r in enumerate(R2s)})


def hadamard_rotations(cfg: ModelConfig, seed: int, device):
    """R1 (hidden) and one R2 (head_dim) per layer: randomized Hadamard
    matrices, signs from a CPU generator seeded with ``seed``, transforms
    on ``device`` (1 + num_layers launches of B10 on the card)."""
    gen = torch.Generator().manual_seed(seed)
    R1 = random_hadamard_matrix(cfg.hidden_size, gen, device=device).double()
    R2s = [random_hadamard_matrix(cfg.head_dim, gen, device=device).double()
           for _ in range(cfg.num_layers)]
    return R1, R2s


# ---------------------------------------------------------------------------
# Cayley-SGD rotation optimization (mode="optimize", JAX :125-270)
# ---------------------------------------------------------------------------


def _ste_qdq(q, x):
    """Straight-through fake quantization: the forward rounds as the jitted
    ``quantize_dequant``, the gradient is the identity."""
    if q.qtype == "dummy":
        return x
    return x + (quantize_dequant(q, x) - x).detach()


def _cayley_step(R, G, lr: float):
    """The plain Cayley retraction R <- (I + a/2 A)^-1 (I - a/2 A) R with
    A = G R^T - R G^T (no momentum, an exact solve)."""
    A = G @ R.T - R @ G.T
    eye = torch.eye(R.shape[0], dtype=R.dtype, device=R.device)
    return torch.linalg.solve(eye + (lr / 2) * A, (eye - (lr / 2) * A) @ R)


def _sgdg_stiefel_step(R, G, V, lr, momentum: float = 0.0, eps: float = 1e-8):
    """One SGDG Stiefel update (reference optimizer.py:121-160) of R, or of
    a stack of them (..., n, n) with their gradients and buffers:

    * X = R with each row normalised;
    * the buffer V <- momentum V - G^T;
    * W = skew(V X - 0.5 X^T X V X), the canonical tangent projection;
    * alpha = min(lr, 1 / (max column sum |W| + eps)), per matrix;
    * five Cayley fixed-point iterations Y = X^T + alpha W (X^T + Y) / 2,
      from Y = X^T + alpha V;
    * the buffer projected back, V <- W X^T.

    ``lr`` is a float32 tensor (the JAX step's traced rate). Returns
    (R_new, V_new). The reference runs momentum 0 (core.py:125-127); the
    buffer is kept for callers that want momentum."""
    t_ = lambda a: a.transpose(-1, -2)
    X = R / (torch.linalg.vector_norm(R, dim=-1, keepdim=True) + eps)
    V = momentum * V - t_(G)
    MX = V @ X
    XMX = X @ MX
    XXMX = t_(X) @ XMX
    W_hat = MX - 0.5 * XXMX
    W = W_hat - t_(W_hat)
    # matrix_norm_one: the largest column sum of |W| (optimizer.py:17-21,156)
    t = 1.0 / (torch.amax(torch.sum(torch.abs(W), dim=-2), dim=-1) + eps)
    alpha = torch.minimum(t, lr)[..., None, None]
    Xt = t_(X)
    Y = Xt + alpha * V
    for _ in range(5):   # Cayley_loop (optimizer.py:24-29)
        Y = Xt + alpha * (W @ (0.5 * (Xt + Y)))
    return t_(Y), W @ Xt


def _qr_retract(R: torch.Tensor) -> torch.Tensor:
    """Sign-fixed QR re-orthonormalization of R, or of a stack of them, in
    float64, then float32 (reference qr_retraction, optimizer.py:32-42; the
    reference applies it with 1 % probability per step, the JAX package on
    a fixed period)."""
    q, r = torch.linalg.qr(R.double().transpose(-1, -2))
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]
    return q.transpose(-1, -2).float()


def make_rotated_ste_loss(params, cfg: ModelConfig, qcfg: QuantConfig):
    """``loss_fn(R1, R2s, toks)`` -> the CE of the rotated, straight-through
    quantized model (reference core.py:111-136: each QLinear rotates and
    fake-quantizes its weight on the fly, qlinear.py:58-84). ``R2s`` is
    (L, head_dim, head_dim); ``toks`` (B, T) on the params' device. The
    weights rotate in float32; activations quantize as the config says,
    without a straight-through estimate (their gradient reaches each
    scale through its absmax)."""
    wq = qcfg.linear.weight
    d, H, KV = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads

    def rotated_forward(R1, R2s, toks):
        p = copy_tree(params)
        p["embed"]["weight"] = params["embed"]["weight"].float() @ R1
        p["lm_head"]["weight"] = _ste_qdq(qcfg.head.weight,
                                          params["lm_head"]["weight"].float() @ R1)
        for i, lp in enumerate(params["layers"]):
            nl = p["layers"][i]
            for slot in ("q", "k", "gate", "up"):
                set_weight(nl, slot, _ste_qdq(wq, get_weight(lp, slot).float() @ R1))
            Wv = get_weight(lp, "v").float() @ R1
            Wv = torch.einsum("hdi,de->hei", Wv.reshape(KV, d, -1), R2s[i]).reshape(Wv.shape)
            set_weight(nl, "v", _ste_qdq(wq, Wv))
            Wo = R1.T @ get_weight(lp, "o").float()
            Wo = torch.einsum("ohd,de->ohe", Wo.reshape(-1, H, d), R2s[i]).reshape(Wo.shape)
            set_weight(nl, "o", _ste_qdq(wq, Wo))
            set_weight(nl, "down", _ste_qdq(wq, R1.T @ get_weight(lp, "down").float()))
        logits = forward(p, cfg, toks, qcfg).float()
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        ll = torch.gather(logp, -1, toks[:, 1:, None].long())
        return -torch.mean(ll)

    return rotated_forward


def optimize_rotations(params, cfg: ModelConfig, calib_tokens, qcfg: QuantConfig,
                       n_steps: int = 100, lr: float = 1.5, momentum: float = 0.0,
                       batch: int = 1, seed: int = 0, qr_period: int = 50,
                       timings: Optional[PhaseTimer] = None, losses: Optional[list] = None):
    """Learn R1 and the per-layer R2s minimizing the CE of the rotated,
    straight-through quantized model on calibration batches (reference
    core.py:111-136): SGDG Stiefel steps at ``lr`` under a cosine schedule
    (the HF Trainer's ``lr_scheduler_type='cosine'``, the rate formed in
    float64 and cast to float32), R1 and the R2s in one group, a QR
    retraction every ``qr_period`` steps. Starts from
    :func:`hadamard_rotations`. Returns (R1, R2s) in float64 on the
    params' device. ``timings`` gains ``draw`` and ``optimize``; ``losses``
    gains each step's loss, a float (no graph is kept across steps)."""
    dev = params["embed"]["weight"].device
    t = time.perf_counter()
    R1, R2s = hadamard_rotations(cfg, seed, dev)
    R1, R2s = R1.float(), torch.stack([r.float() for r in R2s])
    if timings is not None:
        t = timings.add("draw", t, dev)
    loss_fn = make_rotated_ste_loss(params, cfg, qcfg)
    V1, V2s = torch.zeros_like(R1), torch.zeros_like(R2s)
    calib = torch.as_tensor(np.asarray(calib_tokens), device=dev)
    n = calib.shape[0]
    for it in range(n_steps):
        idx = torch.as_tensor(np.arange(it * batch, (it + 1) * batch) % n, device=dev)
        lr_t = torch.tensor(np.float32(lr * 0.5 * (1.0 + np.cos(np.pi * it / max(1, n_steps)))),
                            device=dev)
        R1.requires_grad_()
        R2s.requires_grad_()
        loss = loss_fn(R1, R2s, calib[idx])
        g1, g2 = torch.autograd.grad(loss, (R1, R2s))
        loss = float(loss.detach())
        with torch.no_grad():
            R1, V1 = _sgdg_stiefel_step(R1.detach(), g1, V1, lr_t, momentum)
            R2s, V2s = _sgdg_stiefel_step(R2s.detach(), g2, V2s, lr_t, momentum)
            if qr_period and (it + 1) % qr_period == 0:
                R1, R2s = _qr_retract(R1), _qr_retract(R2s)
        del g1, g2
        if losses is not None:
            losses.append(loss)
        if it % 20 == 0:
            LOGGER.info(f"SpinQuant opt step {it}: loss {loss:.4f}")
    if timings is not None:
        timings.add("optimize", t, dev)
    return R1.double(), list(R2s.double())


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------


def spinquant(params, cfg: ModelConfig, calib_tokens, qcfg: QuantConfig,
              mode: str = "hadamard", rotation_path: Optional[str] = None,
              mse: bool = False, n_steps: int = 100, seed: int = 0, chunk: int = 8,
              scale_book: Optional[dict] = None, timings: Optional[PhaseTimer] = None,
              losses: Optional[list] = None) -> ModelConfig:
    """Rotate, then GPTQ, in place. Returns the untied ModelConfig: rebind
    it for later forwards. ``mode="optimize"`` learns the rotations in
    ``n_steps`` steps first (:func:`optimize_rotations`, its losses into
    ``losses``) and saves them as ``rotation_path``/R.npz. ``scale_book``
    records the GPTQ parameters for a lossless ``pack_model``; ``timings``
    collects seconds for ``rotation`` (with ``draw`` and ``optimize``
    apart in optimize mode) and for GPTQ's ``hessians`` (capture included)
    and ``updates``."""
    if cfg.arch not in ("llama",):
        raise NotImplementedError(
            f"SpinQuant supports the llama family only (reference core.py:63-71), got {cfg.arch}")
    if mode not in ("hadamard", "optimize"):
        raise ValueError(f"unknown SpinQuant mode {mode!r}")
    dev = params["embed"]["weight"].device
    t = time.perf_counter()

    cfg = _untie(params, cfg)
    if mode == "optimize":
        R1, R2s = optimize_rotations(params, cfg, calib_tokens, qcfg, n_steps=n_steps,
                                     seed=seed, timings=timings, losses=losses)
        if rotation_path:
            save_rotations(Path(rotation_path) / "R.npz", R1, R2s)
        t = time.perf_counter()
    elif rotation_path and (Path(rotation_path) / "R.npz").is_file():
        R1, R2s = load_rotations(Path(rotation_path) / "R.npz", cfg)
    else:
        R1, R2s = hadamard_rotations(cfg, seed, dev)
    fuse_layer_norms(params, cfg)
    _rotate_params(params, cfg, R1, R2s)
    del R1, R2s
    if timings is not None:
        t = timings.add("rotation", t, dev)

    ctx = capture_layer0(params, cfg, calib_tokens, chunk=chunk)
    if timings is not None:
        timings.add("hessians", t, dev)
    gptq(params, cfg, ctx, qcfg, mse=mse, scale_book=scale_book, timings=timings)
    return cfg
