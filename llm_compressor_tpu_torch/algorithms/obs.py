"""Blocked OBS (optimal brain surgeon) weight updates: the GPTQ, GPTAQ and
SparseGPT cores (port of ``algorithms/obs.py``).

Reference: gptq/core.py:163-281, sparsegpt/core.py:160-228,
gptaq/core.py:198-335. Semantics kept from the JAX version:

* dead columns (diag(H) == 0): diagonal set to 1, the weight column zeroed;
* damping ``percdamp * mean(diag(H))`` on the diagonal, x10 when the
  Cholesky factorization fails (``cholesky_ex``'s ``info``; JAX sees NaN);
* Hinv = the upper Cholesky factor U of H^-1 (H^-1 = U^T U);
* act order: columns by descending diag(H) — per column for group sizes 0
  and -1, per GROUP (whole groups move) for group size > 0, with the group
  parameters solved on the permuted W and un-permuted for the scale book;
  the sort is stable, as ``jnp.argsort``, so tied sums (dead columns) land
  in the same order;
* per-group branch: a whole group is quantized against its fixed
  parameters, then its error propagates to the later columns;
* the pruning mask (W != 0) multiplies every quantized column;
* GPTAQ adds the asymmetric-calibration correction
  P = alpha * triu(dXXT @ Hinv^T, 1) @ Hinv to every propagation step
  (dXXT's dead columns zeroed, permuted with H under act order);
* SparseGPT prunes per block of columns where W^2 / diag(Hinv)^2 <= its
  k-th smallest value, k = int(block size * ratio) (ties prune more than
  k), with the column-wise error feedback of GPTQ.

The column loop is a Python loop over torch ops (the JAX version's
``fori_loop``); the update of the columns after a block touches only
those columns, where the JAX version subtracts a masked full-width
product — the same values, half the multiply-adds. Everything runs in
float32 with TF32 off (:func:`~..device.full_f32_matmul`).
"""

from __future__ import annotations

import torch

from ..device import full_f32_matmul
from ..qformats.quantize import Quantizer, fake_quantize_blocked, find_params


def _prep(W, H):
    W = W.float()
    H = H.float()
    dead = torch.diagonal(H) == 0
    H = H + torch.diag(dead.float())
    W = W * (~dead)[None, :]
    return W, H, dead


def _actorder_perm(H: torch.Tensor, group: int) -> torch.Tensor:
    d = torch.diagonal(H)
    if group > 1:
        return torch.argsort(-d.reshape(-1, group).sum(-1), stable=True)
    return torch.argsort(-d, stable=True)


def _permute_cols(W, perm, group):
    if group > 1:
        N, K = W.shape
        return W.reshape(N, K // group, group)[:, perm, :].reshape(N, K)
    return W[:, perm]


def _permute_sym(M, perm, group):
    if group > 1:
        K = M.shape[0]
        G = K // group
        return M.reshape(G, group, G, group)[perm][:, :, perm, :].reshape(K, K)
    return M[perm][:, perm]


def _fq_cols(q: Quantizer, w: torch.Tensor, scales, zeros):
    """Fake-quantize an (N, g) column group with fixed per-row parameters
    (N, 1, 1): blocked as (N, 1, g); rounded as the jitted JAX core."""
    return fake_quantize_blocked(q, w[:, None, :], scales, zeros, jitted=True)[:, 0, :]


def hessian_inverse_factor(H: torch.Tensor, percdamp: float = 0.01) -> torch.Tensor:
    """Upper Cholesky factor U of (H + damp I)^-1, damp = percdamp *
    mean(diag(H)), retried once at 10x damping. Raises if H is not
    positive definite even then (the JAX version returns NaN)."""
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    for scale in (percdamp, percdamp * 10.0):
        damp = scale * torch.mean(torch.diagonal(H))
        L, info = torch.linalg.cholesky_ex(H + eye * damp)
        if int(info) != 0:
            continue
        Hinv = torch.cholesky_inverse(L)
        Hinv = (Hinv + Hinv.t()) / 2.0
        U, info = torch.linalg.cholesky_ex(Hinv, upper=True)
        if int(info) == 0:
            return U
    raise ValueError("the Hessian is not positive definite at 10x damping")


def _gptq_core(W, H, quantizer: Quantizer, blocksize: int, actorder: bool,
               dXXT=None, alpha: float = 0.25):
    N, C = W.shape
    gs = quantizer.group_size
    group = gs if gs and gs > 0 else 0
    if gs == -2:
        raise NotImplementedError("GPTQ with per-channel (-2) weight groups")
    if group and C % group:
        raise ValueError(f"GPTQ needs the group size {group} to divide C={C}")

    W, H, dead = _prep(W, H)
    use_p = dXXT is not None
    if use_p:
        dXXT = dXXT.float() * (~dead)[None, :]
    MASK = (W != 0).float()
    perm = None
    if actorder:
        perm = _actorder_perm(H, group)
        W = _permute_cols(W, perm, group)
        MASK = _permute_cols(MASK, perm, group)
        H = _permute_sym(H, perm, group)
        if use_p:
            dXXT = _permute_sym(dXXT, perm, group)

    scales, zeros = find_params(quantizer, W, jitted=True)  # the JAX core is jitted
    Hinv = hessian_inverse_factor(H)
    P = alpha * (torch.triu(dXXT @ Hinv.t(), diagonal=1) @ Hinv) if use_p else None
    Q = torch.zeros_like(W)

    for i1 in range(0, C, blocksize):
        i2 = min(i1 + blocksize, C)
        count = i2 - i1
        W1 = W[:, i1:i2].clone()
        M1 = MASK[:, i1:i2]
        Hinv1 = Hinv[i1:i2, i1:i2]
        P1 = P[i1:i2, i1:i2] if use_p else None
        Q1 = torch.zeros_like(W1)
        Err1 = torch.zeros_like(W1)
        in_idx = torch.arange(count, device=W.device)
        if group == 0:
            # column at a time with error compensation
            dH = torch.diagonal(Hinv1)
            for i in range(count):
                w = W1[:, i]
                q = _fq_cols(quantizer, w[:, None], scales, zeros)[:, 0] * M1[:, i]
                err = (w - q) / dH[i]
                tail = (in_idx >= i).float()
                upd = err[:, None] * (Hinv1[i] * tail)[None, :]
                if use_p:
                    upd = upd - w[:, None] * (P1[i] * tail)[None, :]
                W1 = W1 - upd
                Q1[:, i] = q
                Err1[:, i] = err
        else:
            # group at a time against the group's fixed parameters
            for i in range(0, count, group):
                jg = (i1 + i) // group
                w = W1[:, i:i + group]
                d = torch.diagonal(Hinv1[i:i + group, i:i + group])
                q = _fq_cols(quantizer, w, scales[:, jg:jg + 1, :],
                             zeros[:, jg:jg + 1, :]) * M1[:, i:i + group]
                err = (w - q) / d[None, :]
                tail = (in_idx >= i).float()
                upd = err @ (Hinv1[i:i + group, :] * tail[None, :])
                if use_p:
                    upd = upd - w @ (P1[i:i + group, :] * tail[None, :])
                W1 = W1 - upd
                Q1[:, i:i + group] = q
                Err1[:, i:i + group] = err
        Q[:, i1:i2] = Q1
        if i2 < C:
            upd = Err1 @ Hinv[i1:i2, i2:]
            if use_p:
                upd = upd - W1 @ P[i1:i2, i2:]
            W[:, i2:] -= upd

    if actorder:
        invperm = torch.argsort(perm)
        Q = _permute_cols(Q, invperm, group)
        if group > 1:
            scales = scales[:, invperm, :]
            zeros = zeros[:, invperm, :]
    return Q, scales, zeros


def gptq_update_with_params(W, H, quantizer: Quantizer, blocksize: int = 128,
                            actorder: bool = True):
    """GPTQ of one (N, C) weight against its (C, C) Hessian. Returns the
    float32 quantized weight Q and the exact (scales, zeros) its columns were
    rounded against (act order undone), shapes ``(N, G, 1)``, for lossless
    packing."""
    with full_f32_matmul(), torch.no_grad():
        return _gptq_core(W, H, quantizer, blocksize, actorder)


def gptq_update(W, H, quantizer: Quantizer, blocksize: int = 128,
                actorder: bool = True) -> torch.Tensor:
    """GPTQ error-compensated quantization of one weight matrix."""
    return gptq_update_with_params(W, H, quantizer, blocksize, actorder)[0]


def gptaq_update_with_params(W, H, dXXT, quantizer: Quantizer, blocksize: int = 128,
                             actorder: bool = True, alpha: float = 0.25):
    """GPTAQ of one (N, C) weight: GPTQ with the asymmetric-error correction
    from the (C, C) cross term dXXT = 2/n sum (x_fp - x) x^T. Returns (Q,
    scales, zeros) as :func:`gptq_update_with_params` does."""
    with full_f32_matmul(), torch.no_grad():
        return _gptq_core(W, H, quantizer, blocksize, actorder, dXXT=dXXT, alpha=alpha)


def gptaq_update(W, H, dXXT, quantizer: Quantizer, blocksize: int = 128,
                 actorder: bool = True, alpha: float = 0.25) -> torch.Tensor:
    """GPTAQ: GPTQ plus the asymmetric-error correction term."""
    return gptaq_update_with_params(W, H, dXXT, quantizer, blocksize, actorder, alpha)[0]


def _sparsegpt_core(W, H, sparsity_ratio: float, blocksize: int = 128):
    N, C = W.shape
    W, H, _ = _prep(W, H)
    Hinv = hessian_inverse_factor(H)
    for i1 in range(0, C, blocksize):
        i2 = min(i1 + blocksize, C)
        count = i2 - i1
        W1 = W[:, i1:i2].clone()
        Hinv1 = Hinv[i1:i2, i1:i2]
        dinv = torch.diagonal(Hinv1)
        in_idx = torch.arange(count, device=W.device)
        tmp = W1 ** 2 / dinv[None, :] ** 2
        k = int(tmp.numel() * sparsity_ratio)
        thresh = torch.sort(tmp.reshape(-1)).values[k]
        prune = tmp <= thresh
        Q1 = torch.zeros_like(W1)
        Err1 = torch.zeros_like(W1)
        for i in range(count):
            w = W1[:, i]
            q = torch.where(prune[:, i], torch.zeros_like(w), w)
            err = (w - q) / dinv[i]
            tail = (in_idx >= i).float()
            W1 = W1 - err[:, None] * (Hinv1[i] * tail)[None, :]
            Q1[:, i] = q
            Err1[:, i] = err
        W[:, i1:i2] = Q1
        if i2 < C:
            W[:, i2:] -= Err1 @ Hinv[i1:i2, i2:]
    return W


def sparsegpt_update(W, H, sparsity_ratio: float, blocksize: int = 128) -> torch.Tensor:
    """SparseGPT blocked OBS pruning of one (N, C) weight against its (C, C)
    Hessian: per block of ``blocksize`` columns, the entries with the
    smallest W^2 / diag(Hinv)^2 are zeroed and their error fed through
    Hinv into the later columns. Returns the float32 pruned weight."""
    with full_f32_matmul(), torch.no_grad():
        return _sparsegpt_core(W, H, sparsity_ratio, blocksize)
