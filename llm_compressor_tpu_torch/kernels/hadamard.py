"""Fast Walsh-Hadamard transform (port of ``kernels/hadamard.py``), kernel B10.

    y = x (H_K (x) H_m) * scale        along the last axis, n = K * m

``m`` is a power of two (a Sylvester butterfly); ``H_K`` is a base of
non-power-of-two order K in {12, 20, 28, 36, 44, 52, 60, 108, 140},
constructed here (Paley I / II over GF(q)), or K = 1. The numpy
constructions are copies of the JAX package's, which the port may not
import.

:func:`hadamard_transform` keeps the XLA version's semantics: float32
throughout, the butterfly stages in order h = 1, 2, 4, ..., the base H_K
contracted in float32, the scale (default the float32 value of 1/sqrt(n))
applied last and one cast to ``x.dtype``. A CUDA tensor launches
``csrc/hadamard.cu`` (which also does the H_K contraction) or raises; a
CPU tensor runs :func:`hadamard_transform_plain`. Kernel and plain version
do the same float32 operations in the same order (the contraction adds the
K terms in order l = 0..K-1, each an exact +-x), so they agree bitwise.
:func:`plan` gives the kernel's layout for a size n; the kernel checks it.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from math import gcd
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from . import _build

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}
SMEM_BYTES = 232448   # dynamic shared memory a block may use on the H100
CTA_THREADS = 256     # threads of a CTA at most
SMEM_TARGET = 48 * 1024   # a CTA of several rows keeps at most this in shared memory


# ---------------------------------------------------------------------------
# Paley constructions for non-power-of-two base sizes (numpy, host side)
# ---------------------------------------------------------------------------


def _prime_power(q: int):
    """(p, k) with q = p^k for prime p, else None."""
    for p in range(2, q + 1):
        if p * p > q and p != q:
            break
        if q % p == 0:
            k = 0
            m = q
            while m % p == 0:
                m //= p
                k += 1
            return (p, k) if m == 1 else None
    return (q, 1)


def _gf_tables(p: int, k: int):
    """Addition/multiplication over GF(p^k); elements are integers whose
    base-p digits are polynomial coefficients (mod an irreducible monic
    degree-k polynomial found by exhaustive root check)."""
    q = p ** k
    if k == 1:
        add = (np.arange(p)[:, None] + np.arange(p)[None, :]) % p
        mul = (np.arange(p)[:, None] * np.arange(p)[None, :]) % p
        return add, mul

    def digits(e):
        return [(e // p ** i) % p for i in range(k)]

    def undig(c):
        return sum((ci % p) * p ** i for i, ci in enumerate(c))

    def polymul_mod(a, b, red):
        out = [0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % p
        for d in range(len(out) - 1, k - 1, -1):
            c = out[d]
            if c:
                out[d] = 0
                for i in range(k):
                    out[d - k + i] = (out[d - k + i] - c * red[i]) % p
        return out[:k]

    # a monic x^k + r_{k-1} x^{k-1} + ... + r_0 of degree <= 3 is
    # irreducible over GF(p) iff it has no root in GF(p)
    if k > 3:
        raise ValueError("GF(p^k) tables are implemented for k <= 3")
    red = None
    for tail in range(p ** k):
        r = digits(tail)
        if all(sum(rc * x ** i for i, rc in enumerate(r)) % p != (-x ** k) % p
               for x in range(p)):
            red = r
            break
    add = np.zeros((q, q), np.int64)
    mul = np.zeros((q, q), np.int64)
    for a in range(q):
        da = digits(a)
        for b in range(q):
            db = digits(b)
            add[a, b] = undig([x + y for x, y in zip(da, db)])
            mul[a, b] = undig(polymul_mod(da, db, red))
    return add, mul


def _jacobsthal(q: int) -> np.ndarray:
    """Q[i, j] = chi(a_i - a_j), chi the quadratic character of GF(q)."""
    p, k = _prime_power(q)
    add, mul = _gf_tables(p, k)
    neg = np.array([int(np.where(add[b] == 0)[0][0]) for b in range(q)])
    squares = set(int(mul[a, a]) for a in range(1, q))
    chi = np.array([0] + [1 if a in squares else -1 for a in range(1, q)], dtype=np.int64)
    diff = add[np.arange(q)[:, None], neg[None, :]]   # a_i + (-a_j)
    return chi[diff]


def _paley1(p: int) -> np.ndarray:
    """Hadamard matrix of order p+1 for p = 3 (mod 4): H = I + S with the
    skew core S = [[0, e^T], [-e, Q]]."""
    Q = _jacobsthal(p)
    n = p + 1
    H = np.ones((n, n), dtype=np.int64)
    H[1:, 1:] = Q + np.eye(p, dtype=np.int64)
    H[1:, 0] = -1
    return H


def _paley2(p: int) -> np.ndarray:
    """Hadamard matrix of order 2(p+1) for p = 1 (mod 4)."""
    Q = _jacobsthal(p)
    m = p + 1
    S = np.zeros((m, m), dtype=np.int64)
    S[0, 1:] = 1
    S[1:, 0] = 1
    S[1:, 1:] = Q
    # S_ij = 0 -> [[1, -1], [-1, -1]], else S_ij * [[1, 1], [1, -1]]
    H = np.zeros((2 * m, 2 * m), dtype=np.int64)
    Z = np.array([[1, -1], [-1, -1]])
    P = np.array([[1, 1], [1, -1]])
    for i in range(m):
        for j in range(m):
            H[2 * i:2 * i + 2, 2 * j:2 * j + 2] = Z if S[i, j] == 0 else S[i, j] * P
    return H


# K -> (construction, field size q): Paley I gives q + 1 (q = 3 mod 4),
# Paley II gives 2(q + 1) (q = 1 mod 4, the prime power 25 for K = 52)
_BASES = {
    12: (_paley1, 11), 20: (_paley1, 19), 28: (_paley2, 13),
    36: (_paley2, 17), 44: (_paley1, 43), 52: (_paley2, 25),
    60: (_paley2, 29), 108: (_paley1, 107), 140: (_paley1, 139),
}


@lru_cache(maxsize=None)
def base_hadamard(K: int) -> np.ndarray:
    """Base Hadamard matrix of order K (1 or a key of ``_BASES``), checked
    to satisfy H H^T = K I."""
    if K == 1:
        H = np.ones((1, 1), dtype=np.int64)
    elif K in _BASES:
        fn, q = _BASES[K]
        H = fn(q)
    else:
        raise ValueError(f"No Hadamard base construction for K={K}")
    if not np.array_equal(H @ H.T, K * np.eye(K, dtype=np.int64)):
        raise AssertionError(f"base Hadamard construction of order {K} is wrong")
    return H


def decompose(n: int) -> tuple[int, int]:
    """n = 2^k * K for a supported base K. Returns (K, 2^k)."""

    def _is_pow2(v):
        return v > 0 and (v & (v - 1)) == 0

    for K in (1, *sorted(_BASES)):
        if n % K == 0 and _is_pow2(n // K):
            return K, n // K
    raise ValueError(f"Hadamard size {n} unsupported (need n = 2^k * K, "
                     f"K in {{1, {', '.join(map(str, sorted(_BASES)))}}})")


@lru_cache(maxsize=None)
def _base(K: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """H_K in ``dtype`` on ``device``, copied there once: a copy from
    pageable host memory on every call would make the host wait for the
    card."""
    return torch.as_tensor(base_hadamard(K), dtype=dtype).to(device)


def default_scale(n: int) -> float:
    """The float32 value of 1/sqrt(n), rounded once from float64."""
    return float(np.float32(1.0 / np.sqrt(n)))


# ---------------------------------------------------------------------------
# The kernel's layout (csrc/hadamard.cu checks it against its own)
# ---------------------------------------------------------------------------


class Plan(NamedTuple):
    K: int          # base order
    m: int          # power-of-two block, n = K * m
    E: int          # consecutive values a thread holds in registers
    threads: int    # threads per row
    rows: int       # rows per CTA
    passes: int     # register passes of the butterfly (2: one exchange in shared memory)
    smem: int       # dynamic shared memory per CTA, bytes


def sign_bytes(K: int) -> int:
    """Bytes of H_K's sign bits in shared memory: K columns of ceil(K/32)
    words (none for K = 1)."""
    return 0 if K == 1 else K * ((K + 31) // 32) * 4


def plan(n: int) -> Plan:
    """B10's layout for rows of n values.

    A thread holds E consecutive values of the row (E a power of two, at
    most 4m: H_K's orders are 4 times an odd number). The butterfly stages
    h < E run in its registers and h = E .. 16E through warp shuffles, so
    one pass covers log2(E) + 5 stages. A block m > 32E takes a second
    pass: the row goes to shared memory as f32 and each thread reads the
    2^r values a, a + 32E, ... (r = log2(m / 32E) <= log2(E)) back into
    registers. E is the least that keeps the passes at two: 8 up to
    m = 256 (16, 32 for m = 512, 1024, one pass), and 8, 16, 32 for
    m <= 2048, 8192, 32768 (two passes). A row of n / E chunks takes
    gcd(n / E, 256) threads, each taking chunks in turn, and a CTA 256 /
    threads rows, halved while their shared memory passes 48 KB (never
    below a warp). Shared memory holds each row as f32 when there is a
    second pass or K > 1 (the H_K contraction reads whole columns), and
    then H_K's sign bits. Sizes whose f32 row does not fit in shared
    memory raise."""
    K, m = decompose(n)
    if n * 4 + sign_bytes(K) > SMEM_BYTES:
        raise ValueError(f"the kernel holds a row of n={n} float32 values in shared memory "
                         f"(at most {SMEM_BYTES // 4})")
    b = m.bit_length() - 1
    if b <= 10:
        E, passes = 1 << max(3, b - 5), 1
    else:
        E, passes = (8 if b <= 11 else 16 if b <= 13 else 32), 2
    E = min(E, m * (4 if K > 1 else 1))
    threads = gcd(n // E, CTA_THREADS)
    row_smem = n * 4 if (passes == 2 or K > 1) else 0
    rows = CTA_THREADS // threads
    while rows > 1 and rows * row_smem > SMEM_TARGET and (rows // 2) * threads >= 32:
        rows //= 2
    return Plan(K, m, E, threads, rows, passes, rows * row_smem + sign_bytes(K))


@lru_cache(maxsize=None)
def sign_words(K: int) -> np.ndarray:
    """H_K's signs as bits, (K, ceil(K/32)) int32: bit c of word w of row
    l is set where H_K[32w + c, l] = -1 (column l of H_K, the term l of
    every output k)."""
    neg = base_hadamard(K) < 0
    nw = (K + 31) // 32
    words = np.zeros((K, nw), np.uint64)
    for k in range(K):
        words[:, k // 32] |= neg[k, :].astype(np.uint64) << np.uint64(k % 32)
    return words.astype(np.uint32).view(np.int32)


@lru_cache(maxsize=None)
def _signs(K: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(sign_words(K).copy()).to(device)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _fht_pow2(x: torch.Tensor) -> torch.Tensor:
    """Sylvester butterfly along the last axis (length a power of two):
    stage h pairs element a of each 2h block with a + h."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    h = 1
    while h < n:
        x = x.reshape(*lead, n // (2 * h), 2, h)
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(*lead, n)
        h *= 2
    return x


def hadamard_transform_plain(x: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of B10: float32 butterfly over each m-block, then the
    base H_K contracted term by term (l = 0..K-1), scale, one cast."""
    n = x.shape[-1]
    K, m = decompose(n)
    out = x.float().reshape(*x.shape[:-1], K, m)
    if m > 1:
        out = _fht_pow2(out)
    if K > 1:
        Hk = _base(K, torch.float32, x.device)
        y = torch.zeros_like(out)
        for l in range(K):
            y = y + Hk[:, l, None] * out[..., l:l + 1, :]
        out = y
    s = default_scale(n) if scale is None else float(scale)
    return (out.reshape(x.shape) * s).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# x, out, signs (H_K's sign words or null); rows, n, m, K; the plan's E,
# threads, rows, passes, smem; vec; scale; out_kind
_P, _I = ctypes.c_void_p, ctypes.c_int
_launch = _build.c_launcher("hadamard", "llmc_hadamard",
                            [_P] * 3 + [_I] * 10 + [ctypes.c_float, _I])


def hadamard_transform(x: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """y = x H_n * scale along the last axis (default scale: the float32
    1/sqrt(n)); float32 or bfloat16 ``x`` on the card, any float dtype on
    the CPU. Sizes without a base construction raise ``ValueError``, and
    on the card so do rows whose f32 values do not fit in shared memory."""
    n = x.shape[-1]
    if not x.is_cuda:
        return hadamard_transform_plain(x, scale)
    if x.dtype not in _OUT_KINDS:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {x.dtype}")
    p = plan(n)
    s = default_scale(n) if scale is None else float(scale)
    x2 = x.reshape(-1, n).contiguous()
    out = torch.empty_like(x2)
    signs = _signs(p.K, x.device) if p.K > 1 else None
    vec = int(x2.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    if x2.shape[0]:
        _launch(x2.data_ptr(), out.data_ptr(), None if signs is None else signs.data_ptr(),
                x2.shape[0], n, p.m, p.K, p.E, p.threads, p.rows, p.passes, p.smem, vec, s,
                _OUT_KINDS[x.dtype])
        hadamard_transform.launches += 1
    return out.reshape(x.shape)


hadamard_transform.launches = 0


def hadamard_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Orthonormal H_n / sqrt(n) as an explicit matrix, on ``device``
    (default: the card)."""
    return hadamard_transform(torch.eye(n, dtype=dtype, device=resolve_device(device)))


def signed_hadamard(signs: torch.Tensor) -> torch.Tensor:
    """H diag(signs) / sqrt(n) for a float32 vector of +-1."""
    return hadamard_transform(torch.diag(signs.float()))


def random_hadamard_matrix(n: int, generator: torch.Generator, device=None) -> torch.Tensor:
    """Randomized orthonormal Hadamard H diag(+-1) / sqrt(n) (QuIP#), the
    signs drawn from ``generator`` on its own device, the transform on
    ``device`` (default: the card)."""
    signs = torch.randint(0, 2, (n,), generator=generator, device=generator.device) * 2 - 1
    return signed_hadamard(signs.to(resolve_device(device)))
