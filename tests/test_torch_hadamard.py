"""The port's Hadamard constructions and transform (B10's plain version on
the CPU) against the JAX package's on the same numpy inputs.

Tolerances:
* base matrices, ``decompose`` and the signed (random) Hadamard matrices:
  bitwise. The butterfly of a +-1 diagonal adds exact integers, and both
  sides scale by the float32 value of 1/sqrt(n).
* ``hadamard_transform`` in float32: rtol 1e-5 against the XLA version
  (both sum in float32; the base contraction's order differs).
* in bfloat16: one bf16 ulp of the output, at most 2**-7 relative (both
  round one float32 value once; the float32 values may differ in the
  last bits, which can put them on two sides of a rounding boundary).
* against ``hadamard_transform_pallas`` (interpret mode): as against XLA
  where its math is the XLA version's; where it contracts the base H_K in
  the output dtype after scaling (bf16, K > 1), two bf16 ulps of the
  largest output of the row.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_compressor_tpu.kernels import hadamard as jh
from llm_compressor_tpu_torch.kernels import hadamard as th
from torch_port_util import one_torch_thread  # noqa: F401

SIZES = [64, 96, 128, 160, 896, 2560]


@pytest.mark.parametrize("K", [1, 12, 20, 28, 36, 44, 52, 60, 108, 140])
def test_base_hadamard_bitwise(K):
    np.testing.assert_array_equal(th.base_hadamard(K), jh.base_hadamard(K))


def test_decompose_equal():
    for n in list(range(1, 600)) + [896, 2560, 4096, 8960, 14336]:
        try:
            want = jh.decompose(n)
        except ValueError:
            with pytest.raises(ValueError):
                th.decompose(n)
            continue
        assert th.decompose(n) == want


def _x(n, rows=6, seed=0):
    return np.random.default_rng(seed + n).normal(size=(rows, n)).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
def test_transform_f32(n):
    x = _x(n)
    want = np.asarray(jh.hadamard_transform(jnp.asarray(x)))
    got = th.hadamard_transform(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    pal = np.asarray(jh.hadamard_transform_pallas(jnp.asarray(x)))
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_transform_bf16(n):
    x = _x(n, seed=1)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = th.hadamard_transform(xt).float().numpy()
    assert th.hadamard_transform(xt).dtype == torch.bfloat16
    want = np.asarray(jh.hadamard_transform(xj).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    pal = np.asarray(jh.hadamard_transform_pallas(xj).astype(jnp.float32))
    if jh.decompose(n)[0] == 1:
        np.testing.assert_allclose(got, pal, rtol=2.0 ** -7, atol=0)
    else:
        row_max = np.abs(pal).max(-1, keepdims=True)
        assert (np.abs(got - pal) <= 2 * 2.0 ** -8 * row_max).all()


@pytest.mark.parametrize("n", [12, 160])
def test_transform_scale_and_leading_dims(n):
    x = np.random.default_rng(2).normal(size=(2, 3, n)).astype(np.float32)
    want = np.asarray(jh.hadamard_transform(jnp.asarray(x), scale=0.5))
    got = th.hadamard_transform(torch.from_numpy(x), scale=0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [64, 2048])
def test_signed_hadamard_bitwise(n):
    key = jax.random.PRNGKey(n)
    signs = np.asarray(jax.random.rademacher(key, (n,), dtype=jnp.float32))
    want = np.asarray(jh.random_hadamard_matrix(n, key))
    got = th.signed_hadamard(torch.from_numpy(signs)).numpy()
    np.testing.assert_array_equal(got, want)


def test_random_hadamard_matrix_orthonormal_and_seeded():
    g = lambda s: torch.Generator().manual_seed(s)
    a = th.random_hadamard_matrix(64, g(0), device="cpu")
    np.testing.assert_allclose((a @ a.t()).numpy(), np.eye(64), atol=1e-6)
    assert torch.equal(a.abs(), torch.full_like(a, 0.125))
    assert torch.equal(a, th.random_hadamard_matrix(64, g(0), device="cpu"))
    assert not torch.equal(a, th.random_hadamard_matrix(64, g(1), device="cpu"))


def test_hadamard_matrix_matches_jax():
    np.testing.assert_array_equal(th.hadamard_matrix(128, device="cpu").numpy(),
                                  np.asarray(jh.hadamard_matrix(128)))


def test_unsupported_size_raises():
    with pytest.raises(ValueError, match="unsupported"):
        th.hadamard_transform(torch.zeros(2, 24 * 7))
    with pytest.raises(ValueError):
        th.base_hadamard(24)


def test_cpu_tensor_runs_plain_version():
    before = th.hadamard_transform.launches
    th.hadamard_transform(torch.ones(3, 64))
    assert th.hadamard_transform.launches == before


# ---------------------------------------------------------------------------
# B10's layout: ``plan`` and a numpy mirror of the kernel's index maps
# ---------------------------------------------------------------------------

BASES = [1, 12, 20, 28, 36, 44, 52, 60, 108, 140]


def _supported(limit=th.SMEM_BYTES // 4):
    """Every n = K * 2^k the kernel takes (the f32 row and H_K's sign bits
    fit in shared memory)."""
    out = []
    for K in BASES:
        m = 1
        while K * m * 4 + th.sign_bytes(K) <= th.SMEM_BYTES and K * m <= limit:
            out.append(K * m)
            m *= 2
    return out


def test_plan_covers_every_supported_size():
    for n in _supported():
        p = th.plan(n)
        assert (p.K, p.m) == th.decompose(n)
        chunks = n // p.E
        # threads x E x iterations cover the row exactly; E fits the block
        assert chunks * p.E == n and chunks % p.threads == 0
        assert p.E in (1, 2, 4, 8, 16, 32) and p.E <= p.m * (4 if p.K > 1 else 1)
        cta = p.threads * p.rows
        assert cta <= th.CTA_THREADS and cta % 32 == 0
        # the shuffle stages stay inside one row's lanes of one warp
        assert min(p.m, 32 * p.E) // p.E <= max(p.threads, 1) or p.threads >= 32
        # one pass covers log2(E) + 5 stages, the second at most log2(E)
        b, e = p.m.bit_length() - 1, p.E.bit_length() - 1
        assert b <= e + 5 if p.passes == 1 else e + 5 < b <= 2 * e + 5
        if p.passes == 2 or p.K > 1:
            assert p.smem == p.rows * n * 4 + th.sign_bytes(p.K) and p.E >= 4
        else:
            assert p.smem == 0
        assert p.smem <= th.SMEM_BYTES
        assert p.rows == 1 or p.rows * n * 4 * (p.passes == 2 or p.K > 1) <= th.SMEM_TARGET \
            or p.rows * p.threads == 32


@pytest.mark.parametrize("n", [1 << 16, 12 * 8192, 140 * 512, 28 * 4096])
def test_plan_refuses_sizes_past_shared_memory(n):
    with pytest.raises(ValueError, match="shared memory"):
        th.plan(n)


def test_plan_refuses_unsupported_sizes():
    with pytest.raises(ValueError, match="unsupported"):
        th.plan(24 * 7)


def test_sign_words_are_the_base_signs():
    for K in BASES[1:]:
        words = th.sign_words(K).view(np.uint32)
        H = th.base_hadamard(K)
        for k in range(K):
            bit = (words[:, k // 32] >> np.uint32(k % 32)) & 1
            np.testing.assert_array_equal(bit == 1, H[k, :] < 0)


def _phys(a, E):
    """csrc/hadamard.cu ``phys``: a chunk's 16-byte units xor-swizzled."""
    U = E // 4
    if U <= 1:
        return a
    c, f = a // E, (a % E) >> 2
    return c * E + ((f ^ ((c // (8 // U)) % U)) << 2) + (a & 3)


def _mirror(x, scale=None):
    """Replay B10 on numpy float32 rows through the kernel's index maps:
    CTAs of ``rows`` rows x ``threads`` threads, pass 1 (registers, then
    shuffles between lanes ``lane ^ hs``), the swizzled shared row, pass 2
    and the H_K contraction. Returns the float32 result (before the cast)
    and, per row, the butterfly's pairs in the order the stages ran."""
    rows_total, n = x.shape
    p = th.plan(n)
    K, m, E, tpr, rpc = p.K, p.m, p.E, p.threads, p.rows
    T, chunks, f32 = tpr * rpc, n // E, np.float32
    s = np.float32(th.default_scale(n) if scale is None else scale)
    y = np.zeros_like(x)
    stages = {r: [] for r in range(rows_total)}
    to_smem = p.passes == 2 or K > 1
    t_all = np.arange(T)
    rloc, tid = t_all // tpr, t_all % tpr
    for cta in range((rows_total + rpc - 1) // rpc):
        row = cta * rpc + rloc
        live = row < rows_total
        smem = np.full(rpc * n, np.nan, f32)
        for it in range(chunks // tpr):
            c = it * tpr + tid
            v = np.zeros((T, E), f32)
            a = c[:, None] * E + np.arange(E)[None, :]        # the row's index of each value
            v[live] = x[row[live][:, None], a[live]]
            h = 1
            while h < min(E, m):
                for i in range(E):
                    if not i & h:
                        u, w = v[:, i].copy(), v[:, i + h].copy()
                        v[:, i], v[:, i + h] = u + w, u - w
                        for t in np.nonzero(live)[0]:
                            stages[row[t]].append((h, a[t, i], a[t, i + h]))
                h *= 2
            hs = 1
            while hs < min(m, 32 * E) // E:
                lane = t_all % 32
                partner = t_all - lane + (lane ^ hs)
                assert (c[partner] == c ^ hs).all() and (rloc[partner] == rloc).all()
                hi = (c & hs) != 0
                o = v[partner]   # the kernel's fma(+-1, v, o): -v is exact
                v = np.where(hi[:, None], o - v, v + o).astype(f32)
                for t in np.nonzero(live & ~hi)[0]:
                    for i in range(E):
                        stages[row[t]].append((hs * E, a[t, i], a[t, i] + hs * E))
                hs *= 2
            if to_smem:
                base = rloc[:, None] * n
                dst = base + np.vectorize(lambda q: _phys(q, E))(a)
                smem[dst] = v
            else:
                y[row[live][:, None], a[live]] = v[live] * s
        if not to_smem:
            continue
        if p.passes == 2:
            W = 32 * E
            R2 = m // W
            for q0 in range(0, n // R2, tpr):
                q = q0 + tid
                base = (q // W) * m + q % W
                idx = base[:, None] + np.arange(R2)[None, :] * W      # (T, R2)
                ph = rloc[:, None] * n + np.vectorize(lambda z: _phys(z, E))(idx)
                # the kernel computes phys once a group: a + j * W keeps a's swizzle
                assert (ph == ph[:, :1] + np.arange(R2)[None, :] * W).all()
                v = smem[ph].astype(f32)
                h = 1
                while h < R2:
                    for j in range(R2):
                        if not j & h:
                            u, w = v[:, j].copy(), v[:, j + h].copy()
                            v[:, j], v[:, j + h] = u + w, u - w
                            for t in np.nonzero(live)[0]:
                                stages[row[t]].append((h * W, idx[t, j], idx[t, j + h]))
                    h *= 2
                smem[ph] = v
        for r in range(rpc):
            rr = cta * rpc + r
            if rr >= rows_total:
                continue
            srow = smem[r * n:(r + 1) * n]
            logical = srow[[_phys(a, E) for a in range(n)]]
            if K == 1:
                y[rr] = logical * s
                continue
            words = th.sign_words(K).view(np.uint32)
            vc = min(16 // 2, m)           # the bf16 instance's columns; f32 takes min(4, m)
            for vcol in (vc, min(4, m)):
                acc = np.zeros(n, f32)
                ncol = m // vcol
                for q in range((K // 4) * ncol):
                    kc, jv = divmod(q, ncol)
                    bits = words[:, kc >> 3] >> np.uint32((kc & 7) * 4)
                    out = np.zeros((4, vcol), f32)
                    for l in range(K):
                        v = logical[l * m + jv * vcol: l * m + (jv + 1) * vcol]
                        for kk in range(4):   # the kernel's fma(+-1, v, acc): +-v is exact
                            flip = -v if (bits[l] >> np.uint32(kk)) & 1 else v
                            out[kk] = out[kk] + flip
                    for kk in range(4):
                        acc[(kc * 4 + kk) * m + jv * vcol:(kc * 4 + kk) * m + (jv + 1) * vcol] = \
                            out[kk]
                if vcol == vc:
                    first = acc
                else:
                    np.testing.assert_array_equal(acc, first)
            y[rr] = first * s
    return y, stages


def _check_stage_order(stages, n):
    """Every value of each row met the stages h = 1, 2, 4, .. in order
    (chunks of one thread run one after another), each stage pairing every
    a with (a mod m) & h == 0 with a + h exactly once."""
    K, m = th.decompose(n)
    for pairs in stages.values():
        seen = {}
        for h, a, b in pairs:
            for z in (a, b):
                seen.setdefault(z, []).append(h)
        assert all(hs == sorted(hs) for hs in seen.values())
        h = 1
        while h < m:
            got = sorted((a, b) for hh, a, b in pairs if hh == h)
            want = [(a, a + h) for a in range(n) if not (a % m) & h]
            assert got == want, h
            h *= 2
        assert len(pairs) == (n // 2) * (m.bit_length() - 1)


# small sizes through every branch of the plan: one pass (E = 1, 2, 4, 8,
# 16, 32), two passes (m = 2048, 8192), several rows per CTA and warp, and
# every base K at a few m
MIRROR_SIZES = [1, 2, 4, 64, 512, 1024, 2048, 8192, 12, 96, 20 * 128, 28 * 32, 36 * 2,
                44 * 4, 52 * 16, 60 * 2, 108 * 1, 140 * 2, 12 * 2048]


@pytest.mark.parametrize("n", MIRROR_SIZES)
def test_mirror_of_the_kernel_is_the_plain_version(n):
    p = th.plan(n)
    rows = p.rows + 1 if p.rows <= 8 else 3         # a partial CTA
    x = np.random.default_rng(n).normal(size=(rows, n)).astype(np.float32)
    got, stages = _mirror(x)
    _check_stage_order(stages, n)
    want = th.hadamard_transform_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(got, want.numpy())
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gotb, _ = _mirror(xb.float().numpy(), scale=0.5)
    np.testing.assert_array_equal(torch.from_numpy(gotb).to(torch.bfloat16).float().numpy(),
                                  th.hadamard_transform_plain(xb, scale=0.5).float().numpy())
    jax_y = np.asarray(jh.hadamard_transform(jnp.asarray(x)))
    if p.K == 1:
        np.testing.assert_array_equal(got, jax_y)
    else:   # XLA's einsum adds the K terms in its own order
        np.testing.assert_allclose(got, jax_y, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [64, 512, 1024, 2048, 8192, 32768, 20 * 128, 12 * 4096, 96,
                               140 * 64, 28 * 32])
def test_shared_memory_layout_is_a_bijection_with_few_conflicts(n):
    """``phys`` permutes each row; the float4 stores of pass 1 put a
    quarter warp's 8 units on 8 bank groups (at most 2 where rows of
    fewer than 8 threads share it), and pass 2's scalar reads put a
    warp's 32 values on 32 banks."""
    p = th.plan(n)
    E = p.E
    perm = np.array([_phys(a, E) for a in range(n)])
    assert sorted(perm.tolist()) == list(range(n))
    T = p.threads * p.rows
    t = np.arange(T)
    for f in range(E // 4):
        units = (t // p.threads) * (n // 4) + perm[(t % p.threads) * E + 4 * f] // 4
        for q in range(0, T, 8):
            worst = np.bincount(units[q:q + 8] % 8).max()
            assert worst == 1 or (p.threads < 8 and worst <= 2)
    if p.m % (8 * E) == 0:    # the contraction adds l * m to phys(j) instead
        for l in range(p.K):
            assert (perm[l * p.m:(l + 1) * p.m] == perm[:p.m] + l * p.m).all()
    if p.passes == 2:
        W = 32 * E
        for q0 in range(0, min(n // (p.m // W), 4 * p.threads), 32):
            q = q0 + np.arange(32)
            base = (q // W) * p.m + q % W
            assert len(set((perm[base] % 32).tolist())) == 32
