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
