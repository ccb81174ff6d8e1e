"""The port's native host packer (``utils/native.py``, ctypes over the
repo's ``native/libllmc_host.so``) against the port's
``qformats.quantize_pack`` (the mirror of ``tests/test_native.py``) and
against the JAX package's bindings: pair-plane and legacy bytes bitwise,
the round trip, and the numpy fallback when the library cannot load."""

import numpy as np
import pytest
import torch

from llm_compressor_tpu.utils import native as jnative
from llm_compressor_tpu_torch.qformats import ElemFormat, Quantizer, dequantize, quantize_pack
from llm_compressor_tpu_torch.utils import native as tnative
from torch_port_util import one_torch_thread  # noqa: F401


def _int4(group=128):
    return Quantizer(qtype="int", fmt=ElemFormat.int4, group_size=group)


def test_native_available():
    assert tnative.have_native(), "native library failed to build/load"
    assert tnative._NATIVE_DIR == jnative._NATIVE_DIR


def test_native_matches_port_packer(rng):
    W = rng.normal(size=(32, 256)).astype(np.float32)
    packed, scales = tnative.quantize_pack_int4(W, group=128)

    qt = quantize_pack(_int4(), torch.from_numpy(W))
    np.testing.assert_array_equal(packed, qt.codes.numpy().reshape(32, 128))
    np.testing.assert_allclose(scales, qt.scales.numpy().reshape(32, 2), rtol=1e-6)


def test_native_roundtrip(rng):
    W = rng.normal(size=(16, 128)).astype(np.float32)
    packed, scales = tnative.quantize_pack_int4(W, group=128)
    codes = tnative.unpack_int4(packed, group=128)
    recon = codes.reshape(16, 1, 128) * scales[..., None]
    err = np.abs(recon.reshape(16, 128) - W)
    # at most half a quantization step a group
    assert np.all(err <= scales.max(axis=1)[:, None] * 0.5 + 1e-6)


def test_native_pair_layout_matches_port(rng):
    """The native packer writes the pair-plane bytes ``quantize_pack``
    writes (the int4 default), and both layouts round-trip through the
    native unpack."""
    W = rng.normal(0, 0.1, size=(64, 512)).astype(np.float32)
    packed, scales = tnative.quantize_pack_int4(W, group=128)  # auto: pairs
    qt = quantize_pack(_int4(), torch.from_numpy(W))
    assert qt.pair_planes
    np.testing.assert_array_equal(packed, qt.codes.numpy())
    np.testing.assert_allclose(scales, qt.scales.numpy(), rtol=1e-6)

    codes = tnative.unpack_int4(packed, group=128)
    vals = dequantize(qt).float().numpy()
    sc = np.repeat(qt.scales.numpy(), 128, axis=1)
    np.testing.assert_allclose(codes * sc, vals, atol=1e-5)

    p2, _ = tnative.quantize_pack_int4(W, group=128, pairs=False)
    c2 = tnative.unpack_int4(p2, group=128, pairs=False)
    np.testing.assert_allclose(c2 * sc, vals, atol=1e-5)


# pair planes need an even group count: 384 / 128 packs as group halves
@pytest.mark.parametrize("shape,group,pairs", [
    ((8, 256), 128, None), ((8, 256), 128, True), ((8, 256), 128, False),
    ((4, 384), 128, None), ((4, 384), 128, False),
    ((6, 64), 32, None), ((6, 64), 32, True), ((6, 64), 32, False)])
def test_native_bytes_match_jax(shape, group, pairs, rng):
    W = rng.normal(0, 0.05, size=shape).astype(np.float32)
    got, want = (tnative.quantize_pack_int4(W, group, pairs),
                 jnative.quantize_pack_int4(W, group, pairs))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tnative.unpack_int4(got[0], group, pairs),
                                  jnative.unpack_int4(want[0], group, pairs))


@pytest.mark.parametrize("pairs", [None, False])
def test_numpy_fallback_matches_library(pairs, rng, monkeypatch):
    W = rng.normal(0, 0.05, size=(8, 512)).astype(np.float32)
    lib = tnative.quantize_pack_int4(W, 128, pairs)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    assert not tnative.have_native()
    fallback = tnative.quantize_pack_int4(W, 128, pairs)
    for a, b in zip(fallback, lib):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tnative.unpack_int4(fallback[0], 128, pairs),
                                  jnative.unpack_int4(lib[0], 128, pairs))


def test_invalid_layouts_raise(rng):
    """Where the JAX package's binding passes the library a layout it cannot
    write (pair planes over an odd group count: bytes left unwritten), the
    port's raises."""
    W = rng.normal(size=(4, 384)).astype(np.float32)
    with pytest.raises(ValueError, match="even group count"):
        tnative.quantize_pack_int4(W, 128, pairs=True)
    with pytest.raises(ValueError, match="groups of"):
        tnative.quantize_pack_int4(W, 100)
