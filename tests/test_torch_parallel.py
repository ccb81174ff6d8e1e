"""The mesh, the sharded forward, the multi-host layout and the launcher
against the JAX package (mirrors ``tests/test_parallel.py``).

JAX runs ``forward`` over GSPMD-placed params on this process's 8 virtual
CPU devices (a 2 x 4 mesh); the port runs the same cases through its
explicit path (``shard_params``, then ``tp_forward`` under
``models.layers.tp_trace``) on 4 spawned gloo ranks, a 2 x 2 mesh, which
its local products need: whole heads (the tiny Llama has 2 KV heads) and
whole groups on every rank. So the packed case takes hidden 256 /
intermediate 512 / head_dim 64, where JAX's test takes 128 / 256 / 32:
there its o projection has one int4-g128 group, which GSPMD replicates and
the explicit path refuses (checked). ``test_graft_entry_dryrun`` has no
counterpart (the JAX package's own entry point).

Tolerances (JAX's): float logits rtol = atol = 2e-4 against JAX's
single-device and GSPMD forwards and the port's single-device one; the
int8-act forward 2e-3; the packed W4A8 forward 1e-3. Specs equal JAX's
``PartitionSpec``s leaf for leaf on every architecture's ``tiny_config``
(and packed at 2 model shards); mesh layouts and group members exact.
"""

import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from llm_compressor_tpu import algorithms as jalg
from llm_compressor_tpu import models as jm
from llm_compressor_tpu import parallel as jpar
from llm_compressor_tpu.parallel import multihost as jmh
from llm_compressor_tpu.qformats import build_quant_config as jbuild
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.parallel import launch, mesh as tmesh
from llm_compressor_tpu_torch.parallel import multihost as tmh
from torch_port_util import (ARCHS, jax_spec_leaves, jax_to_numpy, one_torch_thread,  # noqa: F401
                             port_spec_leaves, tree_copy)
import torch_tp_ranks

ACTS = (None, "int8-g[-1]-rw", None, None)
PACKED = ("int4-g[128]-rw", "int8-g[-1]-rw", None, None)
PACKED_CFG = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=4,
                  head_dim=64)
JAX_PACKED_CFG = dict(hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=4,
                      head_dim=32)


def _model(seed, cfg_kw=None, qargs=None, pack=False):
    cfg = jm.tiny_config("llama", **(cfg_kw or {}))
    params = jm.init_params(cfg, jax.random.PRNGKey(seed))
    qcfg = None if qargs is None else jbuild(*qargs)
    if pack:
        jalg.rtn(params, cfg, qcfg)
        jalg.pack_model(params, cfg, qcfg)
    return cfg, params, qcfg


def _forward_case(seed, toks_shape, cfg_kw=None, qargs=None, pack=False, **extra):
    cfg, params, qcfg = _model(seed, cfg_kw, qargs, pack)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, toks_shape).astype(np.int32)
    case = dict(kind="forward", arch="llama", cfg=dict(cfg_kw or {}),
                params=jax_to_numpy(params), qargs=qargs, n_data=2, n_model=2, toks=toks, **extra)
    return (cfg, params, qcfg), case


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    refused = _model(1, JAX_PACKED_CFG, PACKED, pack=True)[1]
    cases = {
        "dp": _forward_case(0, (4, 16)),
        "quantized": _forward_case(1, (2, 8), qargs=ACTS),
        "packed": _forward_case(0, (2, 8), PACKED_CFG, PACKED, pack=True, refused=dict(
            cfg=JAX_PACKED_CFG, params=jax_to_numpy(refused))),
        "layout": ((None,) * 3, dict(kind="mesh_layout", n_data=2, per_host=2)),
    }
    res = launch.run(torch_tp_ranks.run_cases, 4, str(tmp_path_factory.mktemp("store")),
                     ({k: c for k, (_, c) in cases.items()},), timeout=300)
    return cases, res


def _check_forward(world4, name, n_data_jax, tol):
    cases, res = world4
    (cfg, params, qcfg), case = cases[name]
    toks = jnp.asarray(case["toks"])
    ref = np.asarray(jm.forward(params, cfg, toks, qcfg=qcfg))
    mesh = jpar.make_mesh(n_data=n_data_jax)
    sp = jpar.shard_params(tree_copy(params), cfg, mesh)
    gspmd = np.asarray(jm.forward(sp, cfg, jax.device_put(toks, jpar.data_sharding(mesh, 2)),
                                  qcfg=qcfg))
    out0 = res[0][name]
    for r in res[1:]:
        np.testing.assert_array_equal(r[name]["tp"], out0["tp"])
    for want in (ref, gspmd, out0["single"]):
        np.testing.assert_allclose(out0["tp"], want, rtol=tol, atol=tol)
    # the specs on the 2 x 2 mesh, against JAX's on a 1 x 2 one
    jmesh = jpar.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    assert port_spec_leaves(out0["specs"]) == {
        k: v for k, v in jax_spec_leaves(jpar.param_spec_tree(params, cfg, jmesh)).items()
        if k[-1] != "scales_t"}
    return out0


def test_tp_dp_forward_matches_single_device(world4):
    _check_forward(world4, "dp", 2, 2e-4)


def test_tp_quantized_forward(world4):
    """int8 per-token acts on float weights: a row slot's scale from the
    absmax all-reduced over the row (``_quant_global_per_token``)."""
    _check_forward(world4, "quantized", 1, 2e-3)


def test_tp_packed_qtensor_forward(world4):
    """Packed int4-g128 weights sharded over the model axis (o at one group
    a rank, in group halves; down at two, in pair planes) match the
    single-device packed forward; JAX's own widths are refused."""
    out = _check_forward(world4, "packed", 2, 1e-3)
    assert "stays replicated" in out["refused"]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_tree_matches_jax(arch):
    cfg = jm.tiny_config(arch)
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax_to_numpy(jp), "cpu")
    want = jax_spec_leaves(jpar.param_spec_tree(jp, cfg))
    assert port_spec_leaves(tmesh.param_spec_tree(tp)) == want


def test_param_specs_shapes_divisible():
    """Every "model" dim of the tiny Llama's specs divides over 4 shards
    (JAX's mesh of 2 x 4)."""
    cfg = jm.tiny_config("llama")
    tp = params_from_numpy(jax_to_numpy(jm.init_params(cfg, jax.random.PRNGKey(0))), "cpu")
    specs = tmesh.param_spec_tree(tp)

    def check(path, leaf):
        spec = specs
        for k in path:
            spec = spec[k]
        for dim, axis in enumerate(spec):
            if axis == "model":
                assert leaf.shape[dim] % 4 == 0, (path, leaf.shape, spec)
        return spec

    tmesh.tree_map_with_path(check, tp)


def test_multihost_mesh_layout(world4, monkeypatch):
    """The DCN x ICI layout of 2 hosts x 4 ranks against JAX's mocked
    2-host x 4-device mesh (rank r is device r), and the port's real meshes
    on 4 ranks as 2 hosts x 2: rank arrays, axis names and every rank's
    group members."""
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for axis in ("ici", "dcn"):
        arr, names = tmh.multihost_layout(8, 2, axis)
        jmesh = jmh.make_multihost_mesh(model_axis=axis)
        assert names == jmesh.axis_names
        np.testing.assert_array_equal(arr, np.vectorize(lambda d: d.id)(jmesh.devices))
    with pytest.raises(ValueError):
        tmh.multihost_layout(6, 4)
    for rank, r in enumerate(world4[1]):
        out = r["layout"]
        np.testing.assert_array_equal(out["make_mesh"]["mesh"], [[0, 1], [2, 3]])
        for axis in ("ici", "dcn"):
            arr, names = tmh.multihost_layout(4, 2, axis)
            assert tuple(out[axis]["names"]) == names
            np.testing.assert_array_equal(out[axis]["mesh"], arr)
            for d, name in enumerate(names):   # this rank's line along each axis
                line = arr[tuple(slice(None) if e == d else
                                 int(np.argwhere(arr == rank)[0][e]) for e in range(2))]
                assert sorted(out[axis][name]) == sorted(line.tolist())
        np.testing.assert_array_equal(out["data_slice"], np.arange(8)[4 * (rank // 2):][:4])


def test_multihost_initialize_branches(monkeypatch, caplog):
    """``initialize``'s branches with a fake ``init_process_group``: an
    explicit coordinator becomes a TCP init with its world and rank, no
    arguments the env:// (torchrun) init, an initialised group a no-op, a
    failure a debug line and one process."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    tmh.initialize(coordinator="10.0.0.1:1234", num_processes=2, process_id=1)
    assert calls[-1] == dict(backend="gloo", init_method="tcp://10.0.0.1:1234", world_size=2,
                             rank=1)
    tmh.initialize()
    assert calls[-1] == dict(backend="gloo", init_method="env://")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")       # two ranks a host, two cards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    tmh.initialize()
    assert calls[-1] == dict(backend="nccl", init_method="env://")

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    n = len(calls)
    tmh.initialize()               # already initialised: no call
    assert len(calls) == n

    monkeypatch.setattr(dist, "is_initialized", lambda: False)

    def boom(**kw):
        raise RuntimeError("no cluster reachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with caplog.at_level(logging.DEBUG, logger="llm_compressor_tpu_torch"):
        tmh.initialize()           # must not raise (a single-process run)
    assert "no cluster reachable" in caplog.text


def test_pick_backend(monkeypatch):
    """NCCL only when every rank has a card of its own."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launch.pick_backend(2) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert launch.pick_backend(2) == "nccl"
    assert launch.pick_backend(4) == "gloo"


def test_launch_results_and_failure(tmp_path):
    """Results come back in rank order; a rank that raises fails the run
    with its traceback, and no child outlives the call."""
    assert launch.run(torch_tp_ranks.fail_on, 2, str(tmp_path), (-1,), timeout=120) == [0, 1]
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*told to fail"):
        launch.run(torch_tp_ranks.fail_on, 2, str(tmp_path), (1,), timeout=120)
    import multiprocessing

    assert not multiprocessing.active_children()
