"""The rank side of the tensor-parallel CPU tests (``test_torch_tp.py``,
``test_torch_parallel.py``): functions that ``parallel.launch.run`` calls
in each spawned rank of a gloo group. This module imports torch and the
port only, never JAX, so that the ranks do not load the JAX package. The
parent hands each case over as plain data: the architecture and its
``tiny_config`` arguments, the JAX package's params as numpy
(``torch_port_util.jax_to_numpy``), the quantizer specs and the inputs.
Every rank returns its own results, so that the tests can hold the ranks
to each other."""

import os

import numpy as np
import torch

from llm_compressor_tpu_torch import engine, models, parallel, qformats
from llm_compressor_tpu_torch.convert import params_from_numpy
from llm_compressor_tpu_torch.parallel import multihost


def _qcfg(case):
    q = case.get("qargs")
    if q is None:
        return None
    qcfg = qformats.build_quant_config(*q)
    if case.get("mpq"):
        qcfg = qformats.register_4_to_8bit(qcfg, case["mpq"])
    return qcfg


def _model(case):
    cfg = models.tiny_config(case["arch"], **case.get("cfg", {}))
    return cfg, params_from_numpy(case["params"], "cpu"), _qcfg(case)


def _serving(params, cfg, qcfg, shards: int):
    if shards:
        params = models.fuse_model(params, cfg, qcfg, shards=shards)
    return models.stack_model(params)


def _single(params, cfg, qcfg, toks, case):
    """The port's single-device prefill and one decode step."""
    cache = engine.init_cache(cfg.num_layers, toks.shape[0], 16, cfg.num_kv_heads, cfg.head_dim,
                              quantized=case["quantized_kv"], device="cpu",
                              dtype=torch.float32)
    logits, cache = engine.prefill(params, toks, cache, cfg=cfg, qcfg=qcfg)
    step, cache = engine.decode_step(params, toks[:, :1], cache, cfg=cfg, qcfg=qcfg)
    return logits.numpy(), step.numpy()


def serve(case):
    """``tp_serve_fns`` prefill and one decode step on the case's mesh, and
    the port's single-device run of the same (unfused) params."""
    cfg, params, qcfg = _model(case)
    toks = torch.from_numpy(case["toks"])
    single = _single(models.stack_model(params), cfg, qcfg, toks, case)
    cfg, params, qcfg = _model(case)
    mesh = parallel.make_mesh(n_data=case["n_data"], n_model=case["n_model"])
    fused = bool(case.get("shards"))
    sp = parallel.tp_shard_params(_serving(params, cfg, qcfg, case.get("shards", 0)), cfg, mesh,
                                  fused=fused)
    pre, dec = parallel.tp_serve_fns(sp, cfg, mesh, qcfg=qcfg, fused=fused)
    cache = parallel.tp_init_cache(cfg, mesh, toks.shape[0], 16, quantized=case["quantized_kv"],
                                   dtype=torch.float32, device="cpu")
    logits, cache = pre(sp, toks, cache)
    step, cache = dec(sp, toks[:, :1], cache)
    return {"tp": (logits.numpy(), step.numpy()), "single": single,
            "cache_heads": cache.k.shape[2], "cache_batch": cache.k.shape[1]}


def batcher(case):
    """The same requests through the TP batcher and the single-device one
    (both eager, greedy); the errors of ``graph=True`` over gloo, for the
    TP batcher and for ``tp_serve_fns``."""
    def run(params, tp_mesh=None):
        eng = engine.ContinuousBatcher(params, cfg, batch_slots=2, max_len=32, prefill_chunk=8,
                                       qcfg=qcfg, quantized_kv=case["quantized_kv"],
                                       tp_mesh=tp_mesh)
        for p in case["prompts"]:
            eng.submit(p, max_new_tokens=4)
        return {uid: np.asarray(v) for uid, v in eng.run().items()}

    cfg, params, qcfg = _model(case)
    single = run(models.stack_model(params))
    mesh = parallel.make_mesh(n_data=1, n_model=case["n_model"])
    cfg, params, qcfg = _model(case)
    tp = run(parallel.tp_shard_params(models.stack_model(params), cfg, mesh), tp_mesh=mesh)
    graph_errors = []
    for build in (lambda: engine.ContinuousBatcher(params, cfg, tp_mesh=mesh, graph=True),
                  lambda: parallel.tp_serve_fns(params, cfg, mesh, graph=True)):
        try:
            build()
            graph_errors.append(None)
        except ValueError as e:
            graph_errors.append(str(e))
    return {"tp": tp, "single": single, "graph_errors": graph_errors}


def forward(case):
    """``tp_forward`` over ``shard_params`` (the GSPMD cases) against the
    port's single-device ``forward``."""
    cfg, params, qcfg = _model(case)
    toks = torch.from_numpy(case["toks"])
    single = models.forward(params, cfg, toks, qcfg).numpy()
    mesh = parallel.make_mesh(n_data=case["n_data"], n_model=case["n_model"])
    specs = parallel.param_spec_tree(params, cfg, mesh)
    sp = parallel.shard_params(params, cfg, mesh)
    out = {"tp": parallel.tp_forward(sp, cfg, mesh, toks, qcfg).numpy(), "single": single,
           "specs": specs}
    if case.get("refused"):          # widths whose row slots would stay replicated
        cfg, params, qcfg = _model(dict(case, cfg=case["refused"]["cfg"],
                                        params=case["refused"]["params"]))
        try:
            parallel.shard_params(params, cfg, mesh)
            out["refused"] = None
        except ValueError as e:
            out["refused"] = str(e)
    return out


def refusals(case):
    """The errors of plain-fused params and of indivisible heads."""
    out = {}
    cfg, params, qcfg = _model(case)
    mesh = parallel.make_mesh(n_data=1)
    fused = models.stack_model(models.fuse_model(params, cfg, qcfg))
    for name, fn in (("plain_fused", lambda: parallel.tp_shard_params(fused, cfg, mesh)),
                     ("plain_fused_serve", lambda: parallel.tp_serve_fns(fused, cfg, mesh)),
                     ("indivisible", lambda: parallel.tp_serve_fns(
                         fused, models.tiny_config(case["arch"], num_heads=3, num_kv_heads=3,
                                                   head_dim=16), mesh, fused=True))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def mesh_layout(case):
    """``make_mesh`` and ``make_multihost_mesh`` (torchrun's
    ``LOCAL_WORLD_SIZE`` ranks per host): each mesh's rank array and this
    rank's group members along each axis."""
    def describe(mesh):
        return {"mesh": mesh.mesh.numpy(), "names": mesh.mesh_dim_names,
                **{a: torch.distributed.get_process_group_ranks(mesh.get_group(a))
                   for a in mesh.mesh_dim_names}}

    out = {"make_mesh": describe(parallel.make_mesh(n_data=case["n_data"]))}
    os.environ["LOCAL_WORLD_SIZE"] = str(case["per_host"])
    for axis in ("ici", "dcn"):
        out[axis] = describe(multihost.make_multihost_mesh(model_axis=axis))
    multihost.initialize()          # already initialised: a no-op
    out["data_slice"] = parallel.data_sharding(parallel.make_mesh(n_data=case["n_data"]),
                                               torch.arange(8)).numpy()
    return out


def row_parallel(case):
    """One row-parallel projection (slot "o", with a bias) on this rank's
    half of the contraction dim, through each route of ``qlinear``: B1's
    (a stacked layer), B3's (flat packed weights) and the float weight's
    (int8 fake-quantized acts); with the act codes and scales of each
    rank's half under the model group. The single-device results beside."""
    from dataclasses import replace

    from llm_compressor_tpu_torch.kernels import w4a8_matmul as wm
    from llm_compressor_tpu_torch.models.layers import LayerSlice, qlinear, tp_trace
    from llm_compressor_tpu_torch.qformats.config import parse_qspec
    from llm_compressor_tpu_torch.qformats.qtensor import quantize_pack

    x, w, b = (torch.from_numpy(case[k]) for k in ("x", "w", "bias"))
    op = qformats.build_quant_config(*case["qargs"]).linear
    qt = quantize_pack(parse_qspec(case["qargs"][0]), w)
    st = replace(qt, codes=torch.stack([qt.codes] * 2), scales=torch.stack([qt.scales] * 2))
    mesh = parallel.make_mesh(n_data=1)
    group, n = mesh.get_group("model"), mesh.size(1)
    r = mesh.get_local_rank("model")
    local = parallel.tp_shard_params({"layers_stacked": {"attn": {"o": {"weight": st}}},
                                      "layers": [{"attn": {"o": {"weight": qt, "bias": b}}},
                                                 {"attn": {"o": {"weight": w}}}]}, None, mesh)
    C = x.shape[1] // n
    xl = x[:, r * C:(r + 1) * C].contiguous()
    routes = {"B1": (LayerSlice(st, 1), LayerSlice(local["layers_stacked"]["attn"]["o"]["weight"],
                                                   1)),
              "B3": (qt, local["layers"][0]["attn"]["o"]["weight"]),
              "float": (w, local["layers"][1]["attn"]["o"]["weight"])}
    out = {}
    for name, (whole, part) in routes.items():
        want = qlinear(x, whole, b, op, slot="o")
        with tp_trace(group, n):
            got = qlinear(xl, part, b, op, slot="o")
        out[name] = (got.numpy(), want.numpy())
    codes, scale = wm.quantize_acts_per_token(xl, group)
    want_codes, want_scale = wm.quantize_acts_per_token(x)
    out["acts"] = (codes.numpy(), scale.numpy(), want_codes[:, r * C:(r + 1) * C].numpy(),
                   want_scale.numpy())
    return out


def gpu_row_parallel(rank: int, world: int, seed: int) -> dict:
    """On the card (``tests/test_torch_tp_gpu.py``): one row-parallel
    ``down`` of Qwen3-1.7B's shape (2048 x 6144, int4-g128, a stacked
    layer) at 1024 rows through ``qlinear``, on this rank's part of the
    contraction dim under the model group, beside the single-device
    ``qlinear`` over the whole row: the launches of each, whether this
    rank's act codes and the scales equal the single device's, both
    outputs."""
    from dataclasses import replace

    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.kernels import w4a8_matmul as wm
    from llm_compressor_tpu_torch.models.layers import LayerSlice, qlinear, tp_trace
    from llm_compressor_tpu_torch.qformats.config import parse_qspec
    from llm_compressor_tpu_torch.qformats.qtensor import quantize_pack

    M, N, C = 1024, 2048, 6144
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, C), generator=g, device="cuda").to(torch.bfloat16)
    w = 0.02 * torch.randn((N, C), generator=g, device="cuda")
    op = qformats.build_quant_config("int4-g[128]-rw", "int8-g[-1]-rw", None, None).linear
    qt = quantize_pack(parse_qspec("int4-g[128]-rw"), w)
    st = replace(qt, codes=torch.stack([qt.codes] * 2), scales=torch.stack([qt.scales] * 2))
    mesh = parallel.make_mesh(n_data=1)
    group, n = mesh.get_group("model"), mesh.size(1)
    r = mesh.get_local_rank("model")
    local = parallel.tp_shard_params({"layers_stacked": {"mlp": {"down": {"weight": st}}}},
                                     None, mesh)["layers_stacked"]["mlp"]["down"]["weight"]
    Cl = C // n
    xl = x[:, r * Cl:(r + 1) * Cl].contiguous()

    def launched(fn):
        kernels.reset_counts()
        y = fn()
        torch.cuda.synchronize()
        return y, {k: v for k, v in kernels.launch_counts().items() if v}

    want, single = launched(lambda: qlinear(x, LayerSlice(st, 1), None, op, slot="down"))
    with tp_trace(group, n):
        got, tp = launched(lambda: qlinear(xl, LayerSlice(local, 1), None, op, slot="down"))
    codes, scale = wm.quantize_acts_per_token(xl, group)
    want_codes, want_scale = wm.quantize_acts_per_token(x)
    return {"single": single, "tp": tp, "got": got.float().cpu().numpy(),
            "want": want.float().cpu().numpy(),
            "codes_equal": bool(torch.equal(codes, want_codes[:, r * Cl:(r + 1) * Cl])),
            "scales_equal": bool(torch.equal(scale, want_scale))}


def _gpu_model(world: int, seed: int):
    """A small W4A8 model whose every local projection takes the kernels
    (hidden 512, int4-g128: o and down at whole groups on each of 2 or 4
    ranks), fused with ``shards=world`` and sharded over a 1 x world mesh:
    (cfg, qcfg, mesh, this rank's shard)."""
    from llm_compressor_tpu_torch.algorithms import pack_model, rtn

    cfg = models.tiny_config("llama", hidden_size=512, intermediate_size=1024, num_heads=8,
                             num_kv_heads=4, head_dim=64, vocab_size=1024, dtype="bfloat16")
    qcfg = qformats.build_quant_config("int4-g[128]-rw", "int8-g[-1]-rw", None,
                                       "int8-g[128]-rw", head_act="int8-g[-1]-rw")
    params = models.init_params(cfg, seed=seed, device="cuda")
    rtn(params, cfg, qcfg)
    pack_model(params, cfg, qcfg)
    mesh = parallel.make_mesh(n_data=1)
    sp = parallel.tp_shard_params(
        models.stack_model(models.fuse_model(params, cfg, qcfg, shards=world)), cfg, mesh,
        fused=True)
    return cfg, qcfg, mesh, sp


def nccl_graphs(rank: int, world: int, seed: int) -> dict:
    """Over NCCL, a card a rank (``tests/test_torch_tp_gpu.py``): the
    decode step of ``tp_serve_fns`` as a CUDA graph against the eager TP
    step from one prefilled state, 4 steps (the first eager, the second
    captures, then replays): whether logits and cache were bitwise equal,
    and the captures, after each; then the TP batcher with graphs against
    the eager TP batcher on the same requests."""
    from llm_compressor_tpu_torch.engine.graph import _map

    def same(a, b):
        return all(getattr(a, n) is None or torch.equal(getattr(a, n), getattr(b, n))
                   for n in ("k", "v", "k_scale", "v_scale", "lengths"))

    cfg, qcfg, mesh, sp = _gpu_model(world, seed)
    prefill_fn, decode_fn = parallel.tp_serve_fns(sp, cfg, mesh, qcfg=qcfg, fused=True)
    _, eager_fn = parallel.tp_serve_fns(sp, cfg, mesh, qcfg=qcfg, fused=True, graph=False)
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (8, 16), generator=g, device="cuda",
                         dtype=torch.int32)
    cache = parallel.tp_init_cache(cfg, mesh, 8, 32, quantized=True)
    logits, cache = prefill_fn(sp, toks, cache)
    ref = _map(torch.clone, cache)
    tok, steps = torch.argmax(logits, -1).to(torch.int32)[:, None], []
    for _ in range(4):
        got, cache = decode_fn(sp, tok, cache)
        want, ref = eager_fn(sp, tok, ref)
        steps.append((bool(torch.equal(got, want) and same(cache, ref)), cache.graphs.captures))
        tok = torch.argmax(got, -1).to(torch.int32)[:, None]

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32) for t in (5, 40, 17, 58, 33)]
    engines = []
    for graph in (None, False):
        eng = engine.ContinuousBatcher(sp, cfg, batch_slots=3, max_len=64, qcfg=qcfg,
                                       quantized_kv=True, prefill_chunk=16, tp_mesh=mesh,
                                       tp_fused=True, graph=graph)
        eng.warmup()
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        engines.append((eng, eng.run()))
    (ge, gids), (ee, eids) = engines
    return {"decode_steps": steps, "batcher_graph": ge.graph, "batcher_eager": ee.graph,
            "ids_equal": set(gids) == set(eids) and all(np.array_equal(gids[u], eids[u])
                                                         for u in gids),
            "ids": {int(u): v.tolist() for u, v in gids.items()},
            "cache_equal": same(ge.cache, ee.cache),
            "captures": (sum(m.graphs.captures for m in ge._minis.values()),
                         ge.cache.graphs.captures, ge.chunk_classes)}


KINDS = {"row_parallel": row_parallel, "serve": serve, "batcher": batcher, "forward": forward, "refusals": refusals,
         "mesh_layout": mesh_layout}


def run_cases(rank: int, world: int, cases: dict) -> dict:
    """Every case of one world size, in turn, on this rank."""
    return {name: KINDS[case["kind"]](case) for name, case in cases.items()}


def fail_on(rank: int, world: int, bad_rank: int) -> int:
    """Raise on ``bad_rank``; the others return their rank."""
    if rank == bad_rank:
        raise ValueError(f"rank {rank} was told to fail")
    return rank


def gpu_paths(rank: int, world: int, seed: int) -> dict:
    """On the card (``tests/test_torch_tp_gpu.py``): :func:`_gpu_model`
    served by ``tp_serve_fns`` through the kernels and through their plain
    versions (over NCCL the decode steps replay graphs from the second
    step on); each rank's logits of the prefill and 3 decode steps, and
    the launches of each decode step."""
    import contextlib
    import importlib

    from llm_compressor_tpu_torch import kernels
    from llm_compressor_tpu_torch.kernels import decode_attention as da
    from llm_compressor_tpu_torch.kernels import w4a8_matmul as wm

    gen_mod = importlib.import_module("llm_compressor_tpu_torch.engine.generate")

    @contextlib.contextmanager
    def plain():
        swaps = [(wm, "matmul_stacked", lambda x, c, s, sx, layer, f, dt: wm.w4a8_plain(
                      x, c[layer], s[layer], sx, f, dt)),
                 (wm, "matmul_flat", wm.w4a8_plain),
                 (wm, "gateup_silu", lambda x, c, s, sx, layer, f, act, dt: wm.gateup_plain(
                     x, c[layer], s[layer], sx, f, act, dt)),
                 (gen_mod, "decode_attention_append", da.decode_attention_append_plain)]
        saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
        for m, n, f in swaps:
            setattr(m, n, f)
        try:
            yield
        finally:
            for m, n, f in saved:
                setattr(m, n, f)

    cfg, qcfg, mesh, sp = _gpu_model(world, seed)
    fns = parallel.tp_serve_fns(sp, cfg, mesh, qcfg=qcfg, fused=True)
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (8, 16), generator=g, device="cuda",
                         dtype=torch.int32)

    def run():
        cache = parallel.tp_init_cache(cfg, mesh, 8, 32, quantized=True)
        logits, cache = fns[0](sp, toks, cache)
        out, steps = [logits.cpu().numpy()], []
        for _ in range(3):
            kernels.reset_counts()
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            logits, cache = fns[1](sp, tok, cache)
            torch.cuda.synchronize()
            steps.append({k: v for k, v in kernels.launch_counts().items() if v})
            out.append(logits.cpu().numpy())
        return out, steps

    got, steps = run()
    with plain():
        want, plain_steps = run()
    return {"kernel": got, "plain": want, "steps": steps, "plain_steps": plain_steps,
            "local_o_codes": tuple(sp["layers_stacked"]["attn"]["o"]["weight"].codes.shape)}
