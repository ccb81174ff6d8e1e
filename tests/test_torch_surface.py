"""The port's public surface against the JAX package's, read with ``ast``:
neither package is imported, so the whole file runs in well under a
second.

One case per module of ``llm_compressor_tpu/``. A case fails on anything
public that the JAX module has and its counterpart in
``llm_compressor_tpu_torch/`` lacks:

* the module itself (``RENAMED`` maps the two the port names otherwise);
* a top-level name: a function, class or assignment, and in an
  ``__init__.py`` also a name it imports (the package's re-exports);
* a member of a shared class: a method, property or field;
* a parameter of a shared function or method, by name.

The port may bind a name any way it likes (a def, an assignment, an
import). A gap passes only when ``JAX_ONLY`` names it, with the reason the
port does without it. ``test_jax_only_list_is_current`` fails on an entry
that no longer names a gap, so the list cannot go stale.

Keys of ``JAX_ONLY``: ``"module.py::name"`` for a name,
``"module.py::Class.member"`` for a member, ``"module.py::func(param)"``
(or ``"module.py::Class.method(param)"``) for a parameter; modules by
their path under the package.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "llm_compressor_tpu"
PORT_PKG = ROOT / "llm_compressor_tpu_torch"

RENAMED = {
    "evalx/clip_jax.py": ("evalx/clip.py", "the tower in PyTorch; the port has no twin to tell "
                                          "apart from a torch one"),
    "evalx/image_reward_jax.py": ("evalx/image_reward.py", "as evalx/clip_jax.py"),
}

_SCAN = "the lax.scan form of the layer stack; the port loops over layers (layer_view)"
_CACHE = ("a functional cache argument: the port's kernels write the cache in place "
          "(ROADMAP.md, Layouts)")
_SHARD_MAP = ("a shard_map axis name; the port passes the process group instead "
              "(absmax_group=, tp_trace(group, n); ROADMAP.md C)")

JAX_ONLY = {
    # lax.scan helpers and the per-layer arguments they feed
    "models/transformer.py::layer_scan_plan": _SCAN,
    "models/transformer.py::rope_stack": _SCAN + "; layer_ropes computes the ropes once",
    "models/transformer.py::split_packed_stacked": _SCAN,
    "models/transformer.py::reinsert_packed": _SCAN,
    "models/transformer.py::attention(layer_params)": _SCAN,
    "models/transformer.py::mlp(layer_params)": _SCAN,
    "models/transformer.py::decoder_layer(layer_params)": _SCAN,
    "engine/generate.py::decode_greedy_steps(unroll)": "the scan's unroll factor; the port "
                                                      "replays the steps as one CUDA graph",
    # moved
    "models/transformer.py::layer_window": "moved: ModelConfig.layer_window(i) in the port",
    "engine/generate.py::NEG_INF": "moved: kernels/decode_attention.py and "
                                   "models/transformer.py hold the port's mask value, -1e9",
    # PRNG keys
    "models/params.py::init_params(key)": "a jax.random key; the port draws from a "
                                          "torch.Generator seeded by seed=",
    "kernels/hadamard.py::random_hadamard_matrix(key)": "a jax.random key; the port takes a "
                                                        "torch.Generator",
    # shard_map axes
    "kernels/w4a8_matmul.py::quantize_acts_per_token(absmax_axis)": _SHARD_MAP,
    "kernels/w4a8_matmul.py::w4a8_matmul(absmax_axis)": _SHARD_MAP,
    "models/layers.py::tp_trace(axis)": _SHARD_MAP,
    "parallel/mesh.py::data_sharding(ndim)": "the rank of a NamedSharding; the port slices "
                                             "the tensor it is given",
    # unused, traced twins, layouts
    "engine/kvcache.py::write_slot(n_layers)": "not read in JAX's body",
    "engine/kvcache.py::init_fresh(quantized)": "JAX calls it only with quantized=True "
                                                "(engine/generate.py:1059-1060)",
    "engine/kvcache.py::init_fresh(dtype)": "as quantized: read only by the float side "
                                            "block",
    "algorithms/gptq.py::gptq(verbose)": "not read in JAX's body",
    "algorithms/spinquant.py::spinquant(verbose)": "only passed on to gptq, which does not "
                                                   "read it",
    "parallel/mesh.py::make_mesh(devices)": "a process group orders ranks by global rank; "
                                            "the mesh takes every rank in that order",
    "kernels/decode_attention.py::append_supported": "the port's gate is the ALiBi test in "
                                                     "the engine (_cached_attention)",
    "kernels/decode_attention.py::supported": "the port's gate is the ALiBi test in the "
                                              "engine (fresh_path_ok)",
    "algorithms/obs.py::hessian_inverse_factor_traced": "the traced twin that returns NaN; "
                                                        "the port's raises (ROADMAP.md C)",
    "kernels/decode_attention.py::decode_attention(cache_k)": _CACHE,
    "kernels/decode_attention.py::decode_attention(cache_v)": _CACHE,
    "kernels/decode_attention.py::decode_attention(layer)": _CACHE,
    "kernels/decode_attention.py::decode_attention(out_dtype)": "B7 returns f32, the caller "
                                                                "casts",
    "kernels/decode_attention.py::decode_attention_stats(cache_k)": _CACHE,
    "kernels/decode_attention.py::decode_attention_stats(cache_v)": _CACHE,
    "kernels/decode_attention.py::decode_attention_stats(layer)": _CACHE,
    "kernels/decode_attention.py::decode_attention_append(qi)": "B4 quantizes q itself "
                                                                "(JAX's quant_q=True)",
    "kernels/decode_attention.py::decode_attention_append(qs)": "as qi",
    "kernels/decode_attention.py::decode_attention_append(quant_q)": "as qi",
    "kernels/decode_attention.py::decode_attention_append(cache)": _CACHE,
    "kernels/decode_attention.py::decode_attention_append(layer)": _CACHE,
    "kernels/decode_attention.py::decode_attention_append(fresh)": _CACHE,
    "kernels/decode_attention.py::decode_attention_append(new_kv)": _CACHE + "; new_k, new_v, "
                                                                             "new_ks, new_vs",
    "kernels/decode_attention.py::decode_attention_append(main_len)": _CACHE,
    "kernels/decode_attention.py::decode_attention_append(t)": _CACHE,
    "kernels/decode_attention.py::decode_attention_append(merge_new)": _CACHE,
    "kernels/decode_attention.py::decode_attention_append(emit_fresh)": _CACHE,
    "kernels/decode_attention.py::decode_attention_append(acc)": _CACHE,
    # plain versions and CUDA entries under the port's own names
    "kernels/dequant_matmul.py::dequant_matmul_xla": "the plain version is "
                                                     "dequant_matmul_plain",
    "kernels/__init__.py::dequant_matmul_xla": "as kernels/dequant_matmul.py",
    "kernels/hadamard.py::hadamard_transform_pallas": "B10 is hadamard_transform on a CUDA "
                                                      "tensor",
    "kernels/__init__.py::hadamard_transform_pallas": "as kernels/hadamard.py",
    # bench-only
    "engine/generate.py::decode_greedy_steps(ablate)": "bench.py's attribution hook; the "
                                                      "port's timing uses the profiler",
}


def _defs(body):
    """Top-level statements, those under a top-level ``if`` / ``try`` too."""
    for node in body:
        yield node
        if isinstance(node, ast.If):
            yield from _defs(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _defs(node.body + node.orelse + node.finalbody
                             + [s for h in node.handlers for s in h.body])


def _params(fn) -> list:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


def _targets(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [t.id for t in targets if isinstance(t, ast.Name)]


def _members(cls) -> dict:
    """name -> parameter list (methods and properties) or None (fields)."""
    out = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(dict.fromkeys(_targets(node)))
    return out


def surface(path: Path, imports: bool) -> dict:
    """name -> ("def", params) | ("class", members) | ("name", None) of a
    module; ``imports`` counts the names it imports."""
    out = {}
    for node in _defs(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ("def", _params(node))
        elif isinstance(node, ast.ClassDef):
            out[node.name] = ("class", _members(node))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(dict.fromkeys(_targets(node), ("name", None)))
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out[(a.asname or a.name).split(".")[0]] = ("name", None)
    return out


def _public(name: str) -> bool:
    return not name.startswith("_")


def gaps(module: str) -> list:
    """What the JAX module has and its port lacks, as ``JAX_ONLY`` keys."""
    port_rel = RENAMED.get(module, (module,))[0]
    port_path = PORT_PKG / port_rel
    if not port_path.is_file():
        return [module]
    jax = surface(JAX_PKG / module, imports=module.endswith("__init__.py"))
    port = surface(port_path, imports=True)
    out = []
    for name, (kind, detail) in jax.items():
        if not _public(name):
            continue
        if name not in port:
            out.append(f"{module}::{name}")
            continue
        pkind, pdetail = port[name]
        if kind == "def" and pkind == "def":
            out += [f"{module}::{name}({p})" for p in detail if p not in pdetail]
        elif kind == "class" and pkind == "class":
            for m, params in detail.items():
                if not (_public(m) or m == "__call__"):
                    continue
                if m not in pdetail:
                    out.append(f"{module}::{name}.{m}")
                elif params is not None and pdetail[m] is not None:
                    out += [f"{module}::{name}.{m}({p})" for p in params
                            if p not in pdetail[m]]
    return out


JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_has_the_jax_surface(module):
    missing = [g for g in gaps(module) if g not in JAX_ONLY and g not in RENAMED]
    assert not missing, (f"the port lacks {missing}: port it, or add it to JAX_ONLY with "
                         "the reason the port does without it")


def test_jax_only_list_is_current():
    """Every ``JAX_ONLY`` and ``RENAMED`` entry still names a gap, and every
    renamed module's port exists."""
    found = {g for m in JAX_MODULES for g in gaps(m)}
    assert sorted(set(JAX_ONLY) - found) == []
    for module, (port_rel, _) in RENAMED.items():
        assert (JAX_PKG / module).is_file() and not (PORT_PKG / module).is_file()
        assert (PORT_PKG / port_rel).is_file()
    assert all(reason for reason in JAX_ONLY.values())


def test_imports_neither_package():
    tree = ast.parse(Path(__file__).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert {m.split(".")[0] for m in mods} <= {"ast", "pathlib", "pytest"}
