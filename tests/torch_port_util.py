"""Helpers shared by the ``test_torch_*`` parity tests: hand the JAX
package's params over to the port as numpy, draw the norms and biases of
such a tree from a seed, cap torch's threads, and hold the port's GPTQ
chain against the JAX package's functions, teacher-forced."""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_compressor_tpu.algorithms import common as jcommon
from llm_compressor_tpu.algorithms import obs as jobs
from llm_compressor_tpu.capture import pipeline as jpipe
from llm_compressor_tpu.models import layer_ops as j_layer_ops
from llm_compressor_tpu.qformats.qtensor import QTensor as JQTensor
from llm_compressor_tpu_torch.capture import pipeline as tpipe
from torch_threads import one_torch_thread  # noqa: F401  (re-exported for the test files)

ARCHS = ("llama", "qwen2", "qwen3", "gemma", "gemma2", "gemma3", "opt", "bloom", "phi")


def jax_qspec(q) -> str:
    """DSL string of a JAX Quantizer (``qformats.config.qspec_string``)."""
    prefix = {"int": "", "fp": "", "mx": "mx", "nvfp": "nv"}[q.qtype]
    zp = "zp-" if q.zero_point else ""
    return f"{prefix}{q.fmt.value}-g[{q.group_size}]-{zp}{'rw' if q.axes == -1 else 'cw'}"


def jax_to_numpy(tree):
    """JAX params tree -> nested dicts / lists of numpy arrays, with each
    QTensor as its field dict (the input format of ``convert.py``)."""
    if isinstance(tree, JQTensor):
        return {
            "codes": np.asarray(tree.codes), "scales": np.asarray(tree.scales),
            "zeros": None if tree.zeros is None else np.asarray(tree.zeros),
            "shape": tuple(tree.shape), "blocked_shape": tuple(tree.blocked_shape),
            "group_axis": tree.group_axis, "ngroups_axis": tree.ngroups_axis,
            "pair_planes": bool(tree.pair_planes), "dtype": np.dtype(tree.dtype).name,
            "qspec": jax_qspec(tree.quantizer),
        }
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_to_numpy(v) for v in tree]
    return np.asarray(tree)


def randomize(tree, seed):
    """The norms' weights and the biases of a numpy params tree
    (``jax_to_numpy``) drawn from ``seed``, in place: N(0, 0.1) added to
    every 1-D weight, N(0, 0.02) biases. ``init_params`` gives ones or
    zeros, under which a norm's or a bias's misuse would not show."""
    rng = np.random.default_rng(seed)

    def walk(node):
        items = enumerate(node) if isinstance(node, list) else list(node.items())
        for k, v in items:
            if isinstance(v, (dict, list)):
                walk(v)
            elif k == "bias":
                node[k] = rng.normal(0, 0.02, v.shape).astype(v.dtype)
            elif k == "weight" and v.ndim == 1:
                node[k] = (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype)

    walk(tree)
    return tree


def codes_of(Q, s, z, g):
    """Integer codes of a fake-quantized (N, C) weight: round(Q / s + z)
    per group of g columns."""
    N, C = Q.shape
    return np.round(Q.reshape(N, C // g, g) / s + z).reshape(N, C)


def check_codes(tc, jc, min_equal=0.999, max_steps=1):
    """GPTQ's codes on identical W and H: at least ``min_equal`` of them
    equal, the rest at most ``max_steps`` apart (the Cholesky factors and
    the error-feedback products may differ in the last float32 bits)."""
    diff = np.abs(tc - jc)
    assert diff.max() <= max_steps, diff.max()
    assert (diff == 0).mean() >= min_equal, (diff == 0).mean()


def clone_tree(tree):
    """A copy of a port params tree (dicts, lists) with every tensor cloned."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.clone()


def to_jax(tree):
    """A port params tree of float tensors as the JAX package's (jnp arrays)."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def assert_same_tree(tl, jl):
    """Every tensor of a port tree equal to a JAX (or port) tree's, bitwise."""
    if isinstance(jl, (dict, list)):
        assert len(tl) == len(jl)
        for k in (jl if isinstance(jl, dict) else range(len(jl))):
            assert_same_tree(tl[k], jl[k])
    else:
        np.testing.assert_array_equal(np.asarray(tl), np.asarray(jl))


@contextlib.contextmanager
def recording_gptq_chain():
    """Within the block, every Hessian pass of the port's GPTQ driver
    appends a record: the layer, its taps, the layer's input hidden
    states, positions and chunk, the layer params as they stand, and the
    Hessians."""
    tgptq = importlib.import_module("llm_compressor_tpu_torch.algorithms.gptq")
    calls = []

    def recording(ctx, lp, i, taps, ops=None):
        H, outs = tpipe.accumulate_hessian(ctx, lp, i, taps, ops)
        calls.append(dict(layer=i, taps=tuple(taps), hidden=ctx.hidden.clone(),
                          positions=ctx.positions.clone(), chunk=ctx.chunk, params=clone_tree(lp),
                          H={k: v.clone() for k, v in H.items()}))
        return H, outs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgptq, "accumulate_hessian", recording)
        yield calls


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def check_gptq_chain(calls, jcfg, jqcfg, gptq_w, scale_book, hidden0, hidden_tol=1e-3,
                     mse=False, code_steps=1):
    """The port's GPTQ chain, teacher-forced, against the JAX package's
    functions. ``calls`` from ``recording_gptq_chain``, ``gptq_w`` the
    port's GPTQ weights by (layer, slot), ``scale_book`` its (scales,
    zeros), ``hidden0`` JAX's ``capture_layer0`` hidden states. Per layer i:

    * its input: layer 0's within 1e-5 of the largest entry of ``hidden0``
      (no quantizer precedes it); layer i's within
      ``hidden_tol`` of the largest entry of JAX's ``advance`` of layer
      i - 1's recorded input through layer i - 1 with every linear set to
      the port's GPTQ weight;
    * the Hessian passes, one per sequential group of JAX's
      ``sequential_groups`` in its order, each against JAX's
      ``accumulate_hessian`` on the layer's recorded input with the weights
      the layer had before its GPTQ and the earlier groups' linears set to
      the port's GPTQ weights: ``attn_in``, which no activation quantizer
      of the layer precedes, within 1e-5 of the largest entry, the others
      within 1e-3 (``test_capture_and_hessians_w4a8``'s bounds);
    * each linear against JAX's GPTQ core on the same weight and the
      port's Hessian (with the MSE clip search when ``mse``): scale-book
      entry bitwise, codes by ``check_codes`` (at most ``code_steps``
      apart).

    Returns the largest relative errors seen, by kind."""
    to_jax = lambda tree: jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)
    groups = jcommon.sequential_groups(jcfg)
    first = {}
    for c in calls:
        first.setdefault(c["layer"], c)
    assert sorted(first) == list(range(jcfg.num_layers))
    worst = {"hidden": 0.0, "attn_in": 0.0, "other taps": 0.0}

    def ctx_of(c, hidden):
        return jpipe.CalibContext(cfg=jcfg, hidden=jnp.asarray(hidden.numpy()),
                                  positions=jnp.asarray(c["positions"].numpy()),
                                  chunk=c["chunk"])

    def with_gptq(lp, i, slots):
        for s in slots:
            jcommon.set_weight(lp, s, jnp.asarray(gptq_w[(i, s)].numpy()))
        return lp

    for i in range(jcfg.num_layers):
        c0 = first[i]
        if i == 0:
            err = rel_err(c0["hidden"].numpy(), hidden0)
            assert err <= 1e-5, err
            worst["hidden"] = err
        else:
            prev = first[i - 1]
            ctx = ctx_of(prev, prev["hidden"])
            jpipe.advance(ctx, with_gptq(to_jax(prev["params"]), i - 1,
                                         [s for g in groups for s in g]),
                          i - 1, j_layer_ops(jcfg, jqcfg, i - 1))
            err = rel_err(c0["hidden"].numpy(), ctx.hidden)
            assert err <= hidden_tol, (i, err)
            worst["hidden"] = max(worst["hidden"], err)
        mine = [c for c in calls if c["layer"] == i]
        assert [c["taps"] for c in mine] == [(jpipe.SLOT_TAP[g[0]],) for g in groups], i
        done = []
        for c, group in zip(mine, groups):
            assert torch.equal(c["hidden"], c0["hidden"]), (i, group)
            tap = c["taps"][0]
            lp = with_gptq(to_jax(c0["params"]), i, done)
            jH, _ = jpipe.accumulate_hessian(ctx_of(c0, c0["hidden"]), lp, i, (tap,),
                                             j_layer_ops(jcfg, jqcfg, i))
            err = rel_err(c["H"][tap].numpy(), jH[tap])
            kind = "attn_in" if tap == "attn_in" else "other taps"
            assert err <= (1e-5 if tap == "attn_in" else 1e-3), (i, tap, err)
            worst[kind] = max(worst[kind], err)
            for s in group:
                W = jcommon.get_weight(c0["params"], s)
                jQ, js, jz = jobs.gptq_update_with_params(
                    jnp.asarray(W.numpy()), jnp.asarray(c["H"][tap].numpy()),
                    jcommon.weight_quantizer_for(jcfg, jqcfg, i, s, mse))
                ts, tz = (v.numpy() for v in scale_book[(i, s)])
                np.testing.assert_array_equal(ts, np.asarray(js))
                np.testing.assert_array_equal(tz, np.asarray(jz))
                g = W.shape[1] // ts.shape[1]
                check_codes(codes_of(gptq_w[(i, s)].numpy(), ts, tz, g),
                            codes_of(np.asarray(jQ), ts, tz, g), max_steps=code_steps)
            done += group
    return worst


# every architecture's tiny_config, and OPT-350m's variant (project_in,
# post-norm) as tests/test_hf_parity.py builds it: name -> (arch, overrides)
ALL_VARIANTS = {"llama": ("llama", {}), "qwen2": ("qwen2", {}), "qwen3": ("qwen3", {}),
                "gemma": ("gemma", {}), "gemma2": ("gemma2", {}), "gemma3": ("gemma3", {}),
                "opt": ("opt", {}),
                "opt350m": ("opt", dict(project_in_dim=32, do_layer_norm_before=False)),
                "bloom": ("bloom", {}), "phi": ("phi", {})}


def variant_pair(name, seed=0, **kw):
    """(jcfg, tcfg, JAX params, port params) of an ``ALL_VARIANTS`` entry:
    the same float32 weights, norms and biases drawn from ``seed``."""
    from llm_compressor_tpu import models as jm
    from llm_compressor_tpu_torch import models as tm
    from llm_compressor_tpu_torch.convert import params_from_numpy

    arch, over = ALL_VARIANTS[name]
    over = over | kw
    jcfg, tcfg = jm.tiny_config(arch, **over), tm.tiny_config(arch, **over)
    tree = randomize(jax_to_numpy(jm.init_params(jcfg, jax.random.PRNGKey(seed))), seed + 1)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def tree_copy(tree):
    """A JAX params tree with new containers (the arrays shared), for the
    JAX functions that edit their dicts in place (``fuse_model``)."""
    return jax.tree_util.tree_map(lambda x: x, tree)


def jax_spec_leaves(tree) -> dict:
    """{path: spec tuple} of a JAX ``PartitionSpec`` tree, the path as dict
    keys, list indices and QTensor field names."""
    from jax.sharding import PartitionSpec

    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    key = lambda k: getattr(k, "key", getattr(k, "idx", getattr(k, "name", None)))
    return {tuple(key(k) for k in path): tuple(spec) for path, spec in flat}


def port_spec_leaves(tree, path=()) -> dict:
    """{path: spec tuple} of a port spec tree (``parallel.mesh``)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in port_spec_leaves(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in port_spec_leaves(sub, path + (i,)).items()}
    return {path: tree}


def cli_hand_over(mp):
    """The port's ``cli.main._load_model`` returns, for ``--tiny`` runs, the
    model the JAX package's CLI draws for the same flags:
    ``tiny_config(arch, dtype=...)`` and ``init_params(cfg,
    PRNGKey(seed))``, handed over as numpy onto the run's device."""
    from llm_compressor_tpu import models as jm
    from llm_compressor_tpu_torch import models as tm
    from llm_compressor_tpu_torch.cli import main as tmain
    from llm_compressor_tpu_torch.convert import params_from_numpy

    real = tmain._load_model

    def load(args):
        if not (args.tiny or args.model is None):
            return real(args)
        arch = args.arch or "llama"
        tree = jax_to_numpy(jm.init_params(jm.tiny_config(arch, dtype=args.dtype),
                                           jax.random.PRNGKey(args.seed)))
        return (tm.tiny_config(arch, dtype=args.dtype),
                params_from_numpy(tree, tmain._device(args)), None)

    mp.setattr(tmain, "_load_model", load)


WORDS = tuple(f"w{i}" for i in range(200))


def word_tokenizer(path, vocab_words=WORDS):
    """A word-level tokenizer built here with ``tokenizers`` (whitespace
    split, one id a word, ``[UNK]`` 0 and ``</s>`` 1), wrapped as
    ``PreTrainedTokenizerFast`` and saved to the directory ``path``, so
    that ``AutoTokenizer.from_pretrained(path)`` loads it. Nothing is
    downloaded."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"[UNK]": 0, "</s>": 1} | {w: i + 2 for i, w in enumerate(vocab_words)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", eos_token="</s>")
    fast.save_pretrained(str(path))
    return fast


def word_corpus(n_words: int, seed: int, vocab_words=WORDS, line: int = 12) -> str:
    """Text of ``n_words`` words drawn from ``seed``, ``line`` words a line."""
    rng = np.random.default_rng(seed)
    words = [vocab_words[i] for i in rng.integers(0, len(vocab_words), n_words)]
    return "\n".join(" ".join(words[i:i + line]) for i in range(0, n_words, line))
