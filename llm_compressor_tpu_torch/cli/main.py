"""The command-line pipeline (port of ``cli/main.py``): load -> prune -> profile
-> quantize -> evaluate -> pack -> save, as the reference's example
pipeline (examples/llama.py:12-82) runs them.

Everything runs on one device: the card, or the CPU under ``--cpu``. The
device is resolved first, so that a run without a card raises before it
writes anything; the model is loaded onto it and every later step works
where the params are.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from ..device import resolve_device
from ..utils.logging import LOGGER, add_file_sink, init_seeds
from .args import make_exp_dir


def _device(args) -> torch.device:
    return resolve_device("cpu" if getattr(args, "cpu", False) else None)


def _load_model(args):
    """(cfg, params, the HF config dict or None) on the run's device."""
    from ..models import init_params, load_hf_checkpoint, tiny_config

    dev = _device(args)
    if args.tiny or args.model is None:
        arch = args.arch or "llama"
        cfg = tiny_config(arch, dtype=args.dtype)
        LOGGER.info(f"Tiny random-init model: {arch}")
        return cfg, init_params(cfg, seed=args.seed, device=dev), None
    cfg, params = load_hf_checkpoint(args.model, dtype=args.dtype, device=dev)
    hf_cfg = json.loads((Path(args.model) / "config.json").read_text())
    LOGGER.info(f"Loaded {args.model}: {cfg.arch}, {cfg.num_layers} layers")
    return cfg, params, hf_cfg


# Per-method calibration corpora, as the reference's: pile-val for
# AWQ/AWQ+ stage-1/SmoothQuant (awq/core.py:38, awq_plus/core.py:40,
# smoothquant/core.py:48), C4 for Wanda/RIA/SparseGPT (wanda/core.py:34,
# ria/core.py:36, sparsegpt/core.py:35), wikitext-2 for GPTQ/GPTAQ/
# SpinQuant's final GPTQ/AWQ+ stage-2 (gptq/core.py:36, gptaq/core.py:37,
# awq_plus/core.py:155).
CALIB_DATASET = {
    "rtn": None, "magnitude": None,
    "gptq": "wikitext2", "gptaq": "wikitext2",
    "spinquant-had": "wikitext2", "spinquant-opt": "wikitext2",
    "awq": "pileval", "awq_plus": "pileval", "smoothquant": "pileval",
    "wanda": "c4", "ria": "c4", "sparsegpt": "c4",
}

# A stream of its own for each corpus, so that offline runs still calibrate
# each method on its own split.
_OFFLINE_SEED = {"wikitext2": 0, "pileval": 1000, "c4": 2000}


def _calib_tokens(args, cfg, dataset: str):
    """Calibration token windows (N, T) int32 for one corpus name."""
    from ..utils.dataset import get_calib_dataset, get_loaders, synthetic_tokens

    if args.model is not None and not args.tiny:
        if dataset == "pileval":
            return get_calib_dataset("pileval", tokenizer_path=args.model,
                                     n_samples=args.calib_num,
                                     block_size=args.seq_len,
                                     local_path=args.calib_dataset)
        train, _ = get_loaders(dataset, args.model, nsamples=args.calib_num,
                               seqlen=args.seq_len, seed=args.seed,
                               local_path=args.calib_dataset)
        return train
    LOGGER.warning(f"Offline mode: synthetic calibration tokens ({dataset})")
    return synthetic_tokens(args.calib_num, args.seq_len, cfg.vocab_size,
                            args.seed + _OFFLINE_SEED[dataset])


def _eval_stream(args, cfg):
    """The (1, L) int32 perplexity stream."""
    from ..utils.dataset import get_loaders, synthetic_tokens

    if args.model is not None and not args.tiny:
        _, test = get_loaders("wikitext2", args.model, nsamples=1,
                              seqlen=args.seq_len, seed=args.seed,
                              local_path=args.calib_dataset)
        return test
    return synthetic_tokens(1, 1, cfg.vocab_size, args.seed + 1,
                            eval_len=16 * args.seq_len)


def run_pipeline(args, return_state: bool = False):
    """Run the pipeline the flags ask for. Returns the results dict
    (``results.json``; ``{"stats_csv": ...}`` under ``--profile``, which
    stops after profiling), and with ``return_state`` also the compressed
    model: ``{"cfg", "params", "qcfg", "scale_book"}``."""
    _device(args)   # no card and no --cpu: raise before writing anything
    from .. import algorithms as alg
    from ..capture import capture_layer0
    from ..evalx import evaluate, profile_model
    from ..models import save_compressed
    from ..qformats import build_quant_config

    init_seeds(args.seed)
    exp_dir = make_exp_dir(args)
    add_file_sink(exp_dir / "run.log")

    cfg, params, hf_cfg = _load_model(args)
    qcfg = build_quant_config(args.weight, args.act_in, args.act_out, args.head,
                              w_mse=args.w_clip,
                              head_act=getattr(args, "head_act", None))

    def ctx(dataset: str):
        toks = _calib_tokens(args, cfg, dataset)
        return capture_layer0(params, cfg, toks, chunk=8)

    if args.prune:
        LOGGER.info(f"Pruning [{args.prune_method}] sparsity={args.sparsity}")
        pd = CALIB_DATASET[args.prune_method]
        if args.prune_method == "magnitude":
            alg.magnitude(params, cfg, args.sparsity)
        elif args.prune_method == "wanda":
            alg.wanda(params, cfg, ctx(pd), args.sparsity, qcfg)
        elif args.prune_method == "sparsegpt":
            alg.sparsegpt(params, cfg, ctx(pd), args.sparsity, qcfg)
        elif args.prune_method == "ria":
            alg.ria(params, cfg, ctx(pd), args.sparsity, args.ria_alpha, qcfg)

    if args.profile:
        # the reference profiles one 256-token wikitext batch (models/base.py:95)
        toks = _calib_tokens(args, cfg, "wikitext2")
        profile_model(params, cfg, qcfg, toks[:1, :256], save_path=exp_dir)
        LOGGER.info("Profiling done (stats.csv)")
        return {"stats_csv": str(exp_dir / "stats.csv")}

    scale_book: dict = {}
    if args.quantize:
        LOGGER.info(f"Quantizing [{args.quant_method}]")
        m = args.quant_method
        qd = CALIB_DATASET[m]
        if m == "rtn":
            alg.rtn(params, cfg, qcfg, mse=args.w_clip, scale_book=scale_book)
        elif m == "smoothquant":
            alg.smoothquant(params, cfg, ctx(qd), qcfg, alpha=args.sq_alpha,
                            mse=args.w_clip, scale_book=scale_book)
        elif m == "gptq":
            alg.gptq(params, cfg, ctx(qd), qcfg, mse=args.w_clip, scale_book=scale_book)
        elif m == "awq":
            alg.awq(params, cfg, ctx(qd), qcfg, mse=args.w_clip, scale_book=scale_book)
        elif m == "awq_plus":
            # stage-1 AWQ search on pile-val, stage-2 GPTQ on wikitext-2
            # (reference awq_plus/core.py:40,155)
            alg.awq_plus(params, cfg, ctx(qd), ctx("wikitext2"), qcfg,
                         mse=args.w_clip, scale_book=scale_book)
        elif m == "gptaq":
            alg.gptaq(params, cfg, ctx(qd), qcfg, mse=args.w_clip, scale_book=scale_book)
        elif m in ("spinquant-had", "spinquant-opt"):
            cfg = alg.spinquant(params, cfg, _calib_tokens(args, cfg, qd), qcfg,
                                mode="hadamard" if m == "spinquant-had" else "optimize",
                                rotation_path=args.rotation_path, mse=args.w_clip,
                                scale_book=scale_book)

    test_stream = _eval_stream(args, cfg) if "ppl" in args.tasks else None
    results = evaluate(params, cfg, args.tasks, token_stream=test_stream,
                       seq_len=min(args.seq_len * 4, 2048) if args.tiny else 2048,
                       qcfg=qcfg, batch_size=args.batch_size,
                       is_check_sparsity=args.prune,
                       tokenizer_path=args.model)
    LOGGER.info(f"Results: {results}")
    (exp_dir / "results.json").write_text(json.dumps(results, indent=2))

    if args.pack:
        alg.pack_model(params, cfg, qcfg, scale_book=scale_book or None)
        LOGGER.info("Weights packed into QTensors")

    if args.save_path:
        # hf_cfg is the loaded config.json as it was: SpinQuant's untied
        # config is not written, as in the JAX package (ROADMAP C)
        save_compressed(params, cfg, args.save_path, hf_config=hf_cfg,
                        tokenizer_path=args.model)
        LOGGER.info(f"Saved compressed model -> {args.save_path}")
    if return_state:
        # the compressed model itself, for callers that serve it (tinychat)
        return results, {"cfg": cfg, "params": params, "qcfg": qcfg,
                         "scale_book": scale_book}
    return results


def main(argv=None, arch: str = None):
    from .args import build_parser

    parser = build_parser()
    args = parser.parse_args(argv)
    if arch is not None and args.arch is None:
        args.arch = arch
    return run_pipeline(args)


if __name__ == "__main__":
    main()
