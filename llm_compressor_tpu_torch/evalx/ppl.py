"""Perplexity with the reference's windowing (port of ``evalx/ppl.py``;
reference evaluation/eval.py:73-93): non-overlapping ``seq_len`` windows
over the test token stream, each window's mean CE over its first
``seq_len`` - 1 targets times ``seq_len`` as its nll, and
ppl = exp(sum nll / (n * seq_len)). The forward runs under
``torch.inference_mode`` on the params' device, windows batched.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import forward
from ..qformats.config import QuantConfig

LOGGER = logging.getLogger(__name__)


def _window_nll(params, cfg: ModelConfig, batch: torch.Tensor,
                qcfg: Optional[QuantConfig]) -> torch.Tensor:
    """Mean CE over each window's first T - 1 positions (torch
    CrossEntropyLoss's mean, eval.py:87-89), per batch row: (B,) f32."""
    logits = forward(params, cfg, batch, qcfg).float()
    logp = torch.log_softmax(logits[:, :-1, :], dim=-1)
    del logits
    ll = torch.gather(logp, -1, batch[:, 1:, None].long())[..., 0]
    return -torch.mean(ll, dim=-1)


def compute_ppl(params, cfg: ModelConfig, token_stream: np.ndarray,
                seq_len: int = 2048, n_samples: Optional[int] = None,
                qcfg: Optional[QuantConfig] = None, batch_size: int = 1) -> float:
    """``token_stream``: the whole (1, L) int32 test stream; at most
    ``n_samples`` windows; the last batch may be partial."""
    total = token_stream.size // seq_len
    if n_samples is not None:
        total = min(total, n_samples)
    windows = np.asarray(token_stream).reshape(-1)[: total * seq_len].reshape(total, seq_len)
    dev = params["embed"]["weight"].device
    nlls = []
    with torch.inference_mode():
        for i in range(0, total, batch_size):
            batch = torch.as_tensor(windows[i: i + batch_size], device=dev)
            nlls.append(_window_nll(params, cfg, batch, qcfg).cpu().numpy() * seq_len)
    nll_sum = float(np.concatenate(nlls).sum())
    return float(np.exp(nll_sum / (total * seq_len)))


def evaluate(params, cfg: ModelConfig, tasks: str, token_stream=None,
             seq_len: int = 2048, n_samples: Optional[int] = None,
             qcfg: Optional[QuantConfig] = None, batch_size: int = 1,
             is_check_sparsity: bool = False, tokenizer_path: Optional[str] = None):
    """The task-string runner of LMEvaluator.eval (eval.py:28-52): ``ppl``
    runs the perplexity above on ``token_stream`` (its result under
    ``ppl.wikitext2``, ``sys.maxsize`` there if it raises, and the error
    raised again); the other comma-separated tasks go through the lm-eval
    bridge (``lm_eval_bridge.py``)."""
    from .sparsity import check_sparsity

    results = {}
    if is_check_sparsity:
        results["sparsity"] = check_sparsity(params, cfg, verbose=True)

    task_list = [t for t in tasks.split(",") if t]
    if "ppl" in task_list:
        if token_stream is None:
            raise ValueError("ppl task needs a token_stream (get_loaders(...)[1])")
        try:
            ppl = compute_ppl(params, cfg, token_stream, seq_len, n_samples, qcfg, batch_size)
            results["ppl.wikitext2"] = ppl
            LOGGER.info(f"PPL[WIKITEXT2] : {ppl:.4f}")
        except Exception as e:   # the reference records sys.maxsize on failure
            results["ppl.wikitext2"] = sys.maxsize
            LOGGER.error(e)
            raise
        task_list.remove("ppl")

    if task_list:
        from .lm_eval_bridge import eval_qa

        results.update(eval_qa(params, cfg, task_list, qcfg=qcfg,
                               tokenizer_path=tokenizer_path,
                               batch_size=batch_size, n_samples=n_samples))
    return results
