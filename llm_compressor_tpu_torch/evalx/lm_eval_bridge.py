"""lm-eval-harness bridge (port of ``evalx/lm_eval_bridge.py``; reference
evaluation/eval.py:95-163): the model as an lm_eval ``LM`` that serves
loglikelihood and generation requests. lm_eval tokenizes and scores on
the host; only token tensors reach the params' device, where the forward
runs under ``torch.inference_mode``.

``lm_eval`` and ``transformers`` are optional: they are imported inside the
functions that need them, which raise a clear error without them.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..qformats.config import QuantConfig

LOGGER = logging.getLogger(__name__)


def _require_lm_eval():
    try:
        import lm_eval  # noqa: F401
        return lm_eval
    except ImportError as e:
        raise ImportError(
            "lm_eval is not installed — QA task evaluation requires the "
            "lm-eval-harness (pip install lm-eval). Perplexity evaluation "
            "('ppl' task) works without it."
        ) from e


def _loglikelihood_batch(params, cfg, qcfg, batch_tokens: np.ndarray,
                         context_lens: List[int], total_lens: List[int]):
    """Per sequence: (sum of the continuation's log-probs, whether every
    continuation token is the argmax)."""
    from ..models.transformer import forward

    dev = params["embed"]["weight"].device
    with torch.inference_mode():
        logits = forward(params, cfg, torch.as_tensor(batch_tokens, device=dev), qcfg).float()
        logp = torch.log_softmax(logits, dim=-1).cpu().numpy()
    out = []
    for b, (cl, tl) in enumerate(zip(context_lens, total_lens)):
        tgt = batch_tokens[b, cl:tl]
        lp = logp[b, cl - 1: tl - 1]
        token_lp = lp[np.arange(len(tgt)), tgt]
        greedy = bool((lp.argmax(-1) == tgt).all())
        out.append((float(token_lp.sum()), greedy))
    return out


def make_lm(params, cfg: ModelConfig, tokenizer_path: str,
            qcfg: Optional[QuantConfig] = None, batch_size: int = 1,
            max_length: int = 2048):
    """An lm_eval LM adapter for the model, with the tokenizer read from
    the local ``tokenizer_path``."""
    _require_lm_eval()
    from lm_eval.api.model import LM
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(tokenizer_path)

    class TorchLM(LM):
        def __init__(self):
            super().__init__()
            self.tokenizer = tok

        def _encode_pair(self, context, continuation):
            ctx = tok.encode(context) if context else [tok.bos_token_id or tok.eos_token_id]
            whole = tok.encode(context + continuation)
            return ctx, whole

        def loglikelihood(self, requests):
            results = []
            pairs = [self._encode_pair(r.args[0], r.args[1]) for r in requests]
            for i in range(0, len(pairs), batch_size):
                chunk = pairs[i: i + batch_size]
                maxlen = min(max(len(w) for _, w in chunk), max_length)
                batch = np.zeros((len(chunk), maxlen), dtype=np.int32)
                cls_, tls = [], []
                for b, (ctx, whole) in enumerate(chunk):
                    whole = whole[-maxlen:]
                    cl = max(1, min(len(ctx), maxlen - 1))
                    batch[b, : len(whole)] = whole
                    cls_.append(cl)
                    tls.append(len(whole))
                results.extend(_loglikelihood_batch(params, cfg, qcfg, batch, cls_, tls))
            return results

        def loglikelihood_rolling(self, requests):
            out = []
            for r in requests:
                toks = tok.encode(r.args[0])[:max_length]
                batch = np.asarray([toks], dtype=np.int32)
                (ll, _), = _loglikelihood_batch(params, cfg, qcfg, batch, [1], [len(toks)])
                out.append(ll)
            return out

        def generate_until(self, requests):
            from ..engine.generate import generate_text

            return [generate_text(params, cfg, tok, r.args[0], qcfg=qcfg, max_new_tokens=64,
                                  use_chat_template=False) for r in requests]

    return TorchLM()


def eval_qa(params, cfg: ModelConfig, tasks: List[str], qcfg=None,
            tokenizer_path: Optional[str] = None, batch_size: int = 1,
            n_samples: Optional[int] = None):
    """Zero- or few-shot QA through lm_eval (mmlu 5-shot, fewshot seed
    1234: eval.py:99,124); accuracy in percent by task."""
    _require_lm_eval()
    from lm_eval import evaluator
    from lm_eval.tasks import TaskManager, get_task_dict

    lm = make_lm(params, cfg, tokenizer_path, qcfg, batch_size)
    results = {}
    for task in tasks:
        num_fewshot = 5 if task == "mmlu" else 0
        name = {"lambada": "lambada_openai", "truthfulqa": "truthfulqa_mc1"}.get(task, task)
        task_dict = get_task_dict(name, TaskManager())

        def _adjust(d):
            for k, t in d.items():
                if isinstance(t, dict):
                    _adjust(t)
                else:
                    t.set_config(key="num_fewshot", value=num_fewshot)
                    t.set_fewshot_seed(seed=1234)
        _adjust(task_dict)
        res = evaluator.evaluate(lm=lm, task_dict=task_dict, limit=n_samples,
                                 log_samples=False, verbosity="ERROR")
        results[task] = res["results"][name]["acc,none"] * 100
        LOGGER.info(f"QA[{task.upper()}] : {results[task]:.4f}")
    return results
