"""Calibration tokens (port of ``utils/dataset.py::synthetic_tokens``).

The offline corpus only: Zipf-distributed tokens with repeated 8-token
windows, pure numpy, the same array as the JAX package's for the same
arguments. The tokenizer-backed loaders (wikitext-2, ptb, c4, pile-val)
are queued in ROADMAP.md (queue A item 12).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def synthetic_tokens(n_samples: int, seq_len: int, vocab_size: int, seed: int = 0,
                     eval_len: Optional[int] = None) -> np.ndarray:
    """Deterministic synthetic corpus: Zipf-distributed tokens with local
    repetition structure. Returns (n_samples, seq_len) int32, or
    (1, eval_len) when ``eval_len`` is given."""
    rng = np.random.default_rng(seed)
    total = n_samples * seq_len if eval_len is None else eval_len
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab_size, size=total, p=probs).astype(np.int32)
    # n-gram structure: repeat short windows
    for _ in range(total // 64):
        i = rng.integers(0, max(1, total - 16))
        j = rng.integers(0, max(1, total - 16))
        toks[j:j + 8] = toks[i:i + 8]
    if eval_len is not None:
        return toks[None, :]
    return toks.reshape(n_samples, seq_len)
