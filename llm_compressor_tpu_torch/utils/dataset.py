"""Calibration and evaluation datasets (port of ``utils/dataset.py``),
host-side only.

The reference's loader surface (utils/dataset.py:14-136): ``get_loaders``
(wikitext2 / ptb / c4, seeded random windows) and ``get_calib_dataset``
(pile-val, concatenated and split into blocks), returning numpy ``int32``
token arrays, the same arrays as the JAX package's for the same corpus and
tokenizer. ``datasets`` and ``transformers`` are imported inside the
functions that use them; the device only ever sees integer arrays.

Offline: ``synthetic_tokens`` is a deterministic Zipf-ish token stream
for tests and the chip smoke run, and the wikitext-2, c4 and pile-val
loaders take a ``local_path`` text file to tokenize instead of a download.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Optional

import numpy as np

from .logging import LOGGER


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


def _tokenize_text(text: str, tokenizer_path: str) -> np.ndarray:
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(tokenizer_path)
    return np.asarray(tok(text, return_tensors="np").input_ids, dtype=np.int32)


def _windows(enc: np.ndarray, nsamples: int, seqlen: int, seed: int) -> np.ndarray:
    """Seeded random windows: the reference's RNG protocol
    (utils/dataset.py:22-30, ``random.seed`` then one ``random.randint``
    a window), so the same calibration windows are drawn."""
    random.seed(seed)
    out = []
    for _ in range(nsamples):
        i = random.randint(0, enc.shape[1] - seqlen)
        out.append(enc[0, i:i + seqlen])
    return np.stack(out).astype(np.int32)


def get_wikitext2(tokenizer_path, nsamples=128, seqlen=2048, seed=0,
                  local_path: Optional[str] = None):
    if local_path is not None:
        enc = _tokenize_text(Path(local_path).read_text(), tokenizer_path)
        return _windows(enc, nsamples, seqlen, seed), enc
    from datasets import load_dataset

    traindata = load_dataset("wikitext", "wikitext-2-raw-v1", split="train")
    testdata = load_dataset("wikitext", "wikitext-2-raw-v1", split="test")
    trainenc = _tokenize_text("\n\n".join(traindata["text"]), tokenizer_path)
    testenc = _tokenize_text("\n\n".join(testdata["text"]), tokenizer_path)
    return _windows(trainenc, nsamples, seqlen, seed), testenc


def get_ptb(tokenizer_path, nsamples=128, seqlen=2048, seed=0):
    from datasets import load_dataset

    traindata = load_dataset("ptb_text_only", "penn_treebank", split="train",
                             trust_remote_code=True)
    testdata = load_dataset("ptb_text_only", "penn_treebank", split="test",
                            trust_remote_code=True)
    trainenc = _tokenize_text("\n\n".join(traindata["sentence"]), tokenizer_path)
    testenc = _tokenize_text("\n\n".join(testdata["sentence"]), tokenizer_path)
    return _windows(trainenc, nsamples, seqlen, seed), testenc


def get_c4(tokenizer_path, nsamples=128, seqlen=2048, seed=0,
           local_path: Optional[str] = None):
    """C4's windows: each from a random train document of at least
    ``seqlen`` tokens (one ``random.randint`` for the document, one for
    the offset, as the reference draws them); the test stream is the first
    1100 validation documents joined, cut to 256 windows."""
    if local_path is not None:
        enc = _tokenize_text(Path(local_path).read_text(), tokenizer_path)
        return _windows(enc, nsamples, seqlen, seed), enc
    from datasets import load_dataset
    from transformers import AutoTokenizer

    traindata = load_dataset(
        "allenai/c4", data_files={"train": "en/c4-train.00000-of-01024.json.gz"},
        split="train",
    )
    valdata = load_dataset(
        "allenai/c4",
        data_files={"validation": "en/c4-validation.00000-of-00008.json.gz"},
        split="validation",
    )
    tok = AutoTokenizer.from_pretrained(tokenizer_path)
    random.seed(seed)
    samples = []
    for _ in range(nsamples):
        while True:
            i = random.randint(0, len(traindata) - 1)
            enc = np.asarray(tok(traindata[i]["text"], return_tensors="np").input_ids)
            if enc.shape[1] >= seqlen:
                break
        i = random.randint(0, enc.shape[1] - seqlen)
        samples.append(enc[0, i:i + seqlen])
    valenc = np.asarray(tok(" ".join(valdata[:1100]["text"]), return_tensors="np").input_ids)
    return np.stack(samples).astype(np.int32), valenc[:, :256 * seqlen].astype(np.int32)


def get_loaders(name, tokenizer_path, nsamples=128, seqlen=2048, seed=0,
                local_path: Optional[str] = None):
    """(calibration windows (N, T) int32, test token stream (1, L) int32)."""
    if "wikitext2" in name:
        return get_wikitext2(tokenizer_path, nsamples, seqlen, seed, local_path)
    if "ptb" in name:
        return get_ptb(tokenizer_path, nsamples, seqlen, seed)
    if "c4" in name:
        return get_c4(tokenizer_path, nsamples, seqlen, seed, local_path)
    raise RuntimeError(f"Invalid dataset name, got {name}")


def get_calib_dataset(data="pileval", tokenizer_path=None, n_samples=512,
                      block_size=512, local_path: Optional[str] = None) -> np.ndarray:
    """Pile-val calibration blocks (reference utils/dataset.py:109-136):
    the first ``n_samples`` non-empty lines of at most 512 tokens after a
    shuffle with seed 42, concatenated and split into ``block_size``
    blocks. (N, block_size) int32."""
    if data != "pileval":
        raise NotImplementedError(data)
    if local_path is not None:
        cat = _tokenize_text(Path(local_path).read_text(), tokenizer_path)[0]
        n_split = len(cat) // block_size
        return cat[:n_split * block_size].reshape(n_split, block_size).astype(np.int32)
    from datasets import load_dataset
    from transformers import AutoTokenizer

    dataset = load_dataset("mit-han-lab/pile-val-backup", split="validation")
    dataset = dataset.shuffle(seed=42)
    tok = AutoTokenizer.from_pretrained(tokenizer_path)
    samples = []
    for d in dataset:
        enc = tok.encode(d["text"].strip())
        if len(enc) > 512 or len(enc) == 0:
            continue
        samples.append(enc)
        if len(samples) == n_samples:
            break
    cat = np.concatenate([np.asarray(s) for s in samples])
    n_split = len(cat) // block_size
    LOGGER.debug(f" * Split into {n_split} blocks")
    return cat[:n_split * block_size].reshape(n_split, block_size).astype(np.int32)
