"""The port's dataset loaders (``utils/dataset.py``) against the JAX
package's, on the same corpora and tokenizer: a fake
``datasets.load_dataset`` returns ``datasets.Dataset.from_dict`` corpora,
and the tokenizer is a word-level one built here
(``torch_port_util.word_tokenizer``). Nothing is downloaded. The windows
and test streams are bitwise equal, for every loader and every
``local_path`` branch; the port's are int32."""

import datasets
import numpy as np
import pytest

from llm_compressor_tpu.utils import dataset as jds
from llm_compressor_tpu_torch.utils import dataset as tds
from torch_port_util import WORDS, word_corpus, word_tokenizer

N, T = 6, 24


def _lines(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [word_corpus(int(rng.integers(lo, hi)), seed + i, line=1000) for i in range(n)]


CORPORA = {
    ("wikitext", "train"): {"text": _lines(1, 40, 0, 60)},
    ("wikitext", "test"): {"text": _lines(2, 20, 0, 60)},
    ("ptb_text_only", "train"): {"sentence": _lines(3, 40, 1, 40)},
    ("ptb_text_only", "test"): {"sentence": _lines(4, 20, 1, 40)},
    # documents shorter than T are drawn and passed over
    ("allenai/c4", "train"): {"text": _lines(5, 30, 4, 60)},
    ("allenai/c4", "validation"): {"text": _lines(6, 30, 4, 60)},
    # empty lines and lines over 512 tokens are passed over
    ("mit-han-lab/pile-val-backup", "validation"): {
        "text": _lines(7, 40, 0, 40) + ["", "  "] + _lines(8, 3, 513, 600)},
}


@pytest.fixture
def tok(tmp_path):
    word_tokenizer(tmp_path / "tok")
    return str(tmp_path / "tok")


@pytest.fixture
def fake_hub(monkeypatch):
    calls = []

    def load_dataset(path, name=None, split=None, data_files=None, trust_remote_code=None):
        calls.append((path, name, split))
        return datasets.Dataset.from_dict(CORPORA[(path, split)])

    monkeypatch.setattr(datasets, "load_dataset", load_dataset)
    return calls


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert got.dtype == np.int32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["wikitext2", "ptb", "c4"])
@pytest.mark.parametrize("seed", [0, 3])
def test_get_loaders_matches_jax(name, seed, tok, fake_hub):
    want = jds.get_loaders(name, tok, nsamples=N, seqlen=T, seed=seed)
    n_calls = len(fake_hub)
    got = tds.get_loaders(name, tok, nsamples=N, seqlen=T, seed=seed)
    _same(got, want)
    assert fake_hub[n_calls:] == fake_hub[:n_calls]
    assert got[0].shape == (N, T) and got[1].shape[0] == 1


def test_get_calib_dataset_matches_jax(tok, fake_hub):
    want = jds.get_calib_dataset("pileval", tok, n_samples=30, block_size=T)
    got = tds.get_calib_dataset("pileval", tok, n_samples=30, block_size=T)
    _same(got, want)
    assert got.shape[1] == T and got.shape[0] > 10


@pytest.mark.parametrize("name", ["wikitext2", "c4", "pileval"])
def test_local_path_matches_jax(name, tok, tmp_path, fake_hub):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(word_corpus(2000, 9) + "\nunknown words here\n")
    if name == "pileval":
        want = jds.get_calib_dataset("pileval", tok, n_samples=4, block_size=T,
                                     local_path=str(corpus))
        got = tds.get_calib_dataset("pileval", tok, n_samples=4, block_size=T,
                                    local_path=str(corpus))
    else:
        want = jds.get_loaders(name, tok, nsamples=N, seqlen=T, seed=1, local_path=str(corpus))
        got = tds.get_loaders(name, tok, nsamples=N, seqlen=T, seed=1, local_path=str(corpus))
    _same(got, want)
    assert fake_hub == []   # nothing asked of the hub


def test_windows_draw_the_reference_protocol():
    """``_windows`` draws one ``random.randint`` a window after
    ``random.seed(seed)``, as JAX's does."""
    enc = np.arange(500, dtype=np.int32)[None]
    np.testing.assert_array_equal(tds._windows(enc, 7, 33, 5), jds._windows(enc, 7, 33, 5))


def test_unknown_names_raise(tok):
    for mod in (jds, tds):
        with pytest.raises(RuntimeError, match="Invalid dataset name"):
            mod.get_loaders("wikitext3x", tok)
        with pytest.raises(NotImplementedError):
            mod.get_calib_dataset("c4", tok)


def test_tokenizer_stand_in_round_trip(tok):
    from transformers import AutoTokenizer

    t = AutoTokenizer.from_pretrained(tok)
    ids = tds._tokenize_text(" ".join(WORDS[:5]), tok)
    assert ids.dtype == np.int32 and ids.tolist() == [[2, 3, 4, 5, 6]]
    assert t.eos_token_id == 1
