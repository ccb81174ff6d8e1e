"""The port's examples (``llm_compressor_tpu_torch.examples``) against the
JAX package's ``examples/``, on the CPU: each of the nine per-architecture
pipelines run as ``python -m`` runs it (``runpy``, ``sys.argv``) beside
JAX's script on the same initial params (``torch_port_util.cli_hand_over``),
and tinychat's ``prepare`` and one ``generate_text`` on what it returns.

Perplexity within 2e-3 relative, the W4A8 bound of
``tests/test_torch_ppl.py`` (bfloat16 models, int8 per-token activations:
an ulp moves an activation code; measured: at most 2.3e-4, Gemma2)."""

import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_util import ARCHS, cli_hand_over, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--tiny", "--cpu", "--quantize", "--quant-method", "rtn", "--tasks", "ppl",
         "--weight", "int4-g[32]-rw", "--act-in", "int8-g[-1]-rw", "--calib-num", "4",
         "--seq-len", "16"]


def _run(argv0, run, cwd, monkeypatch):
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [argv0, *FLAGS])
    run()
    return json.loads((cwd / "experiments" / "exp" / "results.json").read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_example_matches_jax(arch, tmp_path, monkeypatch):
    cli_hand_over(monkeypatch)
    script = ROOT / "examples" / f"{arch}.py"
    want = _run(str(script), lambda: runpy.run_path(str(script), run_name="__main__"),
                tmp_path / "jax", monkeypatch)
    module = f"llm_compressor_tpu_torch.examples.{arch}"
    got = _run(module, lambda: runpy.run_module(module, run_name="__main__"),
               tmp_path / "port", monkeypatch)
    assert set(got) == set(want) == {"ppl.wikitext2"}
    np.testing.assert_allclose(got["ppl.wikitext2"], want["ppl.wikitext2"], rtol=2e-3)


class ByteTokenizer:
    """A stand-in for a HF tokenizer: UTF-8 bytes in, one character per id
    out (from U+4E00, so that no id decodes to whitespace)."""
    eos_token_id = None
    BASE = 0x4E00

    def encode(self, text):
        return list(text.encode())

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(self.BASE + i) for i in ids)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_tinychat_prepare_and_generate_text(kv_quant, tmp_path, monkeypatch):
    """``prepare`` returns the packed params the pipeline compressed (JAX's
    ``test_tinychat_serves_compressed``), and ``generate_text`` on them
    gives ``generate``'s ids."""
    from llm_compressor_tpu_torch.engine import CHAT_TEMPLATE, generate, generate_text
    from llm_compressor_tpu_torch.examples import tinychat
    from llm_compressor_tpu_torch.qformats import QTensor

    cli_hand_over(monkeypatch)
    monkeypatch.chdir(tmp_path)
    args = tinychat.build_chat_parser().parse_args(
        FLAGS + ["--arch", "llama", "--head", "int8-g[32]-rw", "--head-act", "int8-g[-1]-rw",
                 "--pack", "--dtype", "float32", "--max-new-tokens", "6"]
        + (["--kv-quant"] if kv_quant else []))
    cfg, params, qcfg = tinychat.prepare(args)
    for slot in ("q", "k", "v", "o"):
        assert isinstance(params["layers"][0]["attn"][slot]["weight"], QTensor)
    assert isinstance(params["layers"][1]["mlp"]["down"]["weight"], QTensor)
    assert isinstance(params["lm_head"]["weight"], QTensor)
    assert params["embed"]["weight"].device == torch.device("cpu")

    tok, prompt = ByteTokenizer(), "hi"
    text = generate_text(params, cfg, tok, prompt, max_new_tokens=args.max_new_tokens,
                         qcfg=qcfg, quantized_kv=args.kv_quant)
    ids = tok.encode(CHAT_TEMPLATE.format(message=prompt))
    out = generate(params, cfg, np.asarray([ids], np.int32), max_new_tokens=args.max_new_tokens,
                   qcfg=qcfg, quantized_kv=args.kv_quant)
    assert [ord(c) - tok.BASE for c in text] == out[0, len(ids):].tolist()
    assert len(text) == args.max_new_tokens


def test_tinychat_main_needs_model(tmp_path, monkeypatch):
    """Without ``--model`` tinychat prepares the model, then stops: there
    is no tokenizer to chat with (JAX ``examples/tinychat.py:56-58``)."""
    from llm_compressor_tpu_torch.examples import tinychat

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        tinychat.main(["--tiny", "--cpu"])
    assert e.value.code == 1
