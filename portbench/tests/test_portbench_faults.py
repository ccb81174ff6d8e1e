"""A run with the timed path broken underneath comes out not correct: each
fault a decode cell can have (a token altered where it is produced, a
step that leaves its state unchanged, half of the batch left out), planted
in the program, on the CPU at tiny sizes. (One chip: no exchange between
chips to leave out.)"""

import pytest
import torch

import tiny
from portbench import harness
from llm_compressor_tpu_torch import engine


def run(cell):
    return harness.run_cell(tiny.bench(), cell, 2**31 + 7, 1.0, False, device="cpu",
                            adjust=tiny.shrink, log=lambda *a, **k: None)


def decode_fault(kind):
    real = engine.decode_greedy_steps

    def broken(params, token, cache, **kw):
        lengths = cache.lengths.clone()
        toks, cache = real(params, token, cache, **kw)
        if kind == "token":
            toks = toks.clone()
            toks[:, -1] = (toks[:, -1] + 1) % kw["cfg"].vocab_size
        elif kind == "state":
            cache.lengths.copy_(lengths)
        else:   # half of the batch left out: every other slot repeats its neighbour's tokens
            toks = toks.clone()
            toks[1::2] = toks[0::2]
        return toks, cache

    return broken


DECODE_CELLS = [w["name"] for w in tiny.bench()["workloads"]
                if harness.resolve(tiny.bench(), w["name"]).traffic["driver"] == "offline_decode"]


@pytest.mark.parametrize("kind", ["token", "state", "half"])
@pytest.mark.parametrize("cell", DECODE_CELLS)
def test_decode_fault_is_not_correct(monkeypatch, cell, kind):
    monkeypatch.setattr(engine, "decode_greedy_steps", decode_fault(kind))
    assert run(cell)["correct"] is False
