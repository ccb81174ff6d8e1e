"""Tiny versions of the cells for CPU runs of the harness: the same code,
the same traffic kinds, small widths, depth, batch and window. A family
that ``CONFIG`` does not name brings its tiny size as ``TINY`` in its
family file (``portbench/family.py``)."""

from __future__ import annotations

import json
from pathlib import Path

from portbench import family

ROOT = Path(__file__).resolve().parents[2]
CONFIG = {
    "qwen3": {"vocab_size": 512, "hidden_size": 256, "intermediate_size": 512,
              "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 64, "tie_word_embeddings": False},
    # D = 80 and the published 0.4 rotary share, as the card runs Phi-2
    "phi": {"vocab_size": 512, "hidden_size": 640, "intermediate_size": 1280,
            "num_hidden_layers": 2, "num_attention_heads": 8, "num_key_value_heads": 8},
}
TRAFFIC = {
    "offline_decode": {"batch": 4, "prompt_len": 12, "steps_per_call": 4, "calls_per_job": 2,
                       "prefill_group": 2, "check_slots": 4},
}


# The widest-gap limit at these sizes, between the readings of six seeds a
# cell on the CPU, with more room above the program's than below the
# control's: the program at most 0.027, the control (every 8-bit stage at
# 4 bits) at least 0.162. (The cells' own limits, in portbench/limits/,
# are set from readings at the published sizes on the card.)
LIMIT = {"gap_max": 0.1}


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def shrink(cell) -> None:
    """``run_cell``'s ``adjust``: the cell at its tiny size."""
    tiny = CONFIG.get(cell.config["model_type"])
    cell.config.update(family.of(cell.config).tiny if tiny is None else tiny)
    cell.traffic.update(TRAFFIC[cell.traffic["driver"]])
    cell.limits = dict(LIMIT)
