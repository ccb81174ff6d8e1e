"""A test-only family: Qwen3's, with every hook of ``portbench/family.py``
given as a wrapper of its default that records its calls, and a fault
that a test can plant in one hook at a time. ``test_portbench_family.py``
points the family lookup (``portbench.spec.FAMILIES``) at this directory.
"""

import dataclasses
from pathlib import Path

import torch

from portbench import family, harness, roofline, weights
from portbench.reference import model as reference
from portbench.spec import Spec

QWEN3 = harness.load_module(Path(__file__).resolve().parents[2] / "families" / "qwen3.py")
CALLS = []          # the hooks called, in order
FAULT = None        # "reference" or "draw": the hook the test breaks
OWN = ("hooked_stage",)   # a recipe key of this family's own

# Qwen3's tiny size (tests/tiny.py::CONFIG), here for a run that reads it from the family
TINY = {"vocab_size": 512, "hidden_size": 256, "intermediate_size": 512,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 64, "tie_word_embeddings": False}


@dataclasses.dataclass(frozen=True)
class HookedSpec(Spec):
    hooked: bool = True     # a field that no shared code reads


def spec(cfg):
    CALLS.append("spec")
    return HookedSpec(**dataclasses.asdict(QWEN3.spec(cfg)))


def draw(spec, seed, device):
    CALLS.append("draw")
    if FAULT == "draw":     # weights that do not repeat from the seed
        seed += CALLS.count("draw")
    return weights.draw(spec, seed, device)


def params(spec, W):
    CALLS.append("params")
    return family.to_params(spec, W)


def logits(spec, W, samples, bits):
    CALLS.append("logits")
    out = reference.logits(spec, W, samples, bits)
    if FAULT == "reference":    # each logit moved to the next token's place
        out = [torch.roll(lg, 1, dims=-1) for lg in out]
    return out


def bits_of(recipe):
    CALLS.append("bits_of")
    return reference.bits_of(recipe, own=OWN)


def control_of(bits):
    CALLS.append("control_of")
    return reference.control_of(bits)


class Counters(roofline.Counters):
    ATTENTION_BYTES = 1     # what the family's attention bytes are multiplied by

    def linears(self, m):
        CALLS.append("Counters.linears")
        return super().linears(m)

    def linear_launches(self):
        CALLS.append("Counters.linear_launches")
        return super().linear_launches()

    def attention(self, rows, slot_steps):
        CALLS.append("Counters.attention")
        nbytes, ops = super().attention(rows, slot_steps)
        return self.ATTENTION_BYTES * nbytes, ops

    def weights_bytes(self):
        CALLS.append("Counters.weights_bytes")
        return super().weights_bytes()


def init_cache(ctx, batch, max_len):
    CALLS.append("init_cache")
    return family.init_cache(ctx, batch, max_len)


def splice(cache, group, j, slot):
    CALLS.append("splice")
    family.splice(cache, group, j, slot)
