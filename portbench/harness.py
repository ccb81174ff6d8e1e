"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by name:

* ``configs/<config>.json``: the published ``config.json`` keys, the
  quantization recipe, ``source``, ``reduced``, ``assumed``;
* ``traffic/<mix>.json``: ``driver`` (a file ``drivers/<driver>.py``) and
  its parameters;
* ``metrics/<metric>.py``: ``read(record)`` -> a number, or None where the
  traced run holds nothing for it;
* ``limits/<cell>.json``: each compared number's limit;
* ``families/<model_type>.py``: the configuration's shapes and
  mechanisms, and the hooks (``family.py``) through which a family
  brings its own weights, params tree, reference, byte and operation
  counters, cache set-up and tiny size.

A driver's ``run(ctx)`` does the cell's own set-up on the model that the
harness built, calls ``ctx.setup_done()``, measures its window between
``ctx.window_start()`` and ``ctx.window_end()``, and returns an
:class:`Outcome`. The program is ``llm_compressor_tpu_torch``: the harness
takes from it the system under test, its launch counters and its graphs'
capture counts, nothing else.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import family, traceutil
from .reference import model as reference

PB = Path(__file__).resolve().parent
ROOT = PB.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "llm_compressor_tpu")
# the keys of a configuration file that are not the published config.json's
OWN_KEYS = ("source", "recipe", "reduced", "assumed")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A portbench plug-in file (a driver or a metric reader) by path: its
    name may hold dots."""
    name = "portbench_plugin_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return Cell(name, read_json(PB / "configs" / f"{w['config']}.json"),
                read_json(PB / "traffic" / f"{w['traffic']}.json"),
                read_json(PB / "limits" / f"{name}.json"),
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def published(config: dict) -> dict:
    return {k: v for k, v in config.items() if k not in OWN_KEYS}


def build_model(config: dict, seed: int, device):
    """(program cfg, qcfg, served params): the seed's weights, RTN, packed,
    fused and stacked, as the port serves the recipe."""
    from llm_compressor_tpu_torch import algorithms, models, qformats

    cfg = models.from_hf_config(published(config))
    r = config["recipe"]
    qcfg = qformats.build_quant_config(r["weight"], r["act_in"], None, r["head"],
                                       head_act=r["head_act"])
    fam = family.of(config)
    spec = fam.spec(config)
    W = fam.draw(spec, seed, device)
    params = fam.params(spec, W)
    del W
    algorithms.rtn(params, cfg, qcfg)
    algorithms.pack_model(params, cfg, qcfg)
    params = models.stack_model(models.fuse_model(params, cfg, qcfg))
    return cfg, qcfg, params


@dataclass
class Outcome:
    """What a driver hands back: its end-to-end numbers, the requests
    attempted and failed, the served sequences to check (on the host), the
    traced window's record (None untraced) and notes for standard error."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    samples: List[reference.Sample]
    record: Optional[dict] = None
    info: dict = field(default_factory=dict)


class Ctx:
    """What a driver gets: the cell, the seed, the window's length, whether
    to trace, the device, the family's hooks (``family``: a driver makes
    and fills caches through its ``init_cache`` and ``splice``) and the
    built model, and the harness's clock."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device, t_start):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.traffic = cell.traffic
        self.family = family.of(cell.config)
        self.spec = self.family.spec(cell.config)
        # a recipe the reference does not model is refused before any work
        self.bits = self.family.bits_of(cell.config["recipe"])
        self.t_start = t_start
        self.setup_s = None
        self.memory_peak = None
        self.cfg, self.qcfg, self.params = build_model(cell.config, seed, self.device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generator(self, stream: int) -> torch.Generator:
        """A generator on the cell's device for one use of the seed
        (``stream`` tells the uses apart)."""
        return torch.Generator(device=self.device).manual_seed(self.seed * 16 + stream)

    def setup_done(self):
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    def window_start(self):
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def window_end(self):
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)

    def span(self, name: str):
        """A ``record_function`` range in traced runs (the breakdown's
        labels), nothing otherwise."""
        if not self.trace:
            return contextlib.nullcontext()
        return torch.profiler.record_function("portbench." + name)

    def profiled(self):
        """Profile the block (``traceutil.profiled``); ``traceutil.finish``
        reads the trace once the window has closed."""
        return traceutil.profiled(self.sync)


def free_program(ctx: Ctx) -> None:
    ctx.params = ctx.cfg = ctx.qcfg = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def check(cell: Cell, seed: int, device, samples: List[reference.Sample],
          control: bool = False) -> Dict[str, float]:
    """The widest gap by which a served token's reference logit lies below
    the reference's best over the samples; with ``control`` also the gap of
    the tokens that the reference in the lower precision puts first. The
    weights, the reference and the precisions are the family's."""
    fam = family.of(cell.config)
    spec = fam.spec(cell.config)
    W = fam.draw(spec, seed, device)
    bits = fam.bits_of(cell.config["recipe"])
    ref = fam.logits(spec, W, samples, bits)
    # no served sequence to check reads as a failed check
    out = {"gap_max": max((reference.widest_gap(r, s.targets) for r, s in zip(ref, samples)),
                          default=float("inf")),
           "served_tokens": sum(int(s.targets.numel()) for s in samples)}
    if control:
        low = fam.logits(spec, W, samples, fam.control_of(bits))
        out["control_gap_max"] = max((reference.widest_gap(r, torch.argmax(lo, -1))
                                      for r, lo in zip(ref, low)), default=float("inf"))
    return out


def per_layer(cell: Cell, record: Optional[dict]) -> Dict[str, dict]:
    out = {}
    if record is None:
        return out
    record = dict(record, config=cell.config, traffic=cell.traffic)
    for m in cell.per_layer:
        value = load_module(PB / "metrics" / f"{m['name']}.py").read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, control: bool = False,
             adjust: Optional[Callable[[Cell], None]] = None, log=print) -> dict:
    """One run of cell ``name``: the result line's dict (``checks`` last).
    ``adjust`` may change the resolved cell before the run (the CPU tests
    shrink it); ``control`` adds the control's reading to ``checks``."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = resolve(bench, name)
    if adjust is not None:
        adjust(cell)
    ctx = Ctx(cell, seed, seconds, trace, device, t_start)
    out: Outcome = load_module(PB / "drivers" / f"{cell.traffic['driver']}.py").run(ctx)
    free_program(ctx)
    found = check(cell, seed, ctx.device, out.samples, control)
    limit = cell.limits["gap_max"]
    checks = {"gap_max": {"value": found["gap_max"], "limit": limit}}
    if control:
        checks["control_gap_max"] = {"value": found["control_gap_max"], "limit": limit}
    correct = found["gap_max"] <= limit
    if trace:
        metrics = per_layer(cell, out.record)
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": ctx.setup_s, "unit": "s"}
    dev = ctx.device
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": ctx.memory_peak or 0}
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if trace and out.record is not None:
        device_info["busy_s"] = out.record["busy_s"]
        device_info["window_s"] = out.record["window_s"]
        result["breakdown"] = traceutil.breakdown(out.record)
    info = dict(out.info, setup_s=ctx.setup_s, served_tokens_checked=found["served_tokens"])
    log(json.dumps({"info": info}), file=sys.stderr)
    for k, v in checks.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    result["checks"] = checks
    return result
