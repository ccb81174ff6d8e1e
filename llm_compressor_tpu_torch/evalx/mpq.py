"""Mixed-precision selection from profiling output (port of
``evalx/mpq.py``): parse stats.csv, pick ops by SQNR, and build the
override config over the port's own MPQ registry (``qformats.config``).
The reference leaves the selection manual: the user reads stats.csv and
passes op-name lists to the registry (reference models/llama.py:301-311,
parser.py:110-222).
"""

from __future__ import annotations

import csv
import logging
from typing import Dict, List, Optional

from ..qformats.config import (
    QuantConfig,
    register_4_to_8bit,
    register_8_to_4bit,
    register_org_config,
)

LOGGER = logging.getLogger(__name__)


def read_stats(csv_path) -> List[Dict[str, float]]:
    """stats.csv rows as dicts (column names from the header)."""
    rows = []
    with open(csv_path) as f:
        reader = csv.reader(f)
        header = [h.strip() for h in next(reader)]
        for raw in reader:
            row = {"Op Name": raw[0].strip()}
            for k, v in zip(header[1:], raw[1:]):
                try:
                    row[k] = float(v)
                except ValueError:
                    row[k] = v.strip()
            rows.append(row)
    return rows


def select_ops(rows, suffix: str, sqnr_below: Optional[float] = None,
               sqnr_above: Optional[float] = None) -> List[str]:
    """Op names (with ``suffix``) whose SQNR lies in the given range."""
    out = []
    for r in rows:
        name = r["Op Name"]
        if not name.endswith(suffix):
            continue
        s = r.get("SQNR")
        if sqnr_below is not None and s >= sqnr_below:
            continue
        if sqnr_above is not None and s <= sqnr_above:
            continue
        out.append(name)
    return out


def sqnr_driven_mpq(qcfg: QuantConfig, csv_path,
                    weight_sqnr_floor: float = 20.0,
                    act_sqnr_ceiling: Optional[float] = None,
                    disable_act_sqnr_floor: Optional[float] = None) -> QuantConfig:
    """MPQ overrides from a profile:

    * weights with SQNR < ``weight_sqnr_floor`` dB go to 8 bits;
    * activations with SQNR > ``act_sqnr_ceiling`` dB go to 4 bits;
    * activations with SQNR < ``disable_act_sqnr_floor`` dB keep their
      original precision."""
    rows = read_stats(csv_path)
    promoted = select_ops(rows, ".weight", sqnr_below=weight_sqnr_floor)
    if promoted:
        LOGGER.info(f"MPQ: promoting {len(promoted)} weights to 8-bit")
        qcfg = register_4_to_8bit(qcfg, promoted)
    if act_sqnr_ceiling is not None:
        robust = (select_ops(rows, ".input", sqnr_above=act_sqnr_ceiling)
                  + select_ops(rows, ".output", sqnr_above=act_sqnr_ceiling))
        if robust:
            LOGGER.info(f"MPQ: demoting {len(robust)} activations to 4-bit")
            qcfg = register_8_to_4bit(qcfg, robust)
    if disable_act_sqnr_floor is not None:
        fragile = (select_ops(rows, ".input", sqnr_below=disable_act_sqnr_floor)
                   + select_ops(rows, ".output", sqnr_below=disable_act_sqnr_floor))
        if fragile:
            LOGGER.info(f"MPQ: disabling quantization for {len(fragile)} activations")
            qcfg = register_org_config(qcfg, fragile)
    return qcfg
