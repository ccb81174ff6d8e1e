"""Logging and seeding (port of ``utils/logging.py``; reference
utils/general.py:12-101, on stdlib logging).

``LOGGER`` is the logger named ``"llm_compressor_tpu_torch"``: the port's
modules log under it or under their own ``__name__`` (its children), so
its stderr handler and :func:`add_file_sink` see them all. Unlike the JAX
package's logger it still propagates to the root logger, as the port's
loggers always have (``pytest``'s ``caplog`` reads them there); a root
handler of the caller's then prints a record a second time.
"""

from __future__ import annotations

import logging
import os
import random
import sys

import numpy as np

_COLORS = {
    "black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
    "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
    "cyan": "\033[36m", "white": "\033[37m", "bright_blue": "\033[94m",
    "bright_green": "\033[92m", "bold": "\033[1m", "end": "\033[0m",
}


def colorstr(color: str, s: str) -> str:
    if not sys.stdout.isatty():
        return s
    return f"{_COLORS.get(color, '')}{s}{_COLORS['end']}"


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("llm_compressor_tpu_torch")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(message)s",
                                         datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("LLMC_LOG_LEVEL", "INFO"))
    return logger


LOGGER = _build_logger()


def add_file_sink(path) -> None:
    h = logging.FileHandler(path)
    h.setLevel(logging.DEBUG)
    h.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(message)s"))
    LOGGER.addHandler(h)


def init_seeds(seed: int = 0) -> None:
    """Seed the host RNGs (reference utils/general.py:23-39): ``random``,
    numpy's global RNG and ``PYTHONHASHSEED``. The port's own draws take
    explicit ``torch.Generator`` seeds."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def draw_2d_dist(x, save_path="dist.png", title="2D distribution"):
    """Matshow of a 2-D tensor's magnitude (reference utils/general.py:104-116)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    arr = np.abs(np.asarray(x, dtype=np.float32))
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.matshow(arr, aspect="auto", cmap="viridis")
    fig.colorbar(im)
    ax.set_title(title)
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path
