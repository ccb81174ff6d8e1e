"""utils — host-side helpers (port of ``llm_compressor_tpu.utils``):
logging and seeding, the dataset loaders, the native host packer, and
the port's own safetensors and npz readers and writers."""

from .dataset import get_calib_dataset, get_loaders, synthetic_tokens
from .logging import LOGGER, colorstr, init_seeds

__all__ = ["LOGGER", "colorstr", "init_seeds", "get_calib_dataset", "get_loaders",
           "synthetic_tokens"]
