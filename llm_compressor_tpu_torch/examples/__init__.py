"""examples — the per-architecture pipelines and tinychat (port of the
JAX package's ``examples/``), each runnable as
``python -m llm_compressor_tpu_torch.examples.<name>``."""
