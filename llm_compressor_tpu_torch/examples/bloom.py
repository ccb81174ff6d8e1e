"""Compression pipeline for bloom-family checkpoints (port of
``examples/bloom.py``; reference examples/bloom.py):

  python -m llm_compressor_tpu_torch.examples.bloom --model <ckpt> --quantize \
      --quant-method gptq --weight int4-g[128]-rw --act-in int8-g[-1]-rw --tasks ppl

On the card unless ``--cpu`` is given.
"""

from ..cli.main import main as _main


def main(argv=None):
    return _main(argv, arch="bloom")


if __name__ == "__main__":
    main()
