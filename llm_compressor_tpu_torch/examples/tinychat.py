"""tinychat: chat with a compressed model (port of ``examples/tinychat.py``;
reference examples/tinychat.py). Prune and quantize per the CLI's flags,
then chat over a real KV cache (int8 with ``--kv-quant``):

  python -m llm_compressor_tpu_torch.examples.tinychat --model <ckpt> --quantize \
      --quant-method rtn --weight int4-g[128]-rw --act-in int8-g[-1]-rw --pack --kv-quant

On the card unless ``--cpu`` is given.
"""

import sys


def build_chat_parser():
    from ..cli.args import build_parser

    parser = build_parser()
    parser.add_argument("--max-new-tokens", type=int, default=100)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top-k", type=int, default=None)
    parser.add_argument("--speculative", action="store_true",
                        help="prompt-lookup speculative decoding "
                             "(greedy-exact; used when temperature is 0)")
    parser.add_argument("--k-draft", type=int, default=4,
                        help="draft tokens per speculative verify step")
    return parser


def prepare(args):
    """Compress per the CLI's flags and return (cfg, params, qcfg) of the
    model to chat with: the params the pipeline compressed, not a fresh
    reload (reference examples/tinychat.py:48-56 chats with the model it
    just quantized)."""
    from ..cli.main import _load_model, run_pipeline
    from ..qformats import build_quant_config

    args.tasks = ""  # no evaluation in chat mode
    if args.quantize or args.prune:
        _, state = run_pipeline(args, return_state=True)
        return state["cfg"], state["params"], state["qcfg"]
    cfg, params, _ = _load_model(args)
    qcfg = build_quant_config(args.weight, args.act_in, args.act_out, args.head,
                              head_act=getattr(args, "head_act", None))
    return cfg, params, qcfg


def main(argv=None):
    from ..engine import generate_text
    from ..utils.logging import LOGGER

    args = build_chat_parser().parse_args(argv)
    cfg, params, qcfg = prepare(args)

    if args.model is None:
        LOGGER.error("tinychat needs --model <checkpoint with tokenizer>")
        sys.exit(1)
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(args.model)
    print("tinychat ready — empty line to exit")
    while True:
        try:
            prompt = input("you> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not prompt:
            break
        reply = generate_text(params, cfg, tokenizer, prompt,
                              max_new_tokens=args.max_new_tokens,
                              temperature=args.temperature, top_k=args.top_k,
                              qcfg=qcfg, quantized_kv=args.kv_quant,
                              speculative=args.speculative,
                              k_draft=args.k_draft)
        print(f"bot> {reply}")


if __name__ == "__main__":
    main()
