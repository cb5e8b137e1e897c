"""Chat CLI (port of vsim_tpu/api/chat.py; the reference's
cformers/chat.py), on the CUDA card unless ``--device`` names another:

    python -m vsim_tpu_torch.api.chat -m pythia -p "Hello" -t 100
    python -m vsim_tpu_torch.api.chat --model-path model.bin --device cpu

Prompts are templated as chat.py:15 does:
``<|prompter|>{prompt}<|endoftext|><|assistant|>``.
"""

from __future__ import annotations

import argparse
import sys

# model shortcuts (reference chat.py:9-13)
MODEL_MAP = {
    "pythia": "OpenAssistant/oasst-sft-1-pythia-12b",
    "bloom": "bigscience/bloom-7b1",
    "gptj": "EleutherAI/gpt-j-6B",
}

TEMPLATE = "<|prompter|>{prompt}<|endoftext|><|assistant|>"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="vsim_tpu_torch chat")
    ap.add_argument("-m", "--model", default="pythia",
                    help=f"model shortcut {sorted(MODEL_MAP)} or full name")
    ap.add_argument("-p", "--prompt", default=None,
                    help="single prompt (otherwise interactive loop)")
    ap.add_argument("-t", "--tokens", type=int, default=100)
    ap.add_argument("--model-path", default=None,
                    help="local checkpoint dir or ggml .bin")
    ap.add_argument("--seed", type=int, default=-1)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--temperature", type=float, default=0.9)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    from vsim_tpu_torch.api.interface import AutoInference

    name = MODEL_MAP.get(args.model, args.model)
    ai = AutoInference(name, model_path=args.model_path, device=args.device)

    def ask(prompt: str) -> None:
        ai.generate(
            TEMPLATE.format(prompt=prompt),
            num_tokens_to_generate=args.tokens,
            top_k=args.top_k, top_p=args.top_p,
            temperature=args.temperature, seed=args.seed,
            print_streaming_output=True,
        )

    if args.prompt is not None:
        ask(args.prompt)
        return 0
    while True:
        try:
            prompt = input("you> ")
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if prompt.strip() in ("exit", "quit"):
            return 0
        ask(prompt)


if __name__ == "__main__":
    sys.exit(main())
