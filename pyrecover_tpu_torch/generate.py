"""Sample from a vanilla pyrecover checkpoint through the KV-cached decoder
(the port's counterpart of the JAX package's ``tools/generate.py``).

    python -m pyrecover_tpu_torch.generate CKPT --model llama-1b \\
        --prompt-ids 1,2,3 --max-new-tokens 32 [--temperature T --seed S] \\
        [--device cpu] [--tokenizer NAME --prompt "text"]

Only the checkpoint's ``.params`` leaves are read (``serving/restore.py``).
The prefill is one call over the prompt and each new token one
fill-bounded step. ``;`` separates a batch of equal-length prompts decoded
in lockstep, one output line each. An MoE checkpoint decodes through the
``moe-*`` presets, or a custom shape with ``--moe-experts`` and
``--moe-top-k``, with no token dropped (``models/decode.py``). Runs on the
CUDA card unless ``--device cpu`` is given. A vanilla file, a sharded
directory or a zerostall manifest serves alike (``load_serving_params``).
Exit codes: 0 ok, 2 error.
"""

import argparse
import dataclasses
import sys


def generate(model, rows, max_new_tokens, temperature, seed):
    """``rows``: one or more validated EQUAL-length prompt rows. A prompt
    too long for ``max_seq_len`` with ``max_new_tokens`` keeps its tail and
    ``max_new_tokens`` is capped at ``max_seq_len - 1``, each with a
    warning (the library call raises instead). Returns one output row per
    prompt, the dropped head included."""
    import torch

    from pyrecover_tpu_torch.models.decode import generate_tokens, model_device

    L = model.config.max_seq_len
    max_new_tokens = int(max_new_tokens)
    if max_new_tokens >= L:
        print(f"warning: --max-new-tokens capped to {L - 1} (max-seq-len {L})", file=sys.stderr)
        max_new_tokens = L - 1
    dropped = [[] for _ in rows]
    if len(rows[0]) + max_new_tokens > L:
        keep = L - max_new_tokens
        dropped = [r[:-keep] for r in rows]
        print(f"warning: prompt truncated to its last {keep} tokens to fit max-seq-len {L} "
              f"with {max_new_tokens} new tokens", file=sys.stderr)
        rows = [r[-keep:] for r in rows]
    generator = torch.Generator(device=model_device(model)).manual_seed(seed)
    out = generate_tokens(model, rows if len(rows) > 1 else rows[0], max_new_tokens,
                          temperature=temperature, generator=generator)
    if len(rows) == 1:
        out = [out]
    return [d + o for d, o in zip(dropped, out)]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", help="vanilla .ckpt file")
    ap.add_argument("--model", default="llama-150m", help="preset name (models/presets.py)")
    ap.add_argument("--vocab-size", type=int, default=0,
                    help="override the preset's vocab (must match the checkpoint)")
    ap.add_argument("--model-dim", type=int, default=0,
                    help="with --model-layers/--model-heads/--model-kv-heads: a custom shape "
                         "instead of a preset")
    ap.add_argument("--model-layers", type=int, default=0)
    ap.add_argument("--model-heads", type=int, default=0)
    ap.add_argument("--model-kv-heads", type=int, default=0)
    ap.add_argument("--max-seq-len", type=int, default=0)
    ap.add_argument("--multiple-of", type=int, default=0)
    ap.add_argument("--moe-experts", type=int, default=0,
                    help="with --model-dim: MoE experts per FFN (0 = dense); the moe-* presets "
                         "set their own")
    ap.add_argument("--moe-top-k", type=int, default=2)
    ap.add_argument("--prompt-ids", default="1",
                    help="comma-separated token ids; ';' separates a BATCH of equal-length "
                         "prompts decoded in lockstep (one output line per prompt)")
    ap.add_argument("--prompt", default="", help="text prompt (requires --tokenizer)")
    ap.add_argument("--tokenizer", default="",
                    help="HF tokenizer name/path for --prompt and decoding")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the CUDA card (default) or the CPU")
    return ap


def model_config(args):
    """The model shape from a preset or the custom-shape flags; None (with
    a message) when the flags do not combine."""
    from pyrecover_tpu_torch.models import presets
    from pyrecover_tpu_torch.models.llama import ModelConfig

    if args.model_dim:
        cfg = ModelConfig(
            dim=args.model_dim, n_layers=args.model_layers, n_heads=args.model_heads,
            n_kv_heads=args.model_kv_heads, vocab_size=args.vocab_size or 32768,
            max_seq_len=args.max_seq_len or 2048, multiple_of=args.multiple_of or 1024,
            n_experts=args.moe_experts, moe_top_k=args.moe_top_k,
        )
    else:
        if any((args.model_layers, args.model_heads, args.model_kv_heads, args.multiple_of,
                args.moe_experts)):
            print("--model-layers/-heads/-kv-heads/--multiple-of/--moe-experts require "
                  "--model-dim (custom shape)", file=sys.stderr)
            return None
        if args.model not in presets.PRESETS:
            print(f"unknown --model {args.model!r}; presets: {sorted(presets.PRESETS)}",
                  file=sys.stderr)
            return None
        cfg = presets.PRESETS[args.model]()
        if args.max_seq_len:  # must match the sequence length the model was trained with
            cfg = dataclasses.replace(cfg, max_seq_len=args.max_seq_len)
    if args.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=args.vocab_size)
    return cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        cfg = model_config(args)
        if cfg is None:
            return 2
        tokenizer = None
        if args.tokenizer:
            from transformers import AutoTokenizer  # only text prompts need it

            tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
        if args.prompt:
            if tokenizer is None:
                print("--prompt requires --tokenizer", file=sys.stderr)
                return 2
            rows = [tokenizer(args.prompt)["input_ids"]]
        else:
            groups = [g for g in args.prompt_ids.split(";") if g]
            rows = [[int(x) for x in g.split(",") if x] for g in groups]
        # validate before the tail truncation could equalise a ragged batch
        # the library would have rejected
        if not rows or any(not r for r in rows):
            print("error: every prompt needs at least one token id", file=sys.stderr)
            return 2
        if any(len(r) != len(rows[0]) for r in rows):
            print(f"error: batched prompts must be EQUAL length (got {[len(r) for r in rows]})",
                  file=sys.stderr)
            return 2

        from pyrecover_tpu_torch.serving.restore import load_serving_params

        model, _ = load_serving_params(args.checkpoint, cfg, device=args.device)
        for row in generate(model, rows, args.max_new_tokens, args.temperature, args.seed):
            print(tokenizer.decode(row) if tokenizer is not None else ",".join(map(str, row)))
        return 0
    except Exception as e:  # a CLI: fail with a message, not a traceback wall
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
