"""``dcp-generate`` for the port — sample tokens from a GPT-2 or a Llama
(the subset of ``distributed_compute_pytorch_tpu/cli_generate.py`` the port
takes).

Weights come from a JAX v1 checkpoint (``--ckpt_path``, the file
``dcp-train`` and the port's trainer write) or are drawn at random from
``--init_seed`` (a ``torch.Generator``). Prompts and outputs are token-id
sequences; several prompts separated by ``;`` form one LEFT-padded batch
(each prompt decodes exactly as it would alone):

    python -m distributed_compute_pytorch_tpu_torch.cli_generate \\
        --ckpt_path ck.npz --model_preset tiny --prompt "12,7,90; 5" \\
        --max_new_tokens 16 --temperature 0.8

Prints one JSON line per prompt, as the JAX CLI does: ``{"prompt": [...],
"tokens": [...], "new": [...]}`` (``new`` trimmed after the first
``--eos_id``). Runs on CUDA unless ``--device cpu`` (or ``--force-cpu``).
Not ported yet, each refused with a one-line error naming the flag:
``--mesh`` (sharded generation), ``--quantize`` (int8 weights, which both
of its values imply: ``int8-kv`` is int8 weights AND an int8 KV cache;
the int8 KV cache alone is ``infer.generate(kv_quant=True)``),
``--text_prompt`` / ``--tokenizer`` (text prompts) and ``--model moe``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# flag -> the ROADMAP.md item it waits for
_REFUSED = {"mesh": "sharded generation, queue 1.7.3",
            "quantize": "int8 weights, queue 1.7.1, which both int8 and "
                        "int8-kv imply; the int8 KV cache alone is "
                        "infer.generate(kv_quant=True)",
            "text_prompt": "text prompts, queue 1.7.5",
            "tokenizer": "text prompts, queue 1.7.5"}


def load_model(model_name: str, preset, vocab_size, max_seq_len, *,
               ckpt_path=None, init_seed=None, device=None, dtype="f32"):
    """Shared ``cli_generate``/``cli_serve`` model loader: build the model
    from its knobs on ``device`` (CUDA unless ``"cpu"``), load a JAX v1
    checkpoint's params (``ckpt_path``; a configuration that does not
    match the save raises ``ValueError``) or draw random weights from
    ``init_seed``, and cast to ``dtype`` (``"f32"``/``"bf16"``). One
    implementation, so the two CLIs cannot drift."""
    from distributed_compute_pytorch_tpu_torch.interop import (
        load_jax_checkpoint, load_lm_params)
    from distributed_compute_pytorch_tpu_torch.models.registry import (
        build_model)
    model = build_model(model_name, preset=preset, vocab_size=vocab_size,
                        max_seq_len=max_seq_len, device=device)
    if ckpt_path is not None:
        load_lm_params(model, load_jax_checkpoint(ckpt_path))
    else:
        model.init(torch.Generator().manual_seed(init_seed))
    return model.to(DTYPES[dtype])


def _parse_prompts(s: str) -> list[list[int]]:
    out = []
    for part in s.split(";"):
        try:
            ids = [int(t) for t in part.replace(",", " ").split()]
        except ValueError:
            raise SystemExit(f"--prompt must be token ids, got {part!r}")
        if not ids:
            raise SystemExit("--prompt has an empty prompt "
                             "(check for stray ';')")
        out.append(ids)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt_path", help="JAX v1 checkpoint file")
    src.add_argument("--init_seed", type=int,
                     help="random weights from this torch.Generator seed")
    p.add_argument("--model", default="gpt2", choices=("gpt2", "llama", "moe"))
    p.add_argument("--model_preset", default=None, choices=("tiny", "small"))
    p.add_argument("--vocab_size", type=int, default=None)
    p.add_argument("--max_seq_len", type=int, default=None)
    p.add_argument("--prompt", required=True,
                   help="comma/space-separated token ids; several prompts "
                        "separated by ';' decode as one left-padded batch")
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy")
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--eos_id", type=int, default=None,
                   help="stop a row at this token id (output is trimmed "
                        "at the first occurrence)")
    p.add_argument("--seed", type=int, default=0,
                   help="sampling generator seed")
    p.add_argument("--dtype", default="f32", choices=tuple(DTYPES),
                   help="parameter, activation and KV-cache dtype")
    p.add_argument("--device", default=None,
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--force-cpu", action="store_true", dest="force_cpu",
                   help="same as --device cpu")
    for flag in _REFUSED:
        p.add_argument(f"--{flag}", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag, item in _REFUSED.items():
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag} is not ported yet (ROADMAP.md: "
                             f"{item})")
    if args.model == "moe":
        raise SystemExit("--model moe is not ported yet (ROADMAP.md: MoE "
                         "generation, queue 1.7.4)")

    from distributed_compute_pytorch_tpu_torch.infer import generate

    model = load_model(args.model, args.model_preset, args.vocab_size,
                       args.max_seq_len, ckpt_path=args.ckpt_path,
                       init_seed=args.init_seed,
                       device="cpu" if args.force_cpu else args.device,
                       dtype=args.dtype)
    prompts = _parse_prompts(args.prompt)
    vocab = model.config.vocab_size
    bad = [t for ids in prompts for t in ids if not 0 <= t < vocab]
    if bad:
        raise SystemExit(f"prompt ids {bad} outside vocab [0, {vocab})")
    if args.eos_id is not None and not 0 <= args.eos_id < vocab:
        raise SystemExit(f"--eos_id {args.eos_id} outside vocab [0, {vocab})")
    if args.temperature == 0.0 and (args.top_k is not None
                                    or args.top_p is not None):
        raise SystemExit("--top_k/--top_p need --temperature > 0 "
                         "(sampling); temperature 0 is greedy")

    T0 = max(len(ids) for ids in prompts)
    batch = np.zeros((len(prompts), T0), np.int64)
    mask = np.zeros((len(prompts), T0), np.int64)
    for i, ids in enumerate(prompts):
        batch[i, T0 - len(ids):] = ids
        mask[i, T0 - len(ids):] = 1
    out = generate(model, batch, args.max_new_tokens,
                   temperature=args.temperature, eos_id=args.eos_id,
                   top_k=args.top_k, top_p=args.top_p,
                   generator=torch.Generator(device=model.device).manual_seed(
                       args.seed),
                   prompt_mask=mask if len(prompts) > 1 else None)
    out = out.cpu().numpy()
    for i, ids in enumerate(prompts):
        toks = [int(t) for t in out[i, T0 - len(ids):]]
        new = toks[len(ids):]
        if args.eos_id is not None and args.eos_id in new:
            new = new[:new.index(args.eos_id) + 1]
        print(json.dumps({"prompt": ids, "tokens": toks[:len(ids)] + new,
                          "new": new}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
