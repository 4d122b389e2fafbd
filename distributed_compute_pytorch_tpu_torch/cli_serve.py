"""``dcp-serve`` for the port — continuous-batching greedy inference over a
request file (the subset of ``distributed_compute_pytorch_tpu/cli_serve.py``
this slice ports).

Weights come from a JAX v1 checkpoint (``--ckpt_path``, the file
``dcp-train`` writes) or are drawn at random from ``--init_seed`` (a
``torch.Generator``; for running on the card without a checkpoint).
Requests come from ``--requests FILE`` (``-`` = stdin), one per line:

    12,7,90                                # token ids; --max_new_tokens
    {"tokens": [12,7,90], "max_new": 16}   # per-request budget (+ "id")

Prints one JSON line per request, in input order, as the JAX CLI does:
``{"id", "prompt", "new", "status": "ok", "cached_prefix": 0}`` (the port
has no prefix cache yet, so ``cached_prefix`` is always 0).

``--model gpt2`` (the default) or ``llama``, at ``--model_preset``'s
size (``moe`` exits naming its ROADMAP item). Runs on CUDA unless ``--device cpu``. ``--kv_dtype int8`` keeps the
KV pool in int8 with per-row f32 scales (as the JAX CLI's flag). Example:

    python -m distributed_compute_pytorch_tpu_torch.cli_serve --init_seed 0 \\
        --model_preset small --requests prompts.txt --slots 16 --dtype bf16 \\
        --kv_dtype int8
"""

from __future__ import annotations

import argparse
import json
import sys

from distributed_compute_pytorch_tpu_torch.cli_generate import (
    DTYPES, load_model)


def _read_requests(path: str, default_new: int) -> list[dict]:
    """Parse the request file: token-id lines or JSON lines with
    ``tokens`` and optional ``max_new`` / ``id``; sampling settings are
    refused (not ported yet)."""
    src = sys.stdin if path == "-" else open(path)
    try:
        lines = src.read().splitlines()
    finally:
        if src is not sys.stdin:
            src.close()
    out = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        rid = None
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise SystemExit(f"requests line {i + 1}: bad JSON ({e})")
            ids = obj.get("tokens")
            if not isinstance(ids, list):
                raise SystemExit(f"requests line {i + 1}: need 'tokens' "
                                 f"(list)")
            new = obj.get("max_new", default_new)
            if not isinstance(new, int) or new < 1:
                raise SystemExit(f"requests line {i + 1}: max_new must "
                                 f"be a positive integer, got {new!r}")
            if obj.get("temperature", 0.0) != 0.0:
                raise SystemExit(f"requests line {i + 1}: sampling is not "
                                 f"ported yet (greedy only)")
            rid = obj.get("id")
            if rid is not None and not isinstance(rid, str):
                raise SystemExit(f"requests line {i + 1}: 'id' must be a "
                                 f"string, got {rid!r}")
        else:
            try:
                ids = [int(t) for t in line.replace(",", " ").split()]
            except ValueError:
                raise SystemExit(f"requests line {i + 1}: token ids "
                                 f"expected, got {line!r}")
            new = default_new
        if not ids:
            raise SystemExit(f"requests line {i + 1}: empty prompt")
        out.append({"tokens": ids, "max_new": new, "id": rid})
    if not out:
        raise SystemExit("no requests")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt_path", help="JAX v1 checkpoint file")
    src.add_argument("--init_seed", type=int,
                     help="random weights from this torch.Generator seed")
    p.add_argument("--model", default="gpt2",
                   choices=("gpt2", "llama", "moe"))
    p.add_argument("--model_preset", default=None, choices=("tiny", "small"))
    p.add_argument("--max_seq_len", type=int, default=None)
    p.add_argument("--requests", required=True,
                   help="request file ('-' = stdin), one request per line")
    p.add_argument("--slots", type=int, default=8,
                   help="cache rows decoding concurrently")
    p.add_argument("--segment", type=int, default=16,
                   help="decode ticks per dispatch")
    p.add_argument("--t_max", type=int, default=None,
                   help="per-row horizon (default: sized from the workload)")
    p.add_argument("--prompt_buf", type=int, default=None,
                   help="admission window (default: longest prompt)")
    p.add_argument("--max_new_tokens", type=int, default=32,
                   help="budget for requests that don't carry max_new")
    p.add_argument("--eos_id", type=int, default=None)
    p.add_argument("--dtype", default="f32", choices=tuple(DTYPES),
                   help="parameter and activation dtype (and the KV pool's "
                        "with --kv_dtype bf16)")
    p.add_argument("--kv_dtype", default="bf16", choices=("bf16", "int8"),
                   help="KV pool storage: 'bf16' keeps it in the model's "
                        "--dtype, 'int8' stores int8 K/V with per-row f32 "
                        "scales (about half the bytes)")
    p.add_argument("--device", default=None,
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    if args.model == "moe":
        raise SystemExit("--model moe is not ported yet (ROADMAP.md: MoE "
                         "serving, queue 3.9, with queue 1 item 8)")
    if args.max_new_tokens < 1:
        raise SystemExit("--max_new_tokens must be >= 1")

    from distributed_compute_pytorch_tpu_torch.serve import (
        ContinuousBatcher, Request)

    model = load_model(args.model, args.model_preset, None,
                       args.max_seq_len, ckpt_path=args.ckpt_path,
                       init_seed=args.init_seed, device=args.device,
                       dtype=args.dtype)

    reqs = _read_requests(args.requests, args.max_new_tokens)
    seen = set()
    for i, r in enumerate(reqs):
        rid = r["id"] if r["id"] is not None else f"req-{i:05d}"
        if rid in seen:
            raise SystemExit(f"duplicate request id {rid!r}")
        seen.add(rid)
        r["id"] = rid
    cfg = model.config
    bad = [t for r in reqs for t in r["tokens"] if not 0 <= t < cfg.vocab_size]
    if bad:
        raise SystemExit(f"prompt ids {bad[:8]} outside vocab "
                         f"[0, {cfg.vocab_size})")
    if args.eos_id is not None and not 0 <= args.eos_id < cfg.vocab_size:
        raise SystemExit(f"--eos_id {args.eos_id} outside vocab "
                         f"[0, {cfg.vocab_size})")
    over = [r for r in reqs if len(r["tokens"]) + r["max_new"]
            > cfg.max_seq_len]
    if over:
        raise SystemExit(f"{len(over)} request(s) exceed the model's "
                         f"max_seq_len={cfg.max_seq_len} (prompt+max_new); "
                         f"shrink them")
    prompt_buf = args.prompt_buf or max(len(r["tokens"]) for r in reqs)
    S = args.segment
    t_max = args.t_max or prompt_buf + max(-(-r["max_new"] // S) * S
                                           for r in reqs)
    cb = ContinuousBatcher(model, slots=args.slots, t_max=t_max,
                           prompt_buf=prompt_buf, segment=S,
                           eos_id=args.eos_id, kv_dtype=args.kv_dtype,
                           device=model.device)
    outs = cb.serve([Request(list(r["tokens"]), r["max_new"]) for r in reqs])
    for r, new in zip(reqs, outs):
        print(json.dumps({"id": r["id"], "prompt": r["tokens"], "new": new,
                          "status": "ok", "cached_prefix": 0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
