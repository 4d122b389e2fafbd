"""``dcp-serve`` for the port — continuous-batching inference over a
request file (the subset of ``distributed_compute_pytorch_tpu/cli_serve.py``
the port has).

Weights come from a JAX v1 checkpoint (``--ckpt_path``, the file
``dcp-train`` writes) or are drawn at random from ``--init_seed`` (a
``torch.Generator``; for running on the card without a checkpoint).
Requests come from ``--requests FILE`` (``-`` = stdin), one per line:

    12,7,90                                # token ids; --max_new_tokens
    {"tokens": [12,7,90], "max_new": 16}   # per-request budget (+ "id")

JSON requests may also carry their own sampling settings
(``"temperature"``, ``"top_k"``, ``"top_p"``, ``"seed"``) over the CLI's
defaults (``--temperature``, ``--top_k``, ``--top_p``; ``--seed S`` gives
request i the seed S + i, and without it request i samples with seed i),
so greedy and sampled requests decode side by side in one segment.
``--prefix_cache`` turns on the radix prefix cache: requests sharing a
prompt prefix attach to blocks already prefilled, copy-on-write, and
prefill only their suffix. ``--prefill_chunk_tokens N`` bounds each
prefill wave to about N suffix tokens (long prompts admit chunk by chunk
between decode segments). ``--admit_policy skip_fit`` lets a free row take
the first queued request that fits instead of the queue's head.
``--speculate K`` drafts K tokens a verify step with the n-gram proposer
and scores all K + 1 positions in one forward pass (outputs unchanged).
``--decode_width_buckets N`` keeps the widest N rungs of the table-width
ladder (1, the default, = the full-width table alone);
``--prewarm_widths`` builds every rung's programs before serving.
``--host_cache_mb N`` (with ``--prefix_cache``) keeps evicted prefixes in
an N MB host-memory tier (pinned on the card) instead of discarding them,
and promotes them back with one copy on their next hit;
``--disk_cache_dir D`` (with ``--host_cache_mb``) spills that tier's least
recently used prefixes to CRC-checked parts in D, which a later run on the
same directory adopts (outputs unchanged either way).

Prints one JSON line per request, in input order, as the JAX CLI does:
``{"id", "prompt", "new", "status": "ok", "cached_prefix"}``, where
``cached_prefix`` is the prompt length the request attached from the
prefix cache (0 without it).

``--model gpt2`` (the default) or ``llama``, at ``--model_preset``'s
size (``moe`` exits naming its ROADMAP item, as do the JAX CLI's flags of
later items: ``--journal_dir``, ``--mesh``, ``--replicas``,
``--heartbeat`` and the rest). Runs on CUDA unless
``--device cpu``. ``--kv_dtype int8`` keeps the KV pool in int8 with
per-row f32 scales (as the JAX CLI's flag). Example:

    python -m distributed_compute_pytorch_tpu_torch.cli_serve --init_seed 0 \\
        --model_preset small --requests prompts.txt --slots 16 --dtype bf16 \\
        --prefix_cache --host_cache_mb 512 --temperature 0.8 --top_p 0.95
"""

from __future__ import annotations

import argparse
import json
import sys

from distributed_compute_pytorch_tpu_torch.cli_generate import (
    DTYPES, load_model)

# a JSON request's own sampling settings
SAMPLING = ("temperature", "top_k", "top_p", "seed")

# the JAX CLI's flags of later items -> the ROADMAP.md item each waits for
_LATER = {"the journal and the request lifecycle, queue 3.8": (
              "journal_dir", "journal_fsync", "supervise", "max_pending",
              "request_deadline", "drain_deadline", "tick_timeout",
              "max_recoveries", "fault_at_segment", "fault_mode",
              "poison_request"),
          "sharded serving, queue 3.9": ("mesh",),
          "the serving control plane, queue 1 item 6": (
              "replicas", "prefill_replicas", "fault_replica", "autoscale",
              "elastic_window", "upgrade_to", "weights_version"),
          "telemetry, queue 1 item 4": (
              "heartbeat", "metrics_jsonl", "trace_path", "flight_recorder",
              "profile_dir", "profile_segments"),
          "int8 weights, queue 1.7.1": ("quantize",),
          "text prompts, queue 1.7.5": ("tokenizer",)}
_REFUSED = {flag: item for item, flags in _LATER.items() for flag in flags}


def _read_requests(path: str, default_new: int, defaults: dict
                   ) -> list[dict]:
    """Parse the request file: token-id lines or JSON lines with
    ``tokens`` and optional ``max_new``, ``id`` and sampling settings
    (``temperature``, ``top_k``, ``top_p``, ``seed``) over the CLI's
    ``defaults``."""
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
        sampling = dict(defaults)
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
            for k in SAMPLING:
                if k in obj:
                    sampling[k] = obj[k]
            if sampling["temperature"] == 0.0 and (
                    sampling["top_k"] is not None
                    or sampling["top_p"] is not None):
                raise SystemExit(f"requests line {i + 1}: top_k/top_p "
                                 f"require temperature > 0")
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
        out.append({"tokens": ids, "max_new": new, "id": rid, **sampling})
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
    p.add_argument("--temperature", type=float, default=0.0,
                   help="default sampling temperature (0 = greedy); JSON "
                        "requests may override it per request")
    p.add_argument("--top_k", type=int, default=None,
                   help="default top-k truncation (needs temperature > 0)")
    p.add_argument("--top_p", type=float, default=None,
                   help="default nucleus truncation (needs temperature > 0)")
    p.add_argument("--seed", type=int, default=None,
                   help="base sampling seed: request i uses seed + i "
                        "(default: i), so the whole file is deterministic")
    p.add_argument("--prefix_cache", action="store_true",
                   help="radix prefix cache over the paged KV pool: "
                        "requests sharing a prompt prefix attach to blocks "
                        "already prefilled (copy-on-write) and prefill only "
                        "their suffix; each line reports its "
                        "'cached_prefix' length")
    p.add_argument("--prefill_chunk_tokens", type=int, default=None,
                   help="chunked prefill: at most about this many suffix "
                        "tokens a prefill wave; long prompts admit chunk by "
                        "chunk between decode segments")
    p.add_argument("--admit_policy", default="fifo",
                   choices=("fifo", "skip_fit"),
                   help="admission order: strict FIFO, or skip-fit (a free "
                        "row takes the first queued request that fits)")
    p.add_argument("--speculate", type=int, default=0,
                   help="speculative decoding: draft K tokens a verify step "
                        "with the self-drafting n-gram proposer and score "
                        "all K+1 positions in one forward pass; outputs "
                        "stay token-identical (0 = off)")
    p.add_argument("--decode_width_buckets", type=int, default=1,
                   help="width-bucket ladder depth: decode and verify "
                        "dispatches take the narrowest power-of-two rung of "
                        "table blocks covering the live rows; N keeps the "
                        "widest N rungs (1, the default = the full-width "
                        "table alone). Outputs are token-identical at any "
                        "setting")
    p.add_argument("--prewarm_widths", action="store_true",
                   help="build (and on the card capture) every width rung's "
                        "programs before serving")
    p.add_argument("--host_cache_mb", type=float, default=None,
                   help="hierarchical KV: a host-RAM tier of this many MB "
                        "under the radix prefix cache (pinned on the card). "
                        "Evicted prefixes demote D2H instead of being "
                        "discarded and promote back with one asynchronous "
                        "H2D copy on their next hit. Outputs stay "
                        "token-identical. Requires --prefix_cache")
    p.add_argument("--disk_cache_dir", type=str, default=None,
                   help="optional third tier below --host_cache_mb: the "
                        "host tier's least recently used prefixes spill to "
                        "CRC-checked part-NNNNN.npz entries in this "
                        "directory (a corrupt part is a cache miss, never a "
                        "failure), which a later run on the directory "
                        "adopts")
    p.add_argument("--device", default=None,
                   help="'cuda' (default; raises without a card) or 'cpu'")
    for flag in _REFUSED:
        p.add_argument(f"--{flag}", nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag, item in _REFUSED.items():
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag} is not ported yet (ROADMAP.md: "
                             f"{item})")
    if args.host_cache_mb is not None and not args.prefix_cache:
        raise SystemExit("--host_cache_mb spills the radix prefix cache: "
                         "it requires --prefix_cache")
    if args.host_cache_mb is not None and args.host_cache_mb <= 0:
        raise SystemExit("--host_cache_mb must be > 0")
    if args.disk_cache_dir is not None and args.host_cache_mb is None:
        raise SystemExit("--disk_cache_dir is the tier below host RAM: it "
                         "requires --host_cache_mb")
    if args.model == "moe":
        raise SystemExit("--model moe is not ported yet (ROADMAP.md: MoE "
                         "serving, queue 3.9, with queue 1 item 8)")
    if args.max_new_tokens < 1:
        raise SystemExit("--max_new_tokens must be >= 1")
    if args.temperature == 0.0 and (args.top_k is not None
                                    or args.top_p is not None):
        raise SystemExit("--top_k/--top_p require --temperature > 0")
    if args.prefill_chunk_tokens is not None \
            and args.prefill_chunk_tokens < 1:
        raise SystemExit("--prefill_chunk_tokens must be >= 1")
    if args.decode_width_buckets < 1:
        raise SystemExit("--decode_width_buckets must be >= 1 "
                         "(1 = a single full-horizon bucket)")
    if args.speculate < 0:
        raise SystemExit("--speculate must be >= 0 (0 = off)")

    from distributed_compute_pytorch_tpu_torch.serve import (
        ContinuousBatcher, Request)

    model = load_model(args.model, args.model_preset, None,
                       args.max_seq_len, ckpt_path=args.ckpt_path,
                       init_seed=args.init_seed, device=args.device,
                       dtype=args.dtype)

    reqs = _read_requests(args.requests, args.max_new_tokens,
                          {"temperature": args.temperature,
                           "top_k": args.top_k, "top_p": args.top_p,
                           "seed": None})
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
                           eos_id=args.eos_id,
                           admit_policy=args.admit_policy,
                           prefix_cache=args.prefix_cache,
                           prefill_chunk_tokens=args.prefill_chunk_tokens,
                           kv_dtype=args.kv_dtype,
                           speculate=args.speculate or None,
                           decode_width_buckets=args.decode_width_buckets,
                           host_cache_mb=args.host_cache_mb,
                           disk_cache_dir=args.disk_cache_dir,
                           device=model.device)
    if args.prewarm_widths:
        cb.prewarm_widths(sampling=args.temperature > 0)

    def seed(i, r):
        if r["seed"] is not None:
            return r["seed"]
        return None if args.seed is None else args.seed + i

    try:
        outs = cb.serve([Request(list(r["tokens"]), r["max_new"],
                                 temperature=r["temperature"],
                                 top_k=r["top_k"], top_p=r["top_p"],
                                 seed=seed(i, r))
                         for i, r in enumerate(reqs)])
    except ValueError as e:
        raise SystemExit(f"invalid request: {e}")
    for r, new, m in zip(reqs, outs, cb.last_cached_prefix):
        print(json.dumps({"id": r["id"], "prompt": r["tokens"], "new": new,
                          "status": "ok", "cached_prefix": m}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
