"""``dcp-serve`` for the port — continuous-batching inference over a
request file (the subset of ``distributed_compute_pytorch_tpu/cli_serve.py``
the port has).

Weights come from a JAX v1 checkpoint (``--ckpt_path``, the file
``dcp-train`` writes) or are drawn at random from ``--init_seed`` (a
``torch.Generator``; for running on the card without a checkpoint).
Requests come from ``--requests FILE`` (``-`` = stdin), one per line:

    12,7,90                                # token ids; --max_new_tokens
    {"tokens": [12,7,90], "max_new": 16}   # per-request budget

JSON requests may also carry their own sampling settings
(``"temperature"``, ``"top_k"``, ``"top_p"``, ``"seed"``) over the CLI's
defaults (``--temperature``, ``--top_k``, ``--top_p``; ``--seed S`` gives
request i the seed S + i, and without it request i samples with seed i),
so greedy and sampled requests decode side by side in one segment, a
wall-clock ``"deadline"`` in seconds (default ``--request_deadline``) and a
stable ``"id"`` (default ``req-{line:05d}``) that names the session in the
journal and on its output line.
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

Serving degrades per request (``ContinuousBatcher.serve_detailed``): a
request fails, times out, is shed under overload (``--max_pending``) or is
cut by a drain, and the rest keep their tokens. SIGTERM or SIGINT drains:
admission stops, rows in flight finish within ``--drain_deadline``, every
completed output is printed and the process exits 75 (``EXIT_PREEMPTED``).
A device fault or a harvest hung past ``--tick_timeout`` triggers session
reconstruction (at most ``--max_recoveries`` a run);
``--fault_at_segment``/``--fault_mode``/``--poison_request`` inject faults
to drill it. An error that escapes the engine (a device unusable in this
process: a sticky CUDA error while reconstructing) prints its traceback and
exits 70, nothing moved to the CPU.

Crash durability (``serve_journal.py``): ``--journal_dir D`` keeps a
CRC-framed write-ahead log of every admission, harvested token batch and
terminal status (``--journal_fsync`` prices durability: every_frame,
every_harvest or os). A process restarted on the same directory and
request file dedups the requests the journal shows completed and resumes
incomplete sessions from prompt + emitted-so-far. A journal written with
another ``--kv_dtype`` is refused; one written under another
``weights_version`` (the port serves at 0) warns and replays from tokens.
``--supervise N`` runs serving as a child process, respawned (with
``elastic.backoff_delays`` backoff, at most N times) when it dies
abnormally — a signal, or an exit code other than 0, 1 and 75.

Prints one JSON line per request, in input order, as the JAX CLI does:
``{"id", "prompt", "new", "status", "cached_prefix"}`` (+ ``"error"`` for
an outcome other than ``ok``), where ``cached_prefix`` is the prompt length
the request attached from the prefix cache (0 without it). Exits 0 when
every request is ``ok``, 1 otherwise, 75 after a drain.

``--model gpt2`` (the default) or ``llama``, at ``--model_preset``'s
size (``moe`` exits naming its ROADMAP item, as do the JAX CLI's flags of
later items: ``--mesh``, ``--replicas``, ``--weights_version``,
``--heartbeat`` and the rest). Runs on CUDA unless ``--device cpu``.
``--kv_dtype int8`` keeps the KV pool in int8 with per-row f32 scales (as
the JAX CLI's flag). Example:

    python -m distributed_compute_pytorch_tpu_torch.cli_serve --init_seed 0 \\
        --model_preset small --requests prompts.txt --slots 16 --dtype bf16 \\
        --journal_dir wal/ --supervise 2 --tick_timeout 5
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

from distributed_compute_pytorch_tpu_torch.cli_generate import (
    DTYPES, load_model)
from distributed_compute_pytorch_tpu_torch.serve_journal import (
    ServeJournal, recover)

# a JSON request's own settings over the CLI's defaults
PER_REQUEST = ("temperature", "top_k", "top_p", "seed", "deadline")
# an error escaped the serve engine: the device is unusable in this process
# (``--supervise`` restarts it from the journal)
EXIT_DEVICE_LOST = 70
# the weights version the port serves at (``--weights_version`` and weight
# reloads wait for queue 1 item 6)
WEIGHTS_VERSION = 0

# the JAX CLI's flags of later items -> the ROADMAP.md item each waits for
_LATER = {"sharded serving, queue 3.9": ("mesh",),
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
    ``tokens`` and optional ``max_new``, ``id``, sampling settings
    (``temperature``, ``top_k``, ``top_p``, ``seed``) and ``deadline`` over
    the CLI's ``defaults``."""
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
            for k in PER_REQUEST:
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


def _strip_supervise(argv: list[str]) -> list[str]:
    """The child's command line: the supervisor's, minus ``--supervise``
    (a supervised child must not start another supervisor)."""
    out = []
    it = iter(argv)
    for a in it:
        if a == "--supervise":
            next(it, None)
            continue
        if a.startswith("--supervise="):
            continue
        out.append(a)
    return out


def _supervise(budget: int, argv) -> int:
    """The restart loop (reference ``cli_serve.py:147-195``): run the serve
    CLI as a child process and respawn it on an abnormal death (a signal,
    or an exit code outside 0, 1 and 75) with exponential backoff, at most
    ``budget`` times. Clean exits pass through: 0 (all ok), 1 (some
    requests not ok, which a restart would only repeat) and 75 (drained)."""
    from distributed_compute_pytorch_tpu_torch.train.elastic import (
        EXIT_PREEMPTED, backoff_delays)
    child = _strip_supervise(list(sys.argv[1:] if argv is None else argv))
    cmd = [sys.executable, "-m",
           "distributed_compute_pytorch_tpu_torch.cli_serve", *child]
    delays = backoff_delays(max(1, budget), 1.0)
    restarts = 0
    while True:
        rc = subprocess.call(cmd)
        if rc in (0, 1, EXIT_PREEMPTED):
            return rc
        if restarts >= budget:
            print(f"dcp-serve supervisor: restart budget ({budget}) "
                  f"exhausted; giving up (last rc {rc})",
                  file=sys.stderr, flush=True)
            return rc if rc > 0 else 1
        delay = delays[min(restarts, len(delays) - 1)]
        restarts += 1
        print(f"dcp-serve supervisor: serve process died (rc {rc}); "
              f"restart {restarts}/{budget} in {delay:.2f}s",
              file=sys.stderr, flush=True)
        time.sleep(delay)


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
    # the journal and the request lifecycle (module docstring)
    p.add_argument("--journal_dir", type=str, default=None,
                   help="crash-durable serving: append-only CRC-framed "
                        "write-ahead session journal in this directory. "
                        "Admissions are logged before any device work, "
                        "harvested tokens per segment, terminal status at "
                        "completion; restarting with the same dir and "
                        "request file dedups completed requests and resumes "
                        "incomplete sessions from prompt + emitted tokens")
    p.add_argument("--journal_fsync", default="every_harvest",
                   choices=("every_frame", "every_harvest", "os"),
                   help="journal durability price: fsync per frame "
                        "(power-loss safe, slowest), per harvest boundary "
                        "(default), or never — flush to the OS page cache "
                        "only, which still survives any process death "
                        "(SIGKILL/OOM), just not power loss")
    p.add_argument("--supervise", type=int, default=0,
                   help="run the serve loop as a supervised subprocess: "
                        "respawn it (exponential backoff via "
                        "elastic.backoff_delays) when it dies abnormally, at "
                        "most N restarts; clean exits (0, 1, 75/preempted) "
                        "pass through. Requires --journal_dir so restarts "
                        "recover sessions instead of redoing them. 0 "
                        "(default) = off")
    p.add_argument("--max_pending", type=int, default=None,
                   help="bounded admission: accept at most slots + N "
                        "requests, shed the rest at submission with zero "
                        "device work (default: unbounded)")
    p.add_argument("--request_deadline", type=float, default=None,
                   help="default per-request wall-clock deadline in seconds "
                        "(JSON requests may override with 'deadline'); "
                        "expired requests return their partial stream with "
                        "status 'timeout'")
    p.add_argument("--drain_deadline", type=float, default=30.0,
                   help="graceful-drain budget after SIGTERM/SIGINT: "
                        "in-flight rows get this many seconds to finish "
                        "before returning partial streams")
    p.add_argument("--tick_timeout", type=float, default=None,
                   help="tick watchdog: seconds a segment's token harvest "
                        "may wait before the device is declared hung and "
                        "the session reconstructed (default: no watchdog)")
    p.add_argument("--max_recoveries", type=int, default=2,
                   help="session reconstructions to attempt per run before "
                        "failing the remaining requests")
    p.add_argument("--fault_at_segment", type=int, default=None,
                   help="fault injection (testing): trip --fault_mode at "
                        "the Nth dispatched segment")
    p.add_argument("--fault_mode", default="raise",
                   choices=("raise", "hang", "slow", "poison"),
                   help="injected fault flavour (serve_lifecycle."
                        "ChaosInjector); 'poison' needs --poison_request")
    p.add_argument("--poison_request", type=int, default=None,
                   help="request index that deterministically poisons its "
                        "row (with --fault_mode poison)")
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
    if args.supervise < 0:
        raise SystemExit("--supervise must be >= 0")
    if args.supervise and args.journal_dir is None:
        raise SystemExit("--supervise without --journal_dir would redo "
                         "completed work on every restart; give the "
                         "supervisor a journal to recover from")
    if args.supervise:
        # the serving (model load, kernels, device state) happens in a
        # child this process respawns on an abnormal death
        return _supervise(args.supervise, argv)

    from distributed_compute_pytorch_tpu_torch.train.elastic import (
        EXIT_PREEMPTED, PreemptionGuard)

    # recover before the model loads: a journal of another pool dtype is
    # refused in one line (its streams are promises this pool cannot keep)
    recovery = None
    if args.journal_dir:
        recovery = recover(args.journal_dir)
        jc = recovery.config or {}
        if recovery.frames and jc.get("kv_dtype", "bf16") != args.kv_dtype:
            raise SystemExit(
                f"--journal_dir was written with kv_dtype="
                f"{jc.get('kv_dtype', 'bf16')}, refusing to recover with "
                f"--kv_dtype {args.kv_dtype}")
        # another weights version is safe to recover across: completed ids
        # dedup and incomplete sessions replay from their tokens
        jwv = recovery.weights_version
        if recovery.frames and jwv is not None and jwv != WEIGHTS_VERSION:
            print(f"warning: journal was written at weights_version={jwv}, "
                  f"recovering under {WEIGHTS_VERSION}: incomplete sessions "
                  f"replay from tokens (no cross-version KV reuse)",
                  file=sys.stderr, flush=True)
    # SIGTERM/SIGINT drain, armed before the model loads so a preemption
    # at any point of start-up drains (a second signal kills)
    guard = PreemptionGuard()
    guard.__enter__()
    try:
        rc = _serve(args, guard, recovery)
    finally:
        guard.__exit__()
    # a drain's sheds and cuts are its outcome, not a failure
    return EXIT_PREEMPTED if guard.preempted and rc in (0, 1) else rc


def _serve(args, guard, recovery) -> int:
    """Load the model, serve the request file through ``serve_detailed``
    and print a line per request; returns 0 when every request is ``ok``,
    1 otherwise, ``EXIT_DEVICE_LOST`` when the engine raised."""
    from distributed_compute_pytorch_tpu_torch.serve import (
        ContinuousBatcher, Request)
    from distributed_compute_pytorch_tpu_torch.serve_lifecycle import (
        ChaosInjector)

    model = load_model(args.model, args.model_preset, None,
                       args.max_seq_len, ckpt_path=args.ckpt_path,
                       init_seed=args.init_seed, device=args.device,
                       dtype=args.dtype)

    reqs = _read_requests(args.requests, args.max_new_tokens,
                          {"temperature": args.temperature,
                           "top_k": args.top_k, "top_p": args.top_p,
                           "seed": None, "deadline": args.request_deadline})
    # stable ids: the JSON "id", else the line position, the same across
    # restarts, so a rerun of the same file dedups against the journal
    seen = set()
    for i, r in enumerate(reqs):
        rid = r["id"] if r["id"] is not None else f"req-{i:05d}"
        if rid in seen:
            raise SystemExit(f"duplicate request id {rid!r}: journal "
                             f"recovery dedups by id, so ids must be unique "
                             f"per run")
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
    journal = None
    if args.journal_dir:
        if recovery.sessions:
            print(json.dumps({
                "kind": "serve_recovery", "ts": time.time(),
                "sessions": len(recovery.sessions),
                "completed": len(recovery.completed),
                "incomplete": len(recovery.incomplete),
                "torn_bytes": recovery.torn_bytes}),
                file=sys.stderr, flush=True)
        journal = ServeJournal(args.journal_dir, fsync=args.journal_fsync)
        # this process's config, so the next restart can refuse a
        # mismatched --kv_dtype before touching any session
        journal.config({"kv_dtype": args.kv_dtype,
                        "weights_version": WEIGHTS_VERSION})
    try:
        try:
            cb = ContinuousBatcher(
                model, slots=args.slots, t_max=t_max, prompt_buf=prompt_buf,
                segment=S, eos_id=args.eos_id,
                admit_policy=args.admit_policy,
                prefix_cache=args.prefix_cache,
                prefill_chunk_tokens=args.prefill_chunk_tokens,
                kv_dtype=args.kv_dtype, speculate=args.speculate or None,
                decode_width_buckets=args.decode_width_buckets,
                host_cache_mb=args.host_cache_mb,
                disk_cache_dir=args.disk_cache_dir,
                max_pending=args.max_pending,
                tick_timeout_s=args.tick_timeout,
                max_recoveries=args.max_recoveries, journal=journal,
                device=model.device)
            chaos = None
            if (args.fault_at_segment is not None
                    or args.poison_request is not None):
                chaos = ChaosInjector(fault_at_segment=args.fault_at_segment,
                                      fault_mode=args.fault_mode,
                                      poison_request=args.poison_request)
        except ValueError as e:
            raise SystemExit(str(e))
        if args.prewarm_widths:
            cb.prewarm_widths(sampling=args.temperature > 0)

        def seed(i, r):
            if r["seed"] is not None:
                return r["seed"]
            return None if args.seed is None else args.seed + i

        requests = [Request(list(r["tokens"]), r["max_new"],
                            temperature=r["temperature"], top_k=r["top_k"],
                            top_p=r["top_p"], seed=seed(i, r),
                            deadline_s=r["deadline"], request_id=r["id"])
                    for i, r in enumerate(reqs)]
        try:
            results = cb.serve_detailed(
                requests, drain=guard, drain_deadline_s=args.drain_deadline,
                chaos=chaos, recovery=recovery)
        except Exception:  # noqa: BLE001 — the device is unusable in this
            # process; the journal holds every session still open
            traceback.print_exc()
            print(f"dcp-serve: the serve engine failed; exiting "
                  f"{EXIT_DEVICE_LOST}", file=sys.stderr, flush=True)
            return EXIT_DEVICE_LOST
    finally:
        if journal is not None:
            journal.close()
    for r, res in zip(reqs, results):
        rec = {"id": r["id"], "prompt": r["tokens"], "new": res.tokens,
               "status": res.status,
               "cached_prefix": res.cached_prefix_tokens}
        if res.error is not None:
            rec["error"] = res.error
        print(json.dumps(rec))
    return 0 if all(r.ok for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
