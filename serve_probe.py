#!/usr/bin/env python3
"""Where a captured serve batcher loses time on the host, on one CUDA card:
its first run against its second (``chip_smoke.py``'s serve phase reads its
first graph run slower than the second), and the decode rows' stalls under
chunked prefill (``chip_smoke.py``'s serve_chunked phase).

    python3 serve_probe.py [--cell serve|chunked] [--out FILE]

The serve phase's cell (GPT-2-small, bf16, random weights from seed 0; its
32 requests on 16 slots, segment 16; ``chip_smoke.batcher``): two
batchers, each warmed up as the serve phase warms up (two requests: the
first segment eager, the second captured), then run on the 32 requests
three times in a row. The first batcher's runs are timed alone, on the
host clock to a synchronize, with the host time of the scheduler's three
parts taken apart (admission: ``_prefill_wave``; dispatch: ``_segment``;
the harvest's wait: ``serve._Fetch.result``) and the allocators' calls
(``chip_smoke.alloc_stats``). The second batcher's first and second runs
go under ``torch.profiler`` (``chip_smoke.profile_run``): each run's host
CUDA calls by name, the device's busy time, and its idle time between
kernels, in all and in the largest gaps, with the host calls made while
the device sat in each of them.

``--cell chunked``: the serve_chunked cell instead (``chip_smoke.
chunked_requests``: 8 rows decoding behind 16 long prompts, chunks of 128
tokens), its chunked captured batcher timed in the same three parts over
two runs, each segment's end on the device (``chip_smoke.segment_clock``),
and one run under the profiler with its idle gaps and the host calls made
in them.

Prints the card's name and power limit (``nvidia-smi``) on one line and
the result as one JSON object on the last; ``--out`` writes it to a file
too.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import chip_smoke as C


def _timed_parts(serve, cb):
    """Wrap ``cb``'s admission and dispatch and the harvest's wait with
    host clocks; returns the accumulators (seconds, calls) and an undo."""
    acc = {"admission": [0.0, 0], "dispatch": [0.0, 0],
           "harvest_wait": [0.0, 0]}

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key][0] += time.perf_counter() - t0
                acc[key][1] += 1
        return run
    cb._prefill_wave = timed("admission", cb._prefill_wave)
    cb._segment = timed("dispatch", cb._segment)
    result = serve._Fetch.result
    serve._Fetch.result = timed("harvest_wait", result)

    def undo():
        del cb._prefill_wave, cb._segment
        serve._Fetch.result = result
    return acc, undo


def _idle(torch, prof, start_us, top=8):
    """The device's kernels in a profile: busy us, idle us between
    consecutive kernels, and the largest gaps with the host's CUDA calls
    that began inside each."""
    from distributed_compute_pytorch_tpu_torch.utils.graphs import (
        REPLAY_SPAN)
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()
    # the device timeline's mirror of a replay's span is not a kernel
    kern = sorted(((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == cuda and e.name != REPLAY_SPAN),
                  key=lambda x: x[0])
    busy = sum(b - a for a, b in kern)
    gaps = []
    end = kern[0][1]
    for a, b in kern[1:]:
        if a > end:
            gaps.append((a - end, end, a))
        end = max(end, b)
    host = sorted((e.time_range.start, e.name) for e in events
                  if e.device_type == cpu and C.HOST_CALL.match(e.name))
    largest = []
    for gap, lo, hi in sorted(gaps, reverse=True)[:top]:
        calls: dict = {}
        for t, name in host:
            if lo <= t <= hi:
                calls[name] = calls.get(name, 0) + 1
        largest.append({"gap_us": gap, "at_us": lo - start_us,
                        "host_calls": calls})
    return {"kernels": len(kern), "busy_ms": busy / 1e3,
            "span_ms": (kern[-1][1] - kern[0][0]) / 1e3,
            "idle_ms": sum(g for g, _, _ in gaps) / 1e3,
            "gaps_over_100us": sum(1 for g, _, _ in gaps if g > 100),
            "idle_in_gaps_over_100us_ms": sum(
                g for g, _, _ in gaps if g > 100) / 1e3,
            "largest_gaps": largest}


def _make(serve, model, cell):
    """The cell's requests and a new captured batcher for them."""
    if cell == "chunked":
        reqs = C.chunked_requests(np, serve, model.config.vocab_size)
        return reqs, lambda: C.remainder_batcher(
            serve, model, prefill_chunk_tokens=C.CHUNK_TOKENS,
            t_max=C.CHUNK_BUF + C.CHUNK_DECODE_NEW, prompt_buf=C.CHUNK_BUF)
    reqs = C.serve_requests(np, serve, model.config.vocab_size)
    return reqs, lambda: C.batcher(serve, model)


def probe(torch, serve, model, cell) -> dict:
    reqs, make = _make(serve, model, cell)
    new = sum(r.max_new for r in reqs)
    rec = {"cell": cell, "requests": len(reqs), "new_tokens": new,
           "timed": [], "profiled": []}
    cb = make()
    cb.serve(reqs[:2])
    acc, undo = _timed_parts(serve, cb)
    timed_segment = cb._segment
    for run in range(3):
        marks = C.segment_clock(torch, cb)
        for v in acc.values():
            v[:] = [0.0, 0]
        torch.cuda.synchronize()
        a0 = C.alloc_stats(torch)
        t0 = time.monotonic()
        cb.serve(reqs)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        cb._segment = timed_segment
        gaps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        rec["timed"].append({
            "run": run + 1, "wall_s": wall, "tokens_per_s": new / wall,
            "host_s": {k: v[0] for k, v in acc.items()},
            "calls": {k: v[1] for k, v in acc.items()},
            "allocator_calls": C.alloc_delta(torch, a0),
            "segments": len(marks),
            "segment_gaps_ms": sorted(gaps, reverse=True)[:8],
            "segment_gap_median_ms": sorted(gaps)[len(gaps) // 2]})
    undo()
    cb = make()
    cb.serve(reqs[:2])
    for run in range(2):
        prof, wall = C.profile_run(torch, lambda: cb.serve(reqs))
        host = C.host_calls(torch, prof)
        start = min(e.time_range.start for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CPU)
        rec["profiled"].append({
            "run": run + 1, "wall_s_profiled": wall,
            "host_calls": host["calls"],
            "kernel_launch_calls": host["kernel_launches"],
            "graph_launch_calls": host["graph_launches"],
            "device": _idle(torch, prof, start)})
    first, second = rec["timed"][0], rec["timed"][1]
    rec["first_over_second_wall"] = first["wall_s"] / second["wall_s"]
    rec["first_minus_second_host_s"] = {
        k: first["host_s"][k] - second["host_s"][k] for k in first["host_s"]}
    calls = [p["host_calls"] for p in rec["profiled"]]
    rec["host_calls_first_minus_second"] = {
        k: calls[0].get(k, 0) - calls[1].get(k, 0)
        for k in sorted(set(calls[0]) | set(calls[1]))
        if calls[0].get(k, 0) != calls[1].get(k, 0)}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="serve", choices=("serve", "chunked"))
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_probe: no CUDA card", file=sys.stderr)
        return 1
    from distributed_compute_pytorch_tpu_torch import serve
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
        GPT2, GPT2Config)
    from distributed_compute_pytorch_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    base = GPT2(GPT2Config.small()).init(torch.Generator().manual_seed(0))
    model = GPT2(GPT2Config.small(), dtype=torch.bfloat16)
    model.load_state_dict(base.state_dict())
    del base
    rec = {"probe": "serve_host", "model": C.GPT2_NAME,
           **probe(torch, serve, model, args.cell), "card": C.nvidia_smi()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(rec["card"])
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
