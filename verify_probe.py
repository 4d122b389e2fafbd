#!/usr/bin/env python3
"""Whether a speculating batcher's captured verify program serves what its
eager run serves, run by run and step by step, on one CUDA card; and which
frees inside a CUDA graph capture invalidate the capture.

    python3 verify_probe.py [--part steps|capture|kernel|all] [--root DIR]
                            [--out FILE]

``steps``: GPT-2-small (random weights from seed 0), bf16 and f32, on the
serve cell's 32 requests (``chip_smoke.serve_requests``) and on their
repeated-span form (``chip_smoke.repeated_requests``), speculation held
on (``SpecConfig(k=4, autodisable_window=10**9)``, ``chip_smoke.
spec_batcher``: 16 slots, segment 16). Per cell, the tokens of: a captured
batcher warmed on two requests and reset, run twice; a fresh captured one
(its programs captured mid-run); an eager one, fresh and after a reset; a
plain one (``speculate=None``); and a captured one whose every verify
replay is held, on the same inputs, to a second replay and to two eager
runs of the same program (live rows only). At the first step where a
replay and an eager run differ, each layer's hidden state and the logits
of a diagnostic capture of the step against its eager run.

``capture``: each case in a process of its own, a capture during which
something is freed: a pinned buffer behind a non-blocking copy and its
event (before and after the event is waited for), another CUDA graph (its
own pool, or a shared pool handle), a plain device tensor, and a dead
batcher (cyclic garbage, with its graphs) collected by ``gc.collect()``
inside a fresh batcher's first capture; whether the capture survives.
Also how many ``serve._Fetch`` objects a finished ``serve`` leaves as
cyclic garbage, and how many unreachable objects a collection then finds.

``kernel`` (not part of ``all``): the verify kernel's six entries of
``chip_smoke.py`` (``check_verify``: ``paged_verify_write``, ``_q8`` and
``_llama`` in bf16 and f32, each gated against its plain version and
timed beside its bound, fixed cost, plain version, fused ticks and SDPA)
for the port of the checkout ``--root`` names (default: this one), such
as a parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. One process a tree, so that one card call can time
two trees in turns (parent, change, change, parent). That checkout builds
its kernels into its own ``build/``; the checks and the timing are this
file's ``chip_smoke.py``'s either way.

Prints the card's name and power limit (``nvidia-smi``) on one line and
the result as one JSON object on the last; ``--out`` writes it to a file
too.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

from pathlib import Path

import numpy as np

import chip_smoke as C


def differ(a, b) -> dict:
    """Whether two runs' tokens are equal; the first differing (request,
    position) and the count of differing positions."""
    n, first = 0, None
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (u, v) in enumerate(zip(x, y)):
            if u != v:
                n += 1
                first = (i, j) if first is None else first
        n += abs(len(x) - len(y))
    return {"equal": a == b, "first": first, "positions_differing": n}


def layer_diffs(torch, cb, model, key, live) -> dict:
    """The verify step ``key`` on the batcher's current inputs, eager and
    as a diagnostic capture: each layer's hidden state and the logits,
    their largest difference on the ``live`` rows."""
    from distributed_compute_pytorch_tpu_torch.ops import (
        decode_attention as DA)
    from distributed_compute_pytorch_tpu_torch.utils.graphs import capture
    _, _, width = key
    x0 = model.embed(cb._vtok, cb._vnlog[:, None] + cb._wrange)
    hidden = torch.empty((len(model.blocks),) + tuple(x0.shape),
                         dtype=x0.dtype, device="cuda")
    logits = torch.empty(tuple(x0.shape[:2]) + (model.config.vocab_size,),
                         dtype=x0.dtype, device="cuda")

    def step():
        table = cb._tables_w[width]
        pos = cb._pos0[:, None] + 1 + cb._wrange[None, :]
        x = model.embed(cb._vtok, cb._vnlog[:, None] + cb._wrange)
        with DA.merge_scratch(cb._vscratch):
            for i, (block, cache) in enumerate(zip(model.blocks,
                                                   cb._caches)):
                x, _ = block.verify_step(x, {**cache, "table": table}, pos)
                hidden[i].copy_(x)
        logits.copy_(model.readout(x))

    step()
    eager = hidden.clone(), logits.clone()
    torch.cuda.synchronize()
    capture(step, pool=cb._mempool).replay()
    m = live[:, None, None]
    return {"hidden_max_abs_diff": [
                float(((hidden[i] - eager[0][i]).float().abs() * m).max())
                for i in range(len(model.blocks))],
            "logits_max_abs_diff": float(((logits - eager[1]).float().abs()
                                          * m).max())}


def held_steps(torch, cb, model, reqs):
    """``cb.serve(reqs)`` with every verify replay held to a second replay
    and to two eager runs on the same inputs (rows whose last written slot
    is past 0: the live ones). Returns the tokens and the counts of steps
    where they differ, with the first differing step's detail."""
    st = {"steps": 0, "replay_vs_replay": 0, "eager_vs_eager": 0,
          "replay_vs_eager": 0, "first": None}
    dispatch = cb._dispatch

    def held(key, fn):
        dispatch(key, fn)
        if key[0] != "verify" or key not in cb._programs:
            return
        st["steps"] += 1
        live = torch.tensor(np.array(cb._row_pos) > 0, device="cuda")
        runs = []
        for again in (cb._programs[key].replay, fn, fn):
            runs.append(cb._vtrue.clone())
            again()
        runs.append(cb._vtrue.clone())
        r1, r2, e1, e2 = runs

        def rows(a, b):
            return (a != b).any(1) & live
        st["replay_vs_replay"] += bool(rows(r1, r2).any())
        st["eager_vs_eager"] += bool(rows(e1, e2).any())
        bad = rows(r1, e1)
        if bad.any():
            st["replay_vs_eager"] += 1
            if st["first"] is None:
                idx = [int(i) for i in torch.nonzero(bad).flatten()]
                st["first"] = {"step": st["steps"], "rows": idx,
                               "graph": r1[idx].tolist(),
                               "eager": e1[idx].tolist(),
                               **layer_diffs(torch, cb, model, key, live)}
        # the run goes on from the replay's result
        cb._programs[key].replay()
        cb._vtrue.copy_(r1)

    cb._dispatch = held
    try:
        outs = cb.serve(reqs)
    finally:
        cb._dispatch = dispatch
    return outs, st


def steps_part(torch) -> list:
    from distributed_compute_pytorch_tpu_torch import serve
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
        GPT2, GPT2Config)
    from distributed_compute_pytorch_tpu_torch.spec_decode import SpecConfig
    held = SpecConfig(k=C.SPEC_K, autodisable_window=10 ** 9)
    base = GPT2(GPT2Config.small()).init(torch.Generator().manual_seed(0))
    cells = []
    for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        model = GPT2(GPT2Config.small(), dtype=dtype)
        model.load_state_dict(base.state_dict())
        vocab = model.config.vocab_size
        for prompts, make in (("random", C.serve_requests),
                              ("repeated", C.repeated_requests)):
            reqs = make(np, serve, vocab)
            runs = {}

            def warmed():
                cb = C.spec_batcher(serve, model, spec=held)
                cb.serve(reqs[:2])
                cb.reset()
                return cb
            cb = warmed()
            runs["captured"] = cb.serve(reqs)
            cb.reset()
            runs["captured_again"] = cb.serve(reqs)
            runs["captured_fresh"] = C.spec_batcher(
                serve, model, spec=held).serve(reqs)
            cb = C.spec_batcher(serve, model, spec=held, mode="eager")
            runs["eager"] = cb.serve(reqs)
            cb.reset()
            runs["eager_again"] = cb.serve(reqs)
            runs["plain"] = C.spec_batcher(serve, model,
                                           spec=None).serve(reqs)
            runs["captured_held"], st = held_steps(torch, warmed(), model,
                                                   reqs)
            del cb
            gc.collect()
            torch.cuda.empty_cache()
            cell = {"dtype": dt, "prompts": prompts, "verify_steps": st}
            for a, b in (("captured", "captured_again"),
                         ("captured", "captured_fresh"),
                         ("eager", "eager_again"), ("captured", "eager"),
                         ("captured_fresh", "eager"),
                         ("captured_held", "captured"),
                         ("captured", "plain")):
                cell[f"{a} ~ {b}"] = differ(runs[a], runs[b])
            print(json.dumps(cell), flush=True)
            cells.append(cell)
    return cells


# ---- the capture cases, each in a process of its own ----------------------

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _capture_with(torch, graph, body, pool=None):
    """``body`` captured into ``graph`` on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin(*(() if pool is None else (pool,)))
        try:
            body()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()


def _freed_in_capture(torch, box):
    """A capture during which everything ``box`` holds is freed."""
    x = torch.randn(1 << 20, device="cuda")

    def body():
        y = x * 2
        box.clear()
        y.add_(1)
    _capture_with(torch, torch.cuda.CUDAGraph(), body)


def _fetch(torch, wait: bool) -> dict:
    x = torch.randn(1 << 20, device="cuda")
    box = {"host": torch.empty(x.shape, pin_memory=True),
           "event": torch.cuda.Event()}
    box["host"].copy_(x, non_blocking=True)
    box["event"].record()
    if wait:
        box["event"].synchronize()
    return box


@case
def pinned_fetch_freed(torch):
    """A pinned buffer behind a non-blocking copy, and its event."""
    _freed_in_capture(torch, _fetch(torch, wait=False))


@case
def pinned_fetch_waited_freed(torch):
    """The same once its event has been waited for (a harvested fetch)."""
    _freed_in_capture(torch, _fetch(torch, wait=True))


@case
def graph_freed(torch):
    """Another captured and replayed graph, in a private pool."""
    x = torch.randn(1 << 20, device="cuda")
    box = {"graph": torch.cuda.CUDAGraph()}
    _capture_with(torch, box["graph"], lambda: x * 3)
    torch.cuda.synchronize()
    _freed_in_capture(torch, box)


@case
def shared_pool_graph_freed(torch):
    """Another graph, captured into a shared pool handle."""
    x = torch.randn(1 << 20, device="cuda")
    box = {"graph": torch.cuda.CUDAGraph()}
    _capture_with(torch, box["graph"], lambda: x * 3,
                  pool=torch.cuda.graph_pool_handle())
    torch.cuda.synchronize()
    _freed_in_capture(torch, box)


@case
def device_tensor_freed(torch):
    """A plain device tensor (the control)."""
    _freed_in_capture(torch, {"t": torch.randn(1 << 24, device="cuda")})


def _tiny_batcher(torch, **kw):
    from distributed_compute_pytorch_tpu_torch import serve
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
        GPT2, GPT2Config)
    cfg = GPT2Config(vocab_size=256, max_seq_len=128, num_layers=2,
                     num_heads=4, d_model=64, d_ff=128)
    model = GPT2(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = GPT2(cfg)
    gpu.load_state_dict(model.state_dict())
    rng = np.random.default_rng(9)
    reqs = [serve.Request([int(t) for t in rng.integers(0, 256, 6)], 20)
            for _ in range(5)]
    return gpu, reqs, dict(slots=2, t_max=64, prompt_buf=10, segment=3,
                           kv_block_tokens=8, speculate=3, **kw)


@case
def serve_leaves_cyclic_garbage(torch):
    """A finished ``serve``: the fetches left as cyclic garbage, and the
    unreachable objects a collection then finds."""
    from distributed_compute_pytorch_tpu_torch import serve
    gpu, reqs, kw = _tiny_batcher(torch)
    cb = serve.ContinuousBatcher(gpu, **kw)
    gc.collect()
    gc.disable()
    cb.serve(reqs)
    left = sum(isinstance(o, serve._Fetch) for o in gc.get_objects())
    gc.enable()
    return {"fetches_left": left, "unreachable_collected": gc.collect()}


@case
def dead_batcher_collected_in_capture(torch):
    """A dead batcher (cyclic garbage holding its captured graphs)
    collected by ``gc.collect()`` inside a fresh batcher's first
    capture."""
    from distributed_compute_pytorch_tpu_torch import serve
    gpu, reqs, kw = _tiny_batcher(torch)
    gc.disable()
    cb = serve.ContinuousBatcher(gpu, **kw)
    cb.serve(reqs)
    cb.cycle = cb
    del cb
    readout, hit = gpu.readout, []

    def collecting(x):
        if torch.cuda.is_current_stream_capturing() and not hit:
            hit.append(gc.collect())
        return readout(x)
    gpu.readout = collecting
    serve.ContinuousBatcher(gpu, **kw).serve(reqs)
    return {"collected_in_capture": hit}


def capture_part() -> list:
    out = []
    for name in CASES:
        p = subprocess.run([sys.executable, __file__, "--case", name],
                           capture_output=True, text=True, timeout=600)
        lines = p.stdout.strip().splitlines()
        res = json.loads(lines[-1]) if lines and lines[-1].startswith(
            "{") else None
        errors = [ln for ln in p.stderr.splitlines() if "Error" in ln]
        rec = {"case": name, "what": CASES[name].__doc__.split("\n")[0],
               "capture_survived": p.returncode == 0, "result": res,
               "error": errors[-1] if errors else None}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def kernel_part(torch, root: Path) -> dict:
    """``check_verify``'s six entries for the port under ``root``."""
    sys.path.insert(0, str(root))
    from distributed_compute_pytorch_tpu_torch.ops import _build
    from distributed_compute_pytorch_tpu_torch.ops import attention as A
    from distributed_compute_pytorch_tpu_torch.ops import (
        decode_attention as DA)
    if Path(DA.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {DA.__file__}, not {root}'s port")
    built = _build.build_all()
    ptxas = built["ptxas"].get(DA.VERIFY_NAME, "")
    kernels = {}
    for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        kernels[dt] = {
            "paged_verify_write" + sfx: C.check_verify(
                torch, np, A, DA, dtype, dt, q8, ptxas, hk=hk)
            for q8, hk, sfx in ((False, 12, ""), (True, 12, "_q8"),
                                (False, C.LLAMA_KV_HEADS, "_llama"))}
        torch.cuda.empty_cache()
    return {"root": str(root), "built": built["built"],
            "build_seconds": built["seconds"],
            "launch_floor_ms": C.time_ms(
                torch, [lambda: torch.cuda._sleep(0)], iters=200),
            "kernels": kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", default="all",
                    choices=("steps", "capture", "kernel", "all"))
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent),
                    help="the checkout whose port the kernel part times")
    ap.add_argument("--case", choices=tuple(CASES), help=argparse.SUPPRESS)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("verify_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.case:
        res = CASES[args.case](torch)
        torch.cuda.synchronize()
        print(json.dumps(res or {}))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    smi = C.nvidia_smi()
    result = {"card": smi, "device": torch.cuda.get_device_name(0)}
    if args.part == "kernel":
        result.update(kernel_part(torch, Path(args.root).resolve()))
    else:
        from distributed_compute_pytorch_tpu_torch.ops import _build
        _build.build_all()
    if args.part in ("steps", "all"):
        result["steps"] = steps_part(torch)
    if args.part in ("capture", "all"):
        result["capture"] = capture_part()
    result["seconds"] = time.monotonic() - t0
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
