#!/usr/bin/env python3
"""Two measurements of the port's GPT-2-small train step on one CUDA card
that ``chip_smoke.py`` does not make, each able to read another checkout
of the port so that two trees are compared in one process order on one
card.

    python3 train_probe.py step [--root DIR] [--optimizer adamw]
    python3 train_probe.py fit [--root DIR] [--optimizer adamw_fused]
        [--modes graph,eager] [--warmup_pool]
    python3 train_probe.py cudnn

``step`` runs the train cell of ``chip_smoke.py`` (GPT-2-small, bf16
compute over f32 masters, dropout 0.1, one 8 x 1024 batch of numpy seed
0, warmup-cosine from 0 over 20 updates, peak lr 1e-3) with the chosen
optimizer: ``--runs`` runs of 20 updates of a fresh model for each mode
the tree has ("graph": the captured step that ``make_step_fns`` gives a
CUDA model; "eager": the eager step, the only one of a tree without a
captured step), each update to a synchronize on the host clock; a run's
step time is its median after the first 3 updates. Then the optimizer's
update alone over the 148 leaves with random gradients (CUDA events, ms a
call): ``apply(grads, state, params)`` for ``adamw``, and, where the tree
takes the non-finite guard's flag, the guarded form too.

``fit`` finds the largest batch, a multiple of 8 sequences of 1024
tokens, for which three updates of the step fit on the card, for each
mode: a binary search whose every trial (``trial``) runs in a process of
its own, so that a trial out of memory leaves nothing behind. A trial
reports its peak memory allocated and reserved. The trials inherit the
environment (``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` reaches
them). ``--warmup_pool`` runs the captured step's eager warm-up inside a
``torch.cuda.MemPool`` and captures its graph into that same pool
(``capture_begin(pool=...)``), so the blocks the warm-up freed serve the
capture instead of sitting beside the graph's own pool; it changes this
process only.

``cudnn`` prices the port's cuDNN settings: the train and eval steps run
cuDNN in f32 with its deterministic algorithms
(``train/step.py::cudnn_f32``), which is what makes the captured step
repeat the eager one bit for bit. It times the captured step of
ResNet-50 (bf16 over f32 masters, one batch of 64 224 x 224 x 3 images,
SGD) and of ResNet-18 (f32, one batch of 128 32 x 32 x 3 images, SGD),
each ``--runs`` times in turns with those settings ("port") and with
cuDNN left to PyTorch's defaults plus its autotuner ("default":
``deterministic`` off, ``benchmark`` on, TF32 allowed), by replacing
``cudnn_f32`` in this process only; a run's step time is its median
after the first 3 of 20 updates. The port has no switch for this.

``--root`` imports the port from the checkout at DIR instead of this
one. Kernels are built from that checkout's sources into its own
``build/torch_kernels/``. Prints the card's name and power limit
(``nvidia-smi``) on one line and the result as one JSON object on the
last; ``--out`` writes the result to a file too.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

STEPS, BATCH, T, LR, WARMUP, SKIP = 20, 8, 1024, 1e-3, 2, 3
FIT_UNIT, FIT_MAX = 8, 160
FIT_STEPS = 3


def _port(root: str):
    """The port's train entry points, imported from ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
        GPT2, GPT2Config)
    from distributed_compute_pytorch_tpu_torch.ops import _build
    from distributed_compute_pytorch_tpu_torch.train.optim import (
        build_optimizer)
    from distributed_compute_pytorch_tpu_torch.train.step import (
        make_step_fns)
    return GPT2, GPT2Config, _build, build_optimizer, make_step_fns


def _modes(make_step_fns) -> tuple:
    """The modes a tree's ``make_step_fns`` offers on the card."""
    if "_eager" in inspect.signature(make_step_fns).parameters:
        return ("graph", "eager")
    return ("eager",)


def _setup(torch, port, optimizer, mode, batch, weights):
    """A GPT-2-small on the card from ``weights``, its optimizer and step
    functions in ``mode``, a fresh state and a ``[batch, T]`` batch."""
    import numpy as np
    GPT2, GPT2Config, _, build_optimizer, make_step_fns = port
    cfg = GPT2Config.small()
    model = GPT2(cfg)
    model.load_state_dict(weights)
    tx = build_optimizer(optimizer, LR, steps_per_epoch=STEPS,
                         total_steps=STEPS, warmup_steps=WARMUP)
    kw = {"_eager": mode == "eager"} if len(_modes(make_step_fns)) > 1 \
        else {}
    init_fn, train_step, _ = make_step_fns(model, tx,
                                           compute_dtype="bfloat16", **kw)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, T))
    return model, tx, train_step, init_fn(None), \
        torch.from_numpy(tokens).cuda()


def _weights(torch, port):
    GPT2, GPT2Config = port[0], port[1]
    return GPT2(GPT2Config.small()).init(
        torch.Generator().manual_seed(0)).state_dict()


def _run(torch, setup, steps):
    """``steps`` updates, each to a synchronize: host ms a step, losses."""
    _, _, train_step, state, x = setup
    ms, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, x, x)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(metrics["loss"]))
    return ms, losses


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _apply_ms(torch, port, optimizer, weights) -> dict:
    """The optimizer's update alone over GPT-2-small's leaves, random
    gradients: ms a call (CUDA events, 20 calls after 3), unguarded and,
    where the tree takes ``ok``, guarded."""
    model, tx, _, state, _ = _setup(torch, port, optimizer, "eager", BATCH,
                                    weights)
    params = state.params
    gen = torch.Generator(device="cuda").manual_seed(1)
    for p in params.values():
        g = torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
        if p.grad is None:
            p.grad = g
        else:
            p.grad.copy_(g)
    grads = {n: p.grad for n, p in params.items()}
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    fused = hasattr(tx, "fused_apply")
    apply = tx.fused_apply if fused else tx.apply
    takes_ok = "ok" in inspect.signature(apply).parameters
    if fused:       # the kernel: a flag where the tree's kernel reads one
        forms = {"fused": (ok,) if takes_ok else ()}
    else:
        forms = {"unguarded": (), **({"guarded": (ok,)} if takes_ok
                                     else {})}
    out = {}
    for form, extra in forms.items():
        for _ in range(3):
            apply(grads, state.opt_state, params, *extra)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            apply(grads, state.opt_state, params, *extra)
        end.record()
        torch.cuda.synchronize()
        out[form] = start.elapsed_time(end) / 20
    del model
    return out


def step_probe(args) -> dict:
    import torch
    port = _port(args.root)
    port[2].build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = _weights(torch, port)
    rec = {"probe": "step", "root": os.path.abspath(args.root),
           "optimizer": args.optimizer, "batch": [BATCH, T],
           "steps": STEPS, "median_after": SKIP, "modes": {}}
    for mode in _modes(port[4]):
        runs = []
        for _ in range(args.runs):
            setup = _setup(torch, port, args.optimizer, mode, BATCH, weights)
            torch.cuda.reset_peak_memory_stats()
            ms, losses = _run(torch, setup, STEPS)
            runs.append({"median_step_ms": _median(ms[SKIP:]),
                         "step_ms": ms, "last_loss": losses[-1],
                         "peak_allocated_gb":
                             torch.cuda.max_memory_allocated() / 1e9,
                         "peak_reserved_gb":
                             torch.cuda.max_memory_reserved() / 1e9})
            del setup
            torch.cuda.empty_cache()
        rec["modes"][mode] = runs
    rec["apply_ms"] = _apply_ms(torch, port, args.optimizer, weights)
    return rec


def _pool_warmup(torch, train_step) -> None:
    """The captured step's warm-up allocating from the memory pool its graph
    is then captured into (``--warmup_pool``): the eager update runs inside
    ``torch.cuda.use_mem_pool`` and ``utils/graphs.py``'s recording
    captures with ``capture_begin(pool=...)`` on that pool."""
    import contextlib
    from distributed_compute_pytorch_tpu_torch.utils import graphs
    pool = torch.cuda.MemPool()
    eager = train_step._eager_step

    def warm(*a):
        with torch.cuda.use_mem_pool(pool):
            return eager(*a)

    @contextlib.contextmanager
    def recording(graph, generators=()):
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.stream(torch.cuda.Stream()):
            graph.capture_begin(pool=pool.id)
            try:
                yield
            finally:
                graph.capture_end()
    train_step._eager_step = warm
    graphs._recording = recording


def trial(args) -> dict:
    """Three updates at ``args.batch`` in ``args.mode``: whether they fit,
    and the peak memory."""
    import torch
    port = _port(args.root)
    weights = _weights(torch, port)
    rec = {"mode": args.mode, "batch": args.batch,
           "warmup_pool": args.warmup_pool,
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}
    try:
        setup = _setup(torch, port, args.optimizer, args.mode, args.batch,
                       weights)
        if args.warmup_pool and args.mode == "graph":
            _pool_warmup(torch, setup[2])
        del weights
        torch.cuda.reset_peak_memory_stats()
        _run(torch, setup, FIT_STEPS)
        rec["fits"] = True
    except Exception as e:     # noqa: BLE001 — out of memory, maybe raised
        # inside a capture whose end then raised in its turn
        cause = e
        while cause is not None and not isinstance(
                cause, torch.cuda.OutOfMemoryError):
            cause = cause.__context__
        if cause is None:
            raise
        rec.update(fits=False, error=str(cause).splitlines()[0][:200])
    rec.update(peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    return rec


def _trial(args, mode, batch) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "trial", "--root",
           args.root, "--optimizer", args.optimizer, "--mode", mode,
           "--batch", str(batch)] + (["--warmup_pool"] if args.warmup_pool
                                     else [])
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"trial {mode} {batch} failed (rc "
                           f"{done.returncode}):\n{done.stderr[-3000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def fit_probe(args) -> dict:
    port = _port(args.root)
    port[2].build_all()
    rec = {"probe": "fit", "root": os.path.abspath(args.root),
           "optimizer": args.optimizer, "unit": FIT_UNIT, "seq": T,
           "updates": FIT_STEPS, "warmup_pool": args.warmup_pool,
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
           "modes": {}}
    for mode in args.modes or _modes(port[4]):
        lo, hi, trials = 0, FIT_MAX // FIT_UNIT + 1, []
        while hi - lo > 1:       # lo fits (0: nothing tried), hi does not
            mid = (lo + hi) // 2
            t = _trial(args, mode, mid * FIT_UNIT)
            trials.append(t)
            lo, hi = (mid, hi) if t["fits"] else (lo, mid)
        rec["modes"][mode] = {"largest_batch": lo * FIT_UNIT,
                              "trials": trials}
    return rec


def _cudnn_run(torch, root, name, dtype, batch, size, flags) -> float:
    """One run of 20 captured updates of ``name`` under ``flags``
    ("port" or "default"); its median step ms after the first 3."""
    import contextlib
    import numpy as np
    sys.path.insert(0, os.path.abspath(root))
    from distributed_compute_pytorch_tpu_torch.models.resnet import ResNet
    from distributed_compute_pytorch_tpu_torch.train import step as step_mod
    from distributed_compute_pytorch_tpu_torch.train.optim import (
        build_optimizer)

    @contextlib.contextmanager
    def defaults():
        c = torch.backends.cudnn
        before = (c.allow_tf32, c.deterministic, c.benchmark)
        c.allow_tf32, c.deterministic, c.benchmark = True, False, True
        try:
            yield
        finally:
            c.allow_tf32, c.deterministic, c.benchmark = before
    port_flags = step_mod.cudnn_f32
    if flags == "default":
        step_mod.cudnn_f32 = defaults
    try:
        classes = 1000 if name == "resnet50" else 10
        model = ResNet.build(name, num_classes=classes).init(
            torch.Generator().manual_seed(0))
        init_fn, train_step, _ = step_mod.make_step_fns(
            model, build_optimizer("sgd", 0.1, steps_per_epoch=STEPS),
            compute_dtype=dtype)
        state = init_fn(None)
    finally:
        step_mod.cudnn_f32 = port_flags
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(batch, size, size, 3)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, classes, batch)).cuda()
    times = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = train_step(state, x, y)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return _median(times[SKIP:])


def cudnn_probe(args) -> dict:
    import torch
    out = {}
    for name, dtype, batch, size in (("resnet50", "bfloat16", 64, 224),
                                     ("resnet18", "float32", 128, 32)):
        runs = {"port": [], "default": []}
        for _ in range(args.runs):
            for flags in ("port", "default"):
                runs[flags].append(_cudnn_run(torch, args.root, name,
                                              dtype, batch, size, flags))
                torch.cuda.empty_cache()
        out[name] = {"compute_dtype": dtype, "batch": [batch, size, size, 3],
                     "step_ms": runs,
                     "samples_per_s": {k: [batch / (ms / 1e3) for ms in v]
                                       for k, v in runs.items()}}
    return {"probe": "cudnn", "flags": {
        "port": "train/step.py::cudnn_f32: TF32 off, deterministic on",
        "default": "TF32 allowed, deterministic off, benchmark on"},
        **out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=("step", "fit", "trial", "cudnn"))
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--optimizer", default="adamw_fused",
                    choices=("adamw", "adamw_fused"))
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--mode", choices=("graph", "eager"))
    ap.add_argument("--modes", type=lambda s: tuple(s.split(",")),
                    help="fit: the modes to probe, comma-separated "
                         "(default: every mode the tree has)")
    ap.add_argument("--batch", type=int)
    ap.add_argument("--warmup_pool", action="store_true",
                    help="fit/trial: the captured step's warm-up allocates "
                         "from the pool its graph is captured into")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_probe: no CUDA card", file=sys.stderr)
        return 1
    if args.probe == "trial":
        print(json.dumps(trial(args)), flush=True)
        return 0
    rec = {"step": step_probe, "fit": fit_probe,
           "cudnn": cudnn_probe}[args.probe](args)
    rec["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(rec["card"])
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
