#!/usr/bin/env python3
"""The port's data parallelism across the cards of one host, held to one
process on the whole batch, over ``nccl``: the MNIST ConvNet
(``--model convnet``, the default), ResNet-18 on CIFAR-10 (``--model
resnet18``, as the ConvNet below) or GPT-2-small in three sharded layouts
(``--model gpt2``, below), through the port's ``Trainer``.

    python3 ddp_probe.py [--model convnet|resnet18|gpt2] [--out FILE]

``--model convnet`` trains the reference's workload twice from seed 0 on
the same global batch of ``128 x WORLD``: first as WORLD processes of
128 rows each, one card a rank, joined through
``--coordinator``/``--num_processes``/``--process_id``; then as one
process on card 0. Each run is one ``Trainer.fit`` epoch of mnist's
synthetic stand-in (60,000 x 28 x 28 x 1, 118 updates; the test split's
10,000 images evaluated after it) with Adadelta at lr 1.0 (the reference
``main.py``'s default) and StepLR 0.7, f32, on the captured step.

The two runs sum in different orders, and at lr 1.0 such f32 differences
grow: two one-process runs that differ only in their CPU thread count
drift 1e-5 apart in the weights after two updates and 1e-3 after ten. So
the probe holds the ranks to one process where they start from the same
bits:

- the first two losses (the eager warm-up's forward, and the forward
  after its update) agree to ``TOL``;
- the replayed update ``CHECK`` (the first profiled one): each rank keeps
  its batch rows and the state before and after it; the one process,
  after its own epoch, copies that state into its own captured step and
  replays the update on the ranks' rows joined in rank order. Its loss,
  parameters, Adadelta slots, count and BatchNorm running stats agree
  with the ranks' to ``TOL``;
- every rank ends with rank 0's parameters and stats, bit for bit;
- each of ``COUNTED_STEPS`` updates of every rank, profiled one at a
  time, is one ``cudaGraphLaunch`` whose replay runs NCCL kernels.

A rank that skipped the gradient all-reduce, left the sum undivided by
the world size, never exchanged BatchNorm's sums or drew only its own
rows' dropout mask would fail the first two. Failing gates exit 1.

``--model resnet18`` runs the same two runs and gates on BASELINE config
1: ResNet-18 (CIFAR stem) on CIFAR-10's synthetic stand-in (50,000 x 32 x
32 x 3; 98 updates of 512; the test split evaluated after), SGD at lr 0.1
(momentum 0.9, StepLR 0.7), f32, ``--augment flip-crop`` (every rank
draws the global batch's flips and offsets and keeps its rows, so the
one process replays the ranks' update on their joined rows with their
draws), sync-BN over its 20 BatchNorms' NCHW maps.

Reports, for each run: samples/s a card and in all (host clock, from a
synchronize after update ``SKIP`` to one before the profiled updates),
ms a step, NCCL kernels a replay; from the last ``TIMED_STEPS`` updates,
profiled in one session, the device ms a step of every kernel but
NCCL's, NCCL's device ms a step (BASELINE's "DDP all-reduce step time":
the median over the replays of the sum of their NCCL kernels, as a
kernel that waits for a late rank times the wait) and the busy share
(the two over the step's ms); the test accuracy; the largest difference
of
the epoch's losses, weights and eval sums between the runs (reported,
not gated). The trainer's default ``--shard_update auto`` shards the
update at world 4 (ZeRO-1): a replay's NCCL kernels are the
reduce-scatter, the all-gather, the loss's all-reduce and each
BatchNorm's two (``DP_MODELS``: 5 for the ConvNet, 43 for ResNet-18).

``--model gpt2`` runs the trainer (``Trainer.train_epoch``) on GPT-2-small
(12 x 768, vocab 50257, T 1024; random tokens from numpy seed 0, random
weights from seed 0) at world 4, 8 sequences a card, in each layout of
``GPT2_LAYOUTS``: ``--mesh data=4`` (ZeRO-1, ``adamw_fused``: the fused
kernel on each rank's quarter of the flat buffers), ``--mesh fsdp=4``
and ``--mesh data=2,fsdp=2`` (FSDP, ``adamw``); then one process on card
0 on the same global batch of 32. Each layout's world runs three
trainers:

- gated, f32, dropout 0.1 (every rank draws the global batch's masks, so
  the ranks train as one process): update ``GPT2_CHECK`` (a replay) is
  kept, the ranks' gathered state before and after it and their rows;
  the one process, after its own run, loads that state and replays the
  update on the rows joined in rank order: loss, parameters, moments and
  count agree with the ranks' to ``GPT2_TOL`` (the key third of
  ``qkv.bias`` left out: its exact gradient is zero, and Adam scales
  each order's rounding noise there to about lr); every rank ends with
  the same gathered master bits; each of ``GPT2_COUNTED`` replays,
  profiled one at a time, is one ``cudaGraphLaunch`` running NCCL
  kernels;
- reported, bf16, dropout 0.1 and then 0.0: step ms and tokens/s a card
  and in all (host clock over ``GPT2_TIMED`` updates after
  ``GPT2_SKIP``), then ``GPT2_TIMED`` more profiled in one session: the
  device ms a step of NCCL's kernels (the median over the replays) and
  of the rest, the busy share, ``fused_adamw``'s kernel ms a step beside
  its byte bound on the shard; per card the bytes of masters, moments
  and gradient buffers and the peak reserved memory.

The one process also runs the bf16 cell at world 1 (8 sequences,
``adamw_fused`` and ``adamw``, dropout 0.1 and 0.0) for the same
numbers. ``--device cpu`` rehearses the GPT-2 probe on the CPU over gloo
at GPT-2-tiny sizes, without the profiles and memory readings.

Prints the card's name and power limit (``nvidia-smi``), then the record
as one JSON object on the last line; ``--out`` writes it to a file too.
Needs WORLD cards.
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORLD, BATCH_PER_CARD = 4, 128
SKIP, COUNTED_STEPS, TIMED_STEPS = 3, 10, 20
# the data-parallel cells of ``worker``: the trainer's config, and a
# replay's NCCL kernels: the ZeRO-1 update's reduce-scatter and
# all-gather, the loss's all-reduce and each BatchNorm's sums, forward
# and backward (the ConvNet has one BatchNorm, ResNet-18 20)
DP_MODELS = {
    "convnet": ({"model": "convnet", "dataset": "mnist",
                 "optimizer": "adadelta", "lr": 1.0, "gamma": 0.7}, 3 + 2),
    "resnet18": ({"model": "resnet18", "dataset": "cifar10",
                  "optimizer": "sgd", "lr": 0.1, "gamma": 0.7,
                  "augment": "flip-crop"}, 3 + 2 * 20)}
TOL = 1e-5
TIMEOUT = 900


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def state_tensors(state) -> dict:
    """Every tensor of a ``TrainState`` by name, in logical form:
    parameters, the optimizer's slots (gathered where sharded: every rank
    calls it together) and count, the model state (BatchNorm's running
    stats). A replicated state's tensors are its live views."""
    opt = state.opt_state
    out = {f"param:{n}": t for n, t in opt.param_leaves().items()}
    out.update({f"slot:{k}:{n}": t for k, d in opt.moments().items()
                for n, t in d.items()})
    out["count"] = opt.count
    out.update({f"stat:{n}": t for n, t in state.model_state.items()})
    return out


def worker(out: str, rank: int, world: int, port: int, global_batch: int,
           model: str, ranks_files: list[str]) -> None:
    """One rank: the trainer's epoch with its step wrapped to keep every
    loss, time the steady updates, profile the last ones and keep the
    update ``CHECK``; the one process (``ranks_files``: the ranks' outputs)
    then replays that update from the ranks' state. Writes to the
    ``.npz`` ``out``."""
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_compute_pytorch_tpu_torch.core import mesh
    from distributed_compute_pytorch_tpu_torch.core.config import Config
    from distributed_compute_pytorch_tpu_torch.train.trainer import Trainer

    group = ({"coordinator": f"127.0.0.1:{port}", "num_processes": world,
              "process_id": rank} if world > 1 else {})
    cfg = Config(device="cuda", **DP_MODELS[model][0],
                 batch_size=global_batch, epochs=1, log_every=10 ** 6,
                 data_dir=os.path.dirname(out), ckpt_path=f"{out}.ck.npz",
                 **group)
    tr = Trainer(cfg)
    steps = tr.train_feed.steps_per_epoch
    check = timed_end = steps - COUNTED_STEPS - TIMED_STEPS
    counted_end = timed_end + COUNTED_STEPS
    step, losses, replays, clock, kept = tr.train_step, [], [], {}, {}
    session = profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])

    def snapshot(state, tag):
        kept.update({f"{tag}/{k}": v.detach().clone()
                     for k, v in state_tensors(state).items()})

    def wrapped(state, x, y):
        i = len(losses)
        if i in (SKIP, timed_end):
            torch.cuda.synchronize()
            clock[i] = time.perf_counter()
        if i == check:
            snapshot(state, "before")
            kept.update(x=x.clone(), y=y.clone(),
                        step=torch.tensor(state.step))
        if timed_end <= i < counted_end:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, metrics = step(state, x, y)
                torch.cuda.synchronize()
            replays.append(replay_record(torch, prof))
        else:
            if i == counted_end:
                session.start()
            state, metrics = step(state, x, y)
            if i == steps - 1:
                torch.cuda.synchronize()
                session.stop()
        if i == check:
            snapshot(state, "after")
        losses.append(metrics["loss"])
        return state, metrics
    tr.train_step = wrapped
    ev = tr.fit()
    secs = clock[timed_end] - clock[SKIP]
    n = timed_end - SKIP
    timing = replay_record(torch, session)
    compute_ms = (timing["device_ms"] - timing["nccl_ms"]) / TIMED_STEPS
    nccl_ms = nccl_per_step(torch, session, DP_MODELS[model][1])
    nccl = float(np.median(nccl_ms)) if nccl_ms else None
    step_ms = 1e3 * secs / n
    rec = {"world": world, "batch_per_card": global_batch // world,
           "global_batch": global_batch, "steps": steps,
           "host_threads": torch.get_num_threads(),
           "rate_of": f"steps {SKIP + 1}-{timed_end} by the host clock",
           "step_ms": step_ms,
           "samples_per_s": n * global_batch / secs,
           "samples_per_s_per_card": n * global_batch / world / secs,
           "device_ms_per_step_but_nccl": compute_ms,
           "nccl_device_ms_per_step": nccl,
           "nccl_device_ms_each_step": nccl_ms,
           "nccl_kernels_per_step": timing["nccl_kernels"] / TIMED_STEPS,
           "graph_launches_per_step": timing["graph_launches"]
           / TIMED_STEPS,
           "device_busy_share": (compute_ms + (nccl or 0.0)) / step_ms,
           "replays_counted": replays,
           "graph_stats": {k: v for k, v in step.stats.items()
                           if k != "capture_ms"},
           "test": {"loss": ev["loss"], "accuracy": ev["accuracy"],
                    "count": ev["count"]}}
    final = {k: v.detach().cpu().numpy().copy()
             for k, v in {**tr.state.params, **tr.state.model_state}.items()}
    if ranks_files:
        rec["check"] = replay_check(torch, tr.state, step, ranks_files,
                                    check)
    np.savez(out, losses=torch.stack(losses).cpu().numpy(),
             eval=np.asarray([ev["loss_sum"], ev["correct"], ev["count"]]),
             record=np.asarray(json.dumps(rec)), **final,
             **{f"check/{k}": v.cpu().numpy() for k, v in kept.items()})
    # the graphs go before the group they hold collectives of
    del tr, step, wrapped, kept
    gc.collect()
    torch.cuda.synchronize()
    mesh.shutdown_distributed()


def replay_check(torch, state, step, ranks_files: list[str],
                 check: int) -> dict:
    """The ranks' update ``check`` replayed by this process's captured
    step: their state before it copied into this state in place, their
    rows joined in rank order; the largest difference of the loss and of
    every state tensor from theirs after it."""
    ranks = [np.load(f) for f in ranks_files]
    dev = state.opt_state.count.device
    with torch.no_grad():
        for k, t in state_tensors(state).items():
            t.copy_(torch.from_numpy(ranks[0][f"check/before/{k}"]))
    state.step = int(ranks[0]["check/step"])
    x, y = (torch.from_numpy(np.concatenate([r[f"check/{k}"]
                                             for r in ranks])).to(dev)
            for k in ("x", "y"))
    replays = step.stats["graph_replays"]
    state, metrics = step(state, x, y)
    if step.stats["graph_replays"] != replays + 1:
        raise SystemExit("ddp_probe: the check update did not replay the "
                         "one process's graph")
    errs = {"loss": abs(float(metrics["loss"])
                        - float(ranks[0]["losses"][check]))}
    for k, t in state_tensors(state).items():
        want = ranks[0][f"check/after/{k}"]
        got = t.detach().cpu().numpy()
        if not np.allclose(got, want, atol=TOL, rtol=TOL):
            raise SystemExit(f"ddp_probe: replayed update {check}: {k} "
                             f"differs from the ranks' by up to "
                             f"{np.abs(got - want).max():.3g}")
        group = k.split(":")[0]
        errs[group] = max(errs.get(group, 0.0),
                          float(np.abs(got.astype(np.float64) - want).max()))
    if errs["loss"] > TOL * (1 + abs(float(metrics["loss"]))):
        raise SystemExit(f"ddp_probe: replayed update {check}: loss "
                         f"differs from the ranks' by {errs['loss']:.3g}")
    return {"update": check, "max_abs_err": errs}


def replay_record(torch, prof) -> dict:
    """A profile's graph launches, its device kernels' time, and NCCL's
    kernels and time."""
    device_us = nccl_us = 0.0
    nccl = launches = 0
    for e in prof.key_averages():
        if "GraphLaunch" in e.key:
            launches += e.count
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key == "cuda_graph.replay"):
            continue
        device_us += e.self_device_time_total
        if "nccl" in e.key.lower():
            nccl += e.count
            nccl_us += e.self_device_time_total
    return {"graph_launches": launches, "nccl_kernels": nccl,
            "device_ms": device_us / 1e3, "nccl_ms": nccl_us / 1e3}


def nccl_per_step(torch, prof, collectives: int) -> list[float]:
    """NCCL's device ms in each replay of a profile: its kernels in start
    order, ``collectives`` a replay, summed; empty where the profile holds
    none, or a count that does not divide into its replays."""
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "nccl" in e.name.lower()),
                     key=lambda e: e.time_range.start)
    if len(kernels) != collectives * TIMED_STEPS:
        return []
    return [sum(e.time_range.elapsed_us() for e in kernels[i:i + collectives])
            / 1e3 for i in range(0, len(kernels), collectives)]


def launch(world: int, global_batch: int, model: str, tmp: str,
           ranks_files: list[str]) -> list[str]:
    """Start every rank of a world on ``global_batch``, wait for each
    under the timeout; returns the files they wrote."""
    port = free_port()
    outs = [os.path.join(tmp, f"w{world}r{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", out, str(r),
         str(world), str(port), str(global_batch), model, *ranks_files],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r, out in enumerate(outs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SystemExit(f"ddp_probe: rank {r} of {world} exited "
                             f"{p.returncode}:\n{log[-4000:]}")
    return outs


def compare(one: dict, ranks: list[dict]) -> dict:
    """The gates on the whole runs: the first two losses within ``TOL``,
    the ranks' final parameters and stats equal to rank 0's bits, and
    NCCL in every profiled replay. Returns the largest difference of the
    epoch's losses, final weights and stats and eval sums from the one
    process's (reported)."""
    bad, errs = [], {}
    for r, got in enumerate(ranks):
        if not np.allclose(got["losses"][:2], one["losses"][:2], atol=TOL,
                           rtol=TOL):
            bad.append(f"rank {r}: first losses {got['losses'][:2]} "
                       f"against {one['losses'][:2]}")
        for key, want in one.items():
            if key in ("record",) or key.startswith("check/"):
                continue
            if key not in ("losses", "eval") and not np.array_equal(
                    got[key], ranks[0][key]):
                bad.append(f"rank {r}: {key} differs from rank 0's bits")
            group = key if key in ("losses", "eval") else "weights_and_stats"
            errs[group] = max(errs.get(group, 0.0), float(np.abs(
                got[key].astype(np.float64) - want).max()))
        for i, rep in enumerate(json.loads(str(got["record"]))[
                "replays_counted"]):
            if rep["graph_launches"] != 1 or rep["nccl_kernels"] < 1:
                bad.append(f"rank {r}'s profiled update {i}: {rep}, want "
                           f"one cudaGraphLaunch and NCCL kernels")
    if bad:
        raise SystemExit("ddp_probe: " + "; ".join(bad[:20]))
    return errs


# --- GPT-2 over ranks ------------------------------------------------------

# layout: (--mesh, optimizer)
GPT2_LAYOUTS = {"zero1": ("data=4", "adamw_fused"),
                "fsdp": ("fsdp=4", "adamw"),
                "hybrid": ("data=2,fsdp=2", "adamw")}
GPT2_BATCH_PER_CARD, GPT2_T, GPT2_LR, GPT2_WARMUP = 8, 1024, 1e-4, 2
# the gated run: update GPT2_CHECK (a replay: 0 is the warm-up, 1 the
# capture) is replayed by the one process; GPT2_COUNTED replays follow,
# profiled one at a time
GPT2_CHECK, GPT2_COUNTED = 3, 4
# the reported runs: GPT2_SKIP updates, GPT2_TIMED on the host clock,
# GPT2_TIMED more in one profiler session
GPT2_SKIP, GPT2_TIMED = 3, 10
# stated before a four-card run, from the CPU rehearsal (--device cpu)
GPT2_TOL = 1e-5
# a world's (or the one process's) processes together; a worker dumps its
# stacks and exits GPT2_DUMP_S before it
GPT2_TIMEOUT, GPT2_DUMP_S = 420, 30
# the HBM rate for fused_adamw's byte bound (chip_smoke.py's)
HBM_BYTES_S = 3.35e12


def gpt2_tokens(n: int, t: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(0).integers(0, vocab, (n, t)).astype(
        np.int32)


def gpt2_job(cpu: bool) -> dict:
    """The model config and sizes: GPT-2-small on the card, GPT-2-tiny
    for a CPU rehearsal."""
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2Config
    if cpu:
        return {"cfg": GPT2Config(vocab_size=256, max_seq_len=32,
                                  num_layers=2, num_heads=4, d_model=64,
                                  d_ff=128), "t": 32}
    return {"cfg": GPT2Config.small(), "t": GPT2_T}


def gpt2_trainer(mesh_spec, optimizer, dtype, dropout, global_batch, steps,
                 group, device, tmp):
    """The port's ``Trainer`` on GPT-2 (random weights, seed 0) with
    ``steps`` updates of random tokens at ``global_batch``."""
    import dataclasses

    from distributed_compute_pytorch_tpu_torch.core.config import Config
    from distributed_compute_pytorch_tpu_torch.data.datasets import (
        ArrayDataset)
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2
    from distributed_compute_pytorch_tpu_torch.train.trainer import Trainer
    job = gpt2_job(device == "cpu")
    cfg = dataclasses.replace(job["cfg"], dropout_rate=dropout)
    tokens = gpt2_tokens(global_batch * steps, job["t"], cfg.vocab_size)
    data = ArrayDataset(tokens, tokens, name="random-lm")
    config = Config(device=device, model="gpt2", optimizer=optimizer,
                    lr=GPT2_LR, warmup_steps=GPT2_WARMUP,
                    batch_size=global_batch, epochs=1, log_every=10 ** 6,
                    compute_dtype=dtype, mesh=mesh_spec, seed=0,
                    ckpt_path=os.path.join(tmp, "unused.npz"), **group)
    return Trainer(config, model=GPT2(cfg, device=device), train_data=data,
                   eval_data=data)


def logical_numpy(state) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in state_tensors(state).items()}


def gpt2_gated(torch, tr, cuda: bool, keep_state: bool
               ) -> tuple[dict, dict]:
    """The gated f32 run: every update's loss, the rows of update
    ``GPT2_CHECK`` and (``keep_state``) the gathered state around it,
    ``GPT2_COUNTED`` replays profiled one at a time, a digest of the
    gathered final masters; returns the record and the arrays to keep.
    Every rank gathers (a collective); one keeps the state."""
    from torch.profiler import ProfilerActivity, profile
    step, losses, kept, replays = tr.train_step, [], {}, []

    def keep(tag, state):
        got = logical_numpy(state)
        if keep_state:
            kept.update({f"check/{tag}/{k}": v for k, v in got.items()})

    def wrapped(state, x, y):
        i = len(losses)
        if i == GPT2_CHECK:
            keep("before", state)
            kept["check/x"] = x.cpu().numpy()
            kept["check/step"] = np.asarray(state.step)
        if cuda and GPT2_CHECK < i <= GPT2_CHECK + GPT2_COUNTED:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, metrics = step(state, x, y)
                torch.cuda.synchronize()
            replays.append(replay_record(torch, prof))
        else:
            state, metrics = step(state, x, y)
        if i == GPT2_CHECK:
            keep("after", state)
        losses.append(metrics["loss"])
        return state, metrics
    tr.train_step = wrapped
    tr.train_epoch(0)
    kept["losses"] = torch.stack(losses).cpu().numpy()
    digest = hashlib.sha256()
    params = tr.state.opt_state.param_leaves()
    for name in sorted(params):
        digest.update(params[name].detach().cpu().numpy().tobytes())
    kept["final_digest"] = np.asarray(digest.hexdigest())
    return {"replays_counted": replays,
            "graph_stats": {k: v for k, v in step.stats.items()
                            if k != "capture_ms"}
            if hasattr(step, "stats") else None}, kept


def nccl_median(torch, prof, n: int) -> tuple[float | None, int | None]:
    """NCCL's device ms a replay over a session of ``n`` replays: its
    kernels in start order, split into ``n`` equal runs, each summed; the
    median, and the kernels a replay (``None`` where they do not split
    evenly)."""
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "nccl" in e.name.lower()),
                     key=lambda e: e.time_range.start)
    if not kernels or len(kernels) % n:
        return None, None
    k = len(kernels) // n
    per = [sum(e.time_range.elapsed_us() for e in kernels[i:i + k]) / 1e3
           for i in range(0, len(kernels), k)]
    return float(np.median(per)), k


def gpt2_timed(torch, tr, world: int, cuda: bool) -> dict:
    """A reported run: ``GPT2_SKIP`` updates, ``GPT2_TIMED`` on the host
    clock, ``GPT2_TIMED`` more in one profiler session."""
    from torch.profiler import ProfilerActivity, profile
    step, clock, n = tr.train_step, {}, [0]
    session = profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
    end = GPT2_SKIP + GPT2_TIMED

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def wrapped(state, x, y):
        i = n[0]
        if i in (GPT2_SKIP, end):
            sync()
            clock[i] = time.perf_counter()
        if cuda and i == end:
            session.start()
        state, metrics = step(state, x, y)
        if cuda and i == end + GPT2_TIMED - 1:
            sync()
            session.stop()
        n[0] += 1
        return state, metrics
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tr.train_step = wrapped
    tr.train_epoch(0)
    opt = tr.state.opt_state
    step_ms = 1e3 * (clock[end] - clock[GPT2_SKIP]) / GPT2_TIMED
    tokens = tr.config.batch_size * tr.train_data.inputs.shape[1]
    rec = {"step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
           "tokens_per_s_per_card": tokens / world / step_ms * 1e3,
           "rate_of": f"updates {GPT2_SKIP + 1}-{end} by the host clock",
           "bytes_per_card": opt.nbytes(), "layout": opt.layout.mode,
           "units": len(opt.layout.units)}
    if not cuda:
        return rec
    timing = replay_record(torch, session)
    fused_us = sum(e.self_device_time_total for e in session.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "fused_adamw" in e.key)
    nccl, per_replay = nccl_median(torch, session, GPT2_TIMED)
    other = (timing["device_ms"] - timing["nccl_ms"]) / GPT2_TIMED
    shard = opt.upd_p.numel()
    rec.update({
        "device_ms_per_step_but_nccl": other,
        "nccl_device_ms_per_step": nccl,
        "nccl_kernels_per_step": per_replay,
        "device_busy_share": (other + (nccl or 0.0)) / step_ms,
        "graph_launches_per_step": timing["graph_launches"] / GPT2_TIMED,
        "fused_adamw_ms_per_step": fused_us / 1e3 / GPT2_TIMED,
        "fused_adamw_elements": shard,
        "fused_adamw_bound_ms": 28.0 * shard / HBM_BYTES_S * 1e3,
        "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    return rec


def release(torch, cuda: bool) -> None:
    """Return what a dropped trainer and its graphs held before the next
    one is built."""
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def gpt2_worker(out: str, rank: int, world: int, port: int, layout: str,
                device: str, tmp: str) -> None:
    """One rank of ``layout``'s world: the gated run, then the reported
    runs at dropout 0.1 and 0.0. Writes to the ``.npz`` ``out``."""
    sys.path.insert(0, ROOT)
    import torch

    from distributed_compute_pytorch_tpu_torch.core import mesh
    cuda = device == "cuda"
    spec, optimizer = GPT2_LAYOUTS[layout]
    group = {"coordinator": f"127.0.0.1:{port}", "num_processes": world,
             "process_id": rank}
    # the group first: joining picks this rank's card, on which the
    # models are then built
    mesh.initialize_distributed(**group, device_type=device)
    batch = GPT2_BATCH_PER_CARD * world
    tr = gpt2_trainer(spec, optimizer, "float32", 0.1, batch,
                      GPT2_CHECK + GPT2_COUNTED + 1, group, device, tmp)
    gated, kept = gpt2_gated(torch, tr, cuda, keep_state=rank == 0)
    del tr
    release(torch, cuda)
    rec = {"layout": layout, "mesh": spec, "optimizer": optimizer,
           "world": world, "gated": gated, "bf16": {}}
    for p in (0.1, 0.0):
        tr = gpt2_trainer(spec, optimizer, "bfloat16", p, batch,
                          GPT2_SKIP + 2 * GPT2_TIMED, group, device, tmp)
        rec["bf16"][f"dropout_{p}"] = gpt2_timed(torch, tr, world, cuda)
        del tr
        release(torch, cuda)
    np.savez(out, record=np.asarray(json.dumps(rec)), **kept)
    mesh.shutdown_distributed()


def gpt2_replay_check(torch, tr, ranks_files: list[str]) -> dict:
    """The ranks' update ``GPT2_CHECK`` replayed by this process's
    captured step from their state before it, on their rows joined in
    rank order: the largest differences from their state after it, the
    key third of ``qkv.bias`` (and its moments) left out; raises past
    ``GPT2_TOL``."""
    everyone = [np.load(f) for f in ranks_files]
    ranks = everyone[0]
    state, step = tr.state, tr.train_step
    dev = state.opt_state.count.device
    with torch.no_grad():
        for k, t in state_tensors(state).items():
            t.copy_(torch.from_numpy(ranks[f"check/before/{k}"]))
    state.step = int(ranks["check/step"])
    x = torch.from_numpy(np.concatenate([r["check/x"] for r in everyone])
                         ).to(dev)
    replays = step.stats["graph_replays"] if hasattr(step, "stats") else 0
    state, metrics = step(state, x, x)
    if hasattr(step, "stats") and step.stats["graph_replays"] != replays + 1:
        raise SystemExit("ddp_probe: the check update did not replay the "
                         "one process's graph")
    d = tr.model.config.d_model
    errs = {"loss": abs(float(metrics["loss"])
                        - float(ranks["losses"][GPT2_CHECK]))}
    for k, t in state_tensors(state).items():
        want = ranks[f"check/after/{k}"]
        got = t.detach().cpu().numpy()
        if k.endswith("qkv.bias"):
            got, want = (np.concatenate([a[:d], a[2 * d:]])
                         for a in (got, want))
        if not np.allclose(got, want, atol=GPT2_TOL, rtol=GPT2_TOL):
            raise SystemExit(f"ddp_probe: replayed update {GPT2_CHECK}: {k} "
                             f"differs from the ranks' by up to "
                             f"{np.abs(got - want).max():.3g}")
        group = k.split(":")[0]
        errs[group] = max(errs.get(group, 0.0),
                          float(np.abs(got.astype(np.float64) - want).max()))
    if errs["loss"] > GPT2_TOL * (1 + abs(float(metrics["loss"]))):
        raise SystemExit(f"ddp_probe: replayed update {GPT2_CHECK}: loss "
                         f"differs from the ranks' by {errs['loss']:.3g}")
    return {"update": GPT2_CHECK, "max_abs_err": errs}


def gpt2_one_process(out: str, device: str, tmp: str,
                     ranks_files: dict) -> None:
    """Card 0 alone: per optimizer, the gated run on the global batch and
    the replay checks of the layouts that use it; then the bf16 cell at
    world 1 for each optimizer and dropout."""
    sys.path.insert(0, ROOT)
    import torch
    cuda = device == "cuda"
    rec = {"checks": {}, "bf16": {}}
    for optimizer in ("adamw_fused", "adamw"):
        tr = gpt2_trainer("data=-1", optimizer, "float32", 0.1,
                          GPT2_BATCH_PER_CARD * WORLD,
                          GPT2_CHECK + GPT2_COUNTED + 1, {}, device, tmp)
        gated, kept = gpt2_gated(torch, tr, cuda, keep_state=False)
        rec[f"gated_{optimizer}"] = gated
        np.savez(f"{out}.{optimizer}.npz", **kept)
        for layout, (_, opt) in GPT2_LAYOUTS.items():
            if opt == optimizer:
                rec["checks"][layout] = gpt2_replay_check(
                    torch, tr, ranks_files[layout])
        del tr
        release(torch, cuda)
        for p in (0.1, 0.0):
            tr = gpt2_trainer("data=-1", optimizer, "bfloat16", p,
                              GPT2_BATCH_PER_CARD,
                              GPT2_SKIP + 2 * GPT2_TIMED, {}, device, tmp)
            rec["bf16"][f"{optimizer}/dropout_{p}"] = gpt2_timed(
                torch, tr, 1, cuda)
            del tr
            release(torch, cuda)
    with open(out, "w") as f:
        json.dump(rec, f)


def gpt2_compare(ranks: list[dict], one: dict, cuda: bool) -> dict:
    """The gates on the whole runs of a layout: every rank's gathered
    final masters equal to rank 0's bits, the first two losses equal to
    the one process's within ``GPT2_TOL``, and (on the card) one
    ``cudaGraphLaunch`` running NCCL kernels in every counted replay.
    Returns the largest difference of the losses from the one
    process's."""
    bad = []
    for r, got in enumerate(ranks):
        if str(got["final_digest"]) != str(ranks[0]["final_digest"]):
            bad.append(f"rank {r}: its gathered final masters differ from "
                       f"rank 0's bits")
        if not np.allclose(got["losses"][:2], one["losses"][:2],
                           atol=GPT2_TOL, rtol=GPT2_TOL):
            bad.append(f"rank {r}: first losses {got['losses'][:2]} "
                       f"against {one['losses'][:2]}")
        if cuda:
            for i, rep in enumerate(json.loads(str(got["record"]))[
                    "gated"]["replays_counted"]):
                if rep["graph_launches"] != 1 or rep["nccl_kernels"] < 1:
                    bad.append(f"rank {r}'s counted replay {i}: {rep}")
    if bad:
        raise SystemExit("ddp_probe: " + "; ".join(bad[:20]))
    return {"losses": float(np.abs(ranks[0]["losses"].astype(np.float64)
                                   - one["losses"]).max())}


def gpt2_main(device: str) -> dict:
    import torch
    cuda = device == "cuda"
    if cuda and torch.cuda.device_count() < WORLD:
        raise SystemExit(f"ddp_probe needs {WORLD} CUDA cards (found "
                         f"{torch.cuda.device_count()})")
    rec = {"tol": GPT2_TOL, "layouts": {}}
    # the ranks' state around the check update (GBs) goes beside the
    # checkout, not to the host's temp directory
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        files = {}
        for layout in GPT2_LAYOUTS:
            files[layout] = launch_gpt2(WORLD, layout, device, tmp)
            with np.load(files[layout][0]) as z:   # kept if a later run fails
                print(f"ddp_probe: {layout} rank 0: {z['record']}",
                      flush=True)
        one_out = os.path.join(tmp, "one.json")
        run_procs([[sys.executable, os.path.abspath(__file__),
                    "--gpt2-one", one_out, device, tmp,
                    json.dumps(files)]], "the one process", tmp)
        with open(one_out) as f:
            one = json.load(f)
        for layout, outs in files.items():
            ranks = []
            for o in outs:
                with np.load(o) as z:
                    ranks.append({k: z[k] for k in ("losses", "record",
                                                    "final_digest")})
            optimizer = GPT2_LAYOUTS[layout][1]
            one_kept = dict(np.load(f"{one_out}.{optimizer}.npz"))
            diffs = gpt2_compare(ranks, one_kept, cuda)
            rank0 = json.loads(str(ranks[0]["record"]))
            rec["layouts"][layout] = {
                **rank0, "check": one["checks"][layout],
                "first_losses": ranks[0]["losses"][:2].tolist(),
                "epoch_max_abs_diff": diffs,
                "per_rank_bf16": [json.loads(str(r["record"]))["bf16"]
                                  for r in ranks[1:]]}
        rec["world_1"] = {"bf16": one["bf16"],
                          "gated": {k: v for k, v in one.items()
                                    if k.startswith("gated_")}}
    return rec


def run_procs(cmds: list[list[str]], what: str, tmp: str) -> None:
    """Run ``cmds`` together, each writing its output to a log file in
    ``tmp``, wait for them under ``GPT2_TIMEOUT`` in all; raise naming
    the processes that failed or hung, with the tail of every log (a
    worker dumps its threads' stacks to its log before that timeout)."""
    t0 = time.monotonic()
    paths = [os.path.join(tmp, f"{what.replace(' ', '_')}.{i}.log")
             for i in range(len(cmds))]
    files = [open(path, "w") for path in paths]
    procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT,
                              text=True) for c, f in zip(cmds, files)]
    try:
        for p in procs:
            left = GPT2_TIMEOUT - (time.monotonic() - t0)
            try:
                p.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    print(f"ddp_probe: {what}: {time.monotonic() - t0:.1f} s, exit codes "
          f"{[p.returncode for p in procs]}", flush=True)
    if any(p.returncode != 0 for p in procs):
        tails = []
        for i, path in enumerate(paths):
            with open(path) as f:
                tails.append(f"--- process {i} ---\n{f.read()[-3000:]}")
        raise SystemExit(f"ddp_probe: {what} failed:\n" + "\n".join(tails))


def launch_gpt2(world: int, layout: str, device: str, tmp: str) -> list:
    """Every rank of ``layout``'s world; returns the files they wrote."""
    port = free_port()
    outs = [os.path.join(tmp, f"{layout}_r{r}.npz") for r in range(world)]
    run_procs([[sys.executable, os.path.abspath(__file__), "--gpt2-worker",
                out, str(r), str(world), str(port), layout, device, tmp]
               for r, out in enumerate(outs)], f"{layout} at world {world}",
              tmp)
    return outs


def dp_main(model: str) -> dict:
    """``model`` (``DP_MODELS``) at world 4, then one process on the same
    batch."""
    global_batch = BATCH_PER_CARD * WORLD
    with tempfile.TemporaryDirectory() as tmp:
        ranks_files = launch(WORLD, global_batch, model, tmp, [])
        (one_file,) = launch(1, global_batch, model, tmp, ranks_files)
        ranks = [dict(np.load(f)) for f in ranks_files]
        one = dict(np.load(one_file))
    epoch_errs = compare(one, ranks)
    one_rec, ranks_rec = (json.loads(str(d["record"]))
                          for d in (one, ranks[0]))
    return {"card": nvidia_smi(), "model": model, "tol": TOL,
            "nccl_kernels_per_replay": DP_MODELS[model][1],
            "check": one_rec.pop("check"),
            "epoch_max_abs_diff": epoch_errs, "one_process": one_rec,
            "ranks": ranks_rec}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="convnet",
                   choices=("convnet", "resnet18", "gpt2"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu: rehearse --model gpt2 over gloo, GPT-2-tiny")
    p.add_argument("--out", default=None)
    p.add_argument("--worker", nargs="+", help=argparse.SUPPRESS)
    p.add_argument("--gpt2-worker", nargs=7, help=argparse.SUPPRESS)
    p.add_argument("--gpt2-one", nargs=4, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        out, rank, world, port, batch, model, *ranks_files = args.worker
        worker(out, int(rank), int(world), int(port), int(batch), model,
               ranks_files)
        return 0
    if args.gpt2_worker or args.gpt2_one:
        faulthandler.dump_traceback_later(GPT2_TIMEOUT - GPT2_DUMP_S,
                                          exit=True)
    if args.gpt2_worker:
        out, rank, world, port, layout, device, tmp = args.gpt2_worker
        gpt2_worker(out, int(rank), int(world), int(port), layout, device,
                    tmp)
        return 0
    if args.gpt2_one:
        out, device, tmp, files = args.gpt2_one
        gpt2_one_process(out, device, tmp, json.loads(files))
        return 0
    import torch
    if args.model == "gpt2":
        rec = gpt2_main(args.device)
        card = nvidia_smi() if args.device == "cuda" else "cpu rehearsal"
        rec = {"card": card, "model": "gpt2", **rec}
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
            raise SystemExit(f"ddp_probe needs {WORLD} CUDA cards (found "
                             f"{torch.cuda.device_count()})")
        rec = dp_main(args.model)
        card = rec["card"]
    print(card, flush=True)
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
