#!/usr/bin/env python3
"""The port's data parallelism across the cards of one host, held to one
process on the whole batch: the MNIST ConvNet through the port's
``Trainer``, over ``nccl``.

    python3 ddp_probe.py [--out FILE]

Trains the reference's workload twice from seed 0 on the same global
batch of ``128 x WORLD``: first as WORLD processes of 128 rows each, one
card a rank, joined through ``--coordinator``/``--num_processes``/
``--process_id``; then as one process on card 0. Each run is one
``Trainer.fit`` epoch of mnist's synthetic stand-in (60,000 x 28 x 28 x
1, 118 updates; the test split's 10,000 images evaluated after it) with
Adadelta at lr 1.0 (the reference ``main.py``'s default) and StepLR 0.7,
f32, on the captured step.

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

Reports, for each run: samples/s a card and in all (host clock, from a
synchronize after update ``SKIP`` to one before the profiled updates),
ms a step, NCCL kernels a replay; from the last ``TIMED_STEPS`` updates,
profiled in one session, the device ms a step of every kernel but
NCCL's, NCCL's device ms a step (BASELINE's "DDP all-reduce step time":
the median over the replays of their ``COLLECTIVES`` kernels' sum, as a
kernel that waits for a late rank times the wait) and the busy share
(the two over the step's ms); the test accuracy; the largest difference
of
the epoch's losses, weights and eval sums between the runs (reported,
not gated). Prints the card's name and power limit (``nvidia-smi``),
then the record as one JSON object on the last line; ``--out`` writes
it to a file too. Needs WORLD cards.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORLD, BATCH_PER_CARD, LR = 4, 128, 1.0
SKIP, COUNTED_STEPS, TIMED_STEPS = 3, 10, 20
# a replay's NCCL kernels: the gradient all-reduce and BatchNorm's sums,
# forward and backward
COLLECTIVES = 3
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
    """Every tensor of a ConvNet ``TrainState`` by name: parameters,
    Adadelta's slots and count, BatchNorm's running stats."""
    opt = state.opt_state
    out = {f"param:{n}": t for n, t in state.params.items()}
    out.update({f"slot:{k}:{n}": t for k, d in opt.slots.items()
                for n, t in d.items()})
    out["count"] = opt.count
    out.update({f"stat:{n}": t for n, t in state.model_state.items()})
    return out


def worker(out: str, rank: int, world: int, port: int, global_batch: int,
           ranks_files: list[str]) -> None:
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
    cfg = Config(device="cuda", model="convnet", dataset="mnist",
                 optimizer="adadelta", lr=LR, gamma=0.7,
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
    nccl_ms = nccl_per_step(torch, session)
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


def nccl_per_step(torch, prof) -> list[float]:
    """NCCL's device ms in each replay of a profile: its kernels in start
    order, ``COLLECTIVES`` a replay, summed; empty where the profile holds
    none, or a count that does not divide into its replays."""
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "nccl" in e.name.lower()),
                     key=lambda e: e.time_range.start)
    if len(kernels) != COLLECTIVES * TIMED_STEPS:
        return []
    return [sum(e.time_range.elapsed_us() for e in kernels[i:i + COLLECTIVES])
            / 1e3 for i in range(0, len(kernels), COLLECTIVES)]


def launch(world: int, global_batch: int, tmp: str,
           ranks_files: list[str]) -> list[str]:
    """Start every rank of a world on ``global_batch``, wait for each
    under the timeout; returns the files they wrote."""
    port = free_port()
    outs = [os.path.join(tmp, f"w{world}r{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", out, str(r),
         str(world), str(port), str(global_batch), *ranks_files],
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None)
    p.add_argument("--worker", nargs="+", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        out, rank, world, port, batch, *ranks_files = args.worker
        worker(out, int(rank), int(world), int(port), int(batch),
               ranks_files)
        return 0
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        raise SystemExit(f"ddp_probe needs {WORLD} CUDA cards (found "
                         f"{torch.cuda.device_count()})")
    global_batch = BATCH_PER_CARD * WORLD
    with tempfile.TemporaryDirectory() as tmp:
        ranks_files = launch(WORLD, global_batch, tmp, [])
        (one_file,) = launch(1, global_batch, tmp, ranks_files)
        ranks = [dict(np.load(f)) for f in ranks_files]
        one = dict(np.load(one_file))
    epoch_errs = compare(one, ranks)
    one_rec, ranks_rec = (json.loads(str(d["record"]))
                          for d in (one, ranks[0]))
    card = nvidia_smi()
    rec = {"card": card, "tol": TOL, "check": one_rec.pop("check"),
           "epoch_max_abs_diff": epoch_errs, "one_process": one_rec,
           "ranks": ranks_rec}
    print(card, flush=True)
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
