#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: the quickest proof that the port
builds, is right, serves and trains on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout, on a machine with one CUDA card, nvcc
(``CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch built for CUDA. It
imports nothing of JAX. Phases, one JSON line each:

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA
   versions;
2. build: every ``distributed_compute_pytorch_tpu_torch/csrc/*.cu``
   compiled by ``nvcc`` (in parallel), with the build seconds and each
   kernel's register/spill report;
3. kernels: each hand-written kernel against its plain PyTorch version on
   CUDA tensors at its path's shapes (serving for the forward, pool write
   and paged decode; GPT-2-small training for the flash backward and
   fused AdamW; generation for the dense writes and the dense decode),
   with the tolerances below, and timed beside its plain version, its
   roofline bound and (where one exists) one PyTorch library call
   computing the same function. The int8 forms of the four slot writes
   (quantizing as they write, exact against ``quantize_kv`` then the
   indexed writes) and of the two decode reads (to TOL, and row by row to
   ``ROW_TOL`` in bf16) at the same shapes. Each of the four decode reads
   also reports its grid (splits S, split length, tile, stages, shared
   bytes, blocks), its share of the bound, the same bits on two launches
   (gated) and its fixed cost (the same read with every live length at 1
   or 0); then one long-context line, the paged read float and int8 at 2
   rows x 12 heads over 4,096 live keys each, gated on correctness only.
   The four fused ticks (the slot write and the read in one launch:
   ``paged_decode_write``, ``dense_decode_write`` and their ``_q8`` forms)
   at the serving and generation shapes (a parked all-trash row past the
   horizon among the paged rows): the cache exact and the live rows to
   TOL (bf16: ROW_TOL) against the plain version, the cache and every
   live row bit-identical to the unfused kernel pair (the standalone
   write, then the read-only read) on the same inputs, the same bits on
   two launches, all gated; each timed beside the two launches it
   replaces, back to back, and the read-only read alone, with its grid
   and fixed cost; the long-context line adds the fused paged tick.
   The flash forward is also timed at the
   training shape; the flash kernels, forward and backward, must take the
   tensor-core kernels in bf16 and the CUDA-core ones in f32, give the
   same bits on two launches, hold each bf16 row within ``ROW_TOL`` (a
   planted dropped key tile must fail that check), and report their
   TFLOP/s and share of their bound;
4. serve: GPT-2-small at full width (random weights from a fixed seed)
   through ``ContinuousBatcher.serve`` — 32 staggered requests, 16 slots,
   in bf16 and then in f32 — on a batcher whose segment is a CUDA graph
   (captured in its warm-up, replayed once a segment) and on one kept
   eager (the private ``_capture = False``), in turns (graph, eager,
   eager, graph). Each kernel's launch counter is zeroed just before each
   serve call and read just after; it must equal the count the schedule
   implies, for both: ``flash_fwd`` and ``kv_pool_insert`` (the admission
   scatter) 12 x waves, the fused ``paged_decode_write`` 12 x ticks (a
   replay adds the launches its capture recorded: ``utils/graphs.py``),
   the read-only ``paged_decode`` 0. The graph batcher captures once and
   replays once a segment; every run's tokens must equal the first's, bit
   for bit; those are checked teacher-forced against one full-sequence
   forward with plain dense attention. Capture ms, tokens/s, ms a tick
   and allocator calls of every run; the headline speed is the median of
   the graph runs;
5. serve_profile: the bf16 serve run once more under ``torch.profiler``
   on each batcher: device time by kernel group, device ops a tick, the
   host's CUDA calls a segment (``cudaLaunchKernel``, ``cudaGraphLaunch``:
   one graph launch a segment, and at least 12 kernel launch calls fewer
   a replayed tick than eager, gated), the device busy share, and the
   launches measured: every counter zeroed just before the profiled run
   must equal, just after, the port's kernel events the device ran
   (graph replays' included) and the schedule (``counted_profile``);
6. generate: GPT-2-small at full width and depth (the serve phase's
   weights) through ``infer.make_generate_fn`` — 16 left-padded prompts of
   16-250 tokens, 128 new tokens each, greedy — in bf16 and then in f32,
   with the captured tick (the first tick eager, the capture's warm-up,
   then 126 replays) and with the eager loop (``_eager=True``) in turns.
   The counters are zeroed just before and read just after each run: the
   fused ``dense_decode_write`` 12 x 127, ``flash_fwd`` 12, every other
   kernel 0 (the standalone ``kv_insert`` and the read-only
   ``dense_decode`` included). Every run's tokens must equal the first's;
   those are checked teacher-forced as in serve. In f32, a sampled run
   (eager: a sampled tick is not captured) repeated with the same
   generator seed must repeat its tokens, and ``temperature=1, top_k=1``
   must give the greedy tokens;
7. generate_profile: the bf16 generate once more under ``torch.profiler``
   with the captured tick and eagerly (device time by group, ops a tick,
   host calls a tick: one graph launch a replayed tick, gated; busy; the
   launches measured against the device's kernel events, as in 5);
8. the int8 KV cells, after the float ones:
   serve_int8: the serve phase's 32 requests in bf16 on the int8 KV pool
   (``kv_dtype="int8"``), captured and eager, beside the bf16 float pool
   captured, in turns (float; int8 graph, eager, eager, graph; float).
   Every run, and each batcher's warm-up (where the graph batchers
   capture), is one whole ``serve`` call under
   ``torch.cuda.set_sync_debug_mode("error")``: no host-to-device copy,
   capture or replay may wait for the card (the harvest's own wait,
   ``serve._Fetch.result``, is the one allowed sync), and the float pool's
   tokens must equal the serve phase's. The first int8 run of each mode
   is counted (int8 ``kv_pool_insert`` 12 x waves, the int8 fused tick
   ``paged_decode_write_q8`` 12 x ticks, ``flash_fwd`` 12 x waves, every
   other counter 0); every int8 run must serve the first int8 run's
   tokens, which are checked teacher-forced, the decoded rows against
   quantized K/V; tokens/s of each run, one profiled run of each batcher
   (device busy, ops a tick, host calls a segment, launches measured as
   in 5), both pools' bytes and
   the share of positions where the int8 pool served the float pool's
   token;
   generate_int8: the generate phase's 16 prompts with ``kv_quant=True``,
   captured and eager, beside the float cache in turns:
   ``dense_decode_write_q8`` 12 x 127, ``flash_fwd`` 12, every other
   counter 0; tokens equal across runs, teacher-forced, the rows past
   each prompt against quantized K/V; tokens/s, a profiled run of each
   mode (launches measured as in 5), and both caches' bytes;
9. train: GPT-2-small at full width and depth (dropout 0.1), bf16 compute
   over f32 masters, ``adamw_fused``, 20 steps on one 8 x 1024 batch
   through ``train/step.py::make_step_fns``, the captured step (its first
   update eager, the second captured, then replays) and the eager
   reference (``_eager=True``) in turns (graph, eager, eager, graph), each
   run from the same weights: every run's losses and final parameters,
   moments and count must be bit-identical to the first's; in each run
   the counters are zeroed just before and read just after, and must
   equal 20 x (12, 12, 12, 1), with every flash launch on the tensor-core
   kernels; every captured update from the second on (the capture and
   each replay, with the batch copies before and the metric copies
   after) runs under ``set_sync_debug_mode("error")``; the loss must fall
   by at least 1 nat and stay finite. Step ms (headline: the captured
   runs' median), tokens/s, capture ms, the graph pool's bytes and the
   peak memory allocated and reserved of every run;
10. train_profile: five more updates of each mode's last run under
   ``torch.profiler``, the counters zeroed just before: they must equal
   the port's kernel events the device ran and 5 x (12, 12, 12, 1); host
   calls a step (captured: one ``cudaGraphLaunch`` a step, and inside a
   replay no kernel launch call but the two ``fill_`` launches of the
   dropout generator's prologue, gated), device time by group, ops a step
   and the busy share of each unprofiled run;
11. train_skip: ``nonfinite_policy="skip"`` on the captured step,
   GPT-2-small as in 9, ``adamw_fused`` then ``adamw``: a replay with one
   ``wte`` element of the masters set to inf reports ``skipped`` 1 and
   leaves parameters, moments and count bit-identical; restored, the next
   replays train;
12. train_parity: f32, dropout 0, two layers at full width: the gradients
   of one step through the kernels against autograd of the dense math,
   and five steps' losses against the same steps with
   ``fused_adamw_plain`` (f32: the backward's CUDA-core kernels); then
   20 captured updates against 20 eager ones, bit-identical losses,
   parameters, moments and count;
13. train_cli: the port's trainer CLI for one epoch of ``synthetic-lm``
   at GPT-2-small widths (the captured step), then ``--resume --epochs
   2``.
14. convnet: the reference's own workload (BASELINE config 0): the MNIST
   ConvNet at batch 128, f32, on mnist's synthetic stand-in (60,000 x 28
   x 28 x 1; 469 steps an epoch) through ``make_step_fns`` with Adadelta
   (lr 1e-3, StepLR gamma 0.7 every 200 steps, so the rate drops twice
   inside the replays; the step runs cuDNN in f32 with its deterministic
   algorithms, as every caller of the port's step does): one epoch
   captured and eager in turns (``TURNS``) from the same weights, every
   run's losses, parameters, Adadelta slots, count and BatchNorm running
   stats bit-identical to the first's, every captured update after the
   first under ``set_sync_debug_mode("error")``; samples/s and step ms of
   each mode, a profiled run of each (one ``cudaGraphLaunch`` a replayed
   step and only the dropout generator's prologue inside, gated; busy
   share; no port kernel on this path, gated), the test accuracy; then
   one epoch at lr 1.0 that must reach a test accuracy of 0.9;
15. convnet_ddp: the same captured step under a one-process ``nccl`` group
   (its gradient all-reduce and the sync-BN all-reduces in the graph):
   bit-identical to the convnet phase's captured run, the warm-up and the
   capture each issuing the three all-reduces (c10d's host ops, gated),
   one ``cudaGraphLaunch`` a replay; the collectives' device time a step
   (the three alone, captured and replayed under the profiler: at world
   1 NCCL's in-place all-reduce runs no device work);
16. convnet_cli: the trainer CLI on the ConvNet, mnist and Adadelta for
   one epoch, then ``--resume --epochs 2``, then one epoch as a one-rank
   ``nccl`` world (``--coordinator``/``--num_processes``/``--process_id``).

When a profiled run's counters and the device's kernel events disagree
(``counted_profile``), the profile's port kernel events (name, start,
stream, graph ids), the schedule and its waves are written to
``chiprun_out/kernel_events_*.json`` before the smoke fails.

Then the ``{"kernels": [...]}`` line (launches from the profiled captured
bf16 serve run for the serving kernels, from the profiled captured bf16
generate run for the generation kernels, from the profiled captured int8
runs of serve_int8 and generate_int8 for the int8 forms, each measured
against the device's kernel events; from train_profile's captured run
for the training kernels, measured the same way), the
raw ``nvidia-smi`` line, and last the ``{"ok": true, ...}`` line. Any
failed check exits non-zero before the ``ok`` line. Roofline bounds use
the H100 SXM data-sheet peaks: 3.35 TB/s HBM, 989 TFLOP/s bf16 (tensor
cores), 67 TFLOP/s f32 (no tensor cores).
"""

from __future__ import annotations

import argparse
import bisect
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# kernel vs its plain version on the same inputs. f32: only the summation
# order differs. bf16: the plain versions round the softmax probabilities
# to bf16 before the value product, as the reference does; the decode
# kernels keep them in f32; the flash forward rounds them too, but
# unnormalised, and sums in another order.
TOL = {"bf16": 3e-2, "f32": 1e-4}
# teacher-forced check: each served token's logit must lie within this
# margin of the row maximum of a dense full-sequence forward in the same
# dtype. bf16: two bf16 computations that round in different places; the
# logits here stay below 4 in magnitude, where one bf16 ulp is 2**-5, so
# the margin is four ulps. f32: only the summation order differs.
MARGIN = {"bf16": 0.125, "f32": 1e-3}
LAYERS = 12
# the flash backward: in bf16 the tensor-core kernels round p and ds to
# bf16 before their products (the plain version keeps f32) and round
# outputs from f32 sums taken in another order, so the backward's errors
# are taken relative to the output's largest magnitude where that exceeds
# 1 (TOL as above); f32 sums differ in order only.
# That largest magnitude is set by the first few causal rows, several
# times a late row's, so the bf16 flash kernels (forward and backward) are
# also held row by row: each row's (one query of o or dq, one key of dk
# or dv) largest error over that row's largest plain magnitude, floored at
# ROW_FLOOR of the output's RMS (a row whose true value is 0, such as dq
# of a causal first row, holds only rounding noise), must stay within
# ROW_TOL: about four times the sound kernels' reading, one bf16 ulp of a
# row's largest element (2**-7). A planted fault, the plain version with
# the last 64 queries of one head skipping one 32-key tile, must exceed
# it, or the check could not see a dropped tile.
ROW_TOL, ROW_FLOOR = 3e-2, 1e-2
# the flash forward's logsumexp against the plain version's: both f32 over
# the same exact products, summed in another order with another exp
LSE_TOL = 1e-4
# fused AdamW, kernel against plain, relative to each buffer's largest
# magnitude: the same f32 elementwise ops, which nvcc may contract to FMAs
ADAMW_TOL = 1e-6
TRAIN_STEPS = 20
TRAIN_BATCH, TRAIN_T = 8, 1024
# peak lr of the train phase: warmup-cosine from 0 over TRAIN_STEPS
# updates (2 warm-up), enough to memorise one batch by more than 1 nat
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
PARITY_LAYERS, PARITY_STEPS = 2, 5
# the generate phase: GEN_ROWS prompts of GEN_MIN..GEN_MAX tokens (numpy
# seed GEN_SEED), left-padded to the longest, GEN_NEW new tokens each;
# the sampled checks take GEN_SAMPLED_NEW
GEN_ROWS, GEN_MIN, GEN_MAX, GEN_NEW, GEN_SEED = 16, 16, 250, 128, 1
GEN_SAMPLED_NEW = 32
# train_parity: gradient leaves kernel vs plain, relative to each leaf's
# largest magnitude, and the losses, relative
GRAD_TOL, LOSS_TOL = 1e-3, 1e-4
ROOT = Path(__file__).resolve().parent
# a spin kernel of this many clock cycles (about 50 ms on an H100) holds
# the stream while the host enqueues the timed calls
SPIN_CYCLES = 100_000_000


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fns, iters: int = 40, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    that cycle through ``fns`` (several input copies keep a working set
    larger than the 50 MB L2 cold, as the serving path finds it). A spin
    kernel holds the stream until the host has enqueued every call, so a
    kernel shorter than its host-side launch is timed on the device alone.
    A call that synchronises inside (a plain version's boolean indexing)
    drains the queue and is timed with its host work."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dt: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dt]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---- phase 3: kernels ------------------------------------------------------

def flash_fault(FA, q, k, v, want, mask):
    """The forward's planted fault: ``want`` with the last 64 query rows of
    (batch 0, head 0) from the plain version with the 32 keys [lo, lo + 32)
    refused, as a kernel that dropped that tile of their walk would give."""
    t, tk = q.shape[2], k.shape[2]
    lo, qs = 32 * (tk // 64), slice(max(t - 64, 0), t)
    keep = want.new_ones(1, tk).float() if mask is None else mask[:1].clone()
    keep[:, lo:lo + 32] = 0
    fault = want.float().clone()
    fault[0, 0, qs] = FA.flash_attention_plain(
        q[:1, :1, qs], k[:1, :1], v[:1, :1], causal=True,
        kv_mask=keep)[0, 0].float()
    return fault


def check_flash(torch, np, FA, dtype, dt):
    """Admission prefill shapes: 8 rows x 12 heads x t = tk = 256 x 64,
    causal with a ragged pad mask (split-head views of a fused QKV, as the
    model passes them), plus a t = 64, tk = 320 bottom-right offset case,
    and the training shape [8, 12, 1024, 64] causal. bf16 must take the
    tensor-core kernel and f32 the CUDA-core one (``_tensor_core_path``),
    a second launch must give the same bits, and ``lse`` must agree with
    the plain version's to LSE_TOL. In bf16 the output is also held row by
    row (``row_err``, ROW_TOL), and the planted fault (``flash_fault``)
    must fail that check."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(1)
    out = {"path": "tensor cores" if dt == "bf16" else "CUDA cores"}

    def check(case, q, k, v, mask):
        kw = {"causal": True, "kv_mask": mask}
        tc0 = FA.tc_launches
        got, lse = FA.flash_fwd(q, k, v, **kw)
        tc = FA.tc_launches - tc0
        want_tc = 1 if dt == "bf16" else 0
        require(tc == want_tc, f"flash {case} {dt}: tensor-core launches "
                               f"{tc}, want {want_tc}")
        again, lse_again = FA.flash_fwd(q, k, v, **kw)
        want, lse_want = FA.flash_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        require(torch.equal(got, again) and torch.equal(lse, lse_again),
                f"flash {case} {dt}: two launches gave different bits")
        require(bool(torch.isfinite(got).all()) and bool(
            torch.isfinite(lse).all()), f"flash {case} {dt}: non-finite")
        err = (got.float() - want.float()).abs().max().item()
        require(err <= TOL[dt], f"flash {case} {dt}: max err {err} > "
                                f"{TOL[dt]}")
        lse_err = (lse - lse_want).abs().max().item()
        require(lse_err <= LSE_TOL, f"flash {case} {dt}: lse err {lse_err} "
                                    f"> {LSE_TOL}")
        out[f"{case}_max_abs_err"] = err
        out[f"{case}_lse_max_abs_err"] = lse_err
        out[f"{case}_tensor_core_launches"] = tc
        out[f"{case}_bit_identical"] = True
        if dt == "bf16":
            r = row_err(got, want)
            f = row_err(flash_fault(FA, q, k, v, want, mask), want)
            require(r <= ROW_TOL, f"flash {case}: row error {r} > {ROW_TOL}")
            require(f > ROW_TOL, f"flash {case}: the planted fault's row "
                                 f"error {f} <= {ROW_TOL}: the row check "
                                 f"cannot see a dropped key tile")
            out[f"{case}_row_err"], out[f"{case}_fault_row_err"] = r, f

    for case, (b, t, tk) in (("prefill", (8, 256, 256)),
                             ("offset", (4, 64, 320))):
        h, d = 12, 64
        q = torch.randn(b, h, t, d, generator=gen).to("cuda", dtype)
        kv = torch.randn(b, tk, 2 * h * d, generator=gen).to("cuda", dtype)
        k = kv[..., :h * d].reshape(b, tk, h, d).transpose(1, 2)
        v = kv[..., h * d:].reshape(b, tk, h, d).transpose(1, 2)
        lengths = torch.randint(tk // 8, tk + 1, (b,), generator=gen)
        lengths[0] = tk
        mask = (torch.arange(tk)[None] < lengths[:, None]).float().cuda()
        check(case, q, k, v, mask)
        if case != "prefill":
            continue
        # data-dependent work: (query, key) pairs the causal rule AND the
        # pad mask allow
        rows = np.arange(t)[:, None] + (tk - t)
        keys = np.arange(tk)[None, :]
        pairs = sum(int(((keys <= rows) & (keys < int(n))).sum())
                    for n in lengths) * h
        # q read and o written whole; K and V only at the keys the pad
        # mask keeps; the f32 mask read, the f32 lse written
        esz = q.element_size()
        nbytes = esz * (2 * b * h * t * d + 2 * h * d * int(lengths.sum())) \
            + 4 * b * tk + 4 * b * h * t
        out["gflop"] = 4 * d * pairs / 1e9
        out["bound_ms"], out["bound_by"] = bound(nbytes, 4 * d * pairs, dt)
        out["ms"] = time_ms(torch, [lambda: FA.flash_fwd(
            q, k, v, causal=True, kv_mask=mask)])
        out["tflops"] = out["gflop"] / out["ms"]
        out["bound_share"] = out["bound_ms"] / out["ms"]
        out["plain_ms"] = time_ms(torch, [lambda: FA.flash_attention_plain(
            q, k, v, causal=True, kv_mask=mask)])
        allowed = (keys <= rows)[None, None] & (
            keys[None] < lengths.numpy()[:, None, None])[:, None]
        attn_mask = torch.from_numpy(allowed).cuda()
        out["library_ms"] = time_ms(torch, [
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   attn_mask=attn_mask)])
        out["shape"] = f"q,k,v [{b}, {h}, {t}, {d}] causal + ragged kv_mask"
    # the training shape: [8, 12, 1024, 64] causal, no mask, split-head
    # views of one fused QKV, as the train phase calls it
    b, t, h, d = TRAIN_BATCH, TRAIN_T, 12, 64
    qkv = torch.randn(b, t, 3 * h * d, generator=gen).to("cuda", dtype)
    q, k, v = (x.reshape(b, t, h, d).transpose(1, 2)
               for x in qkv.split(h * d, dim=-1))
    check("train", q, k, v, None)
    # q, k, v read and o written once, the f32 lse written; causal pairs
    pairs = b * h * t * (t + 1) // 2
    nbytes = q.element_size() * 4 * b * h * t * d + 4 * b * h * t
    out["train_gflop"] = 4 * d * pairs / 1e9
    out["train_bound_ms"], out["train_bound_by"] = bound(nbytes, 4 * d * pairs,
                                                         dt)
    out["train_ms"] = time_ms(torch, [lambda: FA.flash_fwd(
        q, k, v, causal=True)])
    out["train_tflops"] = out["train_gflop"] / out["train_ms"]
    out["train_bound_share"] = out["train_bound_ms"] / out["train_ms"]
    out["train_library_ms"] = time_ms(torch, [
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)])
    out["train_shape"] = f"q, k, v [{b}, {h}, {t}, {d}] causal, fused-QKV views"
    cases = ("prefill", "offset", "train")
    out["max_abs_err"] = max(out[f"{c}_max_abs_err"] for c in cases)
    out["lse_max_abs_err"] = max(out[f"{c}_lse_max_abs_err"] for c in cases)
    if dt == "bf16":
        out["row_err"] = max(out[f"{c}_row_err"] for c in cases)
        out["fault_row_err"] = min(out[f"{c}_fault_row_err"] for c in cases)
    return out


def check_insert(torch, CU, dtype, dt):
    """Pool [2, 1025, 12, 16, 64]: a decode tick's 16 rows (two parked
    rows on the trash block) and one admission wave's flattened scatter
    (16 rows x 256 window, pad tokens aimed out of range)."""
    gen = torch.Generator().manual_seed(2)
    P, H, bt, hd = 1025, 12, 16, 64
    copies = [torch.randn(2, P, H, bt, hd, generator=gen).to("cuda", dtype)
              for _ in range(3)]
    out = {}
    for case, n in (("decode", 16), ("admission", 16 * 256)):
        kv = torch.randn(n, 3 * H * hd, generator=gen).to("cuda", dtype)
        k = kv[:, H * hd:2 * H * hd].reshape(n, H, hd)   # fused-QKV views
        v = kv[:, 2 * H * hd:].reshape(n, H, hd)
        blocks = (torch.randperm(P - 1, generator=gen)[:n] + 1
                  if n < P else torch.randint(1, P, (n,), generator=gen))
        offsets = torch.randint(0, bt, (n,), generator=gen)
        if case == "decode":
            blocks[[3, 11]] = 0                          # parked: trash
            valid = torch.ones(n, dtype=torch.bool)
        else:
            # one token per (block, offset): a real wave never aims two
            # tokens at one slot
            blocks = torch.arange(n) // bt + 1
            offsets = torch.arange(n) % bt
            valid = torch.rand(n, generator=gen) < 0.6
            blocks[~valid] = P                           # pad: dropped
        blocks = blocks.to("cuda", torch.int32)
        offsets = offsets.to("cuda", torch.int32)
        want = CU.kv_pool_insert_plain(copies[0].clone(), k, v, blocks,
                                       offsets)
        got = copies[0].clone()
        CU.kv_pool_insert_cuda(got, k, v, blocks, offsets)
        torch.cuda.synchronize()
        # the trash block takes racing garbage writes: compared elsewhere
        err = (got[:, 1:].float() - want[:, 1:].float()).abs().max().item()
        require(err == 0.0, f"insert {case} {dt}: max err {err} != 0")
        out[f"{case}_max_abs_err"] = err
        if case != "decode":
            continue
        n_valid = int(valid.sum())
        nbytes = 2 * 2 * n_valid * H * hd * got.element_size() + 8 * n
        out["bound_ms"], out["bound_by"] = bound(nbytes, 0.0, dt)
        out["ms"] = time_ms(torch, [
            (lambda c=c: CU.kv_pool_insert_cuda(c, k, v, blocks, offsets))
            for c in copies])
        out["plain_ms"] = time_ms(torch, [
            (lambda c=c: CU.kv_pool_insert_plain(c, k, v, blocks, offsets))
            for c in copies])
        upd = torch.stack([k, v], dim=1)                 # [n, 2, H, hd]
        blk_l, off_l = blocks.long(), offsets.long()

        def index_write(c):
            c[:, blk_l, :, off_l, :] = upd
        out["library_ms"] = time_ms(torch, [
            (lambda c=c: index_write(c)) for c in copies])
        out["shape"] = (f"pool [2, {P}, {H}, {bt}, {hd}], {n} decode rows "
                        f"(2 parked on trash)")
    out["max_abs_err"] = max(out["decode_max_abs_err"],
                             out["admission_max_abs_err"])
    return out


def decode_extras(torch, name, launch, b_ms, ms, grid, launch_min):
    """What every decode check adds: the grid (``split_plan``), the share
    of the bound, two launches' bits compared (gated) and the time of
    ``launch_min``, the same read with every live length at 1 or 0: the
    read's fixed cost."""
    a, b = launch(), launch()
    torch.cuda.synchronize()
    same = bool(torch.equal(a, b))
    require(same, f"{name}: two launches differ")
    return {"grid": grid, "bound_share": b_ms / ms, "same_bits": same,
            "one_key_ms": time_ms(torch, [launch_min])}


def check_decode(torch, np, DA, dtype, dt):
    """16 rows x 12 heads x hd 64 over bt 16, nb 64 tables into a
    [2, 1025, 12, 16, 64] pool: ragged positions, one full-horizon row,
    one parked all-trash row."""
    gen = torch.Generator().manual_seed(3)
    B, H, hd, bt, nb = 16, 12, 64, 16, 64
    P = B * nb + 1
    rng = np.random.default_rng(3)
    table = (rng.permutation(P - 1)[:B * nb] + 1).reshape(B, nb)
    pos = rng.integers(16, nb * bt, B)
    pos[5] = nb * bt - 1
    table[9], pos[9] = 0, 3                               # parked row
    table = torch.from_numpy(table.astype(np.int32)).cuda()
    pos_t = torch.from_numpy(pos.astype(np.int32)).cuda()
    copies = [(torch.randn(B, H, 1, hd, generator=gen).to("cuda", dtype),
               torch.randn(2, P, H, bt, hd, generator=gen).to("cuda", dtype))
              for _ in range(3)]
    q, pool = copies[0]
    got = DA.paged_decode_cuda(q, pool, table, pos_t)
    want = DA.paged_decode_plain(q, pool, table, pos_t)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    require(bool(torch.isfinite(got).all()), f"decode {dt}: non-finite")
    require(err <= TOL[dt], f"decode {dt}: max err {err} > {TOL[dt]}")
    keys = int((np.minimum(pos, nb * bt - 1) + 1).sum())
    live_blocks = int((np.minimum(pos, nb * bt - 1) // bt + 1).sum())
    esz = q.element_size()
    nbytes = (esz * (2 * B * H * hd + 2 * keys * H * hd)
              + 4 * live_blocks + 4 * B)
    b_ms, b_by = bound(nbytes, 4.0 * hd * keys * H, dt)
    ms = time_ms(torch, [
        (lambda q=q, p=p: DA.paged_decode_cuda(q, p, table, pos_t))
        for q, p in copies])
    return {
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by, "ms": ms,
        "plain_ms": time_ms(torch, [
            (lambda q=q, p=p: DA.paged_decode_plain(q, p, table, pos_t))
            for q, p in copies]),
        "library_ms": None,
        "library": "none: no single PyTorch call reads through a block table",
        "shape": (f"q [{B}, {H}, 1, {hd}], pool [2, {P}, {H}, {bt}, {hd}], "
                  f"tables [{B}, {nb}], {keys} live keys"),
        **decode_extras(
            torch, f"decode {dt}",
            lambda: DA.paged_decode_cuda(q, pool, table, pos_t), b_ms, ms,
            DA.split_plan(q, pool, table=table),
            lambda: DA.paged_decode_cuda(q, pool, table,
                                         torch.zeros_like(pos_t))),
    }


def rel_err(got, want) -> float:
    """Max abs error over the larger of 1 and the reference's max abs."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


def row_err(got, want) -> float:
    """The largest, over rows (the last axis), of a row's max abs error
    over that row's max abs reference, the latter floored at ROW_FLOOR of
    the reference's RMS."""
    want = want.float()
    floor = ROW_FLOOR * want.square().mean().sqrt().item()
    return ((got.float() - want).abs().amax(-1)
            / want.abs().amax(-1).clamp(min=floor)).max().item()


def check_flash_bwd(torch, np, FA, dtype, dt):
    """GPT-2-small training shapes: q, k, v, dO [8, 12, 1024, 64], causal;
    q, k and v are split-head views of one fused QKV and dO comes in the
    [b, t, h, d] order ``merge_heads``' backward hands over, as in the
    model. Plus a ragged case: t = 45 < tk = 77, head dim 80, a kv_mask.
    bf16 must take the tensor-core kernels and f32 the CUDA-core ones
    (``_tensor_core_path``), and a second launch on the same inputs must
    give the same bits. In bf16 each output is also held row by row
    (``row_err``, ROW_TOL), and the planted fault (the plain version with
    the last query tile of one head skipping one 32-key tile) must fail
    that check.
    Returns ``{"flash_bwd_dq": {...},
    "flash_bwd_dkv": {...}}``."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(4)
    res = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for case, (b, h, t, tk, d, masked) in (
            ("train", (TRAIN_BATCH, 12, TRAIN_T, TRAIN_T, 64, False)),
            ("ragged", (3, 5, 45, 77, 80, True))):
        def inputs():
            qx = torch.randn(b, t, h * d, generator=gen).to("cuda", dtype)
            kv = torch.randn(b, tk, 2 * h * d, generator=gen).to("cuda", dtype)
            q = qx.reshape(b, t, h, d).transpose(1, 2)
            k = kv[..., :h * d].reshape(b, tk, h, d).transpose(1, 2)
            v = kv[..., h * d:].reshape(b, tk, h, d).transpose(1, 2)
            do = torch.randn(b, t, h, d, generator=gen).to(
                "cuda", dtype).transpose(1, 2)
            return q, k, v, do
        mask = None
        if masked:
            lengths = torch.randint(1, tk + 1, (b,), generator=gen)
            lengths[0] = tk
            mask = (torch.arange(tk)[None] < lengths[:, None]).float().cuda()
        kw = {"causal": True, "kv_mask": mask}
        copies = []
        for _ in range(2):      # two copies: a working set past the L2
            q, k, v, do = inputs()
            o, lse = FA.flash_fwd(q, k, v, **kw)
            delta = (do.float() * o.float()).sum(-1)
            copies.append((q, k, v, do, lse, delta))
        q, k, v, do, lse, delta = copies[0]
        tc0 = (FA.dq_tc_launches, FA.dkv_tc_launches)
        dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        tc = (FA.dq_tc_launches - tc0[0], FA.dkv_tc_launches - tc0[1])
        want_tc = (1, 1) if dt == "bf16" else (0, 0)
        require(tc == want_tc, f"flash bwd {case} {dt}: tensor-core "
                               f"launches {tc}, want {want_tc}")
        again = (FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                 *FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
        want = FA.flash_bwd_plain(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        for name, g, g2 in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
            require(torch.equal(g, g2), f"flash bwd {case} {dt}: two "
                                        f"launches gave different {name}")
        del again
        # the planted fault: the last query tile of (batch 0, head 0)
        # skips the key tile [lo, lo + 32), as a kernel that dropped one
        # tile of its walk would: those rows' dq lose those keys, and
        # those keys' dk and dv lose those rows
        lo, qs = 32 * (tk // 64), slice(max(t - 64, 0), t)
        sub = (q[:1, :1, qs], k[:1, :1], v[:1, :1], do[:1, :1, qs],
               lse[:1, :1, qs], delta[:1, :1, qs])
        keep = (torch.ones(1, tk, device="cuda") if mask is None
                else mask[:1].clone())
        skip = keep.clone()
        skip[:, lo:lo + 32] = 0
        part = FA.flash_bwd_plain(*sub, causal=True, kv_mask=keep)
        fault = [w.float().clone() for w in want]
        fault[0][0, 0, qs] = FA.flash_bwd_plain(
            *sub, causal=True, kv_mask=skip)[0][0, 0].float()
        for f, p in zip(fault[1:], part[1:]):
            f[0, 0, lo:lo + 32] -= p[0, 0, lo:lo + 32].float()
        errs = {}
        for name, g, w, f in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                                 fault):
            require(bool(torch.isfinite(g).all()),
                    f"flash bwd {case} {dt}: non-finite {name}")
            errs[name] = (rel_err(g, w),
                          (g.float() - w.float()).abs().max().item(),
                          row_err(g, w), row_err(f, w), rel_err(f, w))
            require(errs[name][0] <= TOL[dt],
                    f"flash bwd {case} {dt}: {name} error {errs[name][0]} "
                    f"> {TOL[dt]} (relative to max(1, max|plain|))")
            if dt == "bf16":
                require(errs[name][2] <= ROW_TOL,
                        f"flash bwd {case}: {name} row error "
                        f"{errs[name][2]} > {ROW_TOL}")
                require(errs[name][3] > ROW_TOL,
                        f"flash bwd {case}: the planted fault's {name} row "
                        f"error {errs[name][3]} <= {ROW_TOL}: the row check "
                        f"cannot see a dropped key tile")
        del fault, part
        for i, (kern, names) in enumerate((("flash_bwd_dq", ("dq",)),
                                           ("flash_bwd_dkv", ("dk", "dv")))):
            r = res[kern]
            for j, key in enumerate(("rel_err", "max_abs_err", "row_err")):
                r[f"{case}_{key}"] = max(errs[n][j] for n in names)
            # the fault is held by its least visible output
            r[f"{case}_fault_row_err"] = min(errs[n][3] for n in names)
            r[f"{case}_fault_rel_err"] = min(errs[n][4] for n in names)
            r[f"{case}_tensor_core_launches"] = tc[i]
            r[f"{case}_bit_identical"] = True
        if case != "train":
            continue
        # causal: query row i attends keys 0..i (t = tk)
        pairs = b * h * t * (t + 1) // 2
        esz = q.element_size()
        io = esz * 4 * b * h * t * d + 4 * 2 * b * h * t   # q k v dO, lse delta
        plain_ms = time_ms(torch, [
            (lambda c=c: FA.flash_bwd_plain(*c, **kw)) for c in copies],
            iters=10)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qg, kg, vg), do)
        lib_ms = time_ms(torch, [sdpa_fwd_bwd]) - time_ms(torch, [sdpa])
        for kern, products, out_bytes, fn in (
                ("flash_bwd_dq", 3, esz * b * h * t * d, FA.flash_bwd_dq),
                ("flash_bwd_dkv", 4, esz * 2 * b * h * tk * d,
                 FA.flash_bwd_dkv)):
            r = res[kern]
            r["bound_ms"], r["bound_by"] = bound(io + out_bytes,
                                                 products * 2 * d * pairs, dt)
            r["gflop"] = products * 2 * d * pairs / 1e9
            r["ms"] = time_ms(torch, [(lambda c=c, fn=fn: fn(*c, **kw))
                                      for c in copies])
            r["tflops"] = r["gflop"] / r["ms"]
            r["bound_share"] = r["bound_ms"] / r["ms"]
            r["path"] = "tensor cores" if dt == "bf16" else "CUDA cores"
            r["plain_ms"] = plain_ms
            r["plain"] = "flash_bwd_plain (dq, dk and dv together)"
            r["library_ms"] = lib_ms
            r["library"] = ("autograd of F.scaled_dot_product_attention "
                            "(fwd+bwd minus fwd; dq, dk and dv together)")
            r["shape"] = (f"q, k, v, dO [{b}, {h}, {t}, {d}] causal; "
                          f"ragged: [3, 5, 45|77, 80] causal + kv_mask")
    for r in res.values():
        r["max_abs_err"] = max(r["train_max_abs_err"],
                               r["ragged_max_abs_err"])
        r["rel_err"] = max(r["train_rel_err"], r["ragged_rel_err"])
        r["row_err"] = max(r["train_row_err"], r["ragged_row_err"])
        r["fault_row_err"] = min(r["train_fault_row_err"],
                                 r["ragged_fault_row_err"])
    return res


def check_adamw(torch, FAW, GPT2, GPT2Config):
    """Every leaf of GPT-2-small (148 leaves, 124,439,808 f32 parameters)
    laid out by ``FusedAdamW.init`` as flat buffers; three steps of the
    kernel against ``fused_adamw_plain`` on the same buffers, the step
    scalars computed from the device count (which the kernel advances);
    timed with the scalars of the count then reached."""
    model = GPT2(GPT2Config.small()).init(torch.Generator().manual_seed(5))
    params = dict(model.named_parameters())
    tx = FAW.fused_adamw(1e-3, weight_decay=0.01)
    state = tx.init(params)
    n = state.params.numel()
    require(len(params) == 148, f"adamw: {len(params)} leaves, want 148")
    gen = torch.Generator(device="cuda").manual_seed(5)
    want = [state.params.clone(), state.mu.clone(), state.nu.clone()]
    grads = {k: p.grad for k, p in params.items()}
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    for _ in range(3):
        state.grads.copy_(torch.randn(n, generator=gen, device="cuda"))
        sc = tx.scalars(state.count)
        want = list(FAW.fused_adamw_plain(state.grads, *want, sc, ok,
                                          **tx.hyper))
        tx.fused_apply(grads, state, params, ok)
    torch.cuda.synchronize()
    require(int(state.count) == 3, f"adamw: device count {int(state.count)}"
                                   f" after 3 updates")
    err = 0.0
    for name, got, w in zip(("p", "mu", "nu"),
                            (state.params, state.mu, state.nu), want):
        e = ((got - w).abs().max() / w.abs().max()).item()
        require(e <= ADAMW_TOL, f"adamw {name}: relative error {e} > "
                                f"{ADAMW_TOL}")
        err = max(err, (got - w).abs().max().item())
    sc = tx.scalars(state.count)
    ms = time_ms(torch, [lambda: FAW.fused_adamw_update(
        state.grads, state.params, state.mu, state.nu, sc, state.count, ok,
        **tx.hyper)], iters=20)
    plain_ms = time_ms(torch, [lambda: FAW.fused_adamw_plain(
        state.grads, state.params, state.mu, state.nu, sc, ok,
        **tx.hyper)], iters=10)
    leaves = [p.detach().clone().requires_grad_() for p in params.values()]
    for leaf, p in zip(leaves, params.values()):
        leaf.grad = p.grad.clone()
    opt = torch.optim.AdamW(leaves, lr=1e-3, weight_decay=0.01, fused=True)
    lib_ms = time_ms(torch, [opt.step], iters=20)
    b_ms, b_by = bound(28.0 * n, 15.0 * n, "f32")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library": "torch.optim.AdamW(fused=True).step() over the 148 "
                       "leaves",
            "params": n, "leaves": len(params),
            "shape": f"flat f32 [{n}] (GPT-2-small, 148 leaves), 3 steps"}


def gen_batch(np, vocab: int):
    """The generate phase's traffic: ``(lengths, prompt [16, T0], mask
    [16, T0])``, left-padded to the longest prompt ``T0``."""
    rng = np.random.default_rng(GEN_SEED)
    lens = rng.integers(GEN_MIN, GEN_MAX + 1, GEN_ROWS)
    T0 = int(lens.max())
    prompt = np.zeros((GEN_ROWS, T0), np.int64)
    mask = np.zeros((GEN_ROWS, T0), np.int64)
    for i, n in enumerate(lens):
        prompt[i, T0 - n:] = rng.integers(0, vocab, n)
        mask[i, T0 - n:] = 1
    return lens, prompt, mask


def check_dense_insert(torch, CU, A, dtype, dt, T0):
    """The generate phase's pair cache ``[2, 16, 12, T0 + 128, 64]``, the
    updates strided split-head views of one fused QKV: ``kv_insert`` at a
    0-dim slot (first, interior, last), ``kv_insert_rows`` at per-row slots
    (0, T - 1 and interior ones), ``cache_insert`` into one plane. Exact.
    Returns ``{"cache_insert": {...}, "kv_insert": {...},
    "kv_insert_rows": {...}}``."""
    gen = torch.Generator().manual_seed(12)
    B, H, hd, T = GEN_ROWS, 12, 64, T0 + GEN_NEW
    copies = [torch.randn(2, B, H, T, hd, generator=gen).to("cuda", dtype)
              for _ in range(3)]
    qkv = torch.randn(B, 1, 3 * H * hd, generator=gen).to("cuda", dtype)
    _, k, v = (A.split_heads(x, H) for x in qkv.split(H * hd, dim=-1))
    slots = torch.arange(T, dtype=torch.int32, device="cuda")
    rows = torch.randint(T0, T, (B,), generator=gen, dtype=torch.int32)
    rows[0], rows[1] = 0, T - 1
    rows = rows.cuda()
    # the library calls' operands, made once outside the timed calls
    kv_upd = torch.stack([k, v])                      # [2, B, H, 1, hd]
    rows_upd = kv_upd[:, :, :, 0].transpose(0, 1)     # [B, 2, H, hd]
    b_idx, rows_l = torch.arange(B, device="cuda"), rows.long()
    slot_l = slots[T0:T0 + 1].long()
    esz = copies[0].element_size()
    base = copies[0].clone()    # the timing loops below write the copies
    res = {}
    for name, cases, planes, launch, plain, library, lib_name in (
            ("kv_insert", [slots[0], slots[T0], slots[T - 1]], 2,
             lambda c, p: CU.kv_insert_cuda(c, k, v, p),
             lambda c, p: CU.kv_insert_plain(c, k, v, p),
             lambda c, p: c.index_copy_(3, slot_l, kv_upd),
             "cache.index_copy_(3, pos, stack([k, v]))"),
            ("kv_insert_rows", [rows], 2,
             lambda c, p: CU.kv_insert_rows_cuda(c, k, v, p),
             lambda c, p: CU.kv_insert_plain(c, k, v, p),
             lambda c, p: c.__setitem__(
                 (slice(None), b_idx, slice(None), rows_l), rows_upd),
             "cache[:, arange(B), :, pos] = stack([k, v])"),
            ("cache_insert", [slots[T0]], 1,
             lambda c, p: CU.cache_insert_cuda(c[0], k, p),
             lambda c, p: CU.cache_insert_plain(c[0], k, p),
             lambda c, p: c[0].index_copy_(2, slot_l, k),
             "cache.index_copy_(2, pos, k)")):
        err = 0.0
        for p in cases:
            got, want = base.clone(), base.clone()
            launch(got, p)
            plain(want, p)
            torch.cuda.synchronize()
            err = max(err, (got.float() - want.float()).abs().max().item())
            require(not torch.equal(got, base),
                    f"{name} {dt}: nothing was written")
        require(err == 0.0, f"{name} {dt}: max err {err} != 0")
        p = cases[-1] if name != "kv_insert" else cases[1]   # = slot_l
        # each written element read once from the update and written once;
        # the position read once (one int, or one per row)
        n_pos = B if name == "kv_insert_rows" else 1
        nbytes = 2 * planes * B * H * hd * esz + 4 * n_pos
        b_ms, b_by = bound(nbytes, 0.0, dt)
        res[name] = {
            "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(torch, [(lambda c=c: launch(c, p)) for c in copies]),
            "plain_ms": time_ms(torch, [(lambda c=c: plain(c, p))
                                        for c in copies]),
            "library_ms": time_ms(torch, [(lambda c=c: library(c, p))
                                          for c in copies]),
            "library": lib_name,
            "shape": (f"cache [{planes}, {B}, {H}, {T}, {hd}] "
                      f"{'(one plane)' if planes == 1 else ''}, updates "
                      f"[{B}, {H}, 1, {hd}] split-head views"),
        }
    return res


def check_dense_decode(torch, np, DA, A, dtype, dt, lens):
    """The generate phase's read: q ``[16, 12, 1, 64]`` (a split-head view)
    over the pair cache ``[2, 16, Hk, T0 + 128, 64]`` at a mid-generation
    lockstep slot and at per-row slots, with and without the left-pad
    slot mask (pad runs of up to T0 - 16 slots, many whole 32-key chunks),
    MHA (Hk 12) and 4 query heads per kv head (Hk 3); to TOL. Timed at the
    generate tick's own call: MHA, lockstep, masked."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(13)
    T0 = int(lens.max())
    B, H, hd, T = GEN_ROWS, 12, 64, T0 + GEN_NEW
    slots = torch.arange(T, dtype=torch.int32, device="cuda")
    pos = T0 + GEN_NEW // 2
    mask_np = np.arange(T)[None, :] >= (T0 - lens)[:, None]       # [B, T]
    mask = torch.from_numpy(mask_np).cuda()
    rows = torch.randint(T0, T, (B,), generator=gen, dtype=torch.int32)
    rows[0] = T - 1
    rows = rows.cuda()
    out, err = {}, 0.0
    for hk in (H, H // 4):
        copies = []
        for _ in range(3):
            qx = torch.randn(B, 1, 3 * H * hd, generator=gen).to("cuda", dtype)
            copies.append((A.split_heads(qx[..., :H * hd], H),
                           torch.randn(2, B, hk, T, hd, generator=gen).to(
                               "cuda", dtype)))
        q, cache = copies[0]
        for p in (slots[pos], rows):
            for m in (None, mask):
                got = DA.dense_decode_cuda(q, cache, p, slot_mask=m)
                want = DA.dense_decode_plain(q, cache, p, slot_mask=m)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(got).all()),
                        f"dense_decode {dt} Hk {hk}: non-finite")
                e = (got.float() - want.float()).abs().max().item()
                require(e <= TOL[dt], f"dense_decode {dt} Hk {hk}: max err "
                                      f"{e} > {TOL[dt]}")
                err = max(err, e)
        if hk != H:
            continue
        p = slots[pos]
        # what this call's data needs: each row's unmasked slots 0..pos
        keys = int(mask_np[:, :pos + 1].sum())
        esz = q.element_size()
        nbytes = (esz * (2 * B * H * hd + 2 * keys * hk * hd) + B * T + 4)
        out["bound_ms"], out["bound_by"] = bound(nbytes, 4.0 * hd * keys * H,
                                                 dt)
        out["ms"] = time_ms(torch, [
            (lambda q=q, c=c: DA.dense_decode_cuda(q, c, p, slot_mask=mask))
            for q, c in copies])
        out["plain_ms"] = time_ms(torch, [
            (lambda q=q, c=c: DA.dense_decode_plain(q, c, p, slot_mask=mask))
            for q, c in copies])
        out.update(decode_extras(
            torch, f"dense_decode {dt}",
            lambda: DA.dense_decode_cuda(q, cache, p, slot_mask=mask),
            out["bound_ms"], out["ms"], DA.split_plan(q, cache),
            lambda: DA.dense_decode_cuda(q, cache, slots[0], slot_mask=mask)))
        valid = ((slots <= pos) & mask)[:, None, None, :]
        out["library_ms"] = time_ms(torch, [
            (lambda q=q, c=c: F.scaled_dot_product_attention(
                q, c[0], c[1], attn_mask=valid)) for q, c in copies])
        out["library"] = ("F.scaled_dot_product_attention(q, k, v, "
                          "attn_mask=<bool [B, 1, 1, T] valid mask>)")
        out["shape"] = (f"q [{B}, {H}, 1, {hd}] view, cache [2, {B}, {H}, "
                        f"{T}, {hd}], lockstep pos {pos}, left-pad slot "
                        f"mask: {keys} of {B * (pos + 1)} slots live; also "
                        f"Hk {H // 4}, per-row pos, no mask")
    out["max_abs_err"] = err
    return out


# ---- phase 3, int8 forms: the quantizing writes and the int8 reads ----------

Q8_LIBRARY = ("none: no single PyTorch call quantizes per row and writes at "
              "a slot, or reads int8 K/V with per-row scales")


def q8_cache(torch, gen, *shape, copies: int = 1):
    """``copies`` int8 caches and their f32 scale planes: ``quantize_kv`` of
    normal floats, as the writes leave them."""
    from distributed_compute_pytorch_tpu_torch.utils.quantize import (
        quantize_kv)
    out = []
    for _ in range(copies):
        kv, sc = quantize_kv(torch.randn(*shape, generator=gen))
        out.append((kv.cuda(), sc.cuda()))
    return out


def check_insert_q8(torch, CU, dtype, dt):
    """The int8 pool [2, 1025, 12, 16, 64] with its scales: a decode tick's
    16 float rows (two parked on the trash block) and one admission wave's
    flattened scatter (16 rows x 256 window, pad tokens aimed out of
    range), quantized as they are written. Both leaves exact against
    ``quantize_kv`` followed by the indexed writes."""
    gen = torch.Generator().manual_seed(32)
    P, H, bt, hd = 1025, 12, 16, 64
    copies = q8_cache(torch, gen, 2, P, H, bt, hd, copies=3)
    out = {}
    for case, n in (("decode", 16), ("admission", 16 * 256)):
        kv = torch.randn(n, 3 * H * hd, generator=gen).to("cuda", dtype)
        k = kv[:, H * hd:2 * H * hd].reshape(n, H, hd)   # fused-QKV views
        v = kv[:, 2 * H * hd:].reshape(n, H, hd)
        if case == "decode":
            blocks = torch.randperm(P - 1, generator=gen)[:n] + 1
            offsets = torch.randint(0, bt, (n,), generator=gen)
            blocks[[3, 11]] = 0                          # parked: trash
            n_valid = n
        else:
            blocks = torch.arange(n) // bt + 1
            offsets = torch.arange(n) % bt
            valid = torch.rand(n, generator=gen) < 0.6
            blocks[~valid] = P                           # pad: dropped
            n_valid = int(valid.sum())
        blocks = blocks.to("cuda", torch.int32)
        offsets = offsets.to("cuda", torch.int32)
        pool, scale = copies[0]
        want = (pool.clone(), scale.clone())
        CU.kv_pool_insert_plain(want[0], k, v, blocks, offsets, want[1])
        got = (pool.clone(), scale.clone())
        CU.kv_pool_insert_cuda(got[0], k, v, blocks, offsets, scale=got[1])
        torch.cuda.synchronize()
        # the trash block takes racing garbage writes: compared elsewhere
        bad = int((got[0][:, 1:] != want[0][:, 1:]).sum()
                  + (got[1][:, 1:] != want[1][:, 1:]).sum())
        require(bad == 0, f"insert_q8 {case} {dt}: {bad} elements differ "
                          f"from quantize-then-write")
        require(not torch.equal(got[0], pool), f"insert_q8 {case} {dt}: "
                                               f"nothing was written")
        out[f"{case}_elements_differing"] = bad
        if case != "decode":
            continue
        # the float rows read once, the int8 bytes and f32 scales written
        # once, the block ids and offsets read once
        nbytes = (2 * n_valid * H * (hd * k.element_size() + hd + 4)
                  + 8 * n)
        out["bound_ms"], out["bound_by"] = bound(nbytes, 0.0, dt)
        out["ms"] = time_ms(torch, [
            (lambda c=c: CU.kv_pool_insert_cuda(c[0], k, v, blocks, offsets,
                                                scale=c[1]))
            for c in copies])
        out["plain_ms"] = time_ms(torch, [
            (lambda c=c: CU.kv_pool_insert_plain(c[0], k, v, blocks, offsets,
                                                 c[1])) for c in copies])
        out["library_ms"], out["library"] = None, Q8_LIBRARY
        out["shape"] = (f"int8 pool [2, {P}, {H}, {bt}, {hd}] + f32 scales, "
                        f"{n} float decode rows (2 parked on trash)")
    out["max_abs_err"] = 0.0
    return out


def check_decode_q8(torch, np, DA, dtype, dt):
    """The int8 paged read at the serving shape: as ``check_decode`` (16
    rows x 12 heads x hd 64 over bt 16, nb 64 tables, ragged positions, a
    full-horizon row, a parked row) over an int8 pool and its scales; to
    TOL, and in bf16 row by row to ROW_TOL."""
    gen = torch.Generator().manual_seed(33)
    B, H, hd, bt, nb = 16, 12, 64, 16, 64
    P = B * nb + 1
    rng = np.random.default_rng(3)
    table = (rng.permutation(P - 1)[:B * nb] + 1).reshape(B, nb)
    pos = rng.integers(16, nb * bt, B)
    pos[5] = nb * bt - 1
    table[9], pos[9] = 0, 3                               # parked row
    table = torch.from_numpy(table.astype(np.int32)).cuda()
    pos_t = torch.from_numpy(pos.astype(np.int32)).cuda()
    pools = q8_cache(torch, gen, 2, P, H, bt, hd, copies=3)
    copies = [(torch.randn(B, H, 1, hd, generator=gen).to("cuda", dtype),
               kv, sc) for kv, sc in pools]
    q, pool, scale = copies[0]
    got = DA.paged_decode_cuda(q, pool, table, pos_t, kv_scale=scale)
    want = DA.paged_decode_plain(q, pool, table, pos_t, kv_scale=scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    r_err = row_err(got, want)
    require(bool(torch.isfinite(got).all()), f"decode_q8 {dt}: non-finite")
    require(err <= TOL[dt], f"decode_q8 {dt}: max err {err} > {TOL[dt]}")
    require(dt != "bf16" or r_err <= ROW_TOL,
            f"decode_q8 {dt}: row error {r_err} > {ROW_TOL}")
    keys = int((np.minimum(pos, nb * bt - 1) + 1).sum())
    live_blocks = int((np.minimum(pos, nb * bt - 1) // bt + 1).sum())
    esz = q.element_size()
    # q read and o written; each live key's int8 K and V rows and their two
    # f32 scales read once; the table entries and positions read once
    nbytes = (esz * 2 * B * H * hd + 2 * keys * H * (hd + 4)
              + 4 * live_blocks + 4 * B)
    b_ms, b_by = bound(nbytes, 4.0 * hd * keys * H, dt)
    ms = time_ms(torch, [
        (lambda q=q, p=p, s=s: DA.paged_decode_cuda(q, p, table, pos_t,
                                                    kv_scale=s))
        for q, p, s in copies])
    return {
        "max_abs_err": err, "row_err": r_err, "bound_ms": b_ms,
        "bound_by": b_by, "ms": ms,
        "plain_ms": time_ms(torch, [
            (lambda q=q, p=p, s=s: DA.paged_decode_plain(q, p, table, pos_t,
                                                         kv_scale=s))
            for q, p, s in copies]),
        "library_ms": None, "library": Q8_LIBRARY,
        "pool_bytes_per_key": 2 * H * (hd + 4),
        "shape": (f"q [{B}, {H}, 1, {hd}], int8 pool [2, {P}, {H}, {bt}, "
                  f"{hd}] + f32 scales, tables [{B}, {nb}], {keys} live "
                  f"keys"),
        **decode_extras(
            torch, f"decode_q8 {dt}",
            lambda: DA.paged_decode_cuda(q, pool, table, pos_t,
                                         kv_scale=scale), b_ms, ms,
            DA.split_plan(q, pool, table=table, kv_scale=scale),
            lambda: DA.paged_decode_cuda(q, pool, table,
                                         torch.zeros_like(pos_t),
                                         kv_scale=scale)),
    }


def check_dense_insert_q8(torch, CU, A, dtype, dt, T0):
    """The generate phase's int8 pair cache ``[2, 16, 12, T0 + 128, 64]``
    with its scales, the float updates strided split-head views of one
    fused QKV: ``kv_insert`` at a 0-dim slot (first, interior, last),
    ``kv_insert_rows`` at per-row slots, ``cache_insert`` into one plane.
    Both leaves exact. Returns ``{"cache_insert_q8": {...}, ...}``."""
    gen = torch.Generator().manual_seed(34)
    B, H, hd, T = GEN_ROWS, 12, 64, T0 + GEN_NEW
    copies = q8_cache(torch, gen, 2, B, H, T, hd, copies=3)
    qkv = torch.randn(B, 1, 3 * H * hd, generator=gen).to("cuda", dtype)
    _, k, v = (A.split_heads(x, H) for x in qkv.split(H * hd, dim=-1))
    slots = torch.arange(T, dtype=torch.int32, device="cuda")
    rows = torch.randint(T0, T, (B,), generator=gen, dtype=torch.int32)
    rows[0], rows[1] = 0, T - 1
    rows = rows.cuda()
    esz = k.element_size()
    base = (copies[0][0].clone(), copies[0][1].clone())
    res = {}
    for name, cases, planes, launch, plain in (
            ("kv_insert_q8", [slots[0], slots[T0], slots[T - 1]], 2,
             lambda c, s, p: CU.kv_insert_cuda(c, k, v, p, scale=s),
             lambda c, s, p: CU.kv_insert_plain(c, k, v, p, s)),
            ("kv_insert_rows_q8", [rows], 2,
             lambda c, s, p: CU.kv_insert_rows_cuda(c, k, v, p, scale=s),
             lambda c, s, p: CU.kv_insert_plain(c, k, v, p, s)),
            ("cache_insert_q8", [slots[T0]], 1,
             lambda c, s, p: CU.cache_insert_cuda(c[0], k, p, scale=s[0]),
             lambda c, s, p: CU.cache_insert_plain(c[0], k, p, s[0]))):
        bad = 0
        for p in cases:
            got = (base[0].clone(), base[1].clone())
            want = (base[0].clone(), base[1].clone())
            launch(*got, p)
            plain(*want, p)
            torch.cuda.synchronize()
            bad += int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
            require(not torch.equal(got[0], base[0]),
                    f"{name} {dt}: nothing was written")
        require(bad == 0, f"{name} {dt}: {bad} elements differ from "
                          f"quantize-then-write")
        p = cases[-1] if name != "kv_insert_q8" else cases[1]
        n_pos = B if name == "kv_insert_rows_q8" else 1
        # each update element read once (float), its int8 byte and its
        # row's f32 scale written once, the position read once
        nbytes = planes * B * H * (hd * esz + hd + 4) + 4 * n_pos
        b_ms, b_by = bound(nbytes, 0.0, dt)
        res[name] = {
            "max_abs_err": 0.0, "elements_differing": bad, "bound_ms": b_ms,
            "bound_by": b_by,
            "ms": time_ms(torch, [(lambda c=c: launch(*c, p))
                                  for c in copies]),
            "plain_ms": time_ms(torch, [(lambda c=c: plain(*c, p))
                                        for c in copies]),
            "library_ms": None, "library": Q8_LIBRARY,
            "shape": (f"int8 cache [{planes}, {B}, {H}, {T}, {hd}] + f32 "
                      f"scales{' (one plane)' if planes == 1 else ''}, float "
                      f"updates [{B}, {H}, 1, {hd}] split-head views"),
        }
    return res


def check_dense_decode_q8(torch, np, DA, A, dtype, dt, lens):
    """The generate phase's int8 read: q ``[16, 12, 1, 64]`` (a split-head
    view) over the int8 pair cache ``[2, 16, Hk, T0 + 128, 64]`` and its
    scales, lockstep and per-row slots, with and without the left-pad slot
    mask, MHA and Hk 3; to TOL, and in bf16 row by row to ROW_TOL. Timed at
    the generate tick's own call: MHA, lockstep, masked."""
    gen = torch.Generator().manual_seed(35)
    T0 = int(lens.max())
    B, H, hd, T = GEN_ROWS, 12, 64, T0 + GEN_NEW
    slots = torch.arange(T, dtype=torch.int32, device="cuda")
    pos = T0 + GEN_NEW // 2
    mask_np = np.arange(T)[None, :] >= (T0 - lens)[:, None]       # [B, T]
    mask = torch.from_numpy(mask_np).cuda()
    rows = torch.randint(T0, T, (B,), generator=gen, dtype=torch.int32)
    rows[0] = T - 1
    rows = rows.cuda()
    out, err, r_err = {}, 0.0, 0.0
    for hk in (H, H // 4):
        copies = []
        for kv, sc in q8_cache(torch, gen, 2, B, hk, T, hd, copies=3):
            qx = torch.randn(B, 1, 3 * H * hd, generator=gen).to("cuda", dtype)
            copies.append((A.split_heads(qx[..., :H * hd], H), kv, sc))
        q, cache, scale = copies[0]
        for p in (slots[pos], rows):
            for m in (None, mask):
                got = DA.dense_decode_cuda(q, cache, p, slot_mask=m,
                                           kv_scale=scale)
                want = DA.dense_decode_plain(q, cache, p, slot_mask=m,
                                             kv_scale=scale)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(got).all()),
                        f"dense_decode_q8 {dt} Hk {hk}: non-finite")
                e, r = ((got.float() - want.float()).abs().max().item(),
                        row_err(got, want))
                require(e <= TOL[dt], f"dense_decode_q8 {dt} Hk {hk}: max "
                                      f"err {e} > {TOL[dt]}")
                require(dt != "bf16" or r <= ROW_TOL,
                        f"dense_decode_q8 {dt} Hk {hk}: row error {r} > "
                        f"{ROW_TOL}")
                err, r_err = max(err, e), max(r_err, r)
        if hk != H:
            continue
        p = slots[pos]
        keys = int(mask_np[:, :pos + 1].sum())
        esz = q.element_size()
        # q read and o written; each live slot's int8 K and V rows and two
        # f32 scales read once; the mask and the position read once
        nbytes = (esz * 2 * B * H * hd + 2 * keys * hk * (hd + 4) + B * T
                  + 4)
        out["bound_ms"], out["bound_by"] = bound(nbytes, 4.0 * hd * keys * H,
                                                 dt)
        out["ms"] = time_ms(torch, [
            (lambda q=q, c=c, s=s: DA.dense_decode_cuda(
                q, c, p, slot_mask=mask, kv_scale=s)) for q, c, s in copies])
        out["plain_ms"] = time_ms(torch, [
            (lambda q=q, c=c, s=s: DA.dense_decode_plain(
                q, c, p, slot_mask=mask, kv_scale=s)) for q, c, s in copies])
        out.update(decode_extras(
            torch, f"dense_decode_q8 {dt}",
            lambda: DA.dense_decode_cuda(q, cache, p, slot_mask=mask,
                                         kv_scale=scale),
            out["bound_ms"], out["ms"],
            DA.split_plan(q, cache, kv_scale=scale),
            lambda: DA.dense_decode_cuda(q, cache, slots[0], slot_mask=mask,
                                         kv_scale=scale)))
        out["library_ms"], out["library"] = None, Q8_LIBRARY
        out["shape"] = (f"q [{B}, {H}, 1, {hd}] view, int8 cache [2, {B}, "
                        f"{H}, {T}, {hd}] + f32 scales, lockstep pos {pos}, "
                        f"left-pad slot mask: {keys} of {B * (pos + 1)} "
                        f"slots live; also Hk {H // 4}, per-row pos, no mask")
    out["max_abs_err"], out["row_err"] = err, r_err
    return out


def check_decode_long(torch, A, CU, DA, dtype, dt):
    """The paged read, float and int8, and the fused serving tick
    (``paged_decode_write``, float and int8) at one long context: 2 rows x
    12 heads x hd 64 over 4096 live keys each (bt 16, nb 256), where one
    block per (row, kv head) made 24 blocks. Gated on correctness only:
    TOL (and ROW_TOL for the bf16 int8 forms) and two launches' bits (the
    fused tick also the cache and the pair's bits, ``check_fused``); timed
    and reported."""
    gen = torch.Generator().manual_seed(36)
    B, H, hd, bt, nb = 2, 12, 64, 16, 256
    P = B * nb + 1
    table = (torch.randperm(P - 1, generator=gen)[:B * nb] + 1).reshape(
        B, nb).to("cuda", torch.int32)
    pos = torch.full((B,), nb * bt - 1, dtype=torch.int32, device="cuda")
    keys = B * nb * bt
    esz = torch.tensor([], dtype=dtype).element_size()
    out = {}
    for name, pools in (
            ("paged_decode", [(torch.randn(2, P, H, bt, hd, generator=gen).to(
                "cuda", dtype), None) for _ in range(3)]),
            ("paged_decode_q8", q8_cache(torch, gen, 2, P, H, bt, hd,
                                         copies=3))):
        qs = [torch.randn(B, H, 1, hd, generator=gen).to("cuda", dtype)
              for _ in pools]
        q, (pool, scale) = qs[0], pools[0]
        got = DA.paged_decode_cuda(q, pool, table, pos, kv_scale=scale)
        want = DA.paged_decode_plain(q, pool, table, pos, kv_scale=scale)
        torch.cuda.synchronize()
        err, r_err = (got.float() - want.float()).abs().max().item(), \
            row_err(got, want)
        require(bool(torch.isfinite(got).all()) and err <= TOL[dt] and (
            dt != "bf16" or scale is None or r_err <= ROW_TOL),
            f"{name} long {dt}: max err {err}, row error {r_err}")
        kind = "" if scale is None else "int8 "
        row = hd * esz if scale is None else hd + 4
        nbytes = esz * 2 * B * H * hd + 2 * keys * H * row + 4 * B * nb + 4 * B
        b_ms, b_by = bound(nbytes, 4.0 * hd * keys * H, dt)
        ms = time_ms(torch, [
            (lambda q=q, p=p: DA.paged_decode_cuda(q, p[0], table, pos,
                                                   kv_scale=p[1]))
            for q, p in zip(qs, pools)])
        out[name] = {
            "max_abs_err": err, "tol": TOL[dt], "bound_ms": b_ms,
            "bound_by": b_by, "ms": ms,
            **decode_extras(
                torch, f"{name} long {dt}",
                lambda q=q, pool=pool, scale=scale: DA.paged_decode_cuda(
                    q, pool, table, pos, kv_scale=scale), b_ms, ms,
                DA.split_plan(q, pool, table=table, kv_scale=scale),
                lambda q=q, pool=pool, scale=scale: DA.paged_decode_cuda(
                    q, pool, table, torch.zeros_like(pos), kv_scale=scale)),
            "shape": (f"q [{B}, {H}, 1, {hd}], {kind}pool [2, {P}, {H}, "
                      f"{bt}, {hd}], tables [{B}, {nb}], {keys} live keys"),
        }
    for q8 in (False, True):
        name = "paged_decode_write" + ("_q8" if q8 else "")
        caches, rows, (fused, pair, read, plain) = paged_tick(
            torch, A, CU, DA, gen, dtype, q8, P, H, bt, hd, table, pos)
        res = check_fused(torch, f"{name} long", dt, fused, pair, plain,
                          caches[0], [0, 1])
        row = hd * esz if not q8 else hd + 4
        nbytes = (esz * 2 * B * H * hd + 2 * keys * H * row + 4 * B * nb
                  + 4 * B) + (2 * B * H * (hd * esz + row) + 4 * B)
        b_ms, b_by = bound(nbytes, 4.0 * hd * keys * H, dt)
        cyc = list(zip(caches, rows))
        ms = time_ms(torch, [(lambda c=c, r=r: fused(c, r)) for c, r in cyc])
        out[name] = {
            **res, "tol": TOL[dt], "bound_ms": b_ms, "bound_by": b_by,
            "ms": ms, "bound_share": b_ms / ms,
            "pair_ms": time_ms(torch, [(lambda c=c, r=r: pair(c, r))
                                       for c, r in cyc]),
            "read_ms": time_ms(torch, [(lambda c=c, r=r: read(c, r))
                                       for c, r in cyc]),
            "one_key_ms": time_ms(torch, [
                (lambda c=c, r=r: fused(c, r, torch.zeros_like(pos)))
                for c, r in cyc]),
            "grid": DA.split_plan(rows[0][0], caches[0][0], table=table,
                                  kv_scale=caches[0][1]),
            "shape": (f"q, k, v [{B}, {H}, 1, {hd}] fused-QKV views, "
                      f"{'int8 ' if q8 else ''}pool [2, {P}, {H}, {bt}, "
                      f"{hd}], tables [{B}, {nb}], {keys} live keys"),
        }
    return out


# ---- phase 3, the fused ticks: the slot write and the read in one launch ----

FUSED_LIBRARY = ("none: no single PyTorch call writes a slot and attends the "
                 "cache in one call")


def tick_rows(torch, A, gen, B, H, hd, dtype):
    """q, k, v ``[B, H, 1, hd]`` as the model hands them to a decode tick:
    split-head views of one fused QKV projection."""
    qkv = torch.randn(B, 1, 3 * H * hd, generator=gen).to("cuda", dtype)
    return tuple(A.split_heads(x, H) for x in qkv.split(H * hd, dim=-1))


def fused_cache(torch, gen, dtype, q8, *shape, copies: int = 3):
    """``copies`` caches ``(kv, scale or None)``: float of ``dtype``, or
    int8 with its scales (``q8_cache``)."""
    if q8:
        return q8_cache(torch, gen, *shape, copies=copies)
    return [(torch.randn(*shape, generator=gen).to("cuda", dtype), None)
            for _ in range(copies)]


def clone_cache(c):
    return c[0].clone(), None if c[1] is None else c[1].clone()


def check_fused(torch, name, dt, fused, pair, plain, cache, live):
    """A fused tick against its plain version and against the unfused
    kernel pair (the standalone write, then the read-only read), each on a
    copy of ``cache``: the caches exact (float bytes; int8 bytes and
    scales) and the pair's every live row bit-identical, gated; the live
    rows within TOL of the plain version (bf16: ROW_TOL row by row); a
    second fused launch on the same inputs the same bits."""
    cf, cp, cq = clone_cache(cache), clone_cache(cache), clone_cache(cache)
    got = fused(cf)
    again = fused(cf)
    want = pair(cp)
    torch.cuda.synchronize()
    ref = plain(cq)
    torch.cuda.synchronize()
    for other, what in ((cp, "the unfused kernel pair's"),
                        (cq, "the plain write's")):
        require(torch.equal(cf[0], other[0]) and (
            cf[1] is None or torch.equal(cf[1], other[1])),
            f"{name} {dt}: the cache differs from {what}")
    require(not torch.equal(cf[0], cache[0]), f"{name} {dt}: nothing was "
                                              f"written")
    g, w, r = got[live], want[live], ref[live]
    require(torch.equal(g, w), f"{name} {dt}: a live row differs from the "
                               f"unfused kernel pair's bits")
    require(torch.equal(g, again[live]), f"{name} {dt}: two launches differ")
    require(bool(torch.isfinite(g).all()), f"{name} {dt}: non-finite")
    err, r_err = (g.float() - r.float()).abs().max().item(), row_err(g, r)
    require(err <= TOL[dt], f"{name} {dt}: max err {err} > {TOL[dt]}")
    require(dt != "bf16" or r_err <= ROW_TOL,
            f"{name} {dt}: row error {r_err} > {ROW_TOL}")
    return {"max_abs_err": err, "row_err": r_err, "same_bits": True,
            "pair_bit_identical": True, "cache_exact": True}


def paged_tick(torch, A, CU, DA, gen, dtype, q8, P, H, bt, hd, table, pos):
    """Three pools ``[2, P, H, bt, hd]`` (int8 with ``q8``) and three sets
    of tick rows, and the serving tick's four forms on one of each (``c``
    a pool and its scales, ``r`` rows): the fused launch (at ``p``, by
    default ``pos``), the unfused kernel pair (the block ids and offsets
    made once, outside the timing), the read-only read and the plain
    version."""
    B, nb = table.shape
    caches = fused_cache(torch, gen, dtype, q8, 2, P, H, bt, hd)
    rows = [tick_rows(torch, A, gen, B, H, hd, dtype) for _ in caches]
    slot = torch.clamp(pos // bt, max=nb - 1).long()
    blk = table.gather(1, slot[:, None])[:, 0].contiguous()
    off = (pos % bt).contiguous()

    def fused(c, r=rows[0], p=pos):
        return DA.paged_write_decode_cuda(*r, c[0], table, p, kv_scale=c[1])

    def pair(c, r=rows[0]):
        CU.kv_pool_insert_cuda(c[0], r[1][:, :, 0], r[2][:, :, 0], blk, off,
                               scale=c[1])
        return DA.paged_decode_cuda(r[0], c[0], table, pos, kv_scale=c[1])

    def read(c, r=rows[0]):
        return DA.paged_decode_cuda(r[0], c[0], table, pos, kv_scale=c[1])

    def plain(c, r=rows[0]):
        return DA.paged_write_decode_plain(*r, c[0], table, pos,
                                           kv_scale=c[1])
    return caches, rows, (fused, pair, read, plain)


def check_decode_write(torch, np, A, CU, DA, dtype, dt, q8):
    """The serving tick fused, ``paged_decode_write`` (``_q8`` with
    ``q8``), at ``check_decode``'s shapes (16 rows x 12 heads x hd 64 over
    bt 16, nb 64 tables into a [2, 1025, 12, 16, 64] pool, ragged
    positions, a full-horizon row) with row 9 parked on an all-trash table
    past the horizon (its output left out), the rows split-head views of a
    fused QKV: ``check_fused``; timed beside the two launches it replaces
    (``kv_pool_insert`` and the read-only ``paged_decode``, back to back,
    the block ids and offsets made outside the timing), the read-only
    read alone, its bound and its plain version; its grid and its fixed
    cost (every row at position 0: one key written and read)."""
    gen = torch.Generator().manual_seed(60 + q8)
    B, H, hd, bt, nb = 16, 12, 64, 16, 64
    P = B * nb + 1
    rng = np.random.default_rng(3)
    table = (rng.permutation(P - 1)[:B * nb] + 1).reshape(B, nb)
    pos = rng.integers(16, nb * bt, B)
    pos[5] = nb * bt - 1
    table[9], pos[9] = 0, nb * bt + 5                  # parked, past it
    live = [b for b in range(B) if b != 9]
    table = torch.from_numpy(table.astype(np.int32)).cuda()
    pos_t = torch.from_numpy(pos.astype(np.int32)).cuda()
    caches, rows, (fused, pair, read, plain) = paged_tick(
        torch, A, CU, DA, gen, dtype, q8, P, H, bt, hd, table, pos_t)
    name = "paged_decode_write" + ("_q8" if q8 else "")
    out = check_fused(torch, name, dt, fused, pair, plain, caches[0], live)
    keys = int((np.minimum(pos, nb * bt - 1) + 1).sum())
    live_blocks = int((np.minimum(pos, nb * bt - 1) // bt + 1).sum())
    esz = rows[0][0].element_size()
    row = hd * esz if not q8 else hd + 4          # a cached row (and scale)
    # the read's bytes (q read, o written, each live key's K and V rows
    # read once, the table entries and positions), plus the write's: the
    # float rows read once, the cache rows (and scales) written once, the
    # table entry of each written slot
    nbytes = (esz * 2 * B * H * hd + 2 * keys * H * row + 4 * live_blocks
              + 4 * B) + (2 * B * H * (hd * esz + row) + 4 * B)
    b_ms, b_by = bound(nbytes, 4.0 * hd * keys * H, dt)
    cyc = list(zip(caches, rows))
    ms = time_ms(torch, [(lambda c=c, r=r: fused(c, r)) for c, r in cyc])
    out.update(
        bound_ms=b_ms, bound_by=b_by, ms=ms, bound_share=b_ms / ms,
        pair_ms=time_ms(torch, [(lambda c=c, r=r: pair(c, r))
                                for c, r in cyc]),
        read_ms=time_ms(torch, [(lambda c=c, r=r: read(c, r))
                                for c, r in cyc]),
        plain_ms=time_ms(torch, [(lambda c=c, r=r: plain(c, r))
                                 for c, r in cyc]),
        one_key_ms=time_ms(torch, [
            (lambda c=c, r=r: fused(c, r, torch.zeros_like(pos_t)))
            for c, r in cyc]),
        grid=DA.split_plan(rows[0][0], caches[0][0], table=table,
                           kv_scale=caches[0][1]),
        library_ms=None, library=FUSED_LIBRARY,
        fuses=CU.REPLACES,
        shape=(f"q, k, v [{B}, {H}, 1, {hd}] fused-QKV views, "
               f"{'int8 ' if q8 else ''}pool [2, {P}, {H}, {bt}, {hd}]"
               f"{' + f32 scales' if q8 else ''}, tables [{B}, {nb}], "
               f"{keys} live keys, row 9 parked past the horizon"))
    return out


def check_dense_decode_write(torch, np, A, CU, DA, dtype, dt, lens, q8):
    """The generation tick fused, ``dense_decode_write`` (``_q8`` with
    ``q8``), at ``check_dense_decode``'s shapes: q, k, v ``[16, 12, 1,
    64]`` split-head views over the pair cache ``[2, 16, 12, T0 + 128,
    64]`` with the left-pad slot mask, at the lockstep slot T0 + 64 and at
    per-row slots: ``check_fused``; timed at the tick's own call
    (lockstep, masked) beside the two launches it replaces (``kv_insert``
    and the read-only ``dense_decode``), the read-only read alone, its
    bound and its plain version; its grid and its fixed cost (slot 0)."""
    gen = torch.Generator().manual_seed(62 + q8)
    T0 = int(lens.max())
    B, H, hd, T = GEN_ROWS, 12, 64, T0 + GEN_NEW
    slots = torch.arange(T, dtype=torch.int32, device="cuda")
    pos = T0 + GEN_NEW // 2
    mask_np = np.arange(T)[None, :] >= (T0 - lens)[:, None]       # [B, T]
    mask = torch.from_numpy(mask_np).cuda()
    per_row = torch.randint(T0, T, (B,), generator=gen, dtype=torch.int32)
    per_row[0] = T - 1
    per_row = per_row.cuda()
    caches = fused_cache(torch, gen, dtype, q8, 2, B, H, T, hd)
    rows = [tick_rows(torch, A, gen, B, H, hd, dtype) for _ in caches]
    name = "dense_decode_write" + ("_q8" if q8 else "")
    out = {}
    for p in (per_row, slots[pos]):
        write = CU.kv_insert_rows_cuda if p.ndim else CU.kv_insert_cuda

        def fused(c, r=rows[0], p=p):
            return DA.dense_write_decode_cuda(*r, c[0], p, slot_mask=mask,
                                              kv_scale=c[1])

        def pair(c, r=rows[0], p=p, write=write):
            write(c[0], r[1], r[2], p, scale=c[1])
            return DA.dense_decode_cuda(r[0], c[0], p, slot_mask=mask,
                                        kv_scale=c[1])

        def read(c, r=rows[0], p=p):
            return DA.dense_decode_cuda(r[0], c[0], p, slot_mask=mask,
                                        kv_scale=c[1])

        def plain(c, r=rows[0], p=p):
            return DA.dense_write_decode_plain(*r, c[0], p, slot_mask=mask,
                                               kv_scale=c[1])
        res = check_fused(torch, name, dt, fused, pair, plain, caches[0],
                          list(range(B)))
        for k in ("max_abs_err", "row_err"):
            out[k] = max(out.get(k, 0.0), res[k])
        out.update({k: v for k, v in res.items() if k not in out})
    # timed at the tick's own call: the lockstep slot, masked
    keys = int(mask_np[:, :pos + 1].sum())
    esz = rows[0][0].element_size()
    row = hd * esz if not q8 else hd + 4
    nbytes = (esz * 2 * B * H * hd + 2 * keys * H * row + B * T + 4) \
        + 2 * B * H * (hd * esz + row)
    b_ms, b_by = bound(nbytes, 4.0 * hd * keys * H, dt)
    cyc = list(zip(caches, rows))
    ms = time_ms(torch, [(lambda c=c, r=r: fused(c, r)) for c, r in cyc])
    out.update(
        bound_ms=b_ms, bound_by=b_by, ms=ms, bound_share=b_ms / ms,
        pair_ms=time_ms(torch, [(lambda c=c, r=r: pair(c, r))
                                for c, r in cyc]),
        read_ms=time_ms(torch, [(lambda c=c, r=r: read(c, r))
                                for c, r in cyc]),
        plain_ms=time_ms(torch, [(lambda c=c, r=r: plain(c, r))
                                 for c, r in cyc]),
        one_key_ms=time_ms(torch, [
            (lambda c=c, r=r: fused(c, r, slots[0])) for c, r in cyc]),
        grid=DA.split_plan(rows[0][0], caches[0][0], kv_scale=caches[0][1]),
        library_ms=None, library=FUSED_LIBRARY,
        fuses=CU.KV_INSERT_REPLACES,
        shape=(f"q, k, v [{B}, {H}, 1, {hd}] fused-QKV views, "
               f"{'int8 ' if q8 else ''}cache [2, {B}, {H}, {T}, {hd}]"
               f"{' + f32 scales' if q8 else ''}, lockstep pos {pos}, "
               f"left-pad slot mask: {keys} of {B * (pos + 1)} slots live; "
               f"also per-row pos"))
    return out


# ---- phase 4: serve ----------------------------------------------------------

def reference_logits(torch, A, model, tokens, q8_from=None):
    """One full-sequence forward with plain dense attention: the model's
    own layers, no kernel. With ``q8_from``, the query rows from that
    position on (those an int8 cache served) attend every key's K and V
    quantized and dequantized in f32 (``quantize_kv``; the per-row scales
    commute out of the int8 reads exactly so), the rows before it the float
    K/V, as the float admission or prefill attends them."""
    from distributed_compute_pytorch_tpu_torch.utils.quantize import (
        quantize_kv)
    x = model.embed(tokens)
    for blk in model.blocks:
        h = blk.ln1(x)
        q, k, v = (A.split_heads(z, blk.num_heads)
                   for z in blk.qkv(h).split(h.shape[-1], dim=-1))
        o = A.dot_product_attention(q, k, v, causal=True)
        if q8_from is not None:
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            o8 = A.dot_product_attention(q.float(), kq.float() * ks,
                                         vq.float() * vs, causal=True)
            o = torch.cat([o[:, :, :q8_from], o8[:, :, q8_from:].to(o.dtype)],
                          dim=2)
        x = x + blk.attn_out(A.merge_heads(o))
        x = x + blk._mlp(blk.ln2(x))
    return model.readout(x)


def serve_requests(np, serve, vocab: int):
    """32 requests from a seeded generator: prompts of 16-250 tokens and
    budgets of 32-128, so admissions stagger as rows finish."""
    rng = np.random.default_rng(0)
    return [serve.Request([int(t) for t in rng.integers(0, vocab, int(n))],
                          int(m))
            for n, m in zip(rng.integers(16, 251, 32),
                            rng.integers(32, 129, 32))]


def batcher(serve, model, kv_dtype="bf16", mode="graph"):
    """The smoke's batcher. ``mode="eager"`` keeps every segment eager on
    the card (the private ``_capture`` switch): the reference the captured
    segment is held to."""
    cb = serve.ContinuousBatcher(model, slots=16, t_max=1024,
                                 prompt_buf=256, segment=16,
                                 kv_block_tokens=16, kv_dtype=kv_dtype)
    cb._capture = mode == "graph"
    return cb


def served_gaps(torch, A, model, reqs, outs, q8: bool):
    """Each request's tokens forwarded with plain dense attention
    (``reference_logits``; for an int8 pool the rows from the last prompt
    token on, which the decode ticks served, read quantized K/V): each
    served token's logit gap below its row maximum."""
    gaps = []
    with torch.no_grad():
        for r, o in zip(reqs, outs):
            seq = torch.tensor(r.tokens + o[:-1], device="cuda")
            split = len(r.tokens) - 1
            logits = reference_logits(torch, A, model, seq[None],
                                      q8_from=split if q8 else None
                                      )[0].float()
            rows = logits[split:]
            require(bool(torch.isfinite(rows).all()),
                    "serve: non-finite reference logits")
            chosen = rows.gather(1, torch.tensor(o, device="cuda")[:, None])
            gaps.append((rows.max(dim=1).values - chosen[:, 0]).cpu())
    return torch.cat(gaps)


# the serving path's kernels: the admission prefill and scatter, the fused
# tick
SERVE_PATH = ("flash_fwd", "kv_pool_insert", "paged_decode_write")
# the captured decode programs against the eager loop on the same inputs,
# in turns within one process
TURNS = ("graph", "eager", "eager", "graph")


def alloc_stats(torch) -> dict:
    """PyTorch's caching allocators so far: ``cudaMalloc`` calls, pinned
    host allocations and their ms (None where this torch does not count)."""
    dev, host = torch.cuda.memory_stats(), torch.cuda.host_memory_stats()
    us = host.get("host_alloc_time.total")
    return {"cuda_mallocs": dev.get("num_device_alloc"),
            "host_allocs": host.get("num_host_alloc"),
            "host_alloc_ms": None if us is None else us / 1e3}


def alloc_delta(torch, before: dict) -> dict:
    """What the allocators did since ``before`` (:func:`alloc_stats`)."""
    return {k: None if n is None or before[k] is None else n - before[k]
            for k, n in alloc_stats(torch).items()}


def check_replays(cb, what, mode, ticks0, replays0):
    """A graph batcher replays once a segment of the run and captured only
    in its warm-up; an eager one neither captures nor replays."""
    segments = (cb.ticks - ticks0) // cb.S
    replays = cb.stats["graph_replays"] - replays0
    want = (1, segments) if mode == "graph" else (0, 0)
    got = (cb.stats["graph_captures"], replays)
    require(got == want, f"{what} {mode}: (captures, replays) {got}, want "
                         f"{want}")
    return replays


def serve_phase(torch, np, mods, model, dt):
    """The 32 requests through a captured-segment batcher and an eager one
    in turns (``TURNS``), each after a warm-up (the graph batcher captures
    there). Every run is counted (every kernel's launches as the schedule
    implies, the same for both: counted at each launch in an eager run,
    added by ``Program.replay`` in a captured one, whose counts
    ``profile_phase`` measures against the device); the graph replays once
    a segment; every run's tokens must equal the first's bit for bit; the
    first run's tokens are checked teacher-forced. The headline speed is
    the median of the graph runs; each run's allocator calls
    (:func:`alloc_stats`) are recorded beside its wall."""
    A, FA, CU, DA, serve = mods
    reqs = serve_requests(np, serve, model.config.vocab_size)
    cbs = {mode: batcher(serve, model, mode=mode) for mode in TURNS[:2]}
    for cb in cbs.values():
        cb.serve(reqs[:2])     # warm-up: the library handles' first calls
    walls = {mode: [] for mode in cbs}
    ttfts = {mode: [] for mode in cbs}
    allocs = {mode: [] for mode in cbs}
    counted, outs = {}, None
    for run, mode in enumerate(TURNS):
        cb = cbs[mode]
        waves0, ticks0 = cb.stats["prefill_calls"], cb.ticks
        replays0 = cb.stats["graph_replays"]
        torch.cuda.synchronize()
        FA.launches = FA.tc_launches = CU.launches = DA.launches = 0
        DA.write_launches = 0
        a0 = alloc_stats(torch)
        t0 = time.monotonic()
        got = cb.serve(reqs)
        torch.cuda.synchronize()
        walls[mode].append(time.monotonic() - t0)
        allocs[mode].append(alloc_delta(torch, a0))
        launches = {"flash_fwd": FA.launches, "kv_pool_insert": CU.launches,
                    "paged_decode_write": DA.write_launches,
                    "paged_decode": DA.launches}
        tc = FA.tc_launches
        waves, ticks = cb.stats["prefill_calls"] - waves0, cb.ticks - ticks0
        # the admission scatter writes the pool; each tick's write is fused
        # into its read; the read-only read is off the path
        want = {"flash_fwd": LAYERS * waves, "kv_pool_insert": LAYERS * waves,
                "paged_decode_write": LAYERS * ticks, "paged_decode": 0}
        require(all(launches[k] > 0 for k in SERVE_PATH),
                f"serve {dt} {mode}: a kernel of the path never launched: "
                f"{launches}")
        require(launches == want, f"serve {dt} {mode}: launches {launches} "
                                  f"!= the schedule's {want}")
        # bf16 on GPT-2's aligned fused-QKV views: every forward launch on
        # the tensor cores; f32 none
        want_tc = launches["flash_fwd"] if dt == "bf16" else 0
        require(tc == want_tc, f"serve {dt}: flash_fwd tensor-core launches "
                               f"{tc}, want {want_tc}")
        replays = check_replays(cb, f"serve {dt}", mode, ticks0, replays0)
        require(cb.last_block_leaks == 0 and cb.last_slot_leaks == 0,
                f"serve {dt} {mode}: leaked blocks/slots")
        ttft = sorted(t for t in cb.last_ttft_s if t is not None)
        ttfts[mode].append(sum(ttft) / len(ttft))
        ttft_stats = (sum(ttft) / len(ttft), ttft[len(ttft) // 2], ttft[-1])
        counted.setdefault(mode, (launches, tc))
        if outs is not None:
            require(got == outs, f"serve {dt}: the {mode} run (turn {run}) "
                                 f"served other tokens than the graph's "
                                 f"first run")
            if mode == "graph":
                first["ttft"].append(ttft_stats)
            continue
        outs, first = got, {"ticks": ticks, "waves": waves,
                            "ttft": [ttft_stats], "replays": replays}
    require(all(len(o) == r.max_new for o, r in zip(outs, reqs)),
            f"serve {dt}: a request returned fewer than max_new tokens")
    gaps = served_gaps(torch, A, model, reqs, outs, q8=False)
    worst = gaps.max().item()
    require(worst <= MARGIN[dt], f"serve {dt}: a served token's logit is "
                                 f"{worst} below the teacher-forced max "
                                 f"(margin {MARGIN[dt]})")
    ticks = first["ticks"]
    new_tokens = sum(len(o) for o in outs)
    wall = statistics.median(walls["graph"])
    ttft = [statistics.median(col) for col in zip(*first["ttft"])]
    launches, tc = counted["eager"]
    return {
        "phase": "serve", "dtype": dt, "model": "gpt2-small (12 x 768, "
        "vocab 50257), random weights seed 0", "requests": len(reqs),
        "slots": 16, "segment": 16, "kv_block_tokens": 16, "t_max": 1024,
        "prompt_buf": 256,
        "headline": "wall_s, decode_tokens_per_s, wall_ms_per_tick and the "
                    "ttft figures: the median of the graph runs",
        "wall_s": wall, "new_tokens": new_tokens,
        "decode_tokens_per_s": statistics.median(new_tokens / w
                                                 for w in walls["graph"]),
        "mean_ttft_s": ttft[0], "median_ttft_s": ttft[1],
        "max_ttft_s": ttft[2],
        "wall_ms_per_tick": statistics.median(1e3 * w / ticks
                                              for w in walls["graph"]),
        "ticks": ticks, "admission_waves": first["waves"],
        "launches": launches,
        "launches_from": "the first eager run (counted at each launch; the "
                         "captured run's, measured against the device, are "
                         "serve_profile's)",
        "flash_fwd_tensor_core_launches": tc,
        "teacher_forced_worst_gap": worst,
        "teacher_forced_mean_gap": gaps.mean().item(),
        "margin": MARGIN[dt],
        "turns": list(TURNS), "graph_capture_ms":
            cbs["graph"]._graph.capture_ms,
        "segments_per_run": ticks // cbs["graph"].S,
        "graph_replays_per_run": first["replays"],
        "graph_eager_tokens_identical": True,
        **{f"{mode}_decode_tokens_per_s": [new_tokens / w for w in ws]
           for mode, ws in walls.items()},
        **{f"{mode}_wall_ms_per_tick": [1e3 * w / ticks for w in ws]
           for mode, ws in walls.items()},
        **{f"{mode}_mean_ttft_s": ttfts[mode] for mode in ttfts},
        **{f"{mode}_allocator_calls": allocs[mode] for mode in allocs},
    }, outs, cbs, walls


# the sync-debug window of the serve_int8 phase: every host sync in a
# whole serve call raises, except the one the serve loop makes on purpose
SYNC_ALLOWED = ("serve._Fetch.result: the harvest's wait on its own "
                "segment's event (sync debug mode set to 0 for that wait "
                "alone); nothing else: the warm-up calls, whose second "
                "dispatch captures the segment, run in the window too")


def serve_under_sync_check(torch, cb, reqs):
    """``cb.serve(reqs)`` inside ``torch.cuda.set_sync_debug_mode("error")``:
    a host-to-device copy, or any other call that waits for the card,
    raises there (fault 3.1)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return cb.serve(reqs)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def q8_counts(FA, CU, DA) -> dict:
    """Every serving and generation counter, the float and the int8 forms."""
    return {**gen_counts(FA, CU, DA),
            "kv_pool_insert_q8": CU.q8_launches,
            "paged_decode_q8": DA.q8_launches,
            "paged_decode_write_q8": DA.write_q8_launches,
            "kv_insert_q8": CU.kv_insert_q8_launches,
            "kv_insert_rows_q8": CU.kv_insert_rows_q8_launches,
            "cache_insert_q8": CU.cache_insert_q8_launches,
            "dense_decode_q8": DA.dense_q8_launches,
            "dense_decode_write_q8": DA.dense_write_q8_launches}


def zero_q8_counts(FA, CU, DA) -> None:
    zero_gen_counts(FA, CU, DA)
    CU.q8_launches = DA.q8_launches = DA.dense_q8_launches = 0
    CU.kv_insert_q8_launches = CU.kv_insert_rows_q8_launches = 0
    CU.cache_insert_q8_launches = 0
    DA.write_q8_launches = DA.dense_write_q8_launches = 0


def pool_bytes(cb) -> int:
    return sum(t.numel() * t.element_size() for c in cb._caches
               for t in c.values())


# the int8 cells' runs: the int8 cache captured and eager in turns, between
# two runs of the float cache captured
RUNS8 = (("bf16", "graph"), ("int8", "graph"), ("int8", "eager"),
         ("int8", "eager"), ("int8", "graph"), ("bf16", "graph"))


def label(kv: str, mode: str) -> str:
    return kv if mode == "graph" else f"{kv}_eager"


def serve_int8_phase(torch, np, mods, model, float_outs):
    """The serve phase's 32 requests, bf16 compute, on the int8 pool
    (``kv_dtype="int8"``), captured and eager, beside the bf16 float pool
    captured, in turns (``RUNS8``). Every run, and each batcher's warm-up
    (where the graph batchers capture), runs under the sync-debug window
    (fault 3.1). The first
    int8 run of each mode is counted (every int8 kernel launch as the
    schedule implies, no float-form launch) and the graph's tokens checked
    teacher-forced, decoded rows against quantized K/V; every int8 run must
    serve the graph's first int8 tokens, every float run the serve phase's.
    Then one profiled run of each batcher gives its device time, ops a
    tick, host calls and measured launches (``profiled_serve``), and each
    unprofiled run's busy share."""
    A, FA, CU, DA, serve = mods
    reqs = serve_requests(np, serve, model.config.vocab_size)
    cbs = {label(kv, mode): batcher(serve, model, kv, mode)
           for kv, mode in dict.fromkeys(RUNS8)}
    for cb in cbs.values():
        serve_under_sync_check(torch, cb, reqs[:2])   # warm-up, capture
    walls = {name: [] for name in cbs}
    rec = {"phase": "serve_int8", "dtype": "bf16", "requests": len(reqs),
           "model": "gpt2-small (12 x 768, vocab 50257), random weights "
                    "seed 0", "slots": 16, "segment": 16,
           "kv_block_tokens": 16, "t_max": 1024, "prompt_buf": 256,
           "runs": [label(kv, mode) for kv, mode in RUNS8],
           "sync_debug": {"mode": "error", "window": "every unprofiled "
                          "ContinuousBatcher.serve call of the phase, the "
                          "warm-ups and their captures included",
                          "allowed": SYNC_ALLOWED, "raised": False}}
    int8_outs, counted, replays = None, set(), {}
    for kv, mode in RUNS8:
        name = label(kv, mode)
        cb = cbs[name]
        waves0, ticks0 = cb.stats["prefill_calls"], cb.ticks
        replays0 = cb.stats["graph_replays"]
        zero_q8_counts(FA, CU, DA)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        outs = serve_under_sync_check(torch, cb, reqs)
        torch.cuda.synchronize()
        walls[name].append(time.monotonic() - t0)
        launches = q8_counts(FA, CU, DA)
        replays[name] = check_replays(cb, f"serve_int8 {kv}", mode, ticks0,
                                      replays0)
        require(cb.last_block_leaks == 0 and cb.last_slot_leaks == 0,
                f"serve_int8 {name}: leaked blocks/slots")
        require(all(len(o) == r.max_new for o, r in zip(outs, reqs)),
                f"serve_int8 {name}: a request returned fewer than max_new "
                f"tokens")
        if kv == "bf16":
            require(outs == float_outs, "serve_int8: the float pool's "
                                        "tokens changed under the sync "
                                        "check or between runs")
            continue
        if name not in counted:
            counted.add(name)
            waves = cb.stats["prefill_calls"] - waves0
            ticks = cb.ticks - ticks0
            want = {k: 0 for k in launches}
            want.update(flash_fwd=LAYERS * waves,
                        kv_pool_insert_q8=LAYERS * waves,
                        paged_decode_write_q8=LAYERS * ticks)
            require(launches == want, f"serve_int8 {mode}: launches "
                                      f"{launches} != the schedule's {want}")
        if int8_outs is not None:
            require(outs == int8_outs, f"serve_int8: the {mode} int8 run "
                                       f"served other tokens than the "
                                       f"graph's first int8 run")
            continue
        int8_outs = outs
        gaps = served_gaps(torch, A, model, reqs, outs, q8=True)
        worst = gaps.max().item()
        require(worst <= MARGIN["bf16"],
                f"serve_int8: a served token's logit is {worst} below the "
                f"teacher-forced max over quantized K/V (margin "
                f"{MARGIN['bf16']})")
        same = sum(int(a == b) for o, f in zip(outs, float_outs)
                   for a, b in zip(o, f))
        rec.update(admission_waves=waves, ticks=ticks, launches={
            k: n for k, n in launches.items() if n},
            teacher_forced_worst_gap=worst,
            teacher_forced_mean_gap=gaps.mean().item(),
            margin=MARGIN["bf16"],
            positions_agreeing_with_float_pool=same / sum(map(len, outs)))
    rec["sync_debug"]["checked_runs"] = rec["runs"]
    rec["int8_graph_eager_tokens_identical"] = True
    rec["graph_capture_ms"] = {name: cb._graph.capture_ms
                               for name, cb in cbs.items() if cb._graph}
    rec["graph_replays_per_run"] = {name: n for name, n in replays.items()
                                    if cbs[name]._graph}
    new_tokens = sum(r.max_new for r in reqs)
    summaries = {}
    for name, cb in cbs.items():
        prof, wall_prof, counts, ticks = profiled_serve(
            torch, (FA, CU, DA), cb, reqs, f"serve_int8 profile {name}",
            q8=name.startswith("int8"), tc=True)
        summaries[name] = profile_summary(torch, prof, wall_prof, counts,
                                          ticks, ticks // cb.S, "segment",
                                          walls[name])
    for kv, eager in (("bf16", None), ("int8", summaries["int8_eager"])):
        check_host_calls(f"serve_int8 {kv}", summaries[kv], eager,
                         summaries[kv]["segments"], cbs[kv].S)
    for name, summary in summaries.items():
        ticks = summary["ticks"]
        rec[f"{name}_profile"] = summary
        rec[f"{name}_wall_s"] = walls[name]
        rec[f"{name}_decode_tokens_per_s"] = [new_tokens / w
                                              for w in walls[name]]
        rec[f"{name}_wall_ms_per_tick"] = [1e3 * w / ticks
                                           for w in walls[name]]
        rec[f"{name}_device_ms"] = summary["device_ms"]
        rec[f"{name}_device_busy_share"] = summary["device_busy_share"]
        rec[f"{name}_device_ops_per_tick"] = summary["device_ops_per_tick"]
    for kv in ("bf16", "int8"):
        rec[f"{kv}_pool_bytes"] = pool_bytes(cbs[kv])
    rec["new_tokens"] = new_tokens
    rec["pool_bytes_ratio"] = rec["int8_pool_bytes"] / rec["bf16_pool_bytes"]
    return rec


# the kernel entries checked exactly, and the source of each entry whose
# file is named otherwise
EXACT = ("kv_pool_insert", "cache_insert", "kv_insert", "kv_insert_rows",
         "kv_pool_insert_q8", "cache_insert_q8", "kv_insert_q8",
         "kv_insert_rows_q8")
# per-kernel fields the kernels line carries where a check records them:
# the flash kernels' rate, share of their bound, path and row errors; the
# flash forward at the training shape and its lse
KERNEL_EXTRAS = ("tflops", "bound_share", "path", "train_ms",
                 "train_bound_ms", "train_library_ms", "train_tflops",
                 "train_bound_share", "row_err", "fault_row_err",
                 "lse_max_abs_err", "grid", "same_bits", "one_key_ms",
                 "pair_ms", "read_ms", "pair_bit_identical", "fuses", "long")
SOURCES = {"cache_insert": "kv_insert", "kv_insert_rows": "kv_insert",
           "kv_pool_insert_q8": "kv_pool_insert",
           "paged_decode_q8": "paged_decode", "cache_insert_q8": "kv_insert",
           "kv_insert_q8": "kv_insert", "kv_insert_rows_q8": "kv_insert",
           "dense_decode_q8": "dense_decode",
           "paged_decode_write": "paged_decode",
           "paged_decode_write_q8": "paged_decode",
           "dense_decode_write": "dense_decode",
           "dense_decode_write_q8": "dense_decode"}
# profiler groups: the int8 reads share their float forms' kernel templates
# (``paged_decode_kernel<T, signed char, ...>``), and so do the fused ticks
# (``paged_decode_write_kernel<...>``); the int8 writes have kernels of
# their own
KERNEL_NAMES = ("flash_fwd", "kv_pool_insert", "paged_decode",
                "paged_decode_write", "flash_bwd_dq", "flash_bwd_dkv",
                "fused_adamw", "kv_insert", "dense_decode",
                "dense_decode_write", "kv_pool_insert_q8", "kv_insert_q8")


def _kernel_group(name: str) -> str:
    for kernel in KERNEL_NAMES:
        if f"::{kernel}_kernel" in name or f"::{kernel}_tc_kernel" in name:
            return kernel
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet")):
        return "matmul (cuBLAS)"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "memcpy/memset"
    return "other PyTorch kernels"


def device_events(torch, prof) -> dict:
    """``{name: [events, device_us]}`` of a profile's device events (not
    the device-timeline mirror of a graph replay's span, which covers the
    replay's kernels)."""
    from distributed_compute_pytorch_tpu_torch.utils.graphs import (
        REPLAY_SPAN)
    out = {}
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key == REPLAY_SPAN):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        n, t = out.get(e.key, (0, 0.0))
        out[e.key] = [n + e.count, t + us]
    return out


def device_time(torch, prof):
    """``(total_us, {group: [launches, us]}, top kernels)`` from a
    profile's device events (:func:`device_events`)."""
    kernels = device_events(torch, prof)
    total_us = sum(t for _, t in kernels.values())
    groups: dict = {}
    for name, (n, us) in kernels.items():
        g = groups.setdefault(_kernel_group(name), [0, 0.0])
        g[0] += n
        g[1] += us
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    return total_us, groups, top


# the port's kernels as the profiler names them, e.g. ``(anonymous
# namespace)::paged_decode_write_kernel<__nv_bfloat16, signed char, 1,
# 8>(...)``: the name, the tensor-core suffix, the template arguments
PORT_KERNEL = re.compile(r"\b(\w+?)(_tc)?_kernel(?:<([^>]*)>)?\(")
PORT_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_adamw",
                "kv_pool_insert", "kv_pool_insert_q8", "kv_insert",
                "kv_insert_q8", "paged_decode", "paged_decode_write",
                "dense_decode", "dense_decode_write")
# one kernel serves the three dense writes of a form (``csrc/kv_insert.cu``)
DENSE_WRITES = ("kv_insert", "kv_insert_rows", "cache_insert")


def device_launches(torch, prof) -> dict:
    """The port's kernel launches the device ran in a profile (every
    kernel event, those of graph replays included), keyed as
    :func:`path_counts` keys the counters: a decode read or fused tick
    whose cache type (its second template argument) is int8 (``signed
    char``) counts as its ``_q8`` form, a tensor-core flash forward also
    as ``flash_fwd_tc``."""
    got: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = PORT_KERNEL.search(e.key)
        if not m or m.group(1) not in PORT_KERNELS:
            continue
        name, tc, args = m.groups()
        if name.startswith(("paged_decode", "dense_decode")) and args and \
                args.split(",")[1].strip() == "signed char":
            name += "_q8"
        names = (name, name + "_tc") if tc else (name,)
        for n in names:
            got[n] = got.get(n, 0) + e.count
    return got


def path_counts(FA, CU, DA) -> dict:
    """Every serving and generation counter (``q8_counts``) and the
    tensor-core forward's, as the device's kernel events can tell them
    apart: the three dense writes of a form summed into ``kv_insert`` /
    ``kv_insert_q8``."""
    c = {**q8_counts(FA, CU, DA), "flash_fwd_tc": FA.tc_launches}
    for sfx in ("", "_q8"):
        c["kv_insert" + sfx] = sum(c.pop(k + sfx) for k in DENSE_WRITES)
    return c


def counted_profile(torch, counters, fn, what, schedule, waves=None):
    """``fn()`` under the profiler (:func:`profile_run`) with every launch
    counter set to 0 just before and read just after; those counts must
    equal the device's kernel events in the profile
    (:func:`device_launches`) and the schedule (``schedule``: the nonzero
    counts, every other one 0). This measures a captured run's launches:
    its replays' counts are added by ``Program.replay``, its kernels'
    events come from the device. ``counters``: ``(FA, CU, DA)``;
    ``waves``: the run's schedule units (admission waves, ticks), which
    ``fn`` may fill in, kept for :func:`dump_kernel_events`. When the
    device's events and the counters disagree, the profile's port kernel
    events go to ``chiprun_out/`` before the check fails. Returns
    ``(profile, wall_s, counts)``, ``counts`` every counter of
    ``q8_counts`` with ``flash_fwd_tc``."""
    FA, CU, DA = counters
    zero_q8_counts(FA, CU, DA)
    prof, wall = profile_run(torch, fn)
    counts = {**q8_counts(FA, CU, DA), "flash_fwd_tc": FA.tc_launches}
    counted = path_counts(FA, CU, DA)
    want = {k: 0 for k in counted}
    want.update(schedule)
    device = {k: 0 for k in counted}
    device.update(device_launches(torch, prof))
    require(counted == want, f"{what}: launches {counted} != the schedule's "
                             f"{want}")
    if device != counted:
        path = dump_kernel_events(prof, what, {
            "schedule": schedule, "waves": waves, "counted": counted,
            "device": device})
        require(False, f"{what}: the device ran {device}, the counters say "
                       f"{counted} (kernel events written to {path})")
    return prof, wall, counts


def dump_kernel_events(prof, what, context: dict) -> str:
    """Write the profile's port kernel events (name, start, duration,
    stream, and the graph ids the trace gives a replayed kernel) and
    ``context`` (the schedule, its waves, the counters and the device's
    counts) to ``chiprun_out/`` as JSON; returns the path."""
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    slug = re.sub(r"\W+", "_", what).strip("_")
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f).get("traceEvents", [])
    kernels = []
    for e in events:
        m = PORT_KERNEL.search(e.get("name", "") + "(")
        if e.get("cat") != "kernel" or not m or m.group(1) not in \
                PORT_KERNELS:
            continue
        args = e.get("args", {})
        kernels.append({
            "name": e["name"][:160], "ts_us": e.get("ts"),
            "dur_us": e.get("dur"), "stream": args.get("stream"),
            "correlation": args.get("correlation"),
            **{k: v for k, v in args.items() if "graph" in k.lower()}})
    path = out / f"kernel_events_{slug}.json"
    with open(path, "w") as f:
        json.dump({"what": what, **context, "kernel_events": kernels}, f)
    return str(path)


def profile_run(torch, fn):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activities), to a
    synchronize: ``(profile, wall_s)``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return prof, wall


# the host's CUDA API calls (runtime `cuda*`, low-level `cu*`) among a
# profile's CPU events
HOST_CALL = re.compile(r"^cu(da)?[A-Z]\w*$")


def host_calls(torch, prof) -> dict:
    """The host's CUDA API calls in a profile, counted from its CPU events
    (``cuda*``/``cu*``): ``calls`` by name; ``kernel_launches`` (every
    ``*LaunchKernel*`` call) and ``graph_launches`` (``*GraphLaunch*``) in
    all and inside the graph replays' spans (``utils/graphs.py``'s
    ``REPLAY_SPAN``; the profiler mirrors each span on the device's
    timeline, which is not counted), the spans' count, and the PyTorch
    ops (``aten::*``) inside the spans by name."""
    from distributed_compute_pytorch_tpu_torch.utils.graphs import (
        REPLAY_SPAN)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == REPLAY_SPAN)
    starts = [s for s, _ in spans]
    calls, inside, ops_inside = {}, {}, {}
    for e in events:
        api = HOST_CALL.match(e.name)
        if not api and not e.name.startswith("aten::"):
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        within = i >= 0 and e.time_range.start <= spans[i][1]
        if not api:
            if within:
                ops_inside[e.name] = ops_inside.get(e.name, 0) + 1
            continue
        calls[e.name] = calls.get(e.name, 0) + 1
        if within:
            inside[e.name] = inside.get(e.name, 0) + 1

    def count(d, kind):
        return sum(n for k, n in d.items() if kind in k)
    return {"calls": calls, "replays": len(spans),
            "kernel_launches": count(calls, "LaunchKernel"),
            "graph_launches": count(calls, "GraphLaunch"),
            "kernel_launches_in_replays": count(inside, "LaunchKernel"),
            "graph_launches_in_replays": count(inside, "GraphLaunch"),
            "ops_in_replays": ops_inside}


def profile_summary(torch, prof, wall_prof, launches, ticks, units, unit,
                    walls):
    """A profiled run's device time by kernel group, device ops a tick,
    host calls a ``unit`` (segment or tick; ``units`` in the run), the
    device busy share of each UNPROFILED run of the same work (``walls``:
    the kernels' device time over its wall; one stream, so kernels do not
    overlap; the profiler slows the host, not the kernels), and the run's
    kernel launches as :func:`counted_profile` measured them
    (``launches``)."""
    total_us, groups, top = device_time(torch, prof)
    ops = sum(n for n, _ in groups.values())
    host = host_calls(torch, prof)
    return {
        "ticks": ticks, f"{unit}s": units, "wall_s_profiled": wall_prof,
        "launches": launches, "launches_measured": "counters zeroed just "
        "before this profiled run, equal to its device kernel events and "
        "the schedule (gated)",
        "wall_s_unprofiled": walls,
        "device_ms": total_us / 1e3 if total_us else None,
        "device_busy_share": ([total_us / 1e6 / w for w in walls]
                              if total_us else None),
        "device_ops": ops, "device_ops_per_tick": ops / ticks,
        f"kernel_launch_calls_per_{unit}": host["kernel_launches"] / units,
        f"graph_launch_calls_per_{unit}": host["graph_launches"] / units,
        "host_calls": host,
        "groups_ms": {g: {"launches": n, "ms": us / 1e3}
                      for g, (n, us) in sorted(groups.items(),
                                               key=lambda kv: -kv[1][1])},
        "top_kernels": [{"name": name[:100], "launches": n, "ms": us / 1e3}
                        for name, (n, us) in top],
    }


def check_host_calls(what, graph, eager, replays, ticks_per_replay):
    """The captured run's profile (``graph``): one ``cudaGraphLaunch`` a
    replay, ``replays`` of them and as many replay spans; against the eager
    run of the same work (``eager``, where there is one), which makes no
    graph launch: at least ``LAYERS`` fewer kernel launch calls for each
    replayed tick (no decode tick's kernels go out one by one)."""
    g = graph["host_calls"]
    require(g["graph_launches"] == g["replays"] == replays,
            f"{what}: {g['graph_launches']} cudaGraphLaunch calls in "
            f"{g['replays']} replay spans, want one for each of {replays} "
            f"replays")
    if eager is None:
        return
    e = eager["host_calls"]
    require(e["graph_launches"] == 0 and e["replays"] == 0,
            f"{what}: the eager run launched graphs: {e}")
    saved = e["kernel_launches"] - g["kernel_launches"]
    require(saved >= LAYERS * replays * ticks_per_replay,
            f"{what}: the captured run made {g['kernel_launches']} kernel "
            f"launch calls, the eager one {e['kernel_launches']}: fewer "
            f"than {LAYERS} saved a replayed tick")


def profiled_serve(torch, counters, cb, reqs, what, q8, tc):
    """``cb.serve(reqs)`` under :func:`counted_profile`, held to a serve
    run's schedule: ``flash_fwd`` and the admission scatter 12 a wave, the
    fused tick 12 a tick, in the int8 forms for an int8 pool (``q8``),
    every forward on the tensor cores where ``tc``. Returns
    ``(profile, wall_s, counts, ticks)``."""
    waves0, ticks0 = cb.stats["prefill_calls"], cb.ticks
    sched, units = {}, {}

    def run():
        cb.serve(reqs)
        waves = cb.stats["prefill_calls"] - waves0
        units.update(admission_waves=waves, ticks=cb.ticks - ticks0)
        sfx = "_q8" if q8 else ""
        sched.update({"flash_fwd": LAYERS * waves,
                      "flash_fwd_tc": LAYERS * waves if tc else 0,
                      "kv_pool_insert" + sfx: LAYERS * waves,
                      "paged_decode_write" + sfx:
                          LAYERS * (cb.ticks - ticks0)})
    prof, wall, counts = counted_profile(torch, counters, run, what, sched,
                                         waves=units)
    return prof, wall, counts, cb.ticks - ticks0


def profile_phase(torch, np, mods, cbs, dt, walls):
    """The serve run once more under ``torch.profiler`` on the captured
    batcher and on the eager one: device time by kernel group, device ops
    a tick, the host's CUDA calls a segment (one ``cudaGraphLaunch`` a
    segment on the graph, gated), each unprofiled run's busy share, and
    each run's launches measured (:func:`counted_profile`: the counters
    equal the device's kernel events and the schedule, gated)."""
    _, FA, CU, DA, serve = mods
    reqs = serve_requests(np, serve, cbs["graph"].model.config.vocab_size)
    rec = {"phase": "serve_profile", "dtype": dt, "requests": len(reqs)}
    summaries = {}
    for mode, cb in cbs.items():
        prof, wall_prof, counts, ticks = profiled_serve(
            torch, (FA, CU, DA), cb, reqs, f"serve_profile {dt} {mode}",
            q8=False, tc=dt == "bf16")
        summaries[mode] = profile_summary(torch, prof, wall_prof, counts,
                                          ticks, ticks // cb.S, "segment",
                                          walls[mode])
    segments = summaries["graph"]["segments"]
    check_host_calls(f"serve_profile {dt}", summaries["graph"],
                     summaries["eager"], segments, cbs["graph"].S)
    return {**rec, **summaries["graph"], "eager": summaries["eager"]}


# ---- phases 6-7: generate ----------------------------------------------------

def gen_counts(FA, CU, DA) -> dict:
    return {"flash_fwd": FA.launches,
            "dense_decode_write": DA.dense_write_launches,
            "kv_insert": CU.kv_insert_launches,
            "dense_decode": DA.dense_launches,
            "kv_insert_rows": CU.kv_insert_rows_launches,
            "cache_insert": CU.cache_insert_launches,
            "paged_decode": DA.launches,
            "paged_decode_write": DA.write_launches,
            "kv_pool_insert": CU.launches}


def zero_gen_counts(FA, CU, DA) -> None:
    FA.launches = FA.tc_launches = CU.launches = DA.launches = 0
    DA.dense_launches = DA.write_launches = DA.dense_write_launches = 0
    CU.kv_insert_launches = CU.kv_insert_rows_launches = 0
    CU.cache_insert_launches = 0


def teacher_forced_gaps(torch, A, model, lens, prompt, out, q8=False):
    """Each row's real prompt and new tokens forwarded alone with plain
    dense attention: the new tokens' logit gaps below the row maximum,
    and the top-2 logit gap at each new token (0 = a tie). ``q8``: the
    rows past the prompt, which the decode ticks served from an int8
    cache, read quantized K/V (``reference_logits``)."""
    T0 = prompt.shape[1]
    gaps, margins = [], []
    with torch.no_grad():
        for i, n in enumerate(lens):
            seq = out[i, T0 - n:].cuda()
            logits = reference_logits(torch, A, model, seq[None, :-1],
                                      q8_from=int(n) if q8 else None
                                      )[0, n - 1:].float()
            chosen = logits.gather(1, seq[n:, None])[:, 0]
            top2 = logits.topk(2, dim=1).values
            gaps.append((top2[:, 0] - chosen).cpu())
            margins.append((top2[:, 0] - top2[:, 1]).cpu())
    return torch.stack(gaps), torch.stack(margins)


def gen_fns(infer, model, kv_quant=False):
    """Generation of ``GEN_NEW`` tokens with the captured tick (``graph``)
    and with every tick eager on the card (``eager``, the private
    ``_eager`` switch: the reference the captured tick is held to)."""
    return {mode: infer.make_generate_fn(model, GEN_NEW, kv_quant=kv_quant,
                                         _eager=mode == "eager")
            for mode in TURNS[:2]}


def check_gen_stats(fn, what, mode):
    """A captured call captures once and replays every tick but the first
    (its eager warm-up); an eager call neither captures nor replays."""
    ticks = GEN_NEW - 1
    want = (1, ticks - 1) if mode == "graph" else (0, 0)
    got = (fn.stats["graph_captures"], fn.stats["graph_replays"])
    require(got == want, f"{what} {mode}: (captures, replays) {got}, want "
                         f"{want}")
    return fn.stats["capture_ms"]


def generate_phase(torch, np, infer, mods, model, dt):
    """The 16-prompt left-padded batch, greedy, with the captured tick and
    with the eager loop in turns (``TURNS``), after a 2-token warm-up; the
    first token's (prefill's) time taken alone. Every run is counted (the
    same launches for both; a captured run's are measured against the
    device by ``generate_profile_phase``), its tokens must equal the first
    run's bit for bit, and the first run's are checked teacher-forced. The
    headline speed is the median of the graph runs; each run's allocator
    calls are recorded beside its wall."""
    A, FA, CU, DA = mods
    lens, prompt_np, mask_np = gen_batch(np, model.config.vocab_size)
    prompt = torch.from_numpy(prompt_np).cuda()
    mask = torch.from_numpy(mask_np).cuda()
    T0 = prompt.shape[1]
    fns = gen_fns(infer, model)
    infer.generate(model, prompt, 2, prompt_mask=mask)
    prefill_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, caches = infer.prefill(model, prompt, T0 + GEN_NEW, mask)
            torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
        del caches, logits
    prefill_ms = min(prefill_ms)
    ticks = GEN_NEW - 1
    walls = {mode: [] for mode in fns}
    allocs = {mode: [] for mode in fns}
    capture_ms, counted, out = [], {}, None
    for run, mode in enumerate(TURNS):
        torch.cuda.reset_peak_memory_stats()
        zero_gen_counts(FA, CU, DA)
        torch.cuda.synchronize()
        a0 = alloc_stats(torch)
        t0 = time.perf_counter()
        got = fns[mode](prompt, prompt_mask=mask)
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
        allocs[mode].append(alloc_delta(torch, a0))
        launches = gen_counts(FA, CU, DA)
        want = {k: 0 for k in launches}
        want.update(flash_fwd=LAYERS, dense_decode_write=LAYERS * ticks)
        require(launches == want, f"generate {dt} {mode}: launches "
                                  f"{launches} != the schedule's {want}")
        tc = FA.tc_launches
        want_tc = LAYERS if dt == "bf16" else 0
        require(tc == want_tc, f"generate {dt}: flash_fwd tensor-core "
                               f"launches {tc}, want {want_tc}")
        ms = check_gen_stats(fns[mode], f"generate {dt}", mode)
        if ms is not None:
            capture_ms.append(ms)
        counted.setdefault(mode, (launches, tc))
        got = got.cpu()
        if out is not None:
            require(torch.equal(got, out), f"generate {dt}: the {mode} run "
                                           f"(turn {run}) gave other tokens "
                                           f"than the graph's first run")
            continue
        out, peak = got, torch.cuda.max_memory_allocated()
    require(tuple(out.shape) == (GEN_ROWS, T0 + GEN_NEW)
            and torch.equal(out[:, :T0], prompt.cpu()),
            f"generate {dt}: output {tuple(out.shape)} does not extend the "
            f"prompt")
    gaps, _ = teacher_forced_gaps(torch, A, model, lens, prompt_np, out)
    worst = gaps.max().item()
    require(worst <= MARGIN[dt], f"generate {dt}: a generated token's logit "
                                 f"is {worst} below the teacher-forced max "
                                 f"(margin {MARGIN[dt]})")
    new_tokens = GEN_ROWS * GEN_NEW
    wall = statistics.median(walls["graph"])
    launches, tc = counted["eager"]
    return {
        "phase": "generate", "dtype": dt, "model": "gpt2-small (12 x 768, "
        "vocab 50257), random weights seed 0", "rows": GEN_ROWS,
        "prompt_lengths": [int(n) for n in lens], "T0": T0,
        "t_max": T0 + GEN_NEW, "new_per_row": GEN_NEW, "greedy": True,
        "headline": "wall_s, new_tokens_per_s and ms_per_tick: the median "
                    "of the graph runs",
        "wall_s": wall, "new_tokens": new_tokens,
        "new_tokens_per_s": statistics.median(new_tokens / w
                                              for w in walls["graph"]),
        "first_token_ms": prefill_ms,
        "ms_per_tick": statistics.median((1e3 * w - prefill_ms) / ticks
                                         for w in walls["graph"]),
        "ticks": ticks,
        "peak_memory_gb": peak / 1e9,
        "launches": launches,
        "launches_from": "the first eager run (counted at each launch; the "
                         "captured run's, measured against the device, are "
                         "generate_profile's)",
        "flash_fwd_tensor_core_launches": tc,
        "teacher_forced_worst_gap": worst,
        "teacher_forced_mean_gap": gaps.mean().item(), "margin": MARGIN[dt],
        "turns": list(TURNS), "graph_capture_ms": capture_ms,
        "graph_replays_per_run": ticks - 1,
        "graph_eager_tokens_identical": True,
        **{f"{mode}_new_tokens_per_s": [new_tokens / w for w in ws]
           for mode, ws in walls.items()},
        **{f"{mode}_ms_per_tick": [(1e3 * w - prefill_ms) / ticks
                                   for w in ws]
           for mode, ws in walls.items()},
        **{f"{mode}_allocator_calls": allocs[mode] for mode in allocs},
    }, (lens, prompt, mask, out), fns, walls


def sampled_phase(torch, np, infer, A, model, batch):
    """f32: ``temperature=0.8, top_k=50, top_p=0.95`` twice from generator
    seed 1 gives the same tokens; ``temperature=1, top_k=1`` gives the
    greedy tokens wherever the greedy row maximum is not tied."""
    lens, prompt, mask, greedy = batch
    T0, n = prompt.shape[1], GEN_SAMPLED_NEW

    def run(**kw):
        gen = torch.Generator(device="cuda").manual_seed(1)
        return infer.generate(model, prompt, n, prompt_mask=mask,
                              generator=gen, **kw).cpu()
    kw = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
    a, b = run(**kw), run(**kw)
    require(torch.equal(a, b), "sampled: one generator seed gave two "
                               "different token streams")
    top1 = run(temperature=1.0, top_k=1)
    _, margins = teacher_forced_gaps(torch, A, model, lens, prompt.cpu(),
                                     greedy)
    differ = []
    for i in range(GEN_ROWS):
        d = (top1[i, T0:] != greedy[i, T0:T0 + n]).nonzero()
        if len(d):
            j = int(d[0, 0])
            # tied: the teacher-forced top two within the f32 margin
            require(margins[i, j].item() <= MARGIN["f32"],
                    f"sampled: top_k=1 row {i} left the greedy tokens at "
                    f"step {j}, where the greedy maximum is not tied")
            differ.append(i)
    return {"phase": "generate_sampled", "dtype": "f32", "new_per_row": n,
            "settings": kw, "repeat_identical": True,
            "sampled_ticks": "eager (a sampled tick draws from the "
                             "caller's torch.Generator; not captured)",
            "top_k1_rows_equal_greedy": GEN_ROWS - len(differ),
            "top_k1_rows_differing_at_a_tie": differ,
            "sampled_tokens_differ_from_greedy": int(
                (a[:, T0:] != greedy[:, T0:T0 + n]).sum())}


def generate_int8_phase(torch, np, infer, mods, model, float_out):
    """The generate phase's 16 left-padded prompts, bf16, with the int8 KV
    cache (``kv_quant=True``), captured and eager, beside the float cache
    captured, in turns (``RUNS8``): every int8 run's launch counts
    (``dense_decode_write_q8`` 12 x 127, ``flash_fwd`` 12, nothing else),
    every int8 run's tokens equal to the captured first int8 run's and
    those checked teacher-forced with the rows past the prompt reading
    quantized K/V, every float run's the generate phase's; both caches'
    bytes; one profiled run of the int8 cache captured and eager, its
    launches measured (``profiled_generate``)."""
    A, FA, CU, DA = mods
    lens, prompt_np, mask_np = gen_batch(np, model.config.vocab_size)
    prompt = torch.from_numpy(prompt_np).cuda()
    mask = torch.from_numpy(mask_np).cuda()
    T0 = prompt.shape[1]
    infer.generate(model, prompt, 2, prompt_mask=mask, kv_quant=True)
    fns = {label(kv, mode): fn for kv in ("bf16", "int8")
           for mode, fn in gen_fns(infer, model, kv == "int8").items()}
    walls = {label(kv, mode): [] for kv, mode in RUNS8}
    rec = {"phase": "generate_int8", "dtype": "bf16", "rows": GEN_ROWS,
           "T0": T0, "t_max": T0 + GEN_NEW, "new_per_row": GEN_NEW,
           "greedy": True, "runs": [label(kv, mode) for kv, mode in RUNS8]}
    ticks = GEN_NEW - 1
    capture_ms, int8_out = {}, None
    for kv, mode in RUNS8:
        name = label(kv, mode)
        zero_q8_counts(FA, CU, DA)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fns[name](prompt, prompt_mask=mask)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
        ms = check_gen_stats(fns[name], f"generate_int8 {kv}", mode)
        if ms is not None:
            capture_ms.setdefault(name, []).append(ms)
        out = out.cpu()
        if kv == "bf16":
            require(torch.equal(out, float_out), "generate_int8: the float "
                                                 "cache's tokens changed")
            continue
        launches = q8_counts(FA, CU, DA)
        want = {k: 0 for k in launches}
        want.update(flash_fwd=LAYERS, dense_decode_write_q8=LAYERS * ticks)
        require(launches == want, f"generate_int8 {mode}: launches "
                                  f"{launches} != the schedule's {want}")
        if int8_out is not None:
            require(torch.equal(out, int8_out), f"generate_int8: the {mode} "
                                                f"int8 run gave other tokens "
                                                f"than the graph's first")
            continue
        int8_out = out
        gaps, _ = teacher_forced_gaps(torch, A, model, lens, prompt_np, out,
                                      q8=True)
        worst = gaps.max().item()
        require(worst <= MARGIN["bf16"],
                f"generate_int8: a generated token's logit is {worst} below "
                f"the teacher-forced max over quantized K/V (margin "
                f"{MARGIN['bf16']})")
        rec.update(launches={k: n for k, n in launches.items() if n},
                   teacher_forced_worst_gap=worst,
                   teacher_forced_mean_gap=gaps.mean().item(),
                   margin=MARGIN["bf16"],
                   positions_agreeing_with_float_cache=(
                       (out[:, T0:] == float_out[:, T0:]).float().mean()
                       .item()))
    summaries = {name: profile_summary(torch, *profiled_generate(
        torch, (FA, CU, DA), lambda: fns[name](prompt, prompt_mask=mask),
        f"generate_int8 profile {name}", q8=True), ticks, ticks, "tick",
        walls[name]) for name in ("int8", "int8_eager")}
    check_host_calls("generate_int8", summaries["int8"],
                     summaries["int8_eager"], ticks - 1, 1)
    hk, hd = model.kv_cache_spec()
    slots = 2 * GEN_ROWS * hk * (T0 + GEN_NEW) * LAYERS
    rec.update(
        {f"{name}_wall_s": walls[name] for name in walls},
        **{f"{name}_new_tokens_per_s": [GEN_ROWS * GEN_NEW / w
                                        for w in walls[name]]
           for name in walls},
        **{f"{name}_profile": s for name, s in summaries.items()},
        int8_graph_eager_tokens_identical=True, graph_capture_ms=capture_ms,
        graph_replays_per_run=ticks - 1,
        bf16_cache_bytes=slots * hd * 2, int8_cache_bytes=slots * (hd + 4))
    return rec


def profiled_generate(torch, counters, fn, what, q8):
    """``fn()``, a bf16 generate call, under :func:`counted_profile`, held
    to its schedule: the prefill's 12 tensor-core ``flash_fwd`` launches
    and the fused tick (its int8 form where ``q8``) 12 a tick."""
    sfx = "_q8" if q8 else ""
    return counted_profile(torch, counters, fn, what, {
        "flash_fwd": LAYERS, "flash_fwd_tc": LAYERS,
        "dense_decode_write" + sfx: LAYERS * (GEN_NEW - 1)},
        waves={"prefill_calls": 1, "ticks": GEN_NEW - 1})


def generate_profile_phase(torch, counters, fns, batch, walls):
    """The bf16 generate once more under ``torch.profiler`` with the
    captured tick and with the eager loop: device time by kernel group,
    device ops a tick, the host's CUDA calls a tick (one
    ``cudaGraphLaunch`` a replayed tick, gated), each unprofiled run's
    busy share, and each run's launches measured
    (:func:`profiled_generate`)."""
    _, prompt, mask, _ = batch
    ticks = GEN_NEW - 1
    summaries = {mode: profile_summary(torch, *profiled_generate(
        torch, counters, lambda: fn(prompt, prompt_mask=mask),
        f"generate_profile {mode}", q8=False), ticks, ticks, "tick",
        walls[mode]) for mode, fn in fns.items()}
    check_host_calls("generate_profile", summaries["graph"],
                     summaries["eager"], ticks - 1, 1)
    return {"phase": "generate_profile", "dtype": "bf16",
            **summaries["graph"], "eager": summaries["eager"]}


# ---- phases 9-13: train ----------------------------------------------------

# a GPT-2-small train step's kernel launches: each flash kernel once a
# layer, fused AdamW once
TRAIN_PER_STEP = {"flash_fwd": LAYERS, "flash_bwd_dq": LAYERS,
                  "flash_bwd_dkv": LAYERS, "fused_adamw": 1}
# the train cell's profiled runs: this many more updates of each mode's
# last run (replays, in the captured one)
TRAIN_PROFILE_STEPS = 5
# the kernels PyTorch launches inside a replay for the dropout generator
# registered with the graph: one fill_ of its seed and one of its offset
# into the graph's device state (``CUDAGraph.replay``'s prologue)
RNG_PROLOGUE_FILLS = 2
# a run's first updates, left out of its median step time: the eager
# warm-up and the capture (captured step), the same count eagerly
TRAIN_SKIP_MEDIAN = 3
# the most device memory the captured step may reserve above its run's
# start, as a multiple of the eager step's (its activations once: the
# graph's pool, the warm-up's cached blocks released before the capture)
RESERVED_RATIO = 1.1


def train_counts(FA, FAW) -> dict:
    return {"flash_fwd": FA.launches, "flash_bwd_dq": FA.dq_launches,
            "flash_bwd_dkv": FA.dkv_launches, "fused_adamw": FAW.launches}


def zero_train_counts(FA, FAW) -> None:
    FA.launches = FA.dq_launches = FA.dkv_launches = FAW.launches = 0
    FA.tc_launches = FA.dq_tc_launches = FA.dkv_tc_launches = 0


def tc_counts(FA) -> dict:
    return {"flash_fwd": FA.tc_launches, "flash_bwd_dq": FA.dq_tc_launches,
            "flash_bwd_dkv": FA.dkv_tc_launches}


def train_setup(torch, np, tm, cfg, state_dict, *, compute_dtype, mode,
                optimizer="adamw_fused", **step_kw):
    """A GPT-2 on the card (f32 masters loaded from ``state_dict``), an
    ``optimizer`` with warmup-cosine from 0 over ``TRAIN_STEPS`` updates
    (peak ``TRAIN_LR``), the step functions (``mode``
    "graph": ``make_step_fns``'s captured step, the card's default;
    "eager": the private eager reference; ``step_kw``: more options), a
    fresh state and the one 8 x 1024 batch (numpy seed 0)."""
    GPT2, build_optimizer, make_step_fns = tm
    model = GPT2(cfg)
    model.load_state_dict(state_dict)
    tx = build_optimizer(optimizer, TRAIN_LR, steps_per_epoch=TRAIN_STEPS,
                         total_steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP)
    init_fn, train_step, _ = make_step_fns(
        model, tx, compute_dtype=compute_dtype, _eager=mode == "eager",
        **step_kw)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_T))
    return [model, tx, train_step, init_fn(None),
            torch.from_numpy(tokens).cuda()]


def state_bits(state) -> list:
    """Copies of every parameter, both moments and the count."""
    opt = state.opt_state
    return ([p.detach().clone() for p in state.params.values()]
            + [t.clone() for kind in opt.moments().values()
               for t in kind.values()] + [opt.count.clone()])


def same_bits(torch, a: list, b: list) -> bool:
    """Every tensor of ``a`` bit for bit its partner in ``b``."""
    def raw(t):
        return t.reshape(-1).contiguous().view(torch.uint8)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and raw(x).equal(raw(y))
        for x, y in zip(a, b))


def train_run(torch, FA, FAW, setup, mode, what, steps=TRAIN_STEPS):
    """``steps`` updates of a fresh ``setup``, each to a synchronize (host
    clock), the counters zeroed just before and read just after. In the
    captured mode every update from the second on (the capture and each
    replay, the batch copies before them and the metric copies after)
    runs under ``torch.cuda.set_sync_debug_mode("error")``; the graph
    pool is the device memory reserved across the capture. Memory: the
    peaks allocated and reserved in the run, what was allocated and
    reserved at its start (its own model and optimizer state, and what
    the smoke holds: the weights, the first run's ``state_bits``, a kept
    run) and each peak above its start.
    Returns the run's record (losses as floats) and ``state_bits``."""
    _, _, train_step, state, x = setup
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    start_reserved = torch.cuda.memory_reserved()
    zero_train_counts(FA, FAW)
    losses, step_ms, pool = [], [], None
    for i in range(steps):
        checked = mode == "graph" and i >= 1
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        if checked:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, metrics = train_step(state, x, x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(metrics["loss"])
        if mode == "graph" and i == 1:
            pool = (torch.cuda.memory_reserved() - reserved) / 1e9
    launches, tc = train_counts(FA, FAW), tc_counts(FA)
    require(len({id(v) for v in losses}) == steps,
            f"{what}: a step's loss is not a tensor of its own")
    losses = [float(v) for v in losses]
    want = {k: steps * n for k, n in TRAIN_PER_STEP.items()}
    require(launches == want, f"{what}: launches {launches} != {want}")
    require(all(math.isfinite(v) for v in losses),
            f"{what}: non-finite loss {losses}")
    tail = sorted(step_ms[TRAIN_SKIP_MEDIAN:])
    rec = {"mode": mode, "losses": losses, "step_ms": step_ms,
           "median_step_ms": tail[len(tail) // 2],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "allocated_at_start_gb": start / 1e9,
           "peak_above_start_gb":
               (torch.cuda.max_memory_allocated() - start) / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "reserved_at_start_gb": start_reserved / 1e9,
           "peak_reserved_above_start_gb":
               (torch.cuda.max_memory_reserved() - start_reserved) / 1e9,
           "launches": launches, "tensor_core_launches": tc}
    if mode == "graph":
        stats = train_step.stats
        want_stats = (1, 1, steps - 1)
        got = (stats["eager_steps"], stats["graph_captures"],
               stats["graph_replays"])
        require(got == want_stats, f"{what}: (eager, captures, replays) "
                                   f"{got}, want {want_stats}")
        rec.update(capture_ms=stats["capture_ms"][0], graph_pool_gb=pool,
                   sync_debug_error_steps=steps - 1)
    return rec, state_bits(state)


def train_profile(torch, FA, FAW, setup, mode, what, tc: bool,
                  steps=TRAIN_PROFILE_STEPS):
    """``steps`` more updates of ``setup`` under the profiler, every
    counter zeroed just before: the counters must equal ``steps`` x
    :data:`TRAIN_PER_STEP` (and, ``tc``, every flash launch on the tensor
    cores) and the port's kernel events the device ran. Host calls: in the
    captured mode one ``cudaGraphLaunch`` a step, each inside a replay
    span, and no kernel launch call inside one; the eager mode makes no
    graph launch. Returns ``(prof, wall_s, launches, host)``."""
    _, _, train_step, state, x = setup

    def run():
        nonlocal state
        for _ in range(steps):
            state, _ = train_step(state, x, x)
    zero_train_counts(FA, FAW)
    prof, wall = profile_run(torch, run)
    counted = train_counts(FA, FAW)
    counted.update({f"{k}_tc": n for k, n in tc_counts(FA).items()})
    want = {k: steps * n for k, n in TRAIN_PER_STEP.items()}
    want.update({f"{k}_tc": steps * LAYERS if tc else 0
                 for k in tc_counts(FA)})
    require(counted == want, f"{what}: launches {counted} != {want}")
    ran = device_launches(torch, prof)
    device = {k: ran.get(k, 0) for k in set(ran) | set(counted)}
    counted_all = {k: counted.get(k, 0) for k in device}
    require(device == counted_all, f"{what}: the device ran {device}, the "
                                   f"counters say {counted_all}")
    host = host_calls(torch, prof)
    if mode == "graph":
        require(host["graph_launches"] == host["replays"] == steps
                and host["graph_launches_in_replays"] == steps,
                f"{what}: {host['graph_launches']} cudaGraphLaunch calls "
                f"in {host['replays']} replay spans, want one for each of "
                f"{steps} steps")
        # inside a replay only the prologue PyTorch runs for a registered
        # generator that the graph draws from (two fill_ kernels: its
        # seed and offset, copied into the graph's device state); none
        # of the step's own kernels
        fills = host["ops_in_replays"].get("aten::fill_", 0)
        require(host["kernel_launches_in_replays"] == fills
                == RNG_PROLOGUE_FILLS * steps,
                f"{what}: {host['kernel_launches_in_replays']} kernel "
                f"launch calls inside the replays, {fills} aten::fill_, "
                f"want the generator prologue's {RNG_PROLOGUE_FILLS} a "
                f"replay and nothing else: {host['ops_in_replays']}")
    else:
        require(host["graph_launches"] == 0 and host["replays"] == 0,
                f"{what}: the eager run launched graphs: {host}")
    return prof, wall, counted, host


def train_profile_summary(torch, prof, wall, launches, host, steps,
                          median_ms: list) -> dict:
    """A profiled train run: device time a step by kernel group, device
    ops and host API calls a step, and the device busy share of each
    unprofiled run of the mode (the kernels' device time a step over that
    run's median step time; one stream, so kernels do not overlap)."""
    total_us, groups, top = device_time(torch, prof)
    per_step_ms = total_us / 1e3 / steps
    return {
        "steps": steps, "wall_s_profiled": wall,
        "launches": launches, "launches_measured": "counters zeroed just "
        "before this profiled run, equal to its device kernel events and "
        "the schedule (gated)",
        "device_ms_per_step": per_step_ms,
        "device_busy_share": [per_step_ms / m for m in median_ms],
        "device_ops_per_step": sum(n for n, _ in groups.values()) / steps,
        "kernel_launch_calls_per_step": host["kernel_launches"] / steps,
        "graph_launch_calls_per_step": host["graph_launches"] / steps,
        "host_calls": host,
        "groups_ms_per_step": {
            g: {"launches_per_step": n / steps, "ms": us / 1e3 / steps}
            for g, (n, us) in sorted(groups.items(),
                                     key=lambda kv: -kv[1][1])},
        "top_kernels": [{"name": name[:100], "launches": n,
                         "ms_per_step": us / 1e3 / steps}
                        for name, (n, us) in top],
    }


def pooled_median(runs: list) -> float:
    tail = sorted(ms for r in runs for ms in r["step_ms"][TRAIN_SKIP_MEDIAN:])
    return tail[len(tail) // 2]


def train_phase(torch, np, tm, FA, FAW, GPT2Config):
    """GPT-2-small, bf16 over f32 masters, dropout 0.1, ``adamw_fused``:
    the captured step and the eager reference in turns (``TURNS``), each
    run 20 updates of a fresh model from the same weights; every run's
    losses and final parameters, moments and count bit-identical to the
    first's (gated). Then the last run of each mode once more under the
    profiler (:func:`train_profile`). Returns the train record, the
    profile record and the weights."""
    cfg = GPT2Config.small()
    base = tm[0](cfg).init(torch.Generator().manual_seed(0)).state_dict()
    runs, kept, first = [], {}, None
    for turn, mode in enumerate(TURNS):
        setup = train_setup(torch, np, tm, cfg, base, mode=mode,
                            compute_dtype="bfloat16")
        what = f"train {mode} run {turn + 1}"
        rec, bits = train_run(torch, FA, FAW, setup, mode, what)
        want_tc = dict.fromkeys(rec["tensor_core_launches"],
                                TRAIN_STEPS * LAYERS)
        require(rec["tensor_core_launches"] == want_tc,
                f"{what}: tensor-core launches "
                f"{rec['tensor_core_launches']} != {want_tc}")
        losses = rec["losses"]
        require(losses[-1] <= losses[0] - 1.0,
                f"{what}: loss {losses[0]} -> {losses[-1]}, not 1 nat lower")
        if first is None:
            first = (losses, bits)
        else:
            require(losses == first[0], f"{what}: losses {losses} differ "
                                        f"from run 1's {first[0]}")
            require(same_bits(torch, bits, first[1]),
                    f"{what}: parameters, moments or count after "
                    f"{TRAIN_STEPS} steps differ from run 1's")
        del bits
        runs.append(rec)
        if turn >= 2:
            kept[mode] = setup     # the last run of each mode, profiled
        del setup
        torch.cuda.empty_cache()
    del first
    graphs_, eagers = ([r for r in runs if r["mode"] == m]
                       for m in ("graph", "eager"))
    reserved = {m: max(r["peak_reserved_above_start_gb"] for r in rs)
                for m, rs in (("graph", graphs_), ("eager", eagers))}
    require(reserved["graph"] <= RESERVED_RATIO * reserved["eager"],
            f"train: the captured step reserved {reserved['graph']} GB "
            f"above its start, the eager one {reserved['eager']} GB (more "
            f"than {RESERVED_RATIO}x: the warm-up's cached activations "
            f"kept beside the graph's pool?)")
    profiles = {}
    for mode in ("graph", "eager"):
        prof, wall, launches, host = train_profile(
            torch, FA, FAW, kept[mode], mode, f"train_profile {mode}",
            tc=True)
        profiles[mode] = train_profile_summary(
            torch, prof, wall, launches, host, TRAIN_PROFILE_STEPS,
            [r["median_step_ms"] for r in runs if r["mode"] == mode])
    del kept
    torch.cuda.empty_cache()
    tokens = TRAIN_BATCH * TRAIN_T
    medians = {"graph": pooled_median(graphs_),
               "eager": pooled_median(eagers)}
    rec = {"phase": "train", "model": "gpt2-small (12 x 768, vocab 50257, "
           "T 1024, dropout 0.1), random weights seed 0",
           "batch": [TRAIN_BATCH, TRAIN_T], "compute_dtype": "bf16",
           "masters": "f32", "optimizer": "adamw_fused", "lr": TRAIN_LR,
           "warmup_steps": TRAIN_WARMUP, "schedule": "warmup-cosine from 0 "
           f"over {TRAIN_STEPS} updates", "steps": TRAIN_STEPS,
           "turns": list(TURNS),
           "bit_identical": "losses, parameters, moments and count after "
           f"{TRAIN_STEPS} steps, every run against the first (gated)",
           "median_step_ms": medians["graph"],
           "median_step_ms_eager": medians["eager"],
           "median_of": f"the mode's runs' step times after the first "
                        f"{TRAIN_SKIP_MEDIAN}",
           "tokens_per_s": tokens / (medians["graph"] / 1e3),
           "tokens_per_s_eager": tokens / (medians["eager"] / 1e3),
           "losses": runs[0]["losses"],
           "loss_drop": runs[0]["losses"][0] - runs[0]["losses"][-1],
           "peak_reserved_above_start_gb": reserved,
           "launches": runs[0]["launches"],
           "launches_per_step": TRAIN_PER_STEP,
           "tensor_core_launches": runs[0]["tensor_core_launches"],
           "runs": [{k: v for k, v in r.items() if k != "losses"}
                    for r in runs]}
    prof_rec = {"phase": "train_profile", "steps": TRAIN_PROFILE_STEPS,
                **{mode: p for mode, p in profiles.items()}}
    return rec, prof_rec, base


def parity_phase(torch, np, tm, A, FA, FAW, GPT2Config):
    """f32, dropout 0, two layers at full width. One step's gradients and
    five steps' losses of the kernel path (the captured step: the first
    update eager, then a capture and replays) against the plain path: the
    model's own layers with dense attention under autograd, and
    ``fused_adamw_plain`` per leaf with the same step scalars. Then the
    captured run goes on to 20 updates, and an eager run of 20 from the
    same weights must give bit-identical losses, parameters, moments and
    count."""
    import dataclasses
    cfg = dataclasses.replace(GPT2Config.small(), num_layers=PARITY_LAYERS,
                              dropout_rate=0.0)
    sd = tm[0](cfg).init(torch.Generator().manual_seed(0)).state_dict()
    setup = train_setup(torch, np, tm, cfg, sd, mode="graph",
                        compute_dtype=None)
    _, tx, train_step, state, x = setup
    ref = tm[0](cfg)
    ref.load_state_dict(sd)
    ref_params = dict(ref.named_parameters())
    mu = {n: torch.zeros_like(p) for n, p in ref_params.items()}
    nu = {n: torch.zeros_like(p) for n, p in ref_params.items()}
    always = torch.ones((), dtype=torch.bool, device=x.device)
    zero_train_counts(FA, FAW)
    losses_k, losses_p, grad_errs = [], [], {}
    for step in range(PARITY_STEPS):
        state, metrics = train_step(state, x, x)
        losses_k.append(float(metrics["loss"]))
        for p in ref_params.values():
            p.grad = None
        loss = ref.loss_fn(reference_logits(torch, A, ref, x), x)
        loss.backward()
        losses_p.append(float(loss.detach()))
        if step == 0:
            for n, p in state.params.items():
                w = ref_params[n].grad
                grad_errs[n] = ((p.grad - w).abs().max()
                                / w.abs().max()).item()
        sc = tx.scalars(torch.tensor(step, dtype=torch.int32,
                                     device=x.device))
        with torch.no_grad():
            for n, p in ref_params.items():
                new = FAW.fused_adamw_plain(p.grad, p, mu[n], nu[n], sc,
                                            always, **tx.hyper)
                for dst, src in zip((p, mu[n], nu[n]), new):
                    dst.copy_(src)
    launches, tc = train_counts(FA, FAW), tc_counts(FA)
    require(not any(tc.values()), f"train_parity: f32 took the tensor-core "
                                  f"flash kernels: {tc}")
    worst = max(grad_errs, key=grad_errs.get)
    require(grad_errs[worst] <= GRAD_TOL,
            f"train_parity: gradient of {worst} off by "
            f"{grad_errs[worst]} of its max (> {GRAD_TOL})")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    require(loss_err <= LOSS_TOL, f"train_parity: losses {losses_k} vs "
                                  f"plain {losses_p}")
    require(all(n > 0 for n in launches.values()),
            f"train_parity: a kernel never launched: {launches}")
    del ref, ref_params, mu, nu
    # the rest of 20 updates captured, then 20 eager from the same weights
    graph_losses = losses_k + [float(train_step(state, x, x)[1]["loss"])
                               for _ in range(TRAIN_STEPS - PARITY_STEPS)]
    stats = dict(train_step.stats)
    graph_bits = state_bits(state)
    del setup, state, train_step
    torch.cuda.empty_cache()
    eager = train_setup(torch, np, tm, cfg, sd, mode="eager",
                        compute_dtype=None)
    eager_losses = [float(eager[2](eager[3], x, x)[1]["loss"])
                    for _ in range(TRAIN_STEPS)]
    require(eager_losses == graph_losses,
            f"train_parity: captured losses {graph_losses} != eager "
            f"{eager_losses}")
    require(same_bits(torch, state_bits(eager[3]), graph_bits),
            f"train_parity: parameters, moments or count after "
            f"{TRAIN_STEPS} steps differ, captured against eager")
    require((stats["eager_steps"], stats["graph_captures"],
             stats["graph_replays"]) == (1, 1, TRAIN_STEPS - 1),
            f"train_parity: captured step stats {stats}")
    return {"phase": "train_parity", "dtype": "f32", "layers": PARITY_LAYERS,
            "batch": [TRAIN_BATCH, TRAIN_T], "steps": PARITY_STEPS,
            "losses": losses_k, "plain_losses": losses_p,
            "loss_rel_err": loss_err, "loss_tol": LOSS_TOL,
            "worst_grad_leaf": worst, "worst_grad_rel_err": grad_errs[worst],
            "grad_tol": GRAD_TOL, "leaves": len(grad_errs),
            "launches": launches, "tensor_core_launches": tc,
            "captured_vs_eager_steps": TRAIN_STEPS,
            "captured_vs_eager": "losses, parameters, moments and count "
                                 "bit-identical (gated)",
            "captured_losses": graph_losses, "capture_ms":
                stats["capture_ms"][0]}


# the poisoned element of the train_skip phase: one entry of wte
SKIP_AT = (0, 0)


def train_skip_phase(torch, np, tm, GPT2Config, base):
    """``nonfinite_policy="skip"`` on the captured step, GPT-2-small as the
    train cell, for ``adamw_fused`` and ``adamw``: three clean updates (the
    warm-up, the capture, a replay), then one ``wte`` element of the
    master parameters set to inf in place and a replay: ``skipped`` 1, a
    non-finite ``grad_sumsq``, and parameters, moments and count
    bit-identical to before it; the element restored, two more replays
    train (``skipped`` 0, finite losses, the count advanced by 2)."""
    cfg = GPT2Config.small()
    rec = {"phase": "train_skip", "model": "gpt2-small as the train cell",
           "poisoned": f"wte.weight{list(SKIP_AT)} = inf"}
    for optimizer in ("adamw_fused", "adamw"):
        what = f"train_skip {optimizer}"
        setup = train_setup(torch, np, tm, cfg, base, mode="graph",
                            optimizer=optimizer, compute_dtype="bfloat16",
                            nonfinite_policy="skip", sentinel=True)
        _, _, train_step, state, x = setup
        seen = []
        for _ in range(3):
            state, m = train_step(state, x, x)
            seen.append({k: float(v) for k, v in m.items()})
        wte = state.params["wte.weight"].detach()
        clean = wte[SKIP_AT].clone()
        wte[SKIP_AT] = float("inf")
        before = state_bits(state)
        count0 = int(state.opt_state.count)
        replays = train_step.stats["graph_replays"]
        state, m = train_step(state, x, x)
        skipped = {k: float(v) for k, v in m.items()}
        require(skipped["skipped"] == 1.0
                and not math.isfinite(skipped["grad_sumsq"]),
                f"{what}: the poisoned replay reported {skipped}")
        require(train_step.stats["graph_replays"] == replays + 1,
                f"{what}: the poisoned update was not a replay")
        require(same_bits(torch, state_bits(state), before),
                f"{what}: the skipped update changed parameters, moments "
                f"or count")
        del before
        wte[SKIP_AT] = clean
        for _ in range(2):
            state, m = train_step(state, x, x)
            seen.append({k: float(v) for k, v in m.items()})
        require(all(s["skipped"] == 0.0 and math.isfinite(s["loss"])
                    and math.isfinite(s["grad_sumsq"]) for s in seen),
                f"{what}: a clean update reported {seen}")
        require(int(state.opt_state.count) == count0 + 2,
                f"{what}: count {int(state.opt_state.count)} after two "
                f"clean replays from {count0}")
        rec[optimizer] = {"clean": seen, "poisoned": skipped,
                          "count_before": count0,
                          "count_after": int(state.opt_state.count),
                          "stats": {k: v for k, v in
                                    train_step.stats.items()}}
        del setup, state, train_step
        torch.cuda.empty_cache()
    return rec


CLI_LINES = {
    "train": re.compile(r"^epoch: (\d+) \[\d+/\d+ \(\d+%\)\]\t Loss:[\d.]+$",
                        re.M),
    "eval": re.compile(r"^Test set: Average loss: [\d.]+, Accuracy: "
                       r"\d+/\d+ \(\d+%\)$", re.M),
    "time": re.compile(r"^time to complete this epoch: [\d.]+ seconds "
                       r"\([\d.]+ samples/s\)$", re.M),
}


def cli_phase(torch, interop, GPT2, GPT2Config):
    """The trainer CLI for one epoch, then resumed for a second: the
    reference-format lines, a checkpoint the serving reader loads into a
    GPT-2 of the trained sizes, and a resume that starts at epoch 1."""
    import dataclasses
    rec = {"phase": "train_cli"}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt.npz")
        cmd = [sys.executable, "-m", "distributed_compute_pytorch_tpu_torch.cli",
               "--model", "gpt2", "--dataset", "synthetic-lm",
               "--optimizer", "adamw_fused", "--compute_dtype", "bfloat16",
               "--batch_size", "32", "--ckpt_path", ckpt]
        for run, extra in (("first", ["--epochs", "1"]),
                           ("resumed", ["--resume", "--epochs", "2"])):
            t0 = time.monotonic()
            res = subprocess.run(cmd + extra, cwd=ROOT, capture_output=True,
                                 text=True, timeout=600)
            rec[f"{run}_s"] = time.monotonic() - t0
            out = res.stdout
            require(res.returncode == 0, f"train_cli {run}: rc "
                    f"{res.returncode}\n{out[-2000:]}\n{res.stderr[-4000:]}")
            for kind, pat in CLI_LINES.items():
                require(pat.search(out) is not None,
                        f"train_cli {run}: no {kind} line in\n{out[-2000:]}")
            epochs = sorted({int(e) for e in CLI_LINES["train"].findall(out)})
            rec[f"{run}_epochs"] = epochs
            rec[f"{run}_tail"] = out.strip().splitlines()[-4:]
            if run == "first":
                require(epochs == [0], f"train_cli: epochs {epochs}")
            else:
                require(re.search(r"resumed from .* at epoch 1\b", out)
                        is not None and epochs == [1],
                        f"train_cli: resume did not start at epoch 1:\n"
                        f"{out[:2000]}")
            require(os.path.isfile(ckpt), "train_cli: no checkpoint")
        tree = interop.load_jax_checkpoint(ckpt)
        cfg = dataclasses.replace(GPT2Config.small(), vocab_size=256,
                                  max_seq_len=128)
        model = interop.load_gpt2_params(GPT2(cfg), tree)
        require(all(bool(torch.isfinite(p).all())
                    for p in model.parameters()),
                "train_cli: reloaded checkpoint holds non-finite params")
        rec["checkpoint_mb"] = os.path.getsize(ckpt) / 1e6
    return rec


# the reference's workload (BASELINE config 0): the MNIST ConvNet at
# batch 128 (469 steps an epoch over 60,000 images), f32, Adadelta at the
# reference's lr 1e-3 with StepLR gamma 0.7. The phase builds the schedule
# at 200 steps an epoch, so the rate drops twice inside the captured run's
# replays (steps 200 and 400).
CONVNET_BATCH, CONVNET_LR, CONVNET_GAMMA, CONVNET_SPE = 128, 1e-3, 0.7, 200
CONVNET_STEPS = 469
# the learning check: torch's own Adadelta default, one epoch
CONVNET_LEARN_LR, CONVNET_MIN_ACCURACY = 1.0, 0.9
# steps of each profiled run, and a run's first steps left out of its
# rate (the eager warm-up and the capture, and one more)
CONVNET_PROFILE_STEPS, CONVNET_SKIP = 20, 3
# the data-parallel step's collectives a step: the gradient all-reduce and
# the BatchNorm statistics' all-reduce, forward and backward
CONVNET_COLLECTIVES = 3
# c10d's host op of an NCCL all-reduce
NCCL_OP = "nccl:all_reduce"


def convnet_data():
    """The mnist train and test splits (the synthetic stand-in: the repo
    holds no idx files), and feeders of the reference's batch."""
    from distributed_compute_pytorch_tpu_torch.data.datasets import (
        load_dataset)
    from distributed_compute_pytorch_tpu_torch.data.loader import (
        DeviceFeeder)
    train, test = (load_dataset("mnist", split) for split in ("train",
                                                              "test"))
    feed = DeviceFeeder(train, CONVNET_BATCH, "cuda", shuffle=True, seed=0)
    test_feed = DeviceFeeder(test, CONVNET_BATCH, "cuda", shuffle=False)
    require(feed.steps_per_epoch == CONVNET_STEPS,
            f"convnet: {feed.steps_per_epoch} steps an epoch, want "
            f"{CONVNET_STEPS}")
    return train, test, feed, test_feed


def convnet_setup(cm, weights, mode, lr=CONVNET_LR):
    """A ConvNet on the card loaded with ``weights``, Adadelta + StepLR,
    and ``(train_step, eval_step, state)`` (``mode`` "graph": the
    captured step; "eager": the private eager reference)."""
    ConvNet, build_optimizer, make_step_fns = cm
    model = ConvNet()
    model.load_state_dict(weights)
    tx = build_optimizer("adadelta", lr, gamma=CONVNET_GAMMA,
                         steps_per_epoch=CONVNET_SPE)
    init_fn, train_step, eval_step = make_step_fns(
        model, tx, _eager=mode == "eager")
    return [train_step, eval_step, init_fn(None)]


def convnet_bits(state) -> list:
    """``state_bits`` and the BatchNorm running stats."""
    return state_bits(state) + [t.clone() for t in
                                state.model_state.values()]


def convnet_run(torch, feed, setup, mode, what) -> tuple[dict, list]:
    """One epoch of ``feed`` through ``setup``'s step, the state updated
    in place. In the captured mode every update from the second on (the
    capture and each replay) runs under ``set_sync_debug_mode("error")``.
    Rates by the host clock from a synchronize after the first
    ``CONVNET_SKIP`` steps to one after the last. Returns the record and
    the losses."""
    train_step, _, state = setup
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_steady = t0
    for i, (x, y) in enumerate(feed.epoch(0)):
        if i == CONVNET_SKIP:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        if mode == "graph" and i >= 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, metrics = train_step(state, x, y)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    setup[2] = state
    losses = [float(v) for v in losses]
    require(len(losses) == CONVNET_STEPS
            and all(math.isfinite(v) for v in losses),
            f"{what}: {len(losses)} steps, losses {losses[:3]}...")
    steady = CONVNET_STEPS - CONVNET_SKIP
    rec = {"mode": mode, "epoch_s": t1 - t0,
           "step_ms": 1e3 * (t1 - t_steady) / steady,
           "samples_per_s": steady * CONVNET_BATCH / (t1 - t_steady)}
    if mode == "graph":
        stats = train_step.stats
        got = (stats["eager_steps"], stats["graph_captures"],
               stats["graph_replays"])
        want = (1, 1, CONVNET_STEPS - 1)
        require(got == want, f"{what}: (eager, captures, replays) {got}, "
                             f"want {want}")
        rec.update(capture_ms=stats["capture_ms"][0],
                   sync_debug_error_steps=CONVNET_STEPS - 1)
    return rec, losses


def convnet_eval(torch, test_feed, setup) -> dict:
    """The test split through ``eval_step``: the sums and the accuracy."""
    _, eval_step, state = setup
    total = None
    for x, y, valid in test_feed.epoch(0, with_valid=True):
        total = eval_step(state, x, y, total, valid)
    count = int(total["count"])
    return {"loss": float(total["loss_sum"]) / count,
            "correct": int(total["correct"]), "count": count,
            "accuracy": int(total["correct"]) / count}


def convnet_profile(torch, setup, batch, mode, what,
                    steps=CONVNET_PROFILE_STEPS):
    """``steps`` more updates of ``setup`` on one device batch under the
    profiler. Host calls: captured, one ``cudaGraphLaunch`` a step, each
    in a replay span, and inside a replay no kernel launch call but the
    dropout generator's two ``fill_`` prologue launches (gated); eager,
    no graph launch. No kernel of the port's runs on this path (gated).
    Returns ``(prof, wall_s, host)``."""
    train_step, _, state = setup
    x, y = batch

    def run():
        nonlocal state
        for _ in range(steps):
            state, _ = train_step(state, x, y)
    prof, wall = profile_run(torch, run)
    setup[2] = state
    ported = device_launches(torch, prof)
    require(not ported, f"{what}: port kernels ran on the ConvNet path: "
                        f"{ported}")
    host = host_calls(torch, prof)
    if mode == "graph":
        fills = host["ops_in_replays"].get("aten::fill_", 0)
        require(host["graph_launches"] == host["replays"] == steps
                and host["graph_launches_in_replays"] == steps
                and host["kernel_launches_in_replays"] == fills
                == RNG_PROLOGUE_FILLS * steps,
                f"{what}: want one cudaGraphLaunch a replayed step and only "
                f"the generator prologue's {RNG_PROLOGUE_FILLS} fill_ "
                f"launches inside: {host}")
    else:
        require(host["graph_launches"] == 0 and host["replays"] == 0,
                f"{what}: the eager run launched graphs: {host}")
    return prof, wall, host


def convnet_summary(torch, prof, wall, host, step_ms: list,
                    steps=CONVNET_PROFILE_STEPS) -> dict:
    """A profiled ConvNet run: device time and ops a step, host calls a
    step, the busy share of each unprofiled run of the mode (device time
    a step over its step time), the top kernels."""
    total_us, groups, top = device_time(torch, prof)
    per_step = total_us / 1e3 / steps
    return {"steps": steps, "wall_s_profiled": wall,
            "device_ms_per_step": per_step,
            "device_busy_share": [per_step / ms for ms in step_ms],
            "device_ops_per_step": sum(n for n, _ in groups.values()) / steps,
            "kernel_launch_calls_per_step": host["kernel_launches"] / steps,
            "graph_launch_calls_per_step": host["graph_launches"] / steps,
            "top_kernels": [{"name": name[:100], "launches": n,
                             "ms_per_step": us / 1e3 / steps}
                            for name, (n, us) in top]}


def convnet_phase(torch, cm, data, smi):
    """The reference's workload on the card: the ConvNet through
    ``make_step_fns`` with Adadelta, one epoch of 469 steps, the captured
    step and the eager one in turns (``TURNS``), each from the same
    weights; every run's losses, parameters, Adadelta slots, count and
    BatchNorm running stats bit-identical to the first's (gated); a
    profiled run of each mode; the test accuracy; then one epoch at lr
    1.0, which must reach ``CONVNET_MIN_ACCURACY``. Returns the record,
    the first captured run's losses and bits, the weights and the
    captured mode's profile."""
    _, _, feed, test_feed = data
    weights = cm[0](device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    runs, first, kept = [], None, {}
    for turn, mode in enumerate(TURNS):
        setup = convnet_setup(cm, weights, mode)
        what = f"convnet {mode} run {turn + 1}"
        rec, losses = convnet_run(torch, feed, setup, mode, what)
        bits = convnet_bits(setup[2])
        if first is None:
            first = (losses, bits)
            rec["eval"] = convnet_eval(torch, test_feed, setup)
        else:
            require(losses == first[0], f"{what}: losses differ from run "
                                        f"1's")
            require(same_bits(torch, bits, first[1]),
                    f"{what}: parameters, slots, count or BatchNorm stats "
                    f"differ from run 1's")
        runs.append(rec)
        if turn >= 2:
            kept[mode] = setup
    batch = next(iter(feed.epoch(1)))
    profiles, graph_prof = {}, None
    for mode in ("graph", "eager"):
        prof, wall, host = convnet_profile(torch, kept[mode], batch, mode,
                                           f"convnet profile {mode}")
        profiles[mode] = convnet_summary(
            torch, prof, wall, host,
            [r["step_ms"] for r in runs if r["mode"] == mode])
        if mode == "graph":
            graph_prof = device_events(torch, prof)
    del kept
    learn = convnet_setup(cm, weights, "graph", lr=CONVNET_LEARN_LR)
    learn_rec, learn_losses = convnet_run(torch, feed, learn, "graph",
                                          "convnet lr 1.0")
    learn_rec["eval"] = convnet_eval(torch, test_feed, learn)
    require(learn_rec["eval"]["accuracy"] >= CONVNET_MIN_ACCURACY,
            f"convnet lr 1.0: test accuracy {learn_rec['eval']['accuracy']}"
            f" after one epoch, want >= {CONVNET_MIN_ACCURACY}")
    del learn
    torch.cuda.empty_cache()

    def median(mode, key):
        return statistics.median(r[key] for r in runs if r["mode"] == mode)
    rec = {"phase": "convnet", "card": smi,
           "model": "the reference MNIST ConvNet (conv 32, conv 64, fc 9216"
                    " x 128, BatchNorm1d, fc 128 x 10), random weights seed 0",
           "data": "mnist: the synthetic stand-in, 60,000 x 28 x 28 x 1 "
                   "train, 10,000 test, 10 classes",
           "batch": CONVNET_BATCH, "steps": CONVNET_STEPS, "dtype": "f32",
           "optimizer": f"adadelta lr {CONVNET_LR}, StepLR gamma "
                        f"{CONVNET_GAMMA} every {CONVNET_SPE} steps",
           "cudnn_deterministic": True, "turns": list(TURNS),
           "bit_identical": "losses, parameters, Adadelta slots, count and "
                            "BatchNorm running stats after the epoch, every "
                            "run against the first (gated)",
           "samples_per_s": median("graph", "samples_per_s"),
           "samples_per_s_eager": median("eager", "samples_per_s"),
           "step_ms": median("graph", "step_ms"),
           "step_ms_eager": median("eager", "step_ms"),
           "rate_of": f"the mode's runs' median, steps {CONVNET_SKIP + 1}-"
                      f"{CONVNET_STEPS} by the host clock",
           "loss_first_last": [first[0][0], first[0][-1]],
           "test": runs[0]["eval"],
           "learn": {"lr": CONVNET_LEARN_LR, "samples_per_s":
                     learn_rec["samples_per_s"], "eval": learn_rec["eval"],
                     "loss_first_last": [learn_losses[0], learn_losses[-1]]},
           "profile": profiles, "runs": runs}
    return rec, first, weights, graph_prof, batch


def convnet_ddp_phase(torch, cm, mesh, data, weights, first, base_prof,
                      batch, smi):
    """The convnet phase's captured step under a one-process ``nccl``
    group: bit-identical to that phase's captured run (a SUM over one
    rank, divided by 1, keeps the bits; gated); the eager warm-up and the
    capture each issue ``CONVNET_COLLECTIVES`` all-reduces (c10d's host
    ops, gated), so the graph holds them; a profiled run of replays, one
    ``cudaGraphLaunch`` each (gated), beside the ungrouped replays. The
    collectives' device time a step: the three all-reduces alone, at the
    step's sizes and in place as the step issues them, captured and
    replayed under the profiler."""
    import socket
    import torch.distributed as dist
    from distributed_compute_pytorch_tpu_torch.utils import graphs
    _, _, feed, _ = data
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mesh.initialize_distributed(f"127.0.0.1:{port}", 1, 0, "cuda")
    n = CONVNET_PROFILE_STEPS
    try:
        require(mesh.distributed() and dist.get_backend() == "nccl"
                and mesh.process_count() == 1,
                "convnet_ddp: no one-rank nccl group")
        setup = convnet_setup(cm, weights, "graph")
        rec, losses = convnet_run(torch, feed, setup, "graph",
                                  "convnet_ddp captured")
        require(losses == first[0], "convnet_ddp: losses differ from the "
                                    "ungrouped captured run's")
        require(same_bits(torch, convnet_bits(setup[2]), first[1]),
                "convnet_ddp: parameters, slots, count or BatchNorm stats "
                "differ from the ungrouped captured run's")
        flat_numel = setup[2].flat_grads.numel()
        prof, wall, host = convnet_profile(torch, setup, batch, "graph",
                                           "convnet_ddp profile")
        summary = convnet_summary(torch, prof, wall, host, [rec["step_ms"]])
        events = device_events(torch, prof)
        extra = {}
        for k in set(events) | set(base_prof):
            (a, ta), (b, tb) = (d.get(k, (0, 0.0)) for d in (events,
                                                             base_prof))
            if a != b:
                extra[k] = [(a - b) / n, (ta - tb) / 1e3 / n]
        del setup
        # the collectives the warm-up and the capture issue
        fresh = convnet_setup(cm, weights, "graph")
        x, y = batch

        def two():
            for _ in range(2):
                fresh[2], _ = fresh[0](fresh[2], x, y)
        cap_prof, _ = profile_run(torch, two)
        ops = sum(e.count for e in cap_prof.key_averages()
                  if e.key == NCCL_OP)
        require(ops == 2 * CONVNET_COLLECTIVES and
                fresh[0].stats["graph_captures"] == 1,
                f"convnet_ddp: {ops} {NCCL_OP} ops in the warm-up and the "
                f"capture, want {2 * CONVNET_COLLECTIVES}")
        del fresh
        # the three collectives alone: the flat gradients (and the loss
        # slot) in f32, BatchNorm's 2 x 128 sums and count in f64, twice
        bufs = [torch.zeros(flat_numel, device="cuda")] + [
            torch.zeros(257, dtype=torch.float64, device="cuda")
            for _ in range(2)]

        def collectives():
            for b in bufs:
                dist.all_reduce(b)
        collectives()
        program = graphs.capture(collectives)

        def replays():
            for _ in range(n):
                program.replay()
        coll_prof, _ = profile_run(torch, replays)
        coll_events = device_events(torch, coll_prof)
        coll_ms = sum(t for _, t in coll_events.values()) / 1e3 / n
        del program, bufs
    finally:
        mesh.shutdown_distributed()
    torch.cuda.empty_cache()
    return {"phase": "convnet_ddp", "card": smi, "backend": "nccl",
            "world": 1, "bit_identical_to_ungrouped_captured_run": True,
            "collectives_a_step": CONVNET_COLLECTIVES,
            "nccl_ops_in_warmup_and_capture": ops,
            "collectives_device_ms_per_step": coll_ms,
            "collectives_device_events_per_step": {
                k: v[0] / n for k, v in coll_events.items()},
            "collectives_measured": "the step's three all-reduces alone, "
                                    "in place at its sizes, captured and "
                                    "replayed under the profiler",
            "device_events_changed_per_step_vs_ungrouped": extra,
            "samples_per_s": rec["samples_per_s"], "step_ms": rec["step_ms"],
            "capture_ms": rec["capture_ms"], "profile": summary}


def convnet_cli_phase(torch, interop, ConvNet, smi):
    """The trainer CLI on the reference's workload: one epoch of the
    ConvNet on mnist (the synthetic stand-in) with Adadelta, then
    ``--resume --epochs 2``, then one epoch as a one-rank world (``nccl``)
    through ``--coordinator``/``--num_processes``/``--process_id``; the
    reference-format lines of each, and the checkpoint loads into a
    ConvNet through the JAX-layout reader."""
    import socket
    rec = {"phase": "convnet_cli", "card": smi}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, ckpt_dp = (os.path.join(tmp, n) for n in ("c.npz", "d.npz"))
        cmd = [sys.executable, "-m",
               "distributed_compute_pytorch_tpu_torch.cli",
               "--model", "convnet", "--dataset", "mnist",
               "--optimizer", "adadelta", "--data_dir", tmp]
        plans = (("first", ["--epochs", "1", "--ckpt_path", ckpt], [0]),
                 ("resumed", ["--resume", "--epochs", "2", "--ckpt_path",
                              ckpt], [1]),
                 ("one_rank_world", ["--epochs", "1", "--ckpt_path", ckpt_dp,
                                     "--coordinator", f"127.0.0.1:{port}",
                                     "--num_processes", "1",
                                     "--process_id", "0"], [0]))
        for run, extra, want_epochs in plans:
            t0 = time.monotonic()
            res = subprocess.run(cmd + extra, cwd=ROOT, capture_output=True,
                                 text=True, timeout=600)
            rec[f"{run}_s"] = time.monotonic() - t0
            out = res.stdout
            require(res.returncode == 0, f"convnet_cli {run}: rc "
                    f"{res.returncode}\n{out[-2000:]}\n{res.stderr[-4000:]}")
            for kind, pat in CLI_LINES.items():
                require(pat.search(out) is not None,
                        f"convnet_cli {run}: no {kind} line in\n{out[-2000:]}")
            epochs = sorted({int(e) for e in CLI_LINES["train"].findall(out)})
            require(epochs == want_epochs, f"convnet_cli {run}: epochs "
                                           f"{epochs}, want {want_epochs}")
            require("model: convnet" in out and "optimizer: adadelta" in out,
                    f"convnet_cli {run}: not the convnet run:\n{out[:1000]}")
            if run == "resumed":
                require(re.search(r"resumed from .* at epoch 1\b", out)
                        is not None, f"convnet_cli: resume did not start at "
                                     f"epoch 1:\n{out[:2000]}")
            if run == "one_rank_world":
                require("world: 1 (nccl)" in out, f"convnet_cli: no nccl "
                        f"group in\n{out[:1000]}")
            rec[f"{run}_tail"] = out.strip().splitlines()[-4:]
        for path in (ckpt, ckpt_dp):
            flat = interop.read_checkpoint(path)[0]
            model = ConvNet()
            model.load_state_dict(interop.convnet_params_from_jax(
                interop.unflatten(flat, ".params"),
                interop.unflatten(flat, ".model_state")))
            require(all(bool(torch.isfinite(t).all())
                        for t in model.state_dict().values()),
                    f"convnet_cli: {path} holds non-finite values")
        rec["checkpoint_mb"] = os.path.getsize(ckpt) / 1e6
    return rec


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None,
                   help="also write every phase's record to this JSON file")
    args = p.parse_args()
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: cannot import torch/numpy: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from distributed_compute_pytorch_tpu_torch import (
            infer, interop, serve)
        from distributed_compute_pytorch_tpu_torch.core import mesh
        from distributed_compute_pytorch_tpu_torch.models.convnet import (
            ConvNet)
        from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
            GPT2, GPT2Config)
        from distributed_compute_pytorch_tpu_torch.ops import _build
        from distributed_compute_pytorch_tpu_torch.ops import attention as A
        from distributed_compute_pytorch_tpu_torch.ops import (
            cache_update as CU, decode_attention as DA, flash_attention as FA,
            fused_adamw as FAW)
        from distributed_compute_pytorch_tpu_torch.train.optim import (
            build_optimizer)
        from distributed_compute_pytorch_tpu_torch.train.step import (
            make_step_fns)
    except ImportError as e:
        print(f"chip_smoke: run from the repository root — the port does "
              f"not import: {e}", file=sys.stderr)
        return 2

    # f32 matmuls in full f32 (the default, stated): the f32 kernels and
    # the teacher-forced check are held to f32 tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    records = []

    def record(obj):
        records.append(obj)
        emit(obj)

    try:
        smi = nvidia_smi()
        record({"phase": "environment", "nvidia_smi": smi,
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "python": sys.version.split()[0],
                "device": torch.cuda.get_device_name(0),
                "device_count": torch.cuda.device_count()})
        built = _build.build_all()
        ptxas = {name: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "entry function" in ln]
                 for name, log in built["ptxas"].items()}
        record({"phase": "build", "seconds": built["seconds"],
                "built": built["built"], "ptxas": ptxas})

        results = {}
        gen_lens = gen_batch(np, GPT2Config.small().vocab_size)[0]
        for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            results[dt] = {
                "flash_fwd": check_flash(torch, np, FA, dtype, dt),
                "kv_pool_insert": check_insert(torch, CU, dtype, dt),
                "paged_decode": check_decode(torch, np, DA, dtype, dt)}
            results[dt].update(check_flash_bwd(torch, np, FA, dtype, dt))
            results[dt].update(check_dense_insert(torch, CU, A, dtype, dt,
                                                  int(gen_lens.max())))
            results[dt]["dense_decode"] = check_dense_decode(
                torch, np, DA, A, dtype, dt, gen_lens)
            results[dt]["kv_pool_insert_q8"] = check_insert_q8(
                torch, CU, dtype, dt)
            results[dt]["paged_decode_q8"] = check_decode_q8(
                torch, np, DA, dtype, dt)
            results[dt].update(check_dense_insert_q8(
                torch, CU, A, dtype, dt, int(gen_lens.max())))
            results[dt]["dense_decode_q8"] = check_dense_decode_q8(
                torch, np, DA, A, dtype, dt, gen_lens)
            for q8 in (False, True):
                sfx = "_q8" if q8 else ""
                results[dt]["paged_decode_write" + sfx] = check_decode_write(
                    torch, np, A, CU, DA, dtype, dt, q8)
                results[dt]["dense_decode_write" + sfx] = \
                    check_dense_decode_write(torch, np, A, CU, DA, dtype, dt,
                                             gen_lens, q8)
            for name, res in results[dt].items():
                record({"phase": "kernel", "name": name, "dtype": dt,
                        "tol": 0.0 if name in EXACT else TOL[dt], **res})
            long_ctx = check_decode_long(torch, A, CU, DA, dtype, dt)
            record({"phase": "decode_long", "dtype": dt, **long_ctx})
            for name, res in long_ctx.items():
                results[dt][name]["long"] = res
            torch.cuda.empty_cache()
        adamw = check_adamw(torch, FAW, GPT2, GPT2Config)
        record({"phase": "kernel", "name": "fused_adamw", "dtype": "f32",
                "tol": ADAMW_TOL, **adamw})
        torch.cuda.empty_cache()

        base = GPT2(GPT2Config.small()).init(
            torch.Generator().manual_seed(0))
        serves = {}
        mods = (A, FA, CU, DA, serve)
        for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            model = GPT2(GPT2Config.small(), dtype=dtype)
            model.load_state_dict(base.state_dict())
            serves[dt], outs, cbs, walls = serve_phase(torch, np, mods,
                                                       model, dt)
            record(serves[dt])
            if dt == "bf16":
                serve_prof = profile_phase(torch, np, mods, cbs, dt, walls)
                record(serve_prof)
                float_served = outs
            del model, outs, cbs
            torch.cuda.empty_cache()

        gens = {}
        for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            model = GPT2(GPT2Config.small(), dtype=dtype)
            model.load_state_dict(base.state_dict())
            gens[dt], batch, fns, walls = generate_phase(
                torch, np, infer, (A, FA, CU, DA), model, dt)
            record(gens[dt])
            if dt == "bf16":
                gen_prof = generate_profile_phase(torch, (FA, CU, DA), fns,
                                                  batch, walls)
                record(gen_prof)
                float_generated = batch[3]
            else:
                record(sampled_phase(torch, np, infer, A, model, batch))
            del model, batch, fns
        torch.cuda.empty_cache()

        # the int8 KV cells after the float ones, so that those run as
        # they did before the int8 cells existed
        model = GPT2(GPT2Config.small(), dtype=torch.bfloat16)
        model.load_state_dict(base.state_dict())
        serve8 = serve_int8_phase(torch, np, mods, model, float_served)
        record(serve8)
        gen8 = generate_int8_phase(torch, np, infer, (A, FA, CU, DA), model,
                                   float_generated)
        record(gen8)
        del model, base, float_served, float_generated
        torch.cuda.empty_cache()

        tm = (GPT2, build_optimizer, make_step_fns)
        train, train_prof, weights = train_phase(torch, np, tm, FA, FAW,
                                                 GPT2Config)
        record(train)
        record(train_prof)
        record(train_skip_phase(torch, np, tm, GPT2Config, weights))
        del weights
        torch.cuda.empty_cache()
        record(parity_phase(torch, np, tm, A, FA, FAW, GPT2Config))
        torch.cuda.empty_cache()
        record(cli_phase(torch, interop, GPT2, GPT2Config))

        # the reference's workload (the port's step runs cuDNN in f32
        # with its deterministic algorithms: ``step.cudnn_f32``)
        cm = (ConvNet, build_optimizer, make_step_fns)
        data = convnet_data()
        conv, first, weights, conv_prof, batch = convnet_phase(
            torch, cm, data, smi)
        record(conv)
        record(convnet_ddp_phase(torch, cm, mesh, data, weights, first,
                                 conv_prof, batch, smi))
        del data, first, weights, conv_prof, batch
        record(convnet_cli_phase(torch, interop, ConvNet, smi))

        # a fused tick replaces its read's Pallas call (and fuses its
        # write's, ``fuses``)
        sources = {"flash_fwd": FA.REPLACES, "kv_pool_insert": CU.REPLACES,
                   "paged_decode": DA.REPLACES,
                   "paged_decode_write": DA.REPLACES,
                   "flash_bwd_dq": FA.DQ_REPLACES,
                   "flash_bwd_dkv": FA.DKV_REPLACES,
                   "cache_insert": CU.CACHE_INSERT_REPLACES,
                   "kv_insert": CU.KV_INSERT_REPLACES,
                   "kv_insert_rows": CU.KV_INSERT_ROWS_REPLACES,
                   "dense_decode": DA.DENSE_REPLACES,
                   "dense_decode_write": DA.DENSE_REPLACES}
        # the int8 forms replace the same Pallas calls (the reads: the
        # port's read kernels; the JAX int8 read is XLA)
        sources.update({f"{name}_q8": sources[name] for name in (
            "kv_pool_insert", "paged_decode", "cache_insert", "kv_insert",
            "kv_insert_rows", "dense_decode", "paged_decode_write",
            "dense_decode_write")})
        # each kernel's launches on the main path: the captured runs'
        # counts measured under the profiler (``counted_profile``: the
        # counters zeroed just before, equal to the device's kernel events
        # after); the train kernels' from train_profile's captured run,
        # measured the same way (``train_profile``); a kernel no run
        # launches reports 0
        train_launches = train_prof["graph"]["launches"]
        runs = (("serve bf16 captured, profiled", serve_prof["launches"]),
                ("serve_int8 int8 captured, profiled",
                 serve8["int8_profile"]["launches"]),
                ("generate bf16 captured, profiled", gen_prof["launches"]),
                ("generate_int8 int8 captured, profiled",
                 gen8["int8_profile"]["launches"]),
                ("train captured, profiled", train_launches))
        kernels = []
        for name, replaces in sources.items():
            r, r32 = results["bf16"][name], results["f32"][name]
            run, launches = next(((run, n[name]) for run, n in runs
                                  if n.get(name)), ("none", 0))
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"distributed_compute_pytorch_tpu_torch/csrc/"
                          f"{SOURCES.get(name, name)}.cu",
                "replaces": replaces, "launches": launches,
                "launches_from": run,
                "serve_launches": serve_prof["launches"].get(name),
                "generate_launches": gen_prof["launches"].get(name),
                "serve_int8_launches":
                    serve8["int8_profile"]["launches"].get(name),
                "generate_int8_launches":
                    gen8["int8_profile"]["launches"].get(name),
                "train_launches": train_launches.get(name),
                "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
                "tol": 0.0 if name in EXACT else TOL["bf16"],
                "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "library": r.get("library", {
                    "flash_fwd": "F.scaled_dot_product_attention",
                    "kv_pool_insert": "pool[:, blocks, :, offsets, :] = upd",
                }.get(name)),
                "dtype": "bf16", "shape": r["shape"],
                **{k: r[k] for k in KERNEL_EXTRAS if k in r},
                "f32": {k: r32[k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")},
            })
        kernels.append({
            "name": "fused_adamw", "route": "cuda",
            "source": "distributed_compute_pytorch_tpu_torch/csrc/"
                      "fused_adamw.cu",
            "replaces": FAW.REPLACES,
            "launches": train_launches["fused_adamw"],
            "launches_from": "train captured, profiled",
            "serve_launches": None, "generate_launches": None,
            "train_launches": train_launches["fused_adamw"],
            "max_abs_err": adamw["max_abs_err"],
            "max_err": adamw["max_abs_err"], "tol": ADAMW_TOL,
            "ms": adamw["ms"], "kernel_ms": adamw["ms"],
            "plain_ms": adamw["plain_ms"], "bound_ms": adamw["bound_ms"],
            "bound_by": adamw["bound_by"], "library_ms": adamw["library_ms"],
            "library": adamw["library"], "dtype": "f32",
            "shape": adamw["shape"]})
        record({"kernels": kernels})
    except Exception as e:   # noqa: BLE001 — the smoke's one boundary:
        # report the failed phase and exit non-zero, no ok line
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    finally:
        if args.out:
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
