#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: the quickest proof that the port
builds, is right and serves on one NVIDIA GPU.

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
   CUDA tensors at the serving path's shapes, in bf16 and f32, with the
   tolerances below, and timed beside its plain version, its roofline
   bound and (where one exists) one PyTorch library call computing the
   same function;
4. serve: GPT-2-small at full width (random weights from a fixed seed)
   through ``ContinuousBatcher.serve`` — 32 staggered requests, 16 slots,
   in bf16 and then in f32. Each kernel's launch counter is zeroed just
   before the serve call and read just after; it must equal the count the
   schedule implies. Every output is checked teacher-forced against one
   full-sequence forward with plain dense attention;
5. serve_profile: the bf16 serve run once more under ``torch.profiler``,
   its device time by kernel group and its device busy share.

Then the ``{"kernels": [...]}`` line (launches from the bf16 serve run),
the raw ``nvidia-smi`` line, and last the ``{"ok": true, ...}`` line. Any
failed check exits non-zero before the ``ok`` line. Roofline bounds use
the H100 SXM data-sheet peaks: 3.35 TB/s HBM, 989 TFLOP/s bf16 (tensor
cores), 67 TFLOP/s f32 (no tensor cores).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# kernel vs its plain version on the same inputs. f32: only the summation
# order differs. bf16: the plain version rounds softmax probabilities to
# bf16 before the value product, the kernels keep them in f32.
TOL = {"bf16": 3e-2, "f32": 1e-4}
# teacher-forced check: each served token's logit must lie within this
# margin of the row maximum of a dense full-sequence forward in the same
# dtype. bf16: two bf16 computations that round in different places; the
# logits here stay below 4 in magnitude, where one bf16 ulp is 2**-5, so
# the margin is four ulps. f32: only the summation order differs.
MARGIN = {"bf16": 0.125, "f32": 1e-3}
LAYERS = 12
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

def check_flash(torch, np, FA, dtype, dt):
    """Admission prefill shapes: 8 rows x 12 heads x t = tk = 256 x 64,
    causal with a ragged pad mask (split-head views of a fused QKV, as the
    model passes them), plus a t = 64, tk = 320 bottom-right offset case."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(1)
    out = {}
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
        got, lse = FA.flash_fwd(q, k, v, causal=True, kv_mask=mask)
        want = FA.flash_attention_plain(q, k, v, causal=True, kv_mask=mask)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        require(bool(torch.isfinite(got).all()) and bool(
            torch.isfinite(lse).all()), f"flash {case} {dt}: non-finite")
        require(err <= TOL[dt], f"flash {case} {dt}: max err {err} > "
                                f"{TOL[dt]}")
        out[f"{case}_max_abs_err"] = err
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
        out["bound_ms"], out["bound_by"] = bound(nbytes, 4 * d * pairs, dt)
        out["ms"] = time_ms(torch, [lambda: FA.flash_fwd(
            q, k, v, causal=True, kv_mask=mask)])
        out["plain_ms"] = time_ms(torch, [lambda: FA.flash_attention_plain(
            q, k, v, causal=True, kv_mask=mask)])
        allowed = (keys <= rows)[None, None] & (
            keys[None] < lengths.numpy()[:, None, None])[:, None]
        attn_mask = torch.from_numpy(allowed).cuda()
        out["library_ms"] = time_ms(torch, [
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   attn_mask=attn_mask)])
        out["shape"] = f"q,k,v [{b}, {h}, {t}, {d}] causal + ragged kv_mask"
    out["max_abs_err"] = max(out["prefill_max_abs_err"],
                             out["offset_max_abs_err"])
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
    return {
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        "ms": time_ms(torch, [
            (lambda q=q, p=p: DA.paged_decode_cuda(q, p, table, pos_t))
            for q, p in copies]),
        "plain_ms": time_ms(torch, [
            (lambda q=q, p=p: DA.paged_decode_plain(q, p, table, pos_t))
            for q, p in copies]),
        "library_ms": None,
        "library": "none: no single PyTorch call reads through a block table",
        "shape": (f"q [{B}, {H}, 1, {hd}], pool [2, {P}, {H}, {bt}, {hd}], "
                  f"tables [{B}, {nb}], {keys} live keys"),
    }


# ---- phase 4: serve ----------------------------------------------------------

def reference_logits(torch, A, model, tokens):
    """One full-sequence forward with plain dense attention: the model's
    own layers, no kernel."""
    x = model.embed(tokens)
    for blk in model.blocks:
        h = blk.ln1(x)
        q, k, v = (A.split_heads(z, blk.num_heads)
                   for z in blk.qkv(h).split(h.shape[-1], dim=-1))
        o = A.dot_product_attention(q, k, v, causal=True)
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


def batcher(serve, model):
    return serve.ContinuousBatcher(model, slots=16, t_max=1024,
                                   prompt_buf=256, segment=16,
                                   kv_block_tokens=16)


def serve_phase(torch, np, mods, model, dt):
    A, FA, CU, DA, serve = mods
    reqs = serve_requests(np, serve, model.config.vocab_size)
    cb = batcher(serve, model)
    cb.serve(reqs[:2])     # warm-up: the library handles' first calls
    waves0, ticks0 = cb.stats["prefill_calls"], cb.ticks
    torch.cuda.synchronize()
    FA.launches = CU.launches = DA.launches = 0
    t0 = time.monotonic()
    outs = cb.serve(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"flash_fwd": FA.launches, "kv_pool_insert": CU.launches,
                "paged_decode": DA.launches}
    waves, ticks = cb.stats["prefill_calls"] - waves0, cb.ticks - ticks0
    want = {"flash_fwd": LAYERS * waves,
            "kv_pool_insert": LAYERS * (waves + ticks),
            "paged_decode": LAYERS * ticks}
    require(all(n > 0 for n in launches.values()),
            f"serve {dt}: a kernel of the path never launched: {launches}")
    require(launches == want, f"serve {dt}: launches {launches} != the "
                              f"schedule's {want}")
    require(all(len(o) == r.max_new for o, r in zip(outs, reqs)),
            f"serve {dt}: a request returned fewer than max_new tokens")
    require(cb.last_block_leaks == 0 and cb.last_slot_leaks == 0,
            f"serve {dt}: leaked blocks/slots")
    gaps = []
    with torch.no_grad():
        for r, o in zip(reqs, outs):
            seq = torch.tensor(r.tokens + o[:-1], device="cuda")
            logits = reference_logits(torch, A, model, seq[None])[0].float()
            rows = logits[len(r.tokens) - 1:]
            require(bool(torch.isfinite(rows).all()),
                    f"serve {dt}: non-finite reference logits")
            chosen = rows.gather(1, torch.tensor(o, device="cuda")[:, None])
            gaps.append((rows.max(dim=1).values - chosen[:, 0]).cpu())
    gaps = torch.cat(gaps)
    worst = gaps.max().item()
    require(worst <= MARGIN[dt], f"serve {dt}: a served token's logit is "
                                 f"{worst} below the teacher-forced max "
                                 f"(margin {MARGIN[dt]})")
    ttft = sorted(t for t in cb.last_ttft_s if t is not None)
    new_tokens = sum(len(o) for o in outs)
    return {
        "phase": "serve", "dtype": dt, "model": "gpt2-small (12 x 768, "
        "vocab 50257), random weights seed 0", "requests": len(reqs),
        "slots": 16, "segment": 16, "kv_block_tokens": 16, "t_max": 1024,
        "prompt_buf": 256, "wall_s": wall, "new_tokens": new_tokens,
        "decode_tokens_per_s": new_tokens / wall,
        "mean_ttft_s": sum(ttft) / len(ttft),
        "median_ttft_s": ttft[len(ttft) // 2], "max_ttft_s": ttft[-1],
        "wall_ms_per_tick": 1e3 * wall / ticks, "ticks": ticks,
        "admission_waves": waves,
        "launches": launches, "teacher_forced_worst_gap": worst,
        "teacher_forced_mean_gap": gaps.mean().item(),
        "margin": MARGIN[dt],
    }


def _kernel_group(name: str) -> str:
    for kernel in ("flash_fwd", "kv_pool_insert", "paged_decode"):
        if f"::{kernel}_kernel<" in name:
            return kernel
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet")):
        return "matmul (cuBLAS)"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "memcpy/memset"
    return "other PyTorch kernels"


def profile_phase(torch, np, serve, model, dt, wall_s):
    """The same serve run once more under ``torch.profiler``: device time
    by kernel group and the top kernels. ``device_busy_share`` is the
    kernels' summed device time over the UNPROFILED run's wall time
    ``wall_s`` (one stream, so kernels do not overlap); the profiler slows
    the host, not the kernels."""
    from torch.profiler import ProfilerActivity, profile
    reqs = serve_requests(np, serve, model.config.vocab_size)
    cb = batcher(serve, model)
    cb.serve(reqs[:2])
    ticks0 = cb.ticks
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        cb.serve(reqs)
        torch.cuda.synchronize()
        wall_prof = time.monotonic() - t0
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        n, t = kernels.get(e.key, (0, 0.0))
        kernels[e.key] = (n + e.count, t + us)
    total_us = sum(t for _, t in kernels.values())
    groups: dict = {}
    for name, (n, us) in kernels.items():
        g = groups.setdefault(_kernel_group(name), [0, 0.0])
        g[0] += n
        g[1] += us
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "phase": "serve_profile", "dtype": dt, "requests": len(reqs),
        "ticks": cb.ticks - ticks0, "wall_s_profiled": wall_prof,
        "wall_s_unprofiled": wall_s,
        "device_ms": total_us / 1e3 if total_us else None,
        "device_busy_share": (total_us / 1e6 / wall_s) if total_us else None,
        "groups_ms": {g: {"launches": n, "ms": us / 1e3}
                      for g, (n, us) in sorted(groups.items(),
                                               key=lambda kv: -kv[1][1])},
        "top_kernels": [{"name": name[:100], "launches": n, "ms": us / 1e3}
                        for name, (n, us) in top],
    }


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
        from distributed_compute_pytorch_tpu_torch import serve
        from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
            GPT2, GPT2Config)
        from distributed_compute_pytorch_tpu_torch.ops import _build
        from distributed_compute_pytorch_tpu_torch.ops import attention as A
        from distributed_compute_pytorch_tpu_torch.ops import (
            cache_update as CU, decode_attention as DA, flash_attention as FA)
    except ImportError as e:
        print(f"chip_smoke: run from the repository root — the port does "
              f"not import: {e}", file=sys.stderr)
        return 2

    # f32 matmuls in full f32 (the defaults, stated): the f32 kernels and
    # the teacher-forced check are held to f32 tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
                        if "registers" in ln or "spill" in ln]
                 for name, log in built["ptxas"].items()}
        record({"phase": "build", "seconds": built["seconds"],
                "built": built["built"], "ptxas": ptxas})

        results = {}
        for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            results[dt] = {
                "flash_fwd": check_flash(torch, np, FA, dtype, dt),
                "kv_pool_insert": check_insert(torch, CU, dtype, dt),
                "paged_decode": check_decode(torch, np, DA, dtype, dt)}
            for name, res in results[dt].items():
                record({"phase": "kernel", "name": name, "dtype": dt,
                        "tol": 0.0 if name == "kv_pool_insert" else TOL[dt],
                        **res})

        base = GPT2(GPT2Config.small()).init(
            torch.Generator().manual_seed(0))
        serves = {}
        mods = (A, FA, CU, DA, serve)
        for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            model = GPT2(GPT2Config.small(), dtype=dtype)
            model.load_state_dict(base.state_dict())
            serves[dt] = serve_phase(torch, np, mods, model, dt)
            record(serves[dt])
            if dt == "bf16":
                record(profile_phase(torch, np, serve, model, dt,
                                     serves[dt]["wall_s"]))
            del model

        sources = {"flash_fwd": FA, "kv_pool_insert": CU, "paged_decode": DA}
        kernels = []
        for name, mod in sources.items():
            r, r32 = results["bf16"][name], results["f32"][name]
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"distributed_compute_pytorch_tpu_torch/csrc/"
                          f"{name}.cu",
                "replaces": mod.REPLACES,
                "launches": serves["bf16"]["launches"][name],
                "launches_f32_run": serves["f32"]["launches"][name],
                "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
                "tol": 0.0 if name == "kv_pool_insert" else TOL["bf16"],
                "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "library": r.get("library", {
                    "flash_fwd": "F.scaled_dot_product_attention",
                    "kv_pool_insert": "pool[:, blocks, :, offsets, :] = upd",
                }.get(name)),
                "dtype": "bf16", "shape": r["shape"],
                "f32": {k: r32[k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")},
            })
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
