"""Paged KV-pool slot write — the port of
``distributed_compute_pytorch_tpu/ops/pallas/cache_update.py``'s
``kv_pool_insert_rows_pallas`` (kernel ``_pool_rows_kernel``) as the
hand-written CUDA kernel ``csrc/kv_pool_insert.cu``.

The write is IN PLACE on the pool tensor (the JAX package donates the
buffer and returns a new one). Rows whose block id lies outside
``[0, P)`` are dropped, the ``mode="drop"`` contract of the reference's
``_pool_scatter``, so one kernel serves both the decode tick and the
admission scatter (whose pad tokens aim at block ``P``).

``launches`` counts kernel launches (plain calls never count).
"""

from __future__ import annotations

import torch

from distributed_compute_pytorch_tpu_torch.ops import _build

NAME = "kv_pool_insert"
REPLACES = "distributed_compute_pytorch_tpu/ops/pallas/cache_update.py:227"
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kv_pool_insert_plain(pool, k, v, blocks, offsets):
    """The kernel's plain PyTorch version: ``pool[0, blocks[i], :,
    offsets[i], :] = k[i]`` (and ``v`` into plane 1), in place, dropping
    rows whose block id or offset is out of range."""
    P, bt = pool.shape[1], pool.shape[3]
    keep = (blocks >= 0) & (blocks < P) & (offsets >= 0) & (offsets < bt)
    blk, off = blocks[keep].long(), offsets[keep].long()
    pool[0, blk, :, off, :] = k[keep].to(pool.dtype)
    pool[1, blk, :, off, :] = v[keep].to(pool.dtype)
    return pool


def _check(pool, k, v, blocks, offsets):
    if pool.ndim != 5 or pool.shape[0] != 2:
        raise ValueError(f"pool must be [2, P, H, bt, hd], got "
                         f"{tuple(pool.shape)}")
    _, _, H, _, hd = pool.shape
    n = blocks.shape[0] if blocks.ndim == 1 else -1
    for name, x in (("k", k), ("v", v)):
        if tuple(x.shape) != (n, H, hd):
            raise ValueError(f"{name} must be [N, H, hd] = {(n, H, hd)}, got "
                             f"{tuple(x.shape)}")
    if tuple(offsets.shape) != (n,):
        raise ValueError("blocks and offsets must both be [N]")


def kv_pool_insert(pool, k, v, blocks, offsets):
    """Write ``k``/``v`` ``[N, H, hd]`` into ``pool [2, P, H, bt, hd]`` at
    ``(blocks[i], offsets[i])``, in place; returns ``pool``. CUDA tensors
    launch ``kv_pool_insert``; CPU tensors run the plain version."""
    _check(pool, k, v, blocks, offsets)
    if pool.device.type == "cpu":
        return kv_pool_insert_plain(pool, k, v, blocks, offsets)
    return kv_pool_insert_cuda(pool, k, v, blocks, offsets)


def kv_pool_insert_cuda(pool, k, v, blocks, offsets):
    """Launch the CUDA kernel. Raises on anything it does not take:
    non-CUDA or mixed devices, a non-contiguous pool, a dtype other than
    the pool's (f32/bf16), a head dim without unit stride, non-int32 or
    non-contiguous block ids and offsets."""
    global launches
    _check(pool, k, v, blocks, offsets)
    dev = pool.device
    if dev.type != "cuda" or any(x.device != dev
                                 for x in (k, v, blocks, offsets)):
        raise ValueError("kv_pool_insert needs CUDA tensors on one device")
    if pool.dtype not in _DTYPES or k.dtype != pool.dtype \
            or v.dtype != pool.dtype:
        raise ValueError(f"kv_pool_insert takes an f32/bf16 pool and updates "
                         f"of its dtype, got {pool.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not pool.is_contiguous() or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("kv_pool_insert needs a contiguous pool and unit "
                         "head-dim stride on k/v")
    for x in (blocks, offsets):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("blocks/offsets must be contiguous int32")
    _, P, H, bt, hd = pool.shape
    n = blocks.shape[0]
    if n == 0:
        return pool
    lib, fn = _build.bind(NAME, "pppppiiiiiisp")
    rc = fn(pool.data_ptr(), k.data_ptr(), v.data_ptr(), blocks.data_ptr(),
            offsets.data_ptr(), _DTYPES[pool.dtype], n, P, H, bt, hd,
            _build.strides_arg(k.stride(0), k.stride(1), v.stride(0),
                               v.stride(1)),
            _build.stream_ptr(dev))
    _build.check(lib, NAME, rc)
    launches += 1
    return pool
