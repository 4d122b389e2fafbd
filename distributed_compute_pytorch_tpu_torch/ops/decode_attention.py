"""Paged flash-decode read — the port of
``distributed_compute_pytorch_tpu/ops/pallas/decode_attention.py``'s
``decode_attention_paged_pallas`` (kernel ``_paged_kernel``) as the
hand-written CUDA kernel ``csrc/paged_decode.cu``.

In the JAX package this kernel sat beside the decode path (measured slower
on a TPU v5e, ``decode_attention.py:29-40``) while XLA gathered every
row's cache and attended the copy. In the port it IS the decode read: no
gathered copy is built and each row reads only its live blocks. Its plain
version is exactly the JAX serving read, ``gather_kv_blocks`` +
``cached_attention``.

``launches`` counts kernel launches (plain calls never count).
"""

from __future__ import annotations

import torch

from distributed_compute_pytorch_tpu_torch.ops import _build
from distributed_compute_pytorch_tpu_torch.ops.attention import (
    cached_attention, gather_kv_blocks)

NAME = "paged_decode"
REPLACES = "distributed_compute_pytorch_tpu/ops/pallas/decode_attention.py:176"
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_plain(q, pool, table, pos, *, scale: float | None = None):
    """The kernel's plain PyTorch version: gather each row's logical view
    through its table, then dense masked decode attention."""
    kv = gather_kv_blocks(pool, table)
    return cached_attention(q, kv[0], kv[1], pos, scale=scale)


def _check(q, pool, table, pos):
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be [B, H, 1, hd], got {tuple(q.shape)}")
    if pool.ndim != 5 or pool.shape[0] != 2:
        raise ValueError(f"pool must be [2, P, Hk, bt, hd], got "
                         f"{tuple(pool.shape)}")
    B, H, _, hd = q.shape
    hk = pool.shape[2]
    if pool.shape[4] != hd or H % hk:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool "
                         f"{tuple(pool.shape)}")
    if table.ndim != 2 or table.shape[0] != B or tuple(pos.shape) != (B,):
        raise ValueError("table must be [B, nb] and pos [B]")


def paged_decode_attention(q, pool, table, pos, *, scale: float | None = None):
    """``q [B, H, 1, hd]`` attends pool ``[2, P, Hk, bt, hd]`` through
    ``table`` int32 ``[B, nb]`` over logical slots ``0..min(pos[b], nb *
    bt - 1)``; ``pos`` is an int32 ``[B]`` tensor (>= 0). Returns ``[B, H,
    1, hd]``. CUDA tensors launch ``paged_decode``; CPU tensors run the
    plain version."""
    _check(q, pool, table, pos)
    if q.device.type == "cpu":
        return paged_decode_plain(q, pool, table, pos, scale=scale)
    return paged_decode_cuda(q, pool, table, pos, scale=scale)


def paged_decode_cuda(q, pool, table, pos, *, scale: float | None = None):
    """Launch the CUDA kernel: one block per (row, kv head), serving the
    query heads that share that kv head. Raises on anything it does not
    take: non-CUDA or mixed devices, dtypes other than the pool's
    (f32/bf16), a non-contiguous or unaligned pool, a head dim not a
    multiple of 8 or above 128 or without unit stride, more than 8 query
    heads per kv head, a non-int32 table or pos."""
    global launches
    _check(q, pool, table, pos)
    dev = q.device
    if dev.type != "cuda" or any(x.device != dev for x in (pool, table, pos)):
        raise ValueError("paged_decode needs CUDA tensors on one device")
    if pool.dtype not in _DTYPES or q.dtype != pool.dtype:
        raise ValueError(f"paged_decode takes an f32/bf16 pool and a query "
                         f"of its dtype, got {pool.dtype}, {q.dtype}")
    B, H, _, hd = q.shape
    _, P, hk, bt, _ = pool.shape
    if hd % 8 or hd > 128 or q.stride(-1) != 1:
        raise ValueError(f"paged_decode needs head_dim % 8 == 0, <= 128 and "
                         f"unit stride (got {hd})")
    if H // hk > 8:
        raise ValueError(f"paged_decode takes at most 8 query heads per kv "
                         f"head (got {H // hk})")
    if not pool.is_contiguous() or pool.data_ptr() % 16:
        raise ValueError("paged_decode needs a contiguous, 16-byte aligned "
                         "pool")
    for x in (table, pos):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("table/pos must be contiguous int32")
    scale = hd ** -0.5 if scale is None else float(scale)
    out = torch.empty(B, 1, H, hd, dtype=q.dtype, device=dev).transpose(1, 2)
    lib, fn = _build.bind(NAME, "pppppiiiiiiiisfp")
    rc = fn(q.data_ptr(), pool.data_ptr(), out.data_ptr(), table.data_ptr(),
            pos.data_ptr(), _DTYPES[pool.dtype], B, H, H // hk, P, bt, hd,
            table.shape[1],
            _build.strides_arg(q.stride(0), q.stride(1), out.stride(0),
                               out.stride(1)),
            scale, _build.stream_ptr(dev))
    _build.check(lib, NAME, rc)
    launches += 1
    return out
