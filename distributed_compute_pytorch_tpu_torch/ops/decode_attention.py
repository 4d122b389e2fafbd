"""Flash-decode reads — the port of
``distributed_compute_pytorch_tpu/ops/pallas/decode_attention.py``'s two
Pallas calls as hand-written CUDA kernels:

- ``paged_decode_attention``: ``decode_attention_paged_pallas`` (kernel
  ``_paged_kernel``) -> ``csrc/paged_decode.cu``, the serving read through
  the block table. Its plain version is exactly the JAX serving read,
  ``gather_kv_blocks`` + ``cached_attention``;
- ``decode_attention``: ``decode_attention_pallas`` (kernel ``_kernel``)
  -> ``csrc/dense_decode.cu``, generation's read of the dense KV-pair
  cache, plus the per-row ``slot_mask`` the Pallas kernel lacks (left-
  padded prompts mask their pad slots). Its plain version is
  ``cached_attention(..., slot_mask=...)``.

In the JAX package both kernels sat beside the decode path (measured slower
on a TPU v5e, ``decode_attention.py:29-40``) while XLA attended the cache
(after gathering it, for the paged pool). In the port they ARE the decode
reads: no gathered copy is built, and each row reads only its slots
``0..pos``. The two share their device code (``csrc/decode_common.cuh``).

``launches`` counts ``paged_decode``'s kernel launches and
``dense_launches`` ``dense_decode``'s (plain calls never count).
"""

from __future__ import annotations

import torch

from distributed_compute_pytorch_tpu_torch.ops import _build
from distributed_compute_pytorch_tpu_torch.ops.attention import (
    cached_attention, gather_kv_blocks)

NAME = "paged_decode"
REPLACES = "distributed_compute_pytorch_tpu/ops/pallas/decode_attention.py:176"
launches = 0

DENSE_NAME = "dense_decode"
DENSE_REPLACES = \
    "distributed_compute_pytorch_tpu/ops/pallas/decode_attention.py:58"
dense_launches = 0

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


# ---- the dense read (csrc/dense_decode.cu) ---------------------------------

def dense_decode_plain(q, cache, pos, *, slot_mask=None,
                       scale: float | None = None):
    """The kernel's plain PyTorch version: ``cached_attention`` over the
    pair cache's two planes with the slot mask."""
    return cached_attention(q, cache[0], cache[1], pos, scale=scale,
                            slot_mask=slot_mask)


def _check_dense(q, cache, pos, slot_mask):
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be [B, H, 1, hd], got {tuple(q.shape)}")
    if cache.ndim != 5 or cache.shape[0] != 2:
        raise ValueError(f"cache must be [2, B, Hk, T, hd], got "
                         f"{tuple(cache.shape)}")
    B, H, _, hd = q.shape
    _, cb, hk, T, chd = cache.shape
    if cb != B or chd != hd or H % hk:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache "
                         f"{tuple(cache.shape)}")
    if isinstance(pos, torch.Tensor) and pos.ndim and \
            tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be a scalar or [B] = [{B}]")
    if slot_mask is not None and tuple(slot_mask.shape) != (B, T):
        raise ValueError(f"slot_mask must be [B, T] = {(B, T)}, got "
                         f"{tuple(slot_mask.shape)}")


def decode_attention(q, cache, pos, *, slot_mask=None,
                     scale: float | None = None):
    """``q [B, H, 1, hd]`` attends the dense pair cache ``[2, B, Hk, T,
    hd]`` over slots ``0..min(pos[b], T - 1)`` that ``slot_mask`` (optional
    ``[B, T]``, nonzero = attend) keeps; ``pos`` is a scalar (a Python int
    or a 0-dim int32 tensor: every row at one slot) or an int32 ``[B]``
    tensor. Returns ``[B, H, 1, hd]``. CUDA tensors launch
    ``dense_decode``; CPU tensors run the plain version."""
    _check_dense(q, cache, pos, slot_mask)
    if q.device.type == "cpu":
        return dense_decode_plain(q, cache, pos, slot_mask=slot_mask,
                                  scale=scale)
    return dense_decode_cuda(q, cache, pos, slot_mask=slot_mask, scale=scale)


def dense_decode_cuda(q, cache, pos, *, slot_mask=None,
                      scale: float | None = None):
    """Launch the CUDA kernel: one block per (row, kv head), serving the
    query heads that share that kv head. Raises on anything it does not
    take: non-CUDA or mixed devices, dtypes other than the cache's
    (f32/bf16; the int8 form waits for the int8 KV slice), a non-contiguous
    or unaligned cache, a head dim not a multiple of 8 or above 128 or
    without unit stride, more than 8 query heads per kv head, a ``pos``
    that is not int32 or has a stride other than 0 or 1, a ``slot_mask``
    that is not bool/uint8 or lacks unit stride along ``T``. ``q`` may be
    any other strided view and ``pos`` a stride-0 view: nothing is
    copied."""
    global dense_launches
    _check_dense(q, cache, pos, slot_mask)
    dev = q.device
    others = (cache,) if slot_mask is None else (cache, slot_mask)
    if dev.type != "cuda" or any(x.device != dev for x in others):
        raise ValueError("dense_decode needs CUDA tensors on one device")
    if cache.dtype == torch.int8:
        raise NotImplementedError(
            "the int8 KV cache form waits for the int8 KV slice "
            "(ROADMAP.md queue 3.6)")
    if cache.dtype not in _DTYPES or q.dtype != cache.dtype:
        raise ValueError(f"dense_decode takes an f32/bf16 cache and a query "
                         f"of its dtype, got {cache.dtype}, {q.dtype}")
    B, H, _, hd = q.shape
    _, _, hk, T, _ = cache.shape
    if hd % 8 or hd > 128 or q.stride(-1) != 1:
        raise ValueError(f"dense_decode needs head_dim % 8 == 0, <= 128 and "
                         f"unit stride (got {hd})")
    if H // hk > 8:
        raise ValueError(f"dense_decode takes at most 8 query heads per kv "
                         f"head (got {H // hk})")
    if not cache.is_contiguous() or cache.data_ptr() % 16:
        raise ValueError("dense_decode needs a contiguous, 16-byte aligned "
                         "cache")
    pos, pos_stride = _build.pos_arg(pos, dev)
    mask_ptr, mask_sb = None, 0
    if slot_mask is not None:
        if slot_mask.dtype not in (torch.bool, torch.uint8) \
                or slot_mask.stride(1) != 1:
            raise ValueError("slot_mask must be bool or uint8 with unit "
                             "stride along T")
        mask_ptr, mask_sb = slot_mask.data_ptr(), slot_mask.stride(0)
    scale = hd ** -0.5 if scale is None else float(scale)
    out = torch.empty(B, 1, H, hd, dtype=q.dtype, device=dev).transpose(1, 2)
    lib, fn = _build.bind(DENSE_NAME, "pppppiiiiiiisfp")
    rc = fn(q.data_ptr(), cache.data_ptr(), out.data_ptr(), pos.data_ptr(),
            mask_ptr, _DTYPES[cache.dtype], B, H, H // hk, T, hd, pos_stride,
            _build.strides_arg(q.stride(0), q.stride(1), out.stride(0),
                               out.stride(1), mask_sb),
            scale, _build.stream_ptr(dev))
    _build.check(lib, DENSE_NAME, rc)
    dense_launches += 1
    return out
