"""KV-cache slot writes — the port of
``distributed_compute_pytorch_tpu/ops/pallas/cache_update.py``'s four
Pallas calls as two hand-written CUDA kernels:

- the paged pool write ``kv_pool_insert`` (``kv_pool_insert_rows_pallas``,
  kernel ``_pool_rows_kernel``) -> ``csrc/kv_pool_insert.cu``. Rows whose
  block id lies outside ``[0, P)`` are dropped, the ``mode="drop"``
  contract of the reference's ``_pool_scatter``, so one kernel serves both
  the decode tick and the admission scatter (whose pad tokens aim at block
  ``P``);
- the dense writes -> ``csrc/kv_insert.cu``: ``cache_insert`` (one
  ``[B, Hk, T, hd]`` cache at a scalar slot; ``cache_insert_pallas``,
  ``_insert_kernel``), ``kv_insert`` (the K/V pair cache ``[2, B, Hk, T,
  hd]`` at one scalar slot, generation's lockstep tick;
  ``kv_insert_pallas``, ``_pair_kernel``) and ``kv_insert_rows`` (the pair
  at per-row slots; ``kv_insert_rows_pallas``, ``_pair_rows_kernel``). A
  slot outside ``[0, T)`` drops the row; the JAX fallback
  (``dynamic_update_slice``) clamps it instead. Generation's capacity check
  keeps every slot in range.

Every write is IN PLACE (the JAX package donates the buffer and returns a
new one). Each entry point counts its own kernel launches (plain calls
never count): ``launches`` the pool write's, ``cache_insert_launches``,
``kv_insert_launches`` and ``kv_insert_rows_launches`` the dense writes'.
The int8 cache form (the ``"scale"`` leaf) waits for the int8 KV slice
(``ROADMAP.md`` queue 3.6); the dense wrappers raise on an int8 cache.
"""

from __future__ import annotations

import torch

from distributed_compute_pytorch_tpu_torch.ops import _build

NAME = "kv_pool_insert"
REPLACES = "distributed_compute_pytorch_tpu/ops/pallas/cache_update.py:227"
launches = 0

DENSE_NAME = "kv_insert"
CACHE_INSERT_REPLACES = \
    "distributed_compute_pytorch_tpu/ops/pallas/cache_update.py:48"
KV_INSERT_REPLACES = \
    "distributed_compute_pytorch_tpu/ops/pallas/cache_update.py:130"
KV_INSERT_ROWS_REPLACES = \
    "distributed_compute_pytorch_tpu/ops/pallas/cache_update.py:318"
cache_insert_launches = kv_insert_launches = kv_insert_rows_launches = 0

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


# ---- dense cache writes (csrc/kv_insert.cu) --------------------------------

def _dense_write_plain(cache, upds, pos):
    """``cache [s, B, Hk, T, w]`` takes plane ``i`` of ``upds`` (each
    ``[B, Hk, 1, w]``) at slot ``pos`` (scalar or ``[B]``), in place,
    dropping rows whose slot lies outside ``[0, T)``."""
    _, B, _, T, _ = cache.shape
    pos = torch.as_tensor(pos, device=cache.device).reshape(-1).expand(B)
    keep = (pos >= 0) & (pos < T)
    rows = torch.arange(B, device=cache.device)[keep]
    slots = pos[keep].long()
    for i, u in enumerate(upds):
        cache[i, rows, :, slots, :] = u[keep][:, :, 0].to(cache.dtype)
    return cache


def cache_insert_plain(cache, upd, pos):
    """``cache[:, :, pos] = upd[:, :, 0]`` for ``cache [B, Hk, T, hd]`` and
    a scalar ``pos``, in place (nothing is written when ``pos`` lies
    outside ``[0, T)``)."""
    _dense_write_plain(cache[None], (upd,), pos)
    return cache


def kv_insert_plain(cache, k, v, pos):
    """``cache[0, b, :, pos[b]] = k[b, :, 0]`` and ``cache[1, ...] = v``
    for ``cache [2, B, Hk, T, hd]``, ``pos`` a scalar or ``[B]``, in place,
    dropping rows whose slot lies outside ``[0, T)``."""
    return _dense_write_plain(cache, (k, v), pos)


def _is_scalar(pos) -> bool:
    return not isinstance(pos, torch.Tensor) or pos.ndim == 0


def _check_dense(cache, upds, pos, s: int, lockstep: bool):
    if cache.ndim != 5 or cache.shape[0] != s:
        raise ValueError(f"cache must be [{s}, B, Hk, T, hd] here, got "
                         f"{tuple(cache.shape)}")
    if cache.dtype == torch.int8:
        raise NotImplementedError(
            "the int8 KV cache form (the 'scale' leaf) waits for the int8 "
            "KV slice (ROADMAP.md queue 3.6)")
    _, B, hk, _, hd = cache.shape
    for name, u in zip("kv", upds):
        if tuple(u.shape) != (B, hk, 1, hd):
            raise ValueError(f"{name} must be [B, Hk, 1, hd] = "
                             f"{(B, hk, 1, hd)}, got {tuple(u.shape)}")
    if lockstep and not _is_scalar(pos):
        raise ValueError(f"pos must be a scalar here, got shape "
                         f"{tuple(pos.shape)} (per-row slots: "
                         f"kv_insert_rows)")
    if not lockstep and (not isinstance(pos, torch.Tensor)
                         or tuple(pos.shape) != (B,)):
        raise ValueError(f"pos must be a [B] = [{B}] tensor")


def cache_insert(cache, upd, pos):
    """Write ``upd [B, Hk, 1, hd]`` into ``cache [B, Hk, T, hd]`` at the
    scalar slot ``pos``, in place; returns ``cache``. CUDA tensors launch
    ``kv_insert``; CPU tensors run the plain version."""
    _check_dense(cache[None], (upd,), pos, 1, True)
    if cache.device.type == "cpu":
        return cache_insert_plain(cache, upd, pos)
    return cache_insert_cuda(cache, upd, pos)


def kv_insert(cache, k, v, pos):
    """Write ``k``/``v`` ``[B, Hk, 1, hd]`` into the pair cache ``[2, B,
    Hk, T, hd]`` at the one slot ``pos`` (a Python int or a 0-dim int32
    tensor: the lockstep tick), in place; returns ``cache``. CUDA tensors
    launch ``kv_insert``; CPU tensors run the plain version."""
    _check_dense(cache, (k, v), pos, 2, True)
    if cache.device.type == "cpu":
        return kv_insert_plain(cache, k, v, pos)
    return kv_insert_cuda(cache, k, v, pos)


def kv_insert_rows(cache, k, v, pos):
    """As :func:`kv_insert`, but row ``b`` writes at its own slot
    ``pos[b]`` (``pos`` an int32 ``[B]`` tensor)."""
    _check_dense(cache, (k, v), pos, 2, False)
    if cache.device.type == "cpu":
        return kv_insert_plain(cache, k, v, pos)
    return kv_insert_rows_cuda(cache, k, v, pos)


def _dense_launch(cache, k, v, pos):
    """Launch ``kv_insert`` for ``cache [s, B, Hk, T, hd]``. Raises on
    anything it does not take: non-CUDA or mixed devices, a non-contiguous
    cache, a dtype other than f32/bf16 or other than the cache's, a head
    dim without unit stride. ``k``/``v`` may be any other strided view
    (the split-head views of the fused QKV) and ``pos`` a stride-0 view:
    nothing is copied."""
    dev = cache.device
    upds = (k,) if v is None else (k, v)
    if dev.type != "cuda" or any(u.device != dev for u in upds):
        raise ValueError("kv_insert needs CUDA tensors on one device")
    if cache.dtype not in _DTYPES or any(u.dtype != cache.dtype
                                         for u in upds):
        raise ValueError(f"kv_insert takes an f32/bf16 cache and updates of "
                         f"its dtype, got {cache.dtype}, "
                         f"{[u.dtype for u in upds]}")
    if not cache.is_contiguous() or any(u.stride(-1) != 1 for u in upds):
        raise ValueError("kv_insert needs a contiguous cache and unit "
                         "head-dim stride on the updates")
    pos, pos_stride = _build.pos_arg(pos, dev)
    s, B, hk, T, hd = cache.shape
    vv = k if v is None else v
    lib, fn = _build.bind(DENSE_NAME, "ppppiiiiiiisp")
    rc = fn(cache.data_ptr(), k.data_ptr(), vv.data_ptr(), pos.data_ptr(),
            cache.element_size(), s, B, hk, T, hd, pos_stride,
            _build.strides_arg(k.stride(0), k.stride(1), vv.stride(0),
                               vv.stride(1)),
            _build.stream_ptr(dev))
    _build.check(lib, DENSE_NAME, rc)


def cache_insert_cuda(cache, upd, pos):
    """Launch the kernel for :func:`cache_insert` (``s = 1``)."""
    global cache_insert_launches
    _check_dense(cache[None], (upd,), pos, 1, True)
    _dense_launch(cache[None], upd, None, pos)
    cache_insert_launches += 1
    return cache


def kv_insert_cuda(cache, k, v, pos):
    """Launch the kernel for :func:`kv_insert` (``s = 2``, one slot)."""
    global kv_insert_launches
    _check_dense(cache, (k, v), pos, 2, True)
    _dense_launch(cache, k, v, pos)
    kv_insert_launches += 1
    return cache


def kv_insert_rows_cuda(cache, k, v, pos):
    """Launch the kernel for :func:`kv_insert_rows` (``s = 2``, per-row
    slots)."""
    global kv_insert_rows_launches
    _check_dense(cache, (k, v), pos, 2, False)
    _dense_launch(cache, k, v, pos)
    kv_insert_rows_launches += 1
    return cache
