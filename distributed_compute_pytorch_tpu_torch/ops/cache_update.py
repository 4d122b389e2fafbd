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

Every write takes the int8 cache form too: an int8 cache with a
``scale=`` plane, f32 ``[..., 1]`` (one scale per cached row; the Pallas
calls' ``{"kv": int8, "scale": f32}`` trees). The int8 forms take the
FLOAT K/V and quantize it as they write (``utils/quantize.py::
quantize_kv``, fused into the kernels: ``kv_pool_insert_q8`` and
``kv_insert_q8``), so a decode tick's quantization needs no launch of its
own; the plain versions quantize, then write both leaves.

A decode tick's write is not launched from here on the card: the tick
writes and reads in one launch (``ops/decode_attention.py``,
``paged_write_decode`` and ``dense_write_decode``, whose plain versions
call the plain writes below). ``kv_pool_insert`` stays the admission
scatter's write; the dense writes stay kernels of the port, and the
standalone tick write with them is what the fused ticks are held to on the
card (bit for bit, ``chip_smoke.py``).

Every write is IN PLACE (the JAX package donates the buffer and returns a
new one). Each entry point counts its own kernel launches (plain calls
never count): ``launches`` the pool write's, ``cache_insert_launches``,
``kv_insert_launches`` and ``kv_insert_rows_launches`` the dense writes';
the int8 forms count apart, in ``q8_launches``,
``cache_insert_q8_launches``, ``kv_insert_q8_launches`` and
``kv_insert_rows_q8_launches``.
"""

from __future__ import annotations

import torch

from distributed_compute_pytorch_tpu_torch.ops import _build
from distributed_compute_pytorch_tpu_torch.utils.quantize import (
    check_scale_plane, quantize_kv)

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
q8_launches = 0
cache_insert_q8_launches = kv_insert_q8_launches = 0
kv_insert_rows_q8_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the int8 forms' scale planes and the widest head dim their kernels take
# (one warp quantizes one row)
_Q8_MAX_HD = 128


def _check_scale(cache, scale, updates):
    """An int8 ``cache`` needs its scale plane and float updates; a float
    cache takes no ``scale``."""
    check_scale_plane(cache, scale)
    if scale is not None and any(not u.is_floating_point() for u in updates):
        raise ValueError(f"the int8 cache takes float K/V (quantized as it is "
                         f"written), got {[u.dtype for u in updates]}")


def _write_rows(cache, scale, plane, index, rows):
    """``cache[plane][index] = rows`` (cast to the cache dtype), or for an
    int8 cache the rows' ``quantize_kv`` bytes, and their scales into
    ``scale[plane][index]``."""
    if scale is None:
        cache[plane][index] = rows.to(cache.dtype)
    else:
        q, s = quantize_kv(rows)
        cache[plane][index] = q
        scale[plane][index] = s


def kv_pool_insert_plain(pool, k, v, blocks, offsets, scale=None):
    """The kernel's plain PyTorch version: ``pool[0, blocks[i], :,
    offsets[i], :] = k[i]`` (and ``v`` into plane 1), in place, dropping
    rows whose block id or offset is out of range; for an int8 pool, the
    rows' ``quantize_kv`` bytes, and their scales into ``scale``."""
    P, bt = pool.shape[1], pool.shape[3]
    keep = (blocks >= 0) & (blocks < P) & (offsets >= 0) & (offsets < bt)
    idx = (blocks[keep].long(), slice(None), offsets[keep].long())
    _write_rows(pool, scale, 0, idx, k[keep])
    _write_rows(pool, scale, 1, idx, v[keep])
    return pool


def _check(pool, k, v, blocks, offsets, scale):
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
    _check_scale(pool, scale, (k, v))


def kv_pool_insert(pool, k, v, blocks, offsets, *, scale=None):
    """Write ``k``/``v`` ``[N, H, hd]`` into ``pool [2, P, H, bt, hd]`` at
    ``(blocks[i], offsets[i])``, in place; returns ``pool``. An int8 pool
    takes its ``scale`` plane ``[2, P, H, bt, 1]`` and float ``k``/``v``,
    quantized as they are written. CUDA tensors launch ``kv_pool_insert``
    (``kv_pool_insert_q8``); CPU tensors run the plain version."""
    _check(pool, k, v, blocks, offsets, scale)
    if pool.device.type == "cpu":
        return kv_pool_insert_plain(pool, k, v, blocks, offsets, scale)
    return kv_pool_insert_cuda(pool, k, v, blocks, offsets, scale=scale)


def _check_cuda_floats(name, cache, scale, upds, others):
    """The CUDA wrappers' shared checks: one CUDA device; a contiguous
    cache; updates of one dtype with a unit head-dim stride; f32/bf16
    updates of the cache's dtype, or, for an int8 cache, of either, with a
    contiguous scale plane and a head dim the quantizing warp takes.
    Returns the kernel's dtype code of the updates."""
    dev = cache.device
    tensors = (*upds, *others) + (() if scale is None else (scale,))
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"{name} needs CUDA tensors on one device")
    dt = upds[0].dtype
    if any(u.dtype != dt for u in upds) or dt not in _DTYPES or (
            cache.dtype != torch.int8 and cache.dtype != dt):
        raise ValueError(f"{name} takes f32/bf16 updates of one dtype, the "
                         f"cache's or an int8 cache's, got cache "
                         f"{cache.dtype}, updates {[u.dtype for u in upds]}")
    if not cache.is_contiguous() or any(u.stride(-1) != 1 for u in upds):
        raise ValueError(f"{name} needs a contiguous cache and unit "
                         f"head-dim stride on the updates")
    if scale is not None and (not scale.is_contiguous()
                              or cache.shape[-1] > _Q8_MAX_HD):
        raise ValueError(f"{name}: the int8 form needs a contiguous scale "
                         f"plane and head_dim <= {_Q8_MAX_HD}, got "
                         f"head_dim {cache.shape[-1]}")
    return _DTYPES[dt]


def kv_pool_insert_cuda(pool, k, v, blocks, offsets, *, scale=None):
    """Launch the CUDA kernel (the int8 form with ``scale``). Raises on
    anything it does not take: non-CUDA or mixed devices, a non-contiguous
    pool or scale plane, a dtype other than the pool's (f32/bf16; an int8
    pool takes f32 or bf16 K/V of one dtype), a head dim without unit
    stride (above 128 for int8), non-int32 or non-contiguous block ids and
    offsets."""
    global launches, q8_launches
    _check(pool, k, v, blocks, offsets, scale)
    dt = _check_cuda_floats(NAME, pool, scale, (k, v), (blocks, offsets))
    for x in (blocks, offsets):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("blocks/offsets must be contiguous int32")
    _, P, H, bt, hd = pool.shape
    n = blocks.shape[0]
    if n == 0:
        return pool
    strides = _build.strides_arg(k.stride(0), k.stride(1), v.stride(0),
                                 v.stride(1))
    stream = _build.stream_ptr(pool.device)
    if scale is None:
        lib, fn = _build.bind(NAME, "pppppiiiiiisp")
        rc = fn(pool.data_ptr(), k.data_ptr(), v.data_ptr(),
                blocks.data_ptr(), offsets.data_ptr(), dt, n, P, H, bt, hd,
                strides, stream)
    else:
        lib, fn = _build.bind(NAME, "ppppppiiiiiisp", "kv_pool_insert_q8")
        rc = fn(pool.data_ptr(), scale.data_ptr(), k.data_ptr(),
                v.data_ptr(), blocks.data_ptr(), offsets.data_ptr(), dt, n,
                P, H, bt, hd, strides, stream)
    _build.check(lib, NAME, rc)
    if scale is None:
        launches += 1
    else:
        q8_launches += 1
    return pool


# ---- dense cache writes (csrc/kv_insert.cu) --------------------------------

def _dense_write_plain(cache, upds, pos, scale=None):
    """``cache [s, B, Hk, T, w]`` takes plane ``i`` of ``upds`` (each
    ``[B, Hk, 1, w]``) at slot ``pos`` (scalar or ``[B]``), in place,
    dropping rows whose slot lies outside ``[0, T)``; an int8 cache takes
    the rows' ``quantize_kv`` bytes, and ``scale`` their scales."""
    _, B, _, T, _ = cache.shape
    pos = torch.as_tensor(pos, device=cache.device).reshape(-1).expand(B)
    keep = (pos >= 0) & (pos < T)
    idx = (torch.arange(B, device=cache.device)[keep], slice(None),
           pos[keep].long())
    for i, u in enumerate(upds):
        _write_rows(cache, scale, i, idx, u[keep][:, :, 0])
    return cache


def cache_insert_plain(cache, upd, pos, scale=None):
    """``cache[:, :, pos] = upd[:, :, 0]`` for ``cache [B, Hk, T, hd]`` and
    a scalar ``pos``, in place (nothing is written when ``pos`` lies
    outside ``[0, T)``); int8 with its ``scale [B, Hk, T, 1]``."""
    _dense_write_plain(cache[None], (upd,), pos,
                       None if scale is None else scale[None])
    return cache


def kv_insert_plain(cache, k, v, pos, scale=None):
    """``cache[0, b, :, pos[b]] = k[b, :, 0]`` and ``cache[1, ...] = v``
    for ``cache [2, B, Hk, T, hd]``, ``pos`` a scalar or ``[B]``, in place,
    dropping rows whose slot lies outside ``[0, T)``; int8 with its
    ``scale [2, B, Hk, T, 1]``."""
    return _dense_write_plain(cache, (k, v), pos, scale)


def _is_scalar(pos) -> bool:
    return not isinstance(pos, torch.Tensor) or pos.ndim == 0


def _check_dense(cache, upds, pos, s: int, lockstep: bool, scale):
    if cache.ndim != 5 or cache.shape[0] != s:
        raise ValueError(f"cache must be [{s}, B, Hk, T, hd] here, got "
                         f"{tuple(cache.shape)}")
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
    _check_scale(cache, scale, upds)


def cache_insert(cache, upd, pos, *, scale=None):
    """Write ``upd [B, Hk, 1, hd]`` into ``cache [B, Hk, T, hd]`` at the
    scalar slot ``pos``, in place; returns ``cache``. An int8 cache takes
    its ``scale [B, Hk, T, 1]`` and a float ``upd``. CUDA tensors launch
    ``kv_insert`` (``kv_insert_q8``); CPU tensors run the plain version."""
    _check_dense(cache[None], (upd,), pos, 1, True,
                 None if scale is None else scale[None])
    if cache.device.type == "cpu":
        return cache_insert_plain(cache, upd, pos, scale)
    return cache_insert_cuda(cache, upd, pos, scale=scale)


def kv_insert(cache, k, v, pos, *, scale=None):
    """Write ``k``/``v`` ``[B, Hk, 1, hd]`` into the pair cache ``[2, B,
    Hk, T, hd]`` at the one slot ``pos`` (a Python int or a 0-dim int32
    tensor: the lockstep tick), in place; returns ``cache``. An int8 cache
    takes its ``scale [2, B, Hk, T, 1]`` and float ``k``/``v``. CUDA
    tensors launch ``kv_insert`` (``kv_insert_q8``); CPU tensors run the
    plain version."""
    _check_dense(cache, (k, v), pos, 2, True, scale)
    if cache.device.type == "cpu":
        return kv_insert_plain(cache, k, v, pos, scale)
    return kv_insert_cuda(cache, k, v, pos, scale=scale)


def kv_insert_rows(cache, k, v, pos, *, scale=None):
    """As :func:`kv_insert`, but row ``b`` writes at its own slot
    ``pos[b]`` (``pos`` an int32 ``[B]`` tensor)."""
    _check_dense(cache, (k, v), pos, 2, False, scale)
    if cache.device.type == "cpu":
        return kv_insert_plain(cache, k, v, pos, scale)
    return kv_insert_rows_cuda(cache, k, v, pos, scale=scale)


def _dense_launch(cache, k, v, pos, scale):
    """Launch ``kv_insert`` (``kv_insert_q8`` with ``scale``) for ``cache
    [s, B, Hk, T, hd]``. Raises on anything it does not take: non-CUDA or
    mixed devices, a non-contiguous cache or scale plane, updates other
    than f32/bf16 of one dtype (the cache's, or either for an int8 cache),
    a head dim without unit stride (above 128 for int8). ``k``/``v`` may
    be any other strided view (the split-head views of the fused QKV) and
    ``pos`` a stride-0 view: nothing is copied."""
    upds = (k,) if v is None else (k, v)
    dt = _check_cuda_floats(DENSE_NAME, cache, scale, upds, ())
    pos, pos_stride = _build.pos_arg(pos, cache.device)
    s, B, hk, T, hd = cache.shape
    vv = k if v is None else v
    strides = _build.strides_arg(k.stride(0), k.stride(1), vv.stride(0),
                                 vv.stride(1))
    stream = _build.stream_ptr(cache.device)
    if scale is None:
        lib, fn = _build.bind(DENSE_NAME, "ppppiiiiiiisp")
        rc = fn(cache.data_ptr(), k.data_ptr(), vv.data_ptr(),
                pos.data_ptr(), cache.element_size(), s, B, hk, T, hd,
                pos_stride, strides, stream)
    else:
        lib, fn = _build.bind(DENSE_NAME, "pppppiiiiiiisp", "kv_insert_q8")
        rc = fn(cache.data_ptr(), scale.data_ptr(), k.data_ptr(),
                vv.data_ptr(), pos.data_ptr(), dt, s, B, hk, T, hd,
                pos_stride, strides, stream)
    _build.check(lib, DENSE_NAME, rc)


def cache_insert_cuda(cache, upd, pos, *, scale=None):
    """Launch the kernel for :func:`cache_insert` (``s = 1``)."""
    global cache_insert_launches, cache_insert_q8_launches
    sc = None if scale is None else scale[None]
    _check_dense(cache[None], (upd,), pos, 1, True, sc)
    _dense_launch(cache[None], upd, None, pos, sc)
    if scale is None:
        cache_insert_launches += 1
    else:
        cache_insert_q8_launches += 1
    return cache


def kv_insert_cuda(cache, k, v, pos, *, scale=None):
    """Launch the kernel for :func:`kv_insert` (``s = 2``, one slot)."""
    global kv_insert_launches, kv_insert_q8_launches
    _check_dense(cache, (k, v), pos, 2, True, scale)
    _dense_launch(cache, k, v, pos, scale)
    if scale is None:
        kv_insert_launches += 1
    else:
        kv_insert_q8_launches += 1
    return cache


def kv_insert_rows_cuda(cache, k, v, pos, *, scale=None):
    """Launch the kernel for :func:`kv_insert_rows` (``s = 2``, per-row
    slots)."""
    global kv_insert_rows_launches, kv_insert_rows_q8_launches
    _check_dense(cache, (k, v), pos, 2, False, scale)
    _dense_launch(cache, k, v, pos, scale)
    if scale is None:
        kv_insert_rows_launches += 1
    else:
        kv_insert_rows_q8_launches += 1
    return cache
