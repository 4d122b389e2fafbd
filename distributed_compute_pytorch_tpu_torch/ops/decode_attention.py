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

Both reads take the int8 cache form too (``kv_scale=``: the f32 ``[...,
1]`` plane of per-row scales beside an int8 cache): the JAX package reads
that form in XLA (``ops/attention.py::cached_attention_q8``, after a
gather for the paged pool); the port's kernels read it themselves, int8
rows and scales, with about half the bytes of a bf16 cache. The plain
versions are ``gather_kv_blocks`` (paged) followed by
``cached_attention_q8``.

Each read is one launch: the keys of a (row, kv head) are split over up
to ``SMAX`` blocks, and the last of them to finish merges their partial
softmax sums in split order before the launch ends
(``csrc/decode_common.cuh``), through a scratch workspace and tickets
kept for each (device, stream), or in a store the caller keeps
(:func:`merge_scratch`: a CUDA graph's reads). ``split_plan`` reports the
grid a read
takes at given shapes, which depends on the shapes alone.

A decode tick writes its fresh K/V row and then reads, and the two are
one launch: ``paged_write_decode`` (``paged_decode_write``, the serving
tick: ``kv_pool_insert`` at the (block, offset) the row's table maps
``pos`` to, then the paged read) and ``dense_write_decode``
(``dense_decode_write``, the generation tick: ``kv_insert`` /
``kv_insert_rows`` at slot ``pos``, then the dense read), each in its
int8 form too (the write quantizes; the read attends the quantized row).
The block whose split holds the written key writes it before it stages
its keys, so the read sees the cache as the unfused write would leave it
and gives the read-only kernel's bits. Their plain versions are the plain
write followed by the plain read.

A speculative verify step writes a window of ``W`` fresh rows and reads
for ``W`` queries a head: ``paged_verify_write`` (``csrc/paged_verify.cu``,
the port's kernel for the JAX package's XLA op ``cache_verify_and_attend``:
the window scattered through the table, dropped at the horizon, then the
gathered read under the per-query staircase), float and int8, one launch a
layer. Its plain version is that scatter and read.

``launches`` counts ``paged_decode``'s kernel launches and
``dense_launches`` ``dense_decode``'s; the int8 forms count apart, in
``q8_launches`` and ``dense_q8_launches``. The fused ticks count in
``write_launches`` and ``dense_write_launches`` (int8:
``write_q8_launches``, ``dense_write_q8_launches``), the verify step in
``verify_launches`` (int8: ``verify_q8_launches``). Plain calls never
count.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from distributed_compute_pytorch_tpu_torch.ops import _build
from distributed_compute_pytorch_tpu_torch.ops.attention import (
    cached_attention, cached_attention_q8, gather_kv_blocks)
from distributed_compute_pytorch_tpu_torch.ops.cache_update import (
    kv_insert_plain, kv_pool_insert_plain)
from distributed_compute_pytorch_tpu_torch.utils.quantize import (
    check_scale_plane)

NAME = "paged_decode"
REPLACES = "distributed_compute_pytorch_tpu/ops/pallas/decode_attention.py:176"
launches = 0

DENSE_NAME = "dense_decode"
DENSE_REPLACES = \
    "distributed_compute_pytorch_tpu/ops/pallas/decode_attention.py:58"
dense_launches = 0
q8_launches = dense_q8_launches = 0
# the fused ticks (write, then read, in one launch): the C entries
# paged_decode_write(_q8) and dense_decode_write(_q8) of the same sources
write_launches = write_q8_launches = 0
dense_write_launches = dense_write_q8_launches = 0

# the speculative verify step: csrc/paged_verify.cu; no Pallas call (the
# JAX package's verify is XLA, ops/attention.py:356)
VERIFY_NAME = "paged_verify"
VERIFY_REPLACES = "distributed_compute_pytorch_tpu/ops/attention.py:356"
verify_launches = verify_q8_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the most blocks the kernels split a (row, kv head) over (SMAX in
# csrc/decode_common.cuh), which sizes the merge's workspace; and the split
# length, a row's capacity over which is its split count (SPLIT_KEYS there)
SMAX, SPLIT_KEYS = 16, 256


# the merge's scratch for each (device, stream): the splits' f32 partials
# and an int32 ticket a (row, kv head), which every launch leaves at zero
# (csrc/decode_common.cuh); reads on two streams never share them. An entry
# lives as long as the process: PyTorch never destroys the streams it hands
# out (``torch.cuda.Stream`` takes one of a fixed pool a device), so the
# entries are a few a device (one more for each ``ExternalStream`` a caller
# brings), each sized to the largest read on its stream (at serving's
# shapes, under 1 MB).
_scratch: dict = {}
# the store a ``merge_scratch`` block routes this thread's reads to
_local = threading.local()


@contextlib.contextmanager
def merge_scratch(store: dict):
    """Inside the block, every decode read on this thread takes its merge
    scratch from ``store`` (a dict the caller keeps: one entry a device)
    instead of the per-stream scratch. A CUDA graph records the scratch's
    addresses, so the graph's owner runs its reads once eagerly under its
    store before the capture (the scratch is sized then: growing it, or
    taking the per-stream scratch, inside a capture raises), and keeps the
    store as long as the graph. Two graphs that may replay on two streams
    at once need a store each."""
    prev = getattr(_local, "store", None)
    _local.store = store
    try:
        yield store
    finally:
        _local.store = prev


def _merge_scratch(device, pairs: int, G: int, hd: int):
    """``(ws, tickets)`` for ``pairs`` (row, kv head) pairs of ``G`` query
    heads of ``hd`` on the current stream of ``device`` (or from the
    :func:`merge_scratch` store in force), grown as needed."""
    store = getattr(_local, "store", None)
    capturing = torch.cuda.is_current_stream_capturing()
    if store is None:
        if capturing:
            raise RuntimeError("a decode read inside a CUDA graph capture "
                               "needs a scratch of its own: capture it "
                               "under decode_attention.merge_scratch")
        store, key = _scratch, (device.index, _build.stream_ptr(device))
    else:
        key = device.index
    ws, tickets = store.get(key, (None, None))
    n = pairs * SMAX * G * (hd + 2)
    grow_ws = ws is None or ws.numel() < n
    grow_tickets = tickets is None or tickets.numel() < pairs
    if capturing and (grow_ws or grow_tickets):
        raise RuntimeError("a decode read's merge scratch must be sized "
                           "before a CUDA graph capture: run the program "
                           "once eagerly under the same merge_scratch store")
    if grow_ws:
        ws = torch.empty(n, dtype=torch.float32, device=device)
    if grow_tickets:
        tickets = torch.zeros(pairs, dtype=torch.int32, device=device)
    store[key] = ws, tickets
    return ws, tickets


def split_plan(q, cache, *, table=None, kv_scale=None) -> dict:
    """The grid the CUDA read of ``q`` over ``cache`` takes: the paged
    read's with a block ``table`` (``cache`` the pool), else the dense
    read's; the int8 form with ``kv_scale``. ``{"S": splits a (row, kv
    head), "L": split length, "tile": keys a tile, "stages": tiles in
    flight, "smem": shared bytes a block, "blocks": the grid's}``. A
    function of the shapes only (it builds the kernel if needed)."""
    import ctypes
    B, H, _, hd = q.shape
    hk = cache.shape[2]
    args = (hd, _DTYPES[q.dtype], int(kv_scale is not None), H // hk)
    vals = (ctypes.c_int * 5)()
    if table is None:
        _, fn = _build.bind(DENSE_NAME, "iiiiip", "dense_decode_plan")
        fn(cache.shape[3], *args, vals)
    else:
        _, fn = _build.bind(NAME, "iiiiiip", "paged_decode_plan")
        fn(table.shape[1], cache.shape[3], *args, vals)
    plan = dict(zip(("S", "L", "tile", "stages", "smem"), vals))
    return {**plan, "blocks": plan["S"] * hk * B}


def _q8_view(cache, kv_scale):
    """The ``cached_attention_q8`` cache of a pair ``[2, B, Hk, T, hd]``
    and its scale plane ``[2, B, Hk, T, 1]``."""
    return {"k": cache[0], "v": cache[1], "k_scale": kv_scale[0],
            "v_scale": kv_scale[1]}


def paged_decode_plain(q, pool, table, pos, *, scale: float | None = None,
                       kv_scale=None):
    """The kernel's plain PyTorch version: gather each row's logical view
    through its table, then dense masked decode attention
    (``cached_attention``, or ``cached_attention_q8`` over the int8 pool
    and its gathered ``kv_scale``)."""
    kv = gather_kv_blocks(pool, table)
    if kv_scale is None:
        return cached_attention(q, kv[0], kv[1], pos, scale=scale)
    return cached_attention_q8(
        q, _q8_view(kv, gather_kv_blocks(kv_scale, table)), pos, scale=scale)


def _check_kv_scale(q, cache, kv_scale):
    """An int8 cache needs its ``kv_scale`` plane and a float query; a
    float cache takes no ``kv_scale``."""
    check_scale_plane(cache, kv_scale, "kv_scale")
    if not q.is_floating_point():
        raise ValueError(f"the query must be float, got {q.dtype}")


def _check(q, pool, table, pos, kv_scale):
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
    _check_kv_scale(q, pool, kv_scale)


def paged_decode_attention(q, pool, table, pos, *, scale: float | None = None,
                           kv_scale=None):
    """``q [B, H, 1, hd]`` attends pool ``[2, P, Hk, bt, hd]`` through
    ``table`` int32 ``[B, nb]`` over logical slots ``0..min(pos[b], nb *
    bt - 1)``; ``pos`` is an int32 ``[B]`` tensor (>= 0). An int8 pool
    takes its ``kv_scale [2, P, Hk, bt, 1]``. Returns ``[B, H, 1, hd]``.
    CUDA tensors launch ``paged_decode`` (``paged_decode_q8``); CPU tensors
    run the plain version."""
    _check(q, pool, table, pos, kv_scale)
    if q.device.type == "cpu":
        return paged_decode_plain(q, pool, table, pos, scale=scale,
                                  kv_scale=kv_scale)
    return paged_decode_cuda(q, pool, table, pos, scale=scale,
                             kv_scale=kv_scale)


def _check_cuda_read(name, q, cache, kv_scale, others):
    """The CUDA reads' shared checks: one CUDA device; an f32/bf16 query
    with a unit head-dim stride, of the cache's dtype or over an int8
    cache; a contiguous, 16-byte aligned cache (and scale plane); a head
    dim a multiple of 8 up to 128; at most 8 query heads per kv head and
    65535 rows.
    Returns the kernel's dtype code of the query."""
    dev = q.device
    tensors = (cache, *others) + (() if kv_scale is None else (kv_scale,))
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"{name} needs CUDA tensors on one device")
    if q.dtype not in _DTYPES or (cache.dtype != torch.int8
                                  and cache.dtype != q.dtype):
        raise ValueError(f"{name} takes an f32/bf16 query over a cache of "
                         f"its dtype or an int8 cache, got {q.dtype}, "
                         f"{cache.dtype}")
    H, hd, hk = q.shape[1], q.shape[3], cache.shape[2]
    if hd % 8 or hd > 128 or q.stride(-1) != 1:
        raise ValueError(f"{name} needs head_dim % 8 == 0, <= 128 and unit "
                         f"stride (got {hd})")
    if H // hk > 8:
        raise ValueError(f"{name} takes at most 8 query heads per kv head "
                         f"(got {H // hk})")
    if q.shape[0] > 65535:
        raise ValueError(f"{name} takes at most 65535 rows (a grid "
                         f"dimension), got {q.shape[0]}")
    if not cache.is_contiguous() or cache.data_ptr() % 16 or (
            kv_scale is not None and not kv_scale.is_contiguous()):
        raise ValueError(f"{name} needs a contiguous, 16-byte aligned cache "
                         f"and a contiguous scale plane")
    return _DTYPES[q.dtype]


def paged_decode_cuda(q, pool, table, pos, *, scale: float | None = None,
                      kv_scale=None):
    """Launch the CUDA kernel (the int8 form with ``kv_scale``): one
    launch, ``min(SMAX, ceil(nb * bt / split length))`` blocks per (row,
    kv head), each serving the query heads that share that kv head.
    Raises on anything it does not take: non-CUDA or mixed devices, a query
    other than f32/bf16 of the pool's dtype (or over an int8 pool), a
    missing or misshapen scale plane, a non-contiguous or unaligned pool, a
    head dim not a multiple of 8 or above 128 or without unit stride, more
    than 8 query heads per kv head, a non-int32 table or pos."""
    global launches, q8_launches
    _check(q, pool, table, pos, kv_scale)
    dt = _check_cuda_read(NAME, q, pool, kv_scale, (table, pos))
    for x in (table, pos):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("table/pos must be contiguous int32")
    B, H, _, hd = q.shape
    _, P, hk, bt, _ = pool.shape
    scale = hd ** -0.5 if scale is None else float(scale)
    out = torch.empty(B, 1, H, hd, dtype=q.dtype, device=q.device
                      ).transpose(1, 2)
    ws, tickets = _merge_scratch(q.device, B * hk, H // hk, hd)
    args = (out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
            table.data_ptr(), pos.data_ptr(), dt, B, H,
            H // hk, P, bt, hd, table.shape[1],
            _build.strides_arg(q.stride(0), q.stride(1), out.stride(0),
                               out.stride(1)),
            scale, _build.stream_ptr(q.device))
    if kv_scale is None:
        lib, fn = _build.bind(NAME, "pppppppiiiiiiiisfp")
        _build.check(lib, NAME, fn(q.data_ptr(), pool.data_ptr(), *args))
        launches += 1
    else:
        lib, fn = _build.bind(NAME, "ppppppppiiiiiiiisfp",
                              "paged_decode_q8")
        _build.check(lib, NAME, fn(q.data_ptr(), pool.data_ptr(),
                                   kv_scale.data_ptr(), *args))
        q8_launches += 1
    return out


# ---- the dense read (csrc/dense_decode.cu) ---------------------------------

def dense_decode_plain(q, cache, pos, *, slot_mask=None,
                       scale: float | None = None, kv_scale=None):
    """The kernel's plain PyTorch version: ``cached_attention`` over the
    pair cache's two planes with the slot mask (``cached_attention_q8``
    over an int8 cache and its ``kv_scale``)."""
    if kv_scale is None:
        return cached_attention(q, cache[0], cache[1], pos, scale=scale,
                                slot_mask=slot_mask)
    return cached_attention_q8(q, _q8_view(cache, kv_scale), pos, scale=scale,
                               slot_mask=slot_mask)


def _check_dense(q, cache, pos, slot_mask, kv_scale):
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
    _check_kv_scale(q, cache, kv_scale)


def decode_attention(q, cache, pos, *, slot_mask=None,
                     scale: float | None = None, kv_scale=None):
    """``q [B, H, 1, hd]`` attends the dense pair cache ``[2, B, Hk, T,
    hd]`` over slots ``0..min(pos[b], T - 1)`` that ``slot_mask`` (optional
    ``[B, T]``, nonzero = attend) keeps; ``pos`` is a scalar (a Python int
    or a 0-dim int32 tensor: every row at one slot) or an int32 ``[B]``
    tensor. An int8 cache takes its ``kv_scale [2, B, Hk, T, 1]``. Returns
    ``[B, H, 1, hd]``. CUDA tensors launch ``dense_decode``
    (``dense_decode_q8``); CPU tensors run the plain version."""
    _check_dense(q, cache, pos, slot_mask, kv_scale)
    if q.device.type == "cpu":
        return dense_decode_plain(q, cache, pos, slot_mask=slot_mask,
                                  scale=scale, kv_scale=kv_scale)
    return dense_decode_cuda(q, cache, pos, slot_mask=slot_mask, scale=scale,
                             kv_scale=kv_scale)


def dense_decode_cuda(q, cache, pos, *, slot_mask=None,
                      scale: float | None = None, kv_scale=None):
    """Launch the CUDA kernel (the int8 form with ``kv_scale``): one
    launch, ``min(SMAX, ceil(T / split length))`` blocks per (row, kv
    head), each serving the query heads that share that kv head.
    Raises on anything it does not take: non-CUDA or mixed devices, a query
    other than f32/bf16 of the cache's dtype (or over an int8 cache), a
    missing or misshapen scale plane, a non-contiguous or unaligned cache,
    a head dim not a multiple of 8 or above 128 or without unit stride,
    more than 8 query heads per kv head, a ``pos`` that is not int32 or
    has a stride other than 0 or 1, a ``slot_mask`` that is not bool/uint8
    or lacks unit stride along ``T``. ``q`` may be any other strided view
    and ``pos`` a stride-0 view: nothing is copied."""
    global dense_launches, dense_q8_launches
    _check_dense(q, cache, pos, slot_mask, kv_scale)
    others = () if slot_mask is None else (slot_mask,)
    dt = _check_cuda_read(DENSE_NAME, q, cache, kv_scale, others)
    B, H, _, hd = q.shape
    _, _, hk, T, _ = cache.shape
    pos, pos_stride = _build.pos_arg(pos, q.device)
    mask_ptr, mask_sb = None, 0
    if slot_mask is not None:
        if slot_mask.dtype not in (torch.bool, torch.uint8) \
                or slot_mask.stride(1) != 1:
            raise ValueError("slot_mask must be bool or uint8 with unit "
                             "stride along T")
        mask_ptr, mask_sb = slot_mask.data_ptr(), slot_mask.stride(0)
    scale = hd ** -0.5 if scale is None else float(scale)
    out = torch.empty(B, 1, H, hd, dtype=q.dtype, device=q.device
                      ).transpose(1, 2)
    ws, tickets = _merge_scratch(q.device, B * hk, H // hk, hd)
    args = (out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
            pos.data_ptr(), mask_ptr, dt, B, H, H // hk, T,
            hd, pos_stride,
            _build.strides_arg(q.stride(0), q.stride(1), out.stride(0),
                               out.stride(1), mask_sb),
            scale, _build.stream_ptr(q.device))
    if kv_scale is None:
        lib, fn = _build.bind(DENSE_NAME, "pppppppiiiiiiisfp")
        _build.check(lib, DENSE_NAME,
                     fn(q.data_ptr(), cache.data_ptr(), *args))
        dense_launches += 1
    else:
        lib, fn = _build.bind(DENSE_NAME, "ppppppppiiiiiiisfp",
                              "dense_decode_q8")
        _build.check(lib, DENSE_NAME, fn(q.data_ptr(), cache.data_ptr(),
                                         kv_scale.data_ptr(), *args))
        dense_q8_launches += 1
    return out


# ---- the fused ticks: the slot write and the read in one launch ------------

def _check_fresh(q, k, v, hk):
    """The tick's fresh rows: ``k``, ``v`` ``[B, Hk, 1, hd]``, as ``q``."""
    B, _, _, hd = q.shape
    for name, x in (("k", k), ("v", v)):
        if tuple(x.shape) != (B, hk, 1, hd):
            raise ValueError(f"{name} must be [B, Hk, 1, hd] = "
                             f"{(B, hk, 1, hd)}, got {tuple(x.shape)}")


def _check_cuda_fresh(name, q, k, v):
    """The fused kernels take the fresh rows in the query's dtype (f32 or
    bf16; an int8 cache quantizes them) with unit head-dim stride, any
    other strides (the fused QKV's split-head views): nothing is
    copied."""
    if any(x.dtype != q.dtype or x.stride(-1) != 1 for x in (k, v)):
        raise ValueError(f"{name} takes k and v of the query's dtype "
                         f"({q.dtype}) with unit head-dim stride, got "
                         f"{k.dtype}, {v.dtype}")


def paged_write_decode_plain(q, k, v, pool, table, pos, *, kv_scale=None):
    """The fused kernel's plain version: the serving tick's write
    (``kv_pool_insert_plain`` of row ``b``'s ``k``/``v`` at block
    ``table[b, min(pos[b] // bt, nb - 1)]``, offset ``pos[b] % bt``, in
    place; quantized for an int8 pool), then ``paged_decode_plain``."""
    bt, nb = pool.shape[3], table.shape[1]
    slot = torch.clamp(pos // bt, max=nb - 1).long()
    blk = table.gather(1, slot[:, None])[:, 0].contiguous()
    off = (pos % bt).contiguous()
    kv_pool_insert_plain(pool, k[:, :, 0], v[:, :, 0], blk, off, kv_scale)
    return paged_decode_plain(q, pool, table, pos, kv_scale=kv_scale)


def paged_write_decode(q, k, v, pool, table, pos, *, kv_scale=None):
    """One serving decode tick of a layer: row ``b``'s ``k``/``v`` ``[B,
    Hk, 1, hd]`` go into pool ``[2, P, Hk, bt, hd]`` (in place) at the
    (block, offset) its ``table`` maps logical slot ``pos[b]`` to (the slot
    clamped to the table's last entry, which only parked all-trash rows
    reach; a block id outside ``[0, P)`` drops the write), then ``q [B, H,
    1, hd]`` attends as :func:`paged_decode_attention` does. ``pos``: int32
    ``[B]`` (>= 0). An int8 pool takes its ``kv_scale`` and float rows,
    quantized as they are written. CUDA tensors launch
    ``paged_decode_write`` (``paged_decode_write_q8``), one launch; CPU
    tensors run the plain version."""
    _check(q, pool, table, pos, kv_scale)
    _check_fresh(q, k, v, pool.shape[2])
    if q.device.type == "cpu":
        return paged_write_decode_plain(q, k, v, pool, table, pos,
                                        kv_scale=kv_scale)
    return paged_write_decode_cuda(q, k, v, pool, table, pos,
                                   kv_scale=kv_scale)


def paged_write_decode_cuda(q, k, v, pool, table, pos, *, kv_scale=None):
    """Launch the fused CUDA kernel (the int8 form with ``kv_scale``):
    the write and :func:`paged_decode_cuda`'s read in one launch, on its
    grid. Raises on what that read refuses, and on ``k``/``v`` of another
    shape or dtype than the query's or without unit head-dim stride."""
    global write_launches, write_q8_launches
    _check(q, pool, table, pos, kv_scale)
    _check_fresh(q, k, v, pool.shape[2])
    dt = _check_cuda_read(NAME, q, pool, kv_scale, (table, pos, k, v))
    _check_cuda_fresh(NAME, q, k, v)
    for x in (table, pos):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("table/pos must be contiguous int32")
    B, H, _, hd = q.shape
    _, P, hk, bt, _ = pool.shape
    scale = hd ** -0.5
    out = torch.empty(B, 1, H, hd, dtype=q.dtype, device=q.device
                      ).transpose(1, 2)
    ws, tickets = _merge_scratch(q.device, B * hk, H // hk, hd)
    args = (out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
            table.data_ptr(), pos.data_ptr(), dt, B, H, H // hk, P, bt, hd,
            table.shape[1],
            _build.strides_arg(q.stride(0), q.stride(1), out.stride(0),
                               out.stride(1), k.stride(0), k.stride(1),
                               v.stride(0), v.stride(1)),
            scale, _build.stream_ptr(q.device))
    rows = (q.data_ptr(), k.data_ptr(), v.data_ptr(), pool.data_ptr())
    if kv_scale is None:
        lib, fn = _build.bind(NAME, "pppppppppiiiiiiiisfp",
                              "paged_decode_write")
        _build.check(lib, NAME, fn(*rows, *args))
        write_launches += 1
    else:
        lib, fn = _build.bind(NAME, "ppppppppppiiiiiiiisfp",
                              "paged_decode_write_q8")
        _build.check(lib, NAME, fn(*rows, kv_scale.data_ptr(), *args))
        write_q8_launches += 1
    return out


def dense_write_decode_plain(q, k, v, cache, pos, *, slot_mask=None,
                             kv_scale=None):
    """The fused kernel's plain version: the generation tick's write
    (``kv_insert_plain`` of ``k``/``v`` at slot ``pos``, in place;
    quantized for an int8 cache), then ``dense_decode_plain``."""
    kv_insert_plain(cache, k, v, pos, kv_scale)
    return dense_decode_plain(q, cache, pos, slot_mask=slot_mask,
                              kv_scale=kv_scale)


def dense_write_decode(q, k, v, cache, pos, *, slot_mask=None,
                       kv_scale=None):
    """One generation decode tick of a layer: ``k``/``v`` ``[B, Hk, 1,
    hd]`` go into the pair cache ``[2, B, Hk, T, hd]`` (in place) at slot
    ``pos`` (a scalar: every row at one slot; or an int32 ``[B]``: each at
    its own), whatever ``slot_mask`` says (a slot outside ``[0, T)`` drops
    the row), then ``q [B, H, 1, hd]`` attends as
    :func:`decode_attention` does. An int8 cache takes its ``kv_scale``
    and float rows, quantized as they are written. CUDA tensors launch
    ``dense_decode_write`` (``dense_decode_write_q8``), one launch; CPU
    tensors run the plain version."""
    _check_dense(q, cache, pos, slot_mask, kv_scale)
    _check_fresh(q, k, v, cache.shape[2])
    if q.device.type == "cpu":
        return dense_write_decode_plain(q, k, v, cache, pos,
                                        slot_mask=slot_mask,
                                        kv_scale=kv_scale)
    return dense_write_decode_cuda(q, k, v, cache, pos, slot_mask=slot_mask,
                                   kv_scale=kv_scale)


def dense_write_decode_cuda(q, k, v, cache, pos, *, slot_mask=None,
                            kv_scale=None):
    """Launch the fused CUDA kernel (the int8 form with ``kv_scale``): the
    write and :func:`dense_decode_cuda`'s read in one launch, on its grid.
    Raises on what that read refuses, and on ``k``/``v`` of another shape
    or dtype than the query's or without unit head-dim stride."""
    global dense_write_launches, dense_write_q8_launches
    _check_dense(q, cache, pos, slot_mask, kv_scale)
    _check_fresh(q, k, v, cache.shape[2])
    others = (k, v) + (() if slot_mask is None else (slot_mask,))
    dt = _check_cuda_read(DENSE_NAME, q, cache, kv_scale, others)
    _check_cuda_fresh(DENSE_NAME, q, k, v)
    B, H, _, hd = q.shape
    _, _, hk, T, _ = cache.shape
    pos, pos_stride = _build.pos_arg(pos, q.device)
    mask_ptr, mask_sb = None, 0
    if slot_mask is not None:
        if slot_mask.dtype not in (torch.bool, torch.uint8) \
                or slot_mask.stride(1) != 1:
            raise ValueError("slot_mask must be bool or uint8 with unit "
                             "stride along T")
        mask_ptr, mask_sb = slot_mask.data_ptr(), slot_mask.stride(0)
    scale = hd ** -0.5
    out = torch.empty(B, 1, H, hd, dtype=q.dtype, device=q.device
                      ).transpose(1, 2)
    ws, tickets = _merge_scratch(q.device, B * hk, H // hk, hd)
    args = (out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
            pos.data_ptr(), mask_ptr, dt, B, H, H // hk, T, hd, pos_stride,
            _build.strides_arg(q.stride(0), q.stride(1), out.stride(0),
                               out.stride(1), mask_sb, k.stride(0),
                               k.stride(1), v.stride(0), v.stride(1)),
            scale, _build.stream_ptr(q.device))
    rows = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cache.data_ptr())
    if kv_scale is None:
        lib, fn = _build.bind(DENSE_NAME, "pppppppppiiiiiiisfp",
                              "dense_decode_write")
        _build.check(lib, DENSE_NAME, fn(*rows, *args))
        dense_write_launches += 1
    else:
        lib, fn = _build.bind(DENSE_NAME, "ppppppppppiiiiiiisfp",
                              "dense_decode_write_q8")
        _build.check(lib, DENSE_NAME, fn(*rows, kv_scale.data_ptr(), *args))
        dense_write_q8_launches += 1
    return out


# ---- the verify step: a window's write and its staircase read, one launch --

def verify_plan(q, pool, table, *, kv_scale=None) -> dict:
    """The grid the CUDA verify step of ``q [B, H, W, hd]`` over ``pool``
    through ``table`` takes: ``{"S": splits a (row, kv head, query group),
    "L": split length, "tile": prefix keys a tile, "stages": tiles in
    flight, "smem": shared bytes a block, "groups": query groups of up to
    "qmax" queries, "qmax", "chunk": keys a warp takes at once, "tc": 1 for
    the tensor-core form (bf16), 0 for the CUDA-core form (f32), "blocks":
    the grid's}``. A function of the shapes only (it builds the kernel if
    needed)."""
    import ctypes
    B, H, W, hd = q.shape
    hk = pool.shape[2]
    _, fn = _build.bind(VERIFY_NAME, "iiiiiiiiip", "paged_verify_plan")
    vals = (ctypes.c_int * 9)()
    fn(table.shape[1], pool.shape[3], hd, _DTYPES[q.dtype],
       int(kv_scale is not None), H // hk, W, B, hk, vals)
    plan = dict(zip(("S", "L", "tile", "stages", "smem", "groups", "qmax",
                     "chunk", "tc"), vals))
    return {**plan, "blocks": plan["S"] * plan["groups"] * hk * B}


def _check_verify(q, k, v, pool, table, positions, kv_scale):
    if q.ndim != 4:
        raise ValueError(f"q must be [B, H, W, hd], got {tuple(q.shape)}")
    if pool.ndim != 5 or pool.shape[0] != 2:
        raise ValueError(f"pool must be [2, P, Hk, bt, hd], got "
                         f"{tuple(pool.shape)}")
    B, H, W, hd = q.shape
    hk = pool.shape[2]
    if pool.shape[4] != hd or H % hk:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool "
                         f"{tuple(pool.shape)}")
    for name, x in (("k", k), ("v", v)):
        if tuple(x.shape) != (B, hk, W, hd):
            raise ValueError(f"{name} must be [B, Hk, W, hd] = "
                             f"{(B, hk, W, hd)}, got {tuple(x.shape)}")
    if table.ndim != 2 or table.shape[0] != B or \
            tuple(positions.shape) != (B, W):
        raise ValueError("table must be [B, nb] and positions [B, W]")
    _check_kv_scale(q, pool, kv_scale)


def paged_verify_write_plain(q, k, v, pool, table, positions, *,
                             kv_scale=None):
    """The verify kernel's plain version, the reference's
    ``cache_verify_and_attend``: row ``b``'s window K/V written (in place;
    quantized for an int8 pool) at block ``table[b, positions // bt]``,
    offset ``positions % bt``, slots at or past ``nb * bt`` dropped, then
    ``cached_attention`` (``cached_attention_q8``) of the gathered view
    under the per-query ``positions``."""
    B, _, W, hd = q.shape
    P, hk, bt = pool.shape[1], pool.shape[2], pool.shape[3]
    nb = table.shape[1]
    pos = positions.long()
    blk = table.long().gather(1, torch.clamp(pos // bt, 0, nb - 1))
    blk = torch.where(pos < nb * bt, blk, torch.full_like(blk, P))
    rows = lambda x: x.transpose(1, 2).reshape(B * W, hk, hd)
    kv_pool_insert_plain(pool, rows(k), rows(v), blk.reshape(-1),
                         (pos % bt).reshape(-1), kv_scale)
    kv = gather_kv_blocks(pool, table)
    if kv_scale is None:
        return cached_attention(q, kv[0], kv[1], positions)
    return cached_attention_q8(
        q, _q8_view(kv, gather_kv_blocks(kv_scale, table)), positions)


def paged_verify_write(q, k, v, pool, table, positions, *, kv_scale=None):
    """One speculative verify step of a layer: row ``b``'s window ``k``/``v``
    ``[B, Hk, W, hd]`` go into pool ``[2, P, Hk, bt, hd]`` (in place) at the
    (block, offset) its ``table`` maps each slot ``positions[b, w]`` to
    (int32 ``[B, W]``, consecutive per row), dropped at or past ``nb *
    bt``; then query ``(h, w)`` of ``q [B, H, W, hd]`` attends the row's
    slots ``0..positions[b, w]`` (capped at the horizon). An int8 pool takes
    its ``kv_scale`` and float rows, quantized as they are written.
    Returns ``[B, H, W, hd]``. CUDA tensors launch ``paged_verify_write``
    (``paged_verify_write_q8``), one launch; CPU tensors run the plain
    version."""
    _check_verify(q, k, v, pool, table, positions, kv_scale)
    if q.device.type == "cpu":
        return paged_verify_write_plain(q, k, v, pool, table, positions,
                                        kv_scale=kv_scale)
    return paged_verify_write_cuda(q, k, v, pool, table, positions,
                                   kv_scale=kv_scale)


def paged_verify_write_cuda(q, k, v, pool, table, positions, *,
                            kv_scale=None):
    """Launch the CUDA verify kernel (the int8 form with ``kv_scale``):
    ``S`` splits of the row's prefix for each (row, kv head, group of up to
    16 queries), one launch; a bf16 query takes the tensor-core form, an
    f32 query the CUDA-core form. Any query group size: a group of heads by a
    window larger than 16 queries takes more groups, each reading the
    prefix again. Raises on non-CUDA or mixed devices, a query other than
    f32/bf16 of the pool's dtype (or over an int8 pool), ``k``/``v`` of
    another dtype, a missing or misshapen scale plane, a non-contiguous or
    unaligned pool, a head dim not a multiple of 8 or above 128, a tensor
    without unit head-dim stride, and a table or positions that are not
    contiguous int32. The window's slots in a row are taken to be
    consecutive: the kernel reads ``positions[b, 0]`` alone."""
    global verify_launches, verify_q8_launches
    _check_verify(q, k, v, pool, table, positions, kv_scale)
    dev = q.device
    tensors = (pool, k, v, table, positions) + (
        () if kv_scale is None else (kv_scale,))
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"{VERIFY_NAME} needs CUDA tensors on one device")
    if q.dtype not in _DTYPES or (pool.dtype != torch.int8
                                  and pool.dtype != q.dtype):
        raise ValueError(f"{VERIFY_NAME} takes an f32/bf16 query over a "
                         f"pool of its dtype or an int8 pool, got "
                         f"{q.dtype}, {pool.dtype}")
    B, H, W, hd = q.shape
    _, P, hk, bt, _ = pool.shape
    if hd % 8 or hd > 128:
        raise ValueError(f"{VERIFY_NAME} needs head_dim % 8 == 0 and <= "
                         f"128 (got {hd})")
    if any(x.dtype != q.dtype or x.stride(-1) != 1 for x in (k, v)) \
            or q.stride(-1) != 1:
        raise ValueError(f"{VERIFY_NAME} takes q, k and v of one dtype "
                         f"with unit head-dim stride")
    if not pool.is_contiguous() or pool.data_ptr() % 16 or (
            kv_scale is not None and not kv_scale.is_contiguous()):
        raise ValueError(f"{VERIFY_NAME} needs a contiguous, 16-byte "
                         f"aligned pool and a contiguous scale plane")
    for x in (table, positions):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("table/positions must be contiguous int32")
    G = H // hk
    plan = verify_plan(q, pool, table, kv_scale=kv_scale)
    out = torch.empty(B, W, H, hd, dtype=q.dtype, device=dev
                      ).permute(0, 2, 1, 3)
    ws, tickets = _merge_scratch(dev, B * hk * plan["groups"], plan["qmax"],
                                 hd)
    args = (out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
            table.data_ptr(), positions.data_ptr(), _DTYPES[q.dtype], B, H,
            G, W, P, bt, hd, table.shape[1],
            _build.strides_arg(*q.stride()[:3], *out.stride()[:3],
                               *k.stride()[:3], *v.stride()[:3]),
            hd ** -0.5, _build.stream_ptr(dev))
    rows = (q.data_ptr(), k.data_ptr(), v.data_ptr(), pool.data_ptr())
    if kv_scale is None:
        lib, fn = _build.bind(VERIFY_NAME, "pppppppppiiiiiiiiisfp",
                              "paged_verify_write")
        _build.check(lib, VERIFY_NAME, fn(*rows, *args))
        verify_launches += 1
    else:
        lib, fn = _build.bind(VERIFY_NAME, "ppppppppppiiiiiiiiisfp",
                              "paged_verify_write_q8")
        _build.check(lib, VERIFY_NAME, fn(*rows, kv_scale.data_ptr(), *args))
        verify_q8_launches += 1
    return out
