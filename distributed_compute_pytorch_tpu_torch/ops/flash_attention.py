"""Flash attention — the port of
``distributed_compute_pytorch_tpu/ops/pallas/flash_attention.py``: its
forward kernel ``_fwd_kernel`` as ``csrc/flash_fwd.cu``, and its two
backward kernels ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` as
``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu``, tied together by
:class:`FlashAttention`, the counterpart of the reference's custom VJPs
``_flash`` / ``_flash_masked``.

:func:`flash_attention` is the entry the attention dispatcher calls, on
every device, through :class:`FlashAttention`: CUDA tensors launch the
kernels (or raise), CPU tensors run the plain versions
(:func:`flash_fwd_plain` forward, :func:`flash_bwd_plain` backward), so
the CPU tests drive the same backward math the kernels are held to. The
kernels take the split-head views of the fused QKV projection as they are
(any strides with a unit head-dim stride) and write their outputs in the
``[b, t, h, d]`` memory order, so neither side of a call copies.

Each source holds two kernels: a tensor-core one (bf16, ``mma.sync`` fed
by ``ldmatrix``) and the CUDA-core one that f32 keeps as its exact parity
path. :func:`_tensor_core_path` picks one per call from shape, dtype and
alignment alone, before the launch; nothing falls back.

``launches``, ``dq_launches`` and ``dkv_launches`` count kernel launches
(plain calls never count); ``tc_launches``, ``dq_tc_launches`` and
``dkv_tc_launches`` count the launches that took the tensor-core kernels.
"""

from __future__ import annotations

import torch

from distributed_compute_pytorch_tpu_torch.ops import _build
from distributed_compute_pytorch_tpu_torch.ops.attention import (
    NEG_FILL, attention_logits, dot_product_attention)

NAME = "flash_fwd"
REPLACES = "distributed_compute_pytorch_tpu/ops/pallas/flash_attention.py:78"
DQ_NAME = "flash_bwd_dq"
DQ_REPLACES = ("distributed_compute_pytorch_tpu/ops/pallas/"
               "flash_attention.py:201")
DKV_NAME = "flash_bwd_dkv"
DKV_REPLACES = ("distributed_compute_pytorch_tpu/ops/pallas/"
                "flash_attention.py:245")
launches = 0
tc_launches = 0
dq_launches = 0
dkv_launches = 0
dq_tc_launches = 0
dkv_tc_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bool_mask(kv_mask):
    return None if kv_mask is None else (kv_mask != 0)[:, None, None, :]


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          scale: float | None = None, kv_mask=None):
    """The forward kernel's plain PyTorch version: dense attention with the
    same masks (``kv_mask [b, tk]``, nonzero = attend)."""
    return dot_product_attention(q, k, v, causal=causal,
                                 mask=_bool_mask(kv_mask), scale=scale)


def flash_fwd_plain(q, k, v, *, causal: bool = False,
                    scale: float | None = None, kv_mask=None):
    """:func:`flash_attention_plain` and the f32 logsumexp of its masked
    logits ``[b, h, t]``, the residual the backward needs: what
    :func:`flash_fwd` returns, computed densely."""
    logits = attention_logits(q, k, causal=causal, mask=_bool_mask(kv_mask),
                              scale=scale)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights, v), torch.logsumexp(logits, dim=-1)


def flash_bwd_plain(q, k, v, do, lse, delta, *, causal: bool = False,
                    scale: float | None = None, kv_mask=None):
    """The two backward kernels' plain PyTorch version, densely and in
    f32 (reference ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``): recompute
    ``p = exp(s - lse)`` with the forward's masks (keys past the
    bottom-right causal limit take no weight; ``kv_mask`` zeros score
    ``-1e30``), then ``dv = p^T dO``, ``ds = p (dO v^T - delta)``,
    ``dq = scale ds k`` and ``dk = scale ds^T q``. ``lse``, ``delta``: f32
    ``[b, h, t]`` (``delta = rowsum(dO * O)``). Returns ``(dq, dk, dv)`` in
    the inputs' dtype."""
    t, d = q.shape[-2:]
    tk = k.shape[-2]
    scale = d ** -0.5 if scale is None else float(scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if kv_mask is not None:
        s = s.masked_fill(~_bool_mask(kv_mask), NEG_FILL)
    p = torch.exp(s - lse[..., None])
    if causal:
        row = torch.arange(t, device=q.device)[:, None]
        col = torch.arange(tk, device=q.device)[None, :]
        p = p.masked_fill(row < col - (tk - t), 0.0)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, causal):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention takes [b, h, t, d] tensors")
    b, h, t, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != (b, h, tk, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if causal and t > tk:
        raise ValueError(
            f"causal flash attention needs q_len <= kv_len (got {t} > "
            f"{tk}): bottom-right alignment would leave the first "
            f"{t - tk} query rows attending nothing")


def _check_cuda(name, tensors, kv_mask, b, tk):
    """What every kernel of this module takes: CUDA tensors on one
    device, f32 or bf16 all alike, head dim <= 128 with unit stride, a
    grid of at most 65535 (batch*head) rows, an optional ``[b, tk]`` mask.
    Returns the mask as contiguous f32 (or None)."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"{[str(x.device) for x in tensors]}")
    dtype = tensors[0].dtype
    if dtype not in _DTYPES or any(x.dtype != dtype for x in tensors):
        raise ValueError(f"{name} takes f32 or bf16 (all alike), got "
                         f"{[x.dtype for x in tensors]}")
    d = tensors[0].shape[-1]
    if d > 128 or any(x.stride(-1) != 1 for x in tensors):
        raise ValueError(f"{name} needs head_dim <= 128 with unit stride")
    bh = tensors[0].shape[0] * tensors[0].shape[1]
    if bh > 65535:
        raise ValueError(f"{name} grid limit: b*h = {bh} > 65535")
    if kv_mask is None:
        return None
    if tuple(kv_mask.shape) != (b, tk) or kv_mask.device != dev:
        raise ValueError(f"kv_mask must be [b, tk] = {(b, tk)} on {dev}")
    return kv_mask.to(torch.float32).contiguous()


def _check_rows(name, lse, delta, b, h, t, dev):
    for nm, x in (("lse", lse), ("delta", delta)):
        if (tuple(x.shape) != (b, h, t) or x.dtype != torch.float32
                or x.device != dev or not x.is_contiguous()):
            raise ValueError(f"{name}: {nm} must be contiguous f32 "
                             f"[b, h, t] = {(b, h, t)} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _tensor_core_path(dtype, d: int, ptrs, strides) -> bool:
    """Whether a call takes the tensor-core kernel: bf16, head dim
    ``d % 8 == 0`` (at most 128), every base address in ``ptrs`` (bytes)
    16-byte aligned and every b/h/t stride in ``strides`` (elements) a
    multiple of 8 bf16 elements, so every row of every tile arrives in
    whole 16-byte copies. Every bf16 call on the port's paths meets it
    (GPT-2's head dims, the fused-QKV split-head views, the
    ``_like_bthd`` outputs). f32 and any other bf16 call take the CUDA-core
    kernel. A rule, decided before the launch, not a fallback."""
    return (dtype == torch.bfloat16 and d % 8 == 0 and d <= 128
            and all(p % 16 == 0 for p in ptrs)
            and all(s % 8 == 0 for s in strides))


def _like_bthd(x):
    """An uninitialised ``[b, h, t, d]`` tensor laid out ``[b, t, h, d]``
    in memory: ``merge_heads`` of it is a view, and its gradient arrives
    in the same order."""
    b, h, t, d = x.shape
    return torch.empty(b, t, h, d, dtype=x.dtype,
                       device=x.device).transpose(1, 2)


def flash_fwd(q, k, v, *, causal: bool = False, scale: float | None = None,
              kv_mask=None):
    """Launch the forward kernel: returns ``(o [b, h, t, d], lse f32 [b,
    h, t])``. Raises on anything the kernel does not take: non-CUDA or
    mixed devices, dtypes other than f32/bf16 or mixed, a head dim above
    128 or without unit stride, causal ``t > tk``. A call that meets
    :func:`_tensor_core_path` takes the tensor-core kernel (counted in
    ``tc_launches``), any other the CUDA-core one."""
    global launches, tc_launches
    _check(q, k, v, causal)
    b, h, t, d = q.shape
    tk = k.shape[2]
    mask = _check_cuda(NAME, (q, k, v), kv_mask, b, tk)
    scale = d ** -0.5 if scale is None else float(scale)
    dev = q.device
    o = _like_bthd(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=dev)
    lib, fn = _build.bind(NAME, "ppppppiiiiiisfiip")
    tensors = (q, k, v, o)
    strides = [s for x in tensors for s in x.stride()[:3]]
    tc = _tensor_core_path(q.dtype, d, [x.data_ptr() for x in tensors],
                           strides)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), None if mask is None else mask.data_ptr(),
            _DTYPES[q.dtype], b, h, t, tk, d, _build.strides_arg(*strides),
            scale, int(causal), int(tc), _build.stream_ptr(dev))
    _build.check(lib, NAME, rc)
    launches += 1
    tc_launches += tc
    return o, lse


def _bwd_prepare(name, q, k, v, do, lse, delta, causal, kv_mask):
    if do.shape != q.shape:
        raise ValueError(f"{name}: dO shape {tuple(do.shape)} != q "
                         f"{tuple(q.shape)}")
    b, h, t, d = q.shape
    mask = _check_cuda(name, (q, k, v, do), kv_mask, b, k.shape[2])
    _check_rows(name, lse, delta, b, h, t, q.device)
    return mask


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                 scale: float | None = None, kv_mask=None):
    """``dq`` of :func:`flash_bwd_plain`: launches ``flash_bwd_dq`` on CUDA
    tensors (raising on what it does not take, as :func:`flash_fwd`
    does; ``lse``/``delta`` contiguous f32 ``[b, h, t]``), the plain
    version on CPU tensors. ``dq`` comes back in q's dtype, laid out
    ``[b, t, h, d]`` in memory."""
    global dq_launches, dq_tc_launches
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, causal=causal,
                               scale=scale, kv_mask=kv_mask)[0]
    mask = _bwd_prepare(DQ_NAME, q, k, v, do, lse, delta, causal, kv_mask)
    b, h, t, d = q.shape
    tk = k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    dq = _like_bthd(q)
    lib, fn = _build.bind(DQ_NAME, "pppppppp" "iiiiiisfiip")
    tensors = (q, k, v, do, dq)
    strides = [s for x in tensors for s in x.stride()[:3]]
    tc = _tensor_core_path(q.dtype, d, [x.data_ptr() for x in tensors],
                           strides)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if mask is None else mask.data_ptr(), dq.data_ptr(),
            _DTYPES[q.dtype], b, h, t, tk, d, _build.strides_arg(*strides),
            scale, int(causal), int(tc), _build.stream_ptr(q.device))
    _build.check(lib, DQ_NAME, rc)
    dq_launches += 1
    dq_tc_launches += tc
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                  scale: float | None = None, kv_mask=None):
    """``(dk, dv)`` of :func:`flash_bwd_plain`: launches ``flash_bwd_dkv``
    on CUDA tensors (raising on what it does not take), the plain version
    on CPU tensors. Both come back in k's dtype, laid out ``[b, tk, h,
    d]`` in memory."""
    global dkv_launches, dkv_tc_launches
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, causal=causal,
                               scale=scale, kv_mask=kv_mask)[1:]
    mask = _bwd_prepare(DKV_NAME, q, k, v, do, lse, delta, causal, kv_mask)
    b, h, t, d = q.shape
    tk = k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    dk, dv = _like_bthd(k), _like_bthd(v)
    lib, fn = _build.bind(DKV_NAME, "ppppppppp" "iiiiiisfiip")
    tensors = (q, k, v, do, dk, dv)
    strides = [s for x in tensors for s in x.stride()[:3]]
    tc = _tensor_core_path(q.dtype, d, [x.data_ptr() for x in tensors],
                           strides)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if mask is None else mask.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _DTYPES[q.dtype], b, h, t, tk, d,
            _build.strides_arg(*strides), scale, int(causal), int(tc),
            _build.stream_ptr(q.device))
    _build.check(lib, DKV_NAME, rc)
    dkv_launches += 1
    dkv_tc_launches += tc
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``_flash`` /
    ``_flash_masked`` custom VJPs). Forward: :func:`flash_fwd` on CUDA,
    :func:`flash_fwd_plain` on the CPU, saving ``q, k, v, o, lse`` and the
    mask. Backward: ``delta = rowsum(dO * O)`` in f32 outside the kernels,
    as the reference computes it (two f32 temporaries of dO's size), then
    :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` on CUDA, or one
    :func:`flash_bwd_plain` on the CPU. ``kv_mask`` is data: no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        fwd = flash_fwd_plain if q.device.type == "cpu" else flash_fwd
        o, lse = fwd(q, k, v, causal=causal, scale=scale, kv_mask=kv_mask)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_mask = ctx.saved_tensors
        kw = {"causal": ctx.causal, "scale": ctx.scale, "kv_mask": kv_mask}
        if do.stride(-1) != 1:
            # not on the model's path: merge_heads' backward hands dO over
            # with a unit head-dim stride; any other caller pays one copy
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        if q.device.type == "cpu":
            dq, dk, dv = flash_bwd_plain(q, k, v, do, lse, delta, **kw)
        else:
            dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, kv_mask=None):
    """``softmax(q k^T * scale + mask) v`` over ``[b, h, t, d]``,
    differentiable in q, k and v; causal is bottom-right aligned (query
    row i attends keys ``<= i + tk - t``). CUDA tensors launch the kernels,
    CPU tensors run the plain versions (:class:`FlashAttention`)."""
    _check(q, k, v, causal)
    return FlashAttention.apply(q, k, v, kv_mask, causal, scale)
