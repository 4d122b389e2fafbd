"""Flash attention forward — the port of
``distributed_compute_pytorch_tpu/ops/pallas/flash_attention.py`` (its
forward kernel ``_fwd_kernel``) as the hand-written CUDA kernel
``csrc/flash_fwd.cu``.

:func:`flash_attention` is the entry the attention dispatcher calls: a
CUDA tensor launches the kernel (or raises), a CPU tensor runs
:func:`flash_attention_plain`, the dense reference math. The kernel takes
the split-head views of the fused QKV projection as they are (any
strides with a unit head-dim stride) and writes its output in the
``[b, t, h, d]`` memory order, so neither side of the call copies.

``launches`` counts kernel launches (plain calls never count).
"""

from __future__ import annotations

import torch

from distributed_compute_pytorch_tpu_torch.ops import _build
from distributed_compute_pytorch_tpu_torch.ops.attention import (
    dot_product_attention)

NAME = "flash_fwd"
REPLACES = "distributed_compute_pytorch_tpu/ops/pallas/flash_attention.py:78"
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          scale: float | None = None, kv_mask=None):
    """The kernel's plain PyTorch version: dense attention with the same
    masks (``kv_mask [b, tk]``, nonzero = attend)."""
    mask = None if kv_mask is None else (kv_mask != 0)[:, None, None, :]
    return dot_product_attention(q, k, v, causal=causal, mask=mask,
                                 scale=scale)


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


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, kv_mask=None):
    """``softmax(q k^T * scale + mask) v`` over ``[b, h, t, d]``; causal is
    bottom-right aligned (query row i attends keys ``<= i + tk - t``).
    CUDA tensors launch ``flash_fwd``; CPU tensors run the plain
    version."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_mask=kv_mask)
    return flash_fwd(q, k, v, causal=causal, scale=scale,
                     kv_mask=kv_mask)[0]


def flash_fwd(q, k, v, *, causal: bool = False, scale: float | None = None,
              kv_mask=None):
    """Launch the CUDA kernel: returns ``(o [b, h, t, d], lse f32 [b, h,
    t])``. Raises on anything the kernel does not take: non-CUDA or mixed
    devices, dtypes other than f32/bf16 or mixed, a head dim above 128 or
    without unit stride, causal ``t > tk``."""
    global launches
    _check(q, k, v, causal)
    b, h, t, d = q.shape
    tk = k.shape[2]
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_fwd needs CUDA tensors on one device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_fwd takes f32 or bf16 (all alike), got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d > 128 or any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_fwd needs head_dim <= 128 with unit stride")
    if b * h > 65535:
        raise ValueError(f"flash_fwd grid limit: b*h = {b * h} > 65535")
    mask = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, tk) or kv_mask.device != dev:
            raise ValueError(f"kv_mask must be [b, tk] = {(b, tk)} on {dev}")
        mask = kv_mask.to(torch.float32).contiguous()
    scale = d ** -0.5 if scale is None else float(scale)
    o = torch.empty(b, t, h, d, dtype=q.dtype, device=dev).transpose(1, 2)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=dev)
    lib, fn = _build.bind(NAME, "ppppppiiiiiisfip")
    strides = _build.strides_arg(*q.stride()[:3], *k.stride()[:3],
                                 *v.stride()[:3], *o.stride()[:3])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), None if mask is None else mask.data_ptr(),
            _DTYPES[q.dtype], b, h, t, tk, d, strides, scale, int(causal),
            _build.stream_ptr(dev))
    _build.check(lib, NAME, rc)
    launches += 1
    return o, lse
