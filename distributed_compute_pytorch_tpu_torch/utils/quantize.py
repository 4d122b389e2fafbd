"""Per-row symmetric int8 for the KV cache — a copy of ``_q8`` and
``quantize_kv`` from ``distributed_compute_pytorch_tpu/utils/quantize.py``
(the port imports nothing of the JAX package; that module imports jax).

This is the plain version of the quantization the int8 slot-write kernels
(``csrc/kv_insert.cu``, ``csrc/kv_pool_insert.cu``) fuse into their
writes, and the one-time quantization of a prompt's K/V in
``infer.prefill(kv_quant=True)``. The kernels reproduce it bit for bit:
f32 absmax over the row, IEEE division by 127, the 1e-12 floor, IEEE
division by the scale, round half to even, clip to [-127, 127].
``check_scale_plane`` is the int8 cache format's one check (an int8 cache
beside its f32 ``[..., 1]`` scale plane), which the writes and the reads
share.

The int8 weights (``quantize_params_int8``) are not ported yet.
"""

from __future__ import annotations

import torch


def _q8(x, axis: int):
    """The symmetric-int8 core: per-slice abs-max / 127 scale (floored at
    1e-12), round (half to even), clip to [-127, 127]. Returns ``(q int8,
    scale f32)`` with ``axis`` kept at size 1 in ``scale``."""
    x32 = x.float()
    amax = x32.abs().amax(dim=axis, keepdim=True)
    # divide by a tensor, not a Python number: on CUDA PyTorch turns a
    # division by a scalar into a product with its reciprocal, which is not
    # the IEEE quotient the reference (and the kernels) take
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kv(x):
    """``x [..., hd]`` -> ``(q int8 [..., hd], scale f32 [..., 1])``: one
    scale per (batch, head, position) row, the granularity at which the
    scales commute out of the decode read's two contractions
    (``ops/attention.py::cached_attention_q8``)."""
    return _q8(x, -1)


def check_scale_plane(cache, scale, name: str = "scale") -> None:
    """The int8 cache format, checked in one place: an int8 ``cache`` goes
    with its f32 scale plane ``cache.shape[:-1] + (1,)`` (one scale per
    cached row), a float cache with none. Raises ``ValueError``."""
    if cache.dtype != torch.int8:
        if scale is not None:
            raise ValueError(f"{name} goes with an int8 cache, not "
                             f"{cache.dtype}")
        return
    if scale is None:
        raise ValueError(f"an int8 cache needs its scale plane ({name}=)")
    want = tuple(cache.shape[:-1]) + (1,)
    if tuple(scale.shape) != want or scale.dtype != torch.float32:
        raise ValueError(f"{name} must be f32 {want}, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
