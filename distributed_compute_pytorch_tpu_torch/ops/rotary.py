"""Rotary position embeddings (RoPE) — port of
``distributed_compute_pytorch_tpu/ops/rotary.py``, the Llama family's
positional encoding.

The open Llama convention, as the reference: half-split ``rotate_half``
(not interleaved pairs), inverse frequencies ``theta ** (-i / (d/2))`` in
f32, the rotation in f32 and cast back to the input's dtype.

Positions are integer tensors on the input's device, ``[T]`` (shared by
every row) or ``[B, T]`` (per row). Nothing here reads a position on the
host, so a captured decode tick or serving segment ropes at whatever its
position buffers hold when it replays.
"""

from __future__ import annotations

import torch


def rope_cos_sin(positions, head_dim: int, theta: float = 10000.0):
    """``cos, sin`` tables ``[..., head_dim]`` for integer ``positions``
    ``[T]`` or ``[B, T]`` (reference ``:25-41``): frequencies ``theta **
    (-i / half)`` for the first ``half = head_dim // 2`` features, each
    table its ``half`` duplicated, so the rotation is an elementwise
    product against the half-split layout."""
    half = head_dim // 2
    exps = -torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    inv_freq = torch.pow(theta, exps)
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def rotate_half(x):
    """``[x1, x2] -> [-x2, x1]`` over the last axis."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rotate(x, cos, sin):
    """Rotate ``x [B, H, T, hd]`` by the tables of :func:`rope_cos_sin`
    (``[T, hd]`` or ``[B, T, hd]``, broadcast over the heads); f32 inside,
    returned in ``x``'s dtype. A block ropes q and k with one pair of
    tables."""
    if cos.ndim == 3:              # [B, T, hd] -> broadcast over heads
        cos, sin = cos[:, None], sin[:, None]
    x32 = x.to(torch.float32)
    return (x32 * cos + rotate_half(x32) * sin).to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotate ``x [B, H, T, hd]`` by integer ``positions`` ``[T]`` (shared)
    or ``[B, T]`` (per row) (reference ``:49-61``)."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))
