"""Weight-update sharding (ZeRO-1) — the port of
``distributed_compute_pytorch_tpu/parallel/collectives.py``: the batch
axes an update shards over, the rule that decides what it shards, and
the two collectives the sharded step issues.

The reference shards each leaf on its largest dimension divisible by the
data-parallel size and keeps leaves under ``MIN_SIZE_TO_SHARD`` (1024
elements: biases, norm scales) and indivisible leaves replicated
(``update_shard_spec``).
The port shards everything flat: the optimizer keeps every parameter,
gradient and slot as a view of one flat f32 buffer per unit
(``train/flat.py``), padded with zeros to a multiple of ``world x
ALIGN`` elements and split into ``world`` equal contiguous shards, so a
rank's update is one reduce-scatter of the flat gradient, one update of
its shard (one ``fused_adamw`` launch) and one all-gather of the shard
back into the flat master buffer. ``ALIGN`` f32 elements are 16 bytes:
every shard starts 16-byte aligned, which the fused kernel's ``float4``
loads need (``ops/fused_adamw.py``). The pads hold zeros and take zero
gradients, so every update leaves them zero.

:func:`reduce_scatter` and :func:`all_gather` are
``torch.distributed``'s flat collectives over the process group of one
mesh axis (``core/mesh.py::Mesh.group``). Neither synchronizes the host,
so both can be captured into a CUDA graph once the group's communicator
exists (the captured step's eager warm-up makes it).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from distributed_compute_pytorch_tpu_torch.core.mesh import BATCH_AXES

# f32 elements a shard boundary is aligned to: 16 bytes
ALIGN = 4

# torch 2.13 renames the two flat collectives (the old names warn); the
# card's torch has only the old ones
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor")
_ALL_GATHER = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")


def dp_axes(mesh) -> tuple[str, ...]:
    """The batch axes of ``mesh`` of size above 1: the axes a gradient is
    summed over and a ZeRO-1 update shards across."""
    return tuple(a for a in BATCH_AXES if mesh.size(a) > 1)


def dp_size(mesh) -> int:
    """The ranks a ZeRO-1 update shards over (1 without a batch axis
    above 1)."""
    return math.prod(mesh.size(a) for a in dp_axes(mesh)) or 1


def padded_size(numel: int, world: int) -> int:
    """``numel`` rounded up to a multiple of ``world x ALIGN``: the size of
    a flat buffer that splits into ``world`` 16-byte-aligned shards."""
    step = world * ALIGN
    return -(-numel // step) * step


def reduce_scatter(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` (``x.numel() / world`` elements) gets this rank's shard of
    ``x`` summed over ``group``."""
    _REDUCE_SCATTER(out, x, group=group)


def all_gather(out: torch.Tensor, shard: torch.Tensor, group) -> None:
    """``out`` gets every rank's ``shard`` in rank order. ``shard`` may be
    this rank's slice of ``out`` (the in-place form, which NCCL and gloo
    both take)."""
    _ALL_GATHER(out, shard, group=group)
