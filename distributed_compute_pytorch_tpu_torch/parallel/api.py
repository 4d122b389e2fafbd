"""Partition strategies — the port of
``distributed_compute_pytorch_tpu/parallel/api.py``: where the parameters
and the optimizer state live over the mesh (``core/mesh.py``).

- :class:`DataParallel` (reference ``:47-53``): every rank holds every
  parameter; the batch is sharded over the batch axes and the gradients
  summed over them. Its update is replicated (one all-reduce of the flat
  gradient) or, by default at a data-parallel size above 1, sharded
  ZeRO-1 style (``parallel/collectives.py``, ``train/step.py``).
- :class:`FSDP` (reference ``:56-88``): the f32 master parameters and the
  optimizer state live sharded over the ``fsdp`` axis, O(params / fsdp)
  a card. The reference shards each leaf on its largest divisible
  dimension and lets XLA gather per layer; the port shards flat, one unit
  at a time (:func:`fsdp_units`): each unit's masters are one flat f32
  buffer, padded and split evenly over the ``fsdp`` group, and the step
  gathers a unit in the compute dtype for the forward and reduce-scatters
  its gradient in the backward (``train/step.py::_GatherUnit``).

``ShardingRules`` (the tensor-parallel layouts) waits for the ``tensor``
axis, which ``core/mesh.py::make_mesh`` refuses.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn


@dataclass(frozen=True)
class DataParallel:
    """Replicated parameters (reference parity strategy)."""


@dataclass(frozen=True)
class FSDP:
    """Parameters and optimizer state sharded over ``axis``."""

    axis: str = "fsdp"


def pick_strategy(mesh):
    """The strategy ``--mesh`` implies (reference ``:120-143``): FSDP where
    the ``fsdp`` axis is above 1, else DataParallel. (The model axes that
    would pick ``ShardingRules`` are refused by the mesh.)"""
    return FSDP() if mesh.size("fsdp") > 1 else DataParallel()


def fsdp_units(model: nn.Module) -> list[tuple[str, list[str]]]:
    """The model's FSDP units, ``[(unit, [parameter names])]`` in
    ``named_parameters`` order within each: every block of a
    ``blocks`` ``ModuleList`` is a unit, and the other parameters one
    more, first. GPT-2's and BERT's twelve blocks (the rest: the
    embeddings and the final or the MLM head's LayerNorms and dense
    layer); Llama's twelve blocks (the rest: the token embedding, the
    final RMSNorm and the untied ``lm_head``); a ResNet's residual
    blocks, 8 for ResNet-18 and 16 for
    ResNet-50 (the rest: the stem, its BatchNorm and the head; the
    BatchNorm running stats are buffers, never sharded). A model without
    blocks (the ConvNet) is one unit."""
    names = [n for n, _ in model.named_parameters()]
    blocks = getattr(model, "blocks", None)
    if not isinstance(blocks, nn.ModuleList):
        return [("model", names)]
    units = [("rest", [n for n in names if not n.startswith("blocks.")])]
    for i in range(len(blocks)):
        units.append((f"blocks.{i}",
                      [n for n in names if n.startswith(f"blocks.{i}.")]))
    return units
