"""Host -> device feed — port of
``distributed_compute_pytorch_tpu/data/loader.py``, one device a process.

:class:`DeviceFeeder` keeps the reference's contract: the epoch-keyed
order of :class:`~.sampler.ShardedSampler` (so the port and the JAX feeder
give identical batches for one seed), wraparound padding to full batches,
``skip`` for a mid-epoch resume and the ``valid`` mask that lets eval
weight padded rows out. Under data parallelism (``rank`` of ``world``)
every rank walks the same global order and feeds its contiguous
``global_batch / world`` rows of each global batch, the rows the
reference's batch-sharded array puts on its devices. Each batch is
gathered on the host, placed in pinned memory and copied with
``non_blocking=True``, so the copy overlaps the device's queued work.
Token ids arrive as int64.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from distributed_compute_pytorch_tpu_torch.core import mesh
from distributed_compute_pytorch_tpu_torch.data.datasets import ArrayDataset
from distributed_compute_pytorch_tpu_torch.data.sampler import ShardedSampler


class DeviceFeeder:
    """Iterates epochs of ``(inputs, targets[, valid])`` device batches:
    rank ``rank``'s ``global_batch / world`` rows of each global batch."""

    def __init__(self, dataset: ArrayDataset, global_batch: int, device,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, rank: int = 0, world: int = 1):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is outside a world of {world}")
        self.dataset = dataset
        self.global_batch = global_batch
        self.local_batch = mesh.local_batch_size(global_batch, world)
        self.rows = slice(rank * self.local_batch,
                          (rank + 1) * self.local_batch)
        self.device = torch.device(device)
        self.sampler = ShardedSampler(
            num_examples=len(dataset), global_batch=global_batch,
            shuffle=shuffle, seed=seed, drop_last=drop_last)

    def __len__(self) -> int:
        return self.sampler.num_batches

    @property
    def steps_per_epoch(self) -> int:
        return self.sampler.num_batches

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        if arr.dtype.kind in "iu":
            arr = arr.astype(np.int64)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def epoch(self, epoch: int = 0, skip: int = 0, with_valid: bool = False
              ) -> Iterator[tuple[torch.Tensor, ...]]:
        """Yield this rank's rows of the batches of ``epoch`` from batch
        ``skip`` on; ``with_valid`` appends a float mask of those rows,
        0.0 on the final batch's wraparound-padded rows."""
        order = self.sampler.epoch_order(epoch)
        num_batches = len(order)
        for b in range(skip, num_batches):
            idx = order[b][self.rows]
            out = (self._put(self.dataset.inputs[idx]),
                   self._put(self.dataset.targets[idx]))
            if with_valid:
                valid = np.ones(self.global_batch, np.float32)
                pad = self.sampler.pad_count
                if pad and b == num_batches - 1:
                    valid[-pad:] = 0.0
                out = (*out, self._put(valid[self.rows]))
            yield out
