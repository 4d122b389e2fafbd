"""Deterministic epoch-keyed sampling — a copy of
``distributed_compute_pytorch_tpu/data/sampler.py`` (jax-free; the port
imports nothing of the JAX package), so the port and the reference draw
identical batch orders from one seed.

The semantics are those of ``torch.utils.data.DistributedSampler``: a
seeded global permutation, padded by wraparound to full batches; the
permutation is keyed by ``(seed, epoch)``. Every rank walks the same
global order and takes its rows of each batch (``data/loader.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ShardedSampler:
    """Global batch order for one dataset.

    Yields, per epoch, an ``[num_batches, global_batch]`` int array of example
    indices: shuffled (epoch-keyed), padded by wraparound so that the last
    batch is full (``DistributedSampler`` padding semantics + full final
    batch, which static XLA shapes require).
    """

    num_examples: int
    global_batch: int
    shuffle: bool = True
    seed: int = 0
    drop_last: bool = False

    @property
    def num_batches(self) -> int:
        if self.drop_last:
            return self.num_examples // self.global_batch
        return -(-self.num_examples // self.global_batch)  # ceil

    @property
    def padded_size(self) -> int:
        return self.num_batches * self.global_batch

    @property
    def pad_count(self) -> int:
        """Wraparound-duplicated rows in the last batch (0 when drop_last)."""
        return 0 if self.drop_last else self.padded_size - self.num_examples

    def epoch_order(self, epoch: int) -> np.ndarray:
        """Padded global order for ``epoch`` as ``[num_batches, global_batch]``.

        Deterministic: same ``(seed, epoch)`` -> same order on every process,
        which is what makes the multi-host feed consistent without any
        communication (the reference gets the same property from every rank
        constructing the same seeded sampler, ``main.py:103,109``).
        """
        if self.shuffle:
            # 2-word key so (seed, epoch) pairs never collide — seed+epoch
            # would make (0,1) and (1,0) replay the same permutation
            rng = np.random.Generator(np.random.Philox(key=[self.seed, epoch]))
            order = rng.permutation(self.num_examples)
        else:
            order = np.arange(self.num_examples)
        if self.drop_last:
            order = order[: self.padded_size]
        else:
            pad = self.padded_size - self.num_examples
            if pad:
                # wraparound padding — same rule as DistributedSampler's
                # `indices += indices[:padding_size]`, except cycling the
                # order as many times as needed: a dataset SMALLER than one
                # global batch (pad > num_examples, e.g. a tiny text-corpus
                # eval split) must still fill the batch
                reps = -(-pad // len(order))
                order = np.concatenate([order, np.tile(order, reps)[:pad]])
        return order.reshape(self.num_batches, self.global_batch)
