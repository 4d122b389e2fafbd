"""Host-side bookkeeping for the paged KV cache — the port's own copy of
``PoolExhausted`` and ``BlockPool`` from
``distributed_compute_pytorch_tpu/kv_pool.py:64-157`` (the port imports
nothing of the JAX package). The radix prefix cache waits for a later
slice.

The serving cache (``serve.ContinuousBatcher``) is a pool of fixed-size
K/V blocks — ``[2, num_blocks, hk, block_tokens, hd]`` per layer — and
each request maps its LOGICAL slot range onto physical blocks through a
per-row block table. :class:`BlockPool` does the refcounted allocation.
Block 0 is the TRASH block: parked rows keep writing garbage K/V every
segment, so their tables point at trash, where the garbage can never
corrupt a live block. :meth:`BlockPool.leak_check` is the block-level
extension of the scheduler's slot-leak discipline.
"""

from __future__ import annotations


class PoolExhausted(RuntimeError):
    """No free block satisfies an allocation — with the serve layer's
    sizing (``pool_blocks >= slots * blocks_per_row + 1``) this means a
    refcount leak, not genuine pressure, so it is raised loudly."""


class BlockPool:
    """Refcounted allocator over ``num_blocks`` physical cache blocks.

    Block ``TRASH`` (0) is reserved at construction with a permanent
    reference: parked rows write into it every segment, so it can never
    be handed out."""

    TRASH = 0

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the reserved "
                             f"trash block), got {num_blocks}")
        self.num_blocks = num_blocks
        self.ref = [0] * num_blocks
        self.ref[self.TRASH] = 1          # pinned forever
        # LIFO free list: recently-freed blocks are re-used first, which
        # keeps the working set small and makes leak repros deterministic
        self._free = list(range(num_blocks - 1, 0, -1))

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` fresh blocks (refcount 1 each)."""
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free of "
                f"{self.num_blocks} (refcount leak or undersized pool)")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            if self.ref[b] != 0:
                raise RuntimeError(f"free block {b} has refcount "
                                   f"{self.ref[b]}")
            self.ref[b] = 1
        return out

    def release(self, blocks) -> None:
        """Drop one reference per block; refcount-0 blocks return to the
        free list."""
        for b in blocks:
            if b == self.TRASH or self.ref[b] <= 0:
                raise RuntimeError(f"release of block {b} with refcount "
                                   f"{self.ref[b]}")
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self._free.append(b)

    def leak_check(self) -> int:
        """Blocks whose refcount is not the idle one (1 on the trash
        block, 0 elsewhere) once every row has released its blocks. 0
        means every reference is accounted for."""
        return sum(self.ref[b] != (1 if b == self.TRASH else 0)
                   for b in range(self.num_blocks))
