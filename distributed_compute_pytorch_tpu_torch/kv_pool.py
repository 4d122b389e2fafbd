"""Host-side bookkeeping for the paged KV cache — the port's own copy of
``distributed_compute_pytorch_tpu/kv_pool.py`` (``PoolExhausted``,
``BlockPool`` and the radix prefix cache ``RadixCache``; the port imports
nothing of the JAX package).

The serving cache (``serve.ContinuousBatcher``) is a pool of fixed-size
K/V blocks — ``[2, num_blocks, hk, block_tokens, hd]`` per layer — and
each request maps its LOGICAL slot range onto physical blocks through a
per-row block table. Everything the device touches stays static-shaped;
the allocation problem lives here, on the host, between dispatches:

- :class:`BlockPool` — refcounted allocation over the physical blocks.
  Block 0 is the TRASH block: parked rows keep writing garbage K/V every
  segment, so their tables point at trash, where the garbage can never
  corrupt a live or cached block. A block attached by k rows plus the
  radix tree frees only when the last reference drops, and
  :meth:`BlockPool.leak_check` (against the tree's references) is the
  block-level extension of the scheduler's slot-leak discipline.
- :class:`RadixCache` — a path-compressed radix tree over prompt-HEAD
  token sequences (the last prompt token is the row's first decode input,
  never prefilled, so never cached). A new request's longest cached
  prefix resolves to block ids it ATTACHES to instead of re-running
  prefill: full blocks shared read-only (refcount++), a prefix ending
  mid-block attached copy-on-write (the partial block is copied on the
  device and the copy's tail overwritten by the attacher's own suffix).
  Eviction is LRU over tree entries and frees only blocks whose refcount
  drops to zero.

Sharing is exact: admission lays every prompt out from logical slot 0,
so two requests sharing a token prefix write bit-identical K/V for the
shared span (same weights, tokens and positions), and a row only appends
at slots at or past its own head, which a later match never reads (a
match is capped by the entry's recorded token count).

The tier states (``TIER_*``) mark where an entry's bytes are: on the
device, or demoted by ``kv_tier.py``'s host and disk tiers (which set
them) when a batcher has a host tier.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# tier states of radix entries: DEVICE entries hold pool block refs;
# HOST/DISK entries (the reference's spill tiers) keep their place in the
# tree with their bytes elsewhere and no pool refs
TIER_DEVICE = "device"
TIER_HOST = "host"
TIER_DISK = "disk"


class PoolExhausted(RuntimeError):
    """No free block satisfies an allocation — with the serve layer's
    sizing (``pool_blocks >= slots * blocks_per_row + 1``) this means a
    refcount leak, not genuine pressure, so it is raised loudly."""


class BlockPool:
    """Refcounted allocator over ``num_blocks`` physical cache blocks.

    Block ``TRASH`` (0) is reserved at construction with a permanent
    reference: parked rows write into it every segment, so it can never
    be handed out. ``high_water`` tracks peak occupancy (the
    ``block_pool_occupancy`` stat)."""

    TRASH = 0

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the reserved "
                             f"trash block), got {num_blocks}")
        self.num_blocks = num_blocks
        self.reset()
        self.high_water = 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated(self) -> int:
        return self.num_blocks - len(self._free)

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
        self.high_water = max(self.high_water, self.allocated)
        return out

    def acquire(self, block: int) -> None:
        """Add a reference to an already-live block (prefix attach, tree
        insertion)."""
        if self.ref[block] <= 0:
            raise RuntimeError(f"acquire of dead block {block} (refcount "
                               f"{self.ref[block]})")
        self.ref[block] += 1

    def shared(self, block: int) -> bool:
        """True when ``block`` has more than one live reference: some
        other owner (a radix entry, an attached row) also reads it."""
        return self.ref[block] > 1

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

    def reset(self) -> None:
        """Free everything: every block but the pinned trash block back
        on the free list."""
        self.ref = [0] * self.num_blocks
        self.ref[self.TRASH] = 1          # pinned forever
        # LIFO free list: recently-freed blocks are re-used first, which
        # keeps the working set small and makes leak repros deterministic
        self._free = list(range(self.num_blocks - 1, 0, -1))

    def leak_check(self, expected: dict[int, int] | None = None) -> int:
        """Blocks whose refcount differs from ``expected`` (block ->
        count: the radix tree's held references, none by default; 1 on
        the trash block) once every row has released its blocks. 0 means
        every reference is accounted for."""
        expected = expected or {}
        return sum(self.ref[b] != (1 if b == self.TRASH
                                   else expected.get(b, 0))
                   for b in range(self.num_blocks))


@dataclass
class _Node:
    """One radix-tree node: ``key`` is the token run on the edge from
    its parent; an ``entry`` marks a full inserted head sequence ending
    here (its block list covers the whole root->here path)."""

    key: tuple = ()
    children: dict = field(default_factory=dict)
    entry: "_Entry | None" = None


@dataclass
class _Entry:
    blocks: list          # block ids covering ceil(n_tokens / bt)
    n_tokens: int         # valid prefix length the blocks hold
    last_used: int = 0
    # tier state (the reference's kv_tier.py): DEVICE entries own one
    # pool ref per block; demoted entries keep their tree position but
    # ``blocks`` is empty and the bytes live host-side (``host_blocks``
    # into the HostBlockPool) or on disk (``disk_key``)
    tier: str = TIER_DEVICE
    host_blocks: list = field(default_factory=list)
    disk_key: "str | None" = None
    tokens: tuple = ()    # the head sequence (demotion/debug bookkeeping)
    # weights-version stamp: the version of the model
    # weights that computed these K/V bytes. Lookups refuse entries
    # from any other version — a rolling weight upgrade clears the
    # cache wholesale, and this stamp is the per-entry proof that a
    # stale prefix can never attach to new weights even if one slipped
    # through (adoption, import, a future partial-invalidation path)
    weights_version: int = 0


class RadixCache:
    """Longest-prefix lookup from prompt-head tokens to prefilled block
    ids, with LRU eviction.

    ``match`` returns ``(m, blocks)``: the longest cached prefix length
    and the blocks covering it (``ceil(m / block_tokens)`` ids; the last
    one is PARTIAL when ``m % block_tokens != 0`` and must be attached
    copy-on-write). ``insert`` records a freshly prefilled head and
    acquires one pool reference per block, so cached blocks survive
    their producing request. ``evict_for`` drops least-recently-used
    entries until the pool can satisfy an allocation — only blocks whose
    refcount reaches zero are actually freed, so entries sharing blocks
    with live rows cost nothing to evict but also free nothing."""

    def __init__(self, pool: BlockPool, block_tokens: int):
        self.pool = pool
        self.bt = block_tokens
        self.root = _Node()
        self._clock = 0
        self.entries: list[_Entry] = []
        # tier hook (the reference's kv_tier.KVTierManager): called
        # with a demoted
        # entry whose spill-tier copy must be dropped — a fresh insert
        # revived it with resident blocks, or eviction discarded it
        self.on_tier_drop = None
        # current weights-version stamp: inserts stamp their entries
        # with it, lookups refuse entries stamped otherwise (serve's
        # reload_weights bumps it after clearing the tree)
        self.weights_version = 0

    # ---- stats / accounting ------------------------------------------------

    def held(self) -> dict[int, int]:
        """block id -> number of tree references (for leak accounting)."""
        out: dict[int, int] = {}
        for e in self.entries:
            for b in e.blocks:
                out[b] = out.get(b, 0) + 1
        return out

    def clear(self) -> None:
        """Drop every entry (device-failure reconstruction: the pool
        content is untrusted, so the cache over it is too). Demoted
        entries drop their spill-tier copies through ``on_tier_drop``
        — a fault zeroes ALL tiers (the tier manager's own ``reset``
        is the belt to this suspender)."""
        for e in self.entries:
            if e.tier == TIER_DEVICE:
                self.pool.release(e.blocks)
            elif self.on_tier_drop is not None:
                self.on_tier_drop(e)
        self.entries = []
        self.root = _Node()

    # ---- lookup ------------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _walk(self, tokens: tuple) -> tuple["_Node", int]:
        """Descend from the root along ``tokens``; returns the deepest
        node reached and the matched prefix length. Pure traversal — no
        LRU stamps, no refcounts — shared by :meth:`match` and
        :meth:`longest_match_len`."""
        node, matched = self.root, 0
        while matched < len(tokens):
            child = node.children.get(tokens[matched])
            if child is None:
                break
            key = child.key
            common = 0
            limit = min(len(key), len(tokens) - matched)
            while common < limit and key[common] == tokens[matched + common]:
                common += 1
            matched += common
            if common < len(key):
                node = child          # ended mid-edge: subtree extends us
                break
            node = child
        return node, matched

    def match(self, tokens) -> tuple[int, list[int]]:
        """Longest cached prefix of ``tokens``: ``(m, blocks)`` with
        ``blocks`` covering ``ceil(m / bt)``; ``(0, [])`` on a miss.
        Refcounts are NOT acquired here — the caller attaches explicitly
        (it may cap ``m`` further, e.g. to its own head length).
        DEVICE-resident entries only: a demoted prefix is a miss here —
        tier-aware callers use :meth:`match_entry`, which can hand back
        an entry whose bytes need promoting first."""
        node, matched = self._walk(tuple(tokens))
        entry = self._any_entry(node, device_only=True)
        if entry is None or matched == 0:
            return 0, []
        m = min(matched, entry.n_tokens)
        if m == 0:
            return 0, []
        entry.last_used = self._tick()
        return m, entry.blocks[:-(-m // self.bt)]

    def match_entry(self, tokens) -> tuple[int, "_Entry | None"]:
        """Tier-aware longest-prefix lookup: ``(m, entry)`` where the
        entry may be DEVICE-resident (attach its ``blocks`` directly)
        or demoted to HOST/DISK (the caller promotes it before
        attaching, ``kv_tier.py``). Device entries
        win over demoted ones covering the same prefix (promotion is
        never paid when resident bytes exist). Stamps LRU like
        :meth:`match`; acquires nothing."""
        node, matched = self._walk(tuple(tokens))
        entry = self._any_entry(node)
        if entry is None or matched == 0:
            return 0, None
        m = min(matched, entry.n_tokens)
        if m == 0:
            return 0, None
        entry.last_used = self._tick()
        return m, entry

    def longest_match_len(self, tokens) -> int:
        """Affinity PROBE: the length :meth:`match_entry` would return,
        with ZERO side effects — no LRU touch, no refcount change,
        nothing promoted or evicted. The replica router calls this on
        every candidate replica per request (``serve_router``), so a
        probe that mutated LRU order would let routing decisions evict
        state the loser replicas still want; a probe must observe,
        never vote. ANY tier counts: a host/disk-demoted prefix is
        still warm for routing purposes — promotion (one H2D copy) is
        far cheaper than re-prefilling it elsewhere. The returned
        length is a HINT: by admission time the entry may have been
        evicted, and admission re-``match``es authoritatively."""
        node, matched = self._walk(tuple(tokens))
        entry = self._any_entry(node)
        if entry is None or matched == 0:
            return 0
        return min(matched, entry.n_tokens)

    def _any_entry(self, node: _Node,
                   device_only: bool = False) -> "_Entry | None":
        """An entry in ``node``'s subtree — every path through ``node``
        shares the matched prefix, so any of them can supply its
        blocks. DEVICE-resident entries are preferred (attaching them
        is free; a demoted one costs a promotion copy);
        ``device_only`` drops demoted entries entirely (the tier-off
        :meth:`match` contract)."""
        stack, demoted = [node], None
        while stack:
            n = stack.pop()
            if (n.entry is not None
                    and n.entry.weights_version == self.weights_version):
                if n.entry.tier == TIER_DEVICE:
                    return n.entry
                if demoted is None:
                    demoted = n.entry
            stack.extend(n.children.values())
        return None if device_only else demoted

    # ---- insertion ---------------------------------------------------------

    def _insert_node(self, tokens: tuple) -> _Node:
        """Descend (splitting edges as needed) to the node that exactly
        terminates ``tokens``, creating it if absent — the write-side
        half of :meth:`insert`, shared with :meth:`insert_demoted`."""
        node, i = self.root, 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                new = _Node(key=tokens[i:])
                node.children[tokens[i]] = new
                node = new
                i = len(tokens)
                break
            key = child.key
            common = 0
            limit = min(len(key), len(tokens) - i)
            while common < limit and key[common] == tokens[i + common]:
                common += 1
            if common < len(key):
                # split the edge at the divergence (or early-end) point
                mid = _Node(key=key[:common])
                child.key = key[common:]
                mid.children[child.key[0]] = child
                node.children[tokens[i]] = mid
                node = mid
                i += common
                continue
            node = child
            i += common
        return node

    def insert(self, tokens, blocks: list[int]) -> bool:
        """Record a freshly prefilled head; acquires one pool reference
        per block. Returns False (and acquires nothing) when the exact
        sequence is already cached — the existing entry just refreshes
        its LRU stamp."""
        tokens = tuple(tokens)
        if len(blocks) != -(-len(tokens) // self.bt):
            raise ValueError(f"{len(blocks)} blocks do not cover "
                             f"{len(tokens)} tokens at {self.bt} a block")
        node = self._insert_node(tokens)
        if node.entry is not None:
            if node.entry.tier != TIER_DEVICE:
                # REVIVE: the head was re-prefilled before its demoted
                # copy was promoted (promotion declined under pool
                # pressure, or a disk-CRC miss dropped the bytes). The
                # fresh blocks are authoritative — take them and drop
                # the spill-tier copy
                if self.on_tier_drop is not None:
                    self.on_tier_drop(node.entry)
                node.entry.blocks = list(blocks)
                node.entry.tier = TIER_DEVICE
                node.entry.host_blocks = []
                node.entry.disk_key = None
                node.entry.weights_version = self.weights_version
                node.entry.last_used = self._tick()
                for b in blocks:
                    self.pool.acquire(b)
                return True
            node.entry.last_used = self._tick()
            return False
        node.entry = _Entry(blocks=list(blocks), n_tokens=len(tokens),
                            last_used=self._tick(), tokens=tokens,
                            weights_version=self.weights_version)
        for b in blocks:
            self.pool.acquire(b)
        self.entries.append(node.entry)
        return True

    def insert_demoted(self, tokens) -> "_Entry | None":
        """Register a HOST-tier placeholder for ``tokens`` — zero
        device blocks, zero pool refs; the caller stores the actual
        bytes through the reference's ``kv_tier.KVTierManager.store``
        (which flips the
        bookkeeping exactly as an eviction-path demotion would). The
        cross-pool import seam: a prefix handed over from ANOTHER
        batcher's pool enters this tree as if it had been prefilled
        here and demoted, and the existing promotion path scatters it
        H2D on first match. Returns None when the sequence is already
        cached in ANY tier (the existing entry just refreshes its LRU
        stamp — nothing to store)."""
        tokens = tuple(tokens)
        if not tokens:
            return None
        node = self._insert_node(tokens)
        if node.entry is not None:
            node.entry.last_used = self._tick()
            return None
        node.entry = _Entry(blocks=[], n_tokens=len(tokens),
                            last_used=self._tick(), tier=TIER_HOST,
                            tokens=tokens,
                            weights_version=self.weights_version)
        self.entries.append(node.entry)
        return node.entry

    # ---- eviction ----------------------------------------------------------

    def evict_for(self, need_free: int, on_evict=None) -> int:
        """Drop LRU entries until the pool has ``need_free`` free blocks
        (or no DEVICE-resident entry is left). Returns the number of
        entries evicted. Only refcount-0 blocks actually free — a block
        shared with a live row stays resident.

        ``on_evict(entry, blocks)`` — the tier demotion hook — runs
        BEFORE the victim's references are released, with ``blocks``
        holding only the ids this eviction will actually free (tree
        refcount 1; blocks a live row still shares are NEVER passed —
        their bytes survive on device regardless). The hook may capture
        the entry's K/V (all of ``entry.blocks`` is still valid at call
        time) and return truthy to DEMOTE: the entry then keeps its
        place in the tree with its device refs released and ``blocks``
        emptied — the hook owns setting ``tier``/``host_blocks``.
        Falsy (or no hook) discards the entry, the pre-tier
        behaviour."""
        evicted = 0
        while self.pool.free_count < need_free:
            resident = [e for e in self.entries if e.tier == TIER_DEVICE]
            if not resident:
                break
            victim = min(resident, key=lambda e: e.last_used)
            doomed = [b for b in victim.blocks if self.pool.ref[b] == 1]
            demoted = (on_evict is not None
                       and bool(on_evict(victim, doomed)))
            blocks = victim.blocks
            if demoted:
                victim.blocks = []
            else:
                self.entries.remove(victim)
                self._detach(victim)
                if victim.tier != TIER_DEVICE and self.on_tier_drop:
                    # the hook stored a copy but asked for a discard
                    # anyway — don't strand spill bytes
                    self.on_tier_drop(victim)
            self.pool.release(blocks)
            evicted += 1
        return evicted

    def _detach(self, entry: _Entry) -> None:
        """Unlink ``entry`` from its node (prune childless entry-less
        leaves so dead paths do not accumulate)."""
        self._prune(self.root, entry)

    def _prune(self, node: _Node, entry: _Entry) -> bool:
        """DFS removal; returns True when ``node`` itself became
        removable (no entry, no children)."""
        if node.entry is entry:
            node.entry = None
        for first, child in list(node.children.items()):
            if self._prune(child, entry):
                del node.children[first]
        return (node is not self.root and node.entry is None
                and not node.children)
