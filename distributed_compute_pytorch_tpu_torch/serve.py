"""Segment-wise continuous batching — the port of
``distributed_compute_pytorch_tpu/serve.py``'s serving core.

A fixed pool of ``slots`` cache rows decodes in segments of ``segment``
ticks while finished rows take the next queued request:

- **Paged block-pool KV cache.** Each layer's cache is a pool of
  fixed-size blocks ``{"kv": [2, pool_blocks, hk, kv_block_tokens, hd]}``
  in the model's float dtype (``kv_dtype="bf16"``), or int8 beside a
  ``"scale"`` leaf ``[2, pool_blocks, hk, kv_block_tokens, 1]`` of f32
  per-row scales (``kv_dtype="int8"``: about half the bytes, so about
  twice the context in the same memory; every write quantizes the float
  K/V as it lands), and each row maps its LOGICAL slots
  ``[0, t_max)`` onto physical blocks through a per-row block table
  (host-side, refcounted: ``kv_pool.BlockPool``). Decode writes resolve
  ``pos -> (table[pos // bt], pos % bt)`` and attention reads through the
  table (``ops/attention.py::cache_write_and_attend``: one launch of the
  fused ``paged_decode_write`` CUDA kernel a layer). The pool is
  updated IN PLACE (the JAX package donates the buffers instead).
  Parked and free rows point at the reserved trash block, where their
  per-tick garbage writes never touch a live or cached block.
- **Radix prefix cache** (``prefix_cache=True``): a host-side radix tree
  over prompt-HEAD tokens (``kv_pool.RadixCache``) maps a new request's
  longest cached prefix to blocks already prefilled. The request
  ATTACHES: full blocks are shared read-only (refcount++), a prefix
  ending mid-block gets a fresh block copied from the donor's
  (copy-on-write, :meth:`ContinuousBatcher._copy_blocks`, issued on the
  stream before the wave's prefill), and only the unshared suffix runs
  prefill. Every prompt is laid out from logical slot 0, so a shared
  token prefix has bit-identical K/V at identical positions, and
  attaching is exact. Heads enter the tree after their prefill is
  dispatched; eviction is LRU over tree entries, freeing refcount-0
  blocks only (:meth:`ContinuousBatcher._alloc`).
- **Batched admission.** Every pending request that has a free row is
  stacked into ONE prefill per admission wave (the ``flash_fwd`` kernel,
  causal with the pad mask). Each prompt's tokens but the last are
  prefilled — its SUFFIX past any cached prefix, attended against the
  prefix's K/V gathered from the pool (``ops/attention.py::
  gather_kv_blocks``; an int8 pool's dequantized with its scales) through
  the blocks' ``kv_prefix`` under the bottom-right causal alignment — and
  their K/V scattered to the row's blocks by ``kv_pool_insert`` (pad
  tokens aim at an out-of-range block id and are dropped). The LAST
  prompt token becomes the row's current token, consumed by its first
  decode tick. A wave whose rows are all fully cached runs no prefill.
- **Chunked prefill** (``prefill_chunk_tokens``): each wave prefills
  about that many suffix tokens at most (rounded up to the block size);
  a longer prompt admits its first chunk, stays parked behind an
  all-trash table while mid-prompt, and extends chunk by chunk between
  decode segments through the same suffix prefill (``chunk_wave``). Its
  head enters the radix tree only once it is complete.
- **Per-row positions.** Every row advances its own write position, so
  ``t_max`` bounds one request (``prompt_buf + ceil(max_new / segment) *
  segment``), not the stream; rows recycle indefinitely.
- **Per-row sampling.** Each request carries its own ``temperature`` (0
  = greedy), ``top_k``, ``top_p`` and ``seed``, held in ``[B]`` device
  buffers the admission fills. A segment with a sampling row draws with
  ``infer.sample_rows``: the reference's per-row truncation, then
  Gumbel-max over noise from a counter-based hash of (request seed,
  logical position, vocab index) computed on the card in integer ops. A
  row's t-th draw depends only on (seed, tokens so far), so sampled
  streams are the same whatever ``slots``, ``segment``, prefix attach or
  chunking, and no generator is involved. Greedy rows take the plain
  ``argmax`` in either program.
- **Overlapped host scheduler.** Segment N+1 is dispatched BEFORE segment
  N's tokens are fetched: each segment's tokens are copied to pinned host
  memory behind a CUDA event right after its launches, and the harvest
  waits on that event alone, so the card runs segment N+1 while the host
  harvests N and admits. No dispatch waits for the card: every
  host-to-device copy (admission arrays, block tables, positions,
  sampling settings, copy-on-write pairs) is staged through pinned memory
  and issued ``non_blocking``, and the harvest's wait
  (``_Fetch.result``) is the loop's one host sync. A freed row's
  in-flight segment may still write through its old table; its writes
  land at or past its head, in blocks it owned (which a later admission
  overwrites, in stream order, before reading) or past the valid span of
  a tree entry, which no match reads.
- **The segment as one CUDA graph** (the reference jits ``_segment_impl``,
  a ``lax.scan`` of ticks, once with its static ``sampling`` flag off and
  once on). A segment reads and writes static device buffers made once
  per batcher: the block tables, each row's last written slot, the
  carried current token and logical position (rewritten in place by each
  segment and by admission), the sampling settings and the segment's
  tokens. On CUDA each of the two programs (greedy, sampled) runs its
  first dispatch eagerly (the capture's warm-up: kernels loaded, the
  decode reads' merge scratch sized), is captured at its second
  (``utils/graphs.py``) and replayed at every later one, in this
  ``serve`` call or a later one: one ``cudaGraphLaunch`` a segment. The
  admission wave stays eager (its width varies). On the CPU every
  segment runs eagerly over the same buffers.

Admission is FIFO by default: a free row always takes the queue head. A
request whose segment-rounded budget can never fit a row would block the
head forever, so it is set aside up front, everything else is served,
then :class:`HorizonError` is raised carrying the completed outputs.
``admit_policy="skip_fit"`` keeps that no-leapfrog order among requests
that fit and skips the others in place, reporting them the same way.

Not ported yet: width buckets, speculation, tiers, handoff, the journal,
deadlines, cancel, shed, drain, reconstruction and telemetry (the int8
pool's ``kvq`` counters among them).
"""

from __future__ import annotations

import functools
import inspect
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from distributed_compute_pytorch_tpu_torch.device import resolve_device
from distributed_compute_pytorch_tpu_torch.infer import sample_rows
from distributed_compute_pytorch_tpu_torch.kv_pool import (
    BlockPool, RadixCache)
from distributed_compute_pytorch_tpu_torch.ops.attention import (
    gather_kv_blocks)
from distributed_compute_pytorch_tpu_torch.ops.cache_update import (
    kv_pool_insert)
from distributed_compute_pytorch_tpu_torch.ops.decode_attention import (
    merge_scratch)
from distributed_compute_pytorch_tpu_torch.utils.graphs import capture

# the reference's default block size for float pools (its Pallas slot
# window); the CUDA kernels take any block size, int8 pools too (the
# reference's 32-slot int8 alignment is a TPU tiling rule)
DEFAULT_BLOCK_TOKENS = 8
KV_DTYPES = ("bf16", "int8")
ADMIT_POLICIES = ("fifo", "skip_fit")


@dataclass
class Request:
    """One generation request: ``tokens`` (prompt ids) in, up to
    ``max_new`` continuations out (fewer if ``eos_id`` fires).

    ``temperature`` 0 (default) decodes greedily; above 0 samples, with
    optional ``top_k`` / ``top_p`` truncation (both need a temperature
    above 0). ``seed`` fixes the request's sampling stream; ``None`` means
    the request's index in the ``serve`` call, so a whole call is
    deterministic by default."""

    tokens: list
    max_new: int
    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    seed: int | None = None


@dataclass
class _Slot:
    """Host-side bookkeeping for one cache row."""

    req_index: int = -1        # position in the request list (-1 = free)
    remaining: int = 0
    out: list = field(default_factory=list)
    blocks: list = field(default_factory=list)   # owned pool block refs
    # chunked prefill: the known tokens of a row admitted mid-prompt and
    # how many logical head tokens (attached prefix included) are
    # prefilled so far; None = fully prefilled, the only rows a decode
    # plan takes
    pf_known: list | None = None
    pf_done: int = 0

    def free(self):
        self.req_index = -1
        self.remaining = 0
        self.out = []
        self.blocks = []
        self.pf_known = None
        self.pf_done = 0


class HorizonError(RuntimeError):
    """A request's segment-rounded budget can never fit the per-row
    horizon (``prompt_buf + ceil(max_new/segment)*segment > t_max``).

    Raised AFTER every admissible request has been served; ``outputs``
    holds the completed results (in request order, ``[]`` for the
    rejected requests)."""

    def __init__(self, message: str, outputs: list):
        super().__init__(message)
        self.outputs = outputs


class _Fetch:
    """One dispatched segment's tokens on their way to the host: on CUDA
    a non-blocking copy into pinned memory behind an event, so waiting
    for it waits for that segment alone, not for work queued after it."""

    def __init__(self, toks: torch.Tensor):
        if toks.device.type == "cuda":
            self._host = torch.empty(toks.shape, dtype=toks.dtype,
                                     pin_memory=True)
            self._host.copy_(toks, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            # the CPU runs the copy now; the next segment reuses ``toks``
            self._host, self._event = toks.clone(), None

    def result(self) -> np.ndarray:
        if self._event is not None:
            # the harvest's wait for its own segment, the serve loop's one
            # intended host sync: allowed even under
            # torch.cuda.set_sync_debug_mode("error"), and only here
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                self._event.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return self._host.numpy()


class ContinuousBatcher:
    """Fixed-pool continuous batching for one causal LM over a paged
    block-table KV cache.

    Args:
      model: a ``models.gpt2.GPT2`` or ``models.llama.LlamaLM`` (any
        model with ``embed``, ``blocks[i].forward/decode_step``,
        ``readout``, ``kv_cache_spec``) on the batcher's device; it serves
        in its parameter dtype. A block that ropes (Llama's) ropes the
        admission window at its logical slots and each tick at the row's
        slot ``pos``; the pool holds post-rope keys at kv-head width
        (quantized as they are, in an int8 pool).
      params: a state dict to load into ``model`` first, or ``None`` to
        serve the model's current weights.
      slots: cache rows decoding concurrently (the static batch).
      t_max: each ROW's logical length bound, rounded up to whole blocks:
        one request needs ``prompt_buf + ceil(max_new/segment)*segment <=
        t_max``.
      prompt_buf: the admission window; longer prompts are rejected.
      segment: decode ticks per dispatch.
      eos_id: optional stop token (rows stop early and free their slot).
      admit_policy: ``"fifo"`` (default) or ``"skip_fit"`` (module
        docstring).
      kv_block_tokens: logical slots per pool block (default 8).
      prefix_cache: the radix prefix cache (module docstring); off by
        default.
      pool_blocks: physical blocks per layer pool (default ``slots *
        (t_max // bt) + 1``: every row's worst case plus the trash block,
        plus 4 rows' worth of cache headroom with ``prefix_cache``; that
        sum without the headroom is also the minimum).
      prefill_chunk_tokens: chunked prefill's per-wave suffix budget
        (module docstring), rounded up to the block size; ``None`` = off.
      kv_dtype: ``"bf16"`` (the pool in the model's compute dtype, whatever
        it is) or ``"int8"`` (int8 K/V with per-row f32 scales).
      device: ``None``/``"cuda"`` (raises without CUDA) or ``"cpu"``.

    Counters: ``stats`` (prefill waves, their rows and those that ran a
    device forward (``prefill_forwards``), overlapped fetches,
    eager, captured, replayed and sampled segments, and the prefix cache's
    ``prefix_hits``, ``cached_prefix_tokens``, ``prefill_tokens_saved``,
    ``cow_copies`` and peak ``block_pool_occupancy``), ``prefill`` (the
    chunk counters: ``chunked_admissions``, ``chunk_waves``,
    ``chunk_tokens``, ``stall_ticks``), and after each ``serve`` call
    ``last_slot_leaks``, ``last_block_leaks`` (pool references the radix
    tree does not account for), ``last_ttft_s``, ``last_cached_prefix``
    (each request's attached length) and ``last_admissions`` (request
    indices, one list a wave, in admission order).
    """

    def __init__(self, model, params=None, *, slots: int, t_max: int,
                 prompt_buf: int, segment: int = 16,
                 eos_id: int | None = None, admit_policy: str = "fifo",
                 kv_block_tokens: int | None = None,
                 prefix_cache: bool = False,
                 pool_blocks: int | None = None,
                 prefill_chunk_tokens: int | None = None,
                 kv_dtype: str = "bf16", device=None):
        self.device = resolve_device(device)
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}")
        if prompt_buf > t_max:
            raise ValueError(f"prompt_buf {prompt_buf} > t_max {t_max}")
        if admit_policy not in ADMIT_POLICIES:
            raise ValueError(f"admit_policy must be 'fifo' or 'skip_fit', "
                             f"got {admit_policy!r}")
        if slots < 1 or segment < 1:
            raise ValueError("slots and segment must be >= 1")
        if kv_block_tokens is not None and kv_block_tokens < 1:
            raise ValueError(
                f"kv_block_tokens must be >= 1, got {kv_block_tokens}")
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError(f"prefill_chunk_tokens must be >= 1, got "
                             f"{prefill_chunk_tokens}")
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, the batcher on "
                             f"{self.device}")
        if params is not None:
            model.load_state_dict(params)
        self.model = model
        # does the block rope internally (Llama)? Then a wave hands it each
        # row's logical slots (reference ``_block_takes_positions``,
        # ``:495``); GPT-2 embeds its positions instead
        sig = inspect.signature(model.blocks[0].forward).parameters
        self._block_takes_positions = "positions" in sig
        if ((prefix_cache or prefill_chunk_tokens is not None)
                and "kv_prefix" not in sig):
            raise ValueError(
                f"prefix_cache and prefill_chunk_tokens need a block with "
                f"kv_prefix suffix prefill; "
                f"{type(model.blocks[0]).__name__} has none")
        self.B = slots
        self.Tb = prompt_buf
        self.S = segment
        self.eos_id = eos_id
        self.admit_policy = admit_policy
        self.bt = kv_block_tokens or DEFAULT_BLOCK_TOKENS
        self.t_max = -(-t_max // self.bt) * self.bt
        self.nb = self.t_max // self.bt          # table entries per row
        # chunked prefill: the block-rounded per-wave suffix budget (the
        # chunk is the wave's window, so the scatter stays whole-block)
        self._chunk = (None if prefill_chunk_tokens is None else
                       -(-prefill_chunk_tokens // self.bt) * self.bt)
        min_blocks = slots * self.nb + 1         # + the trash block
        if pool_blocks is None:
            pool_blocks = min_blocks + (4 * self.nb if prefix_cache else 0)
        if pool_blocks < min_blocks:
            raise ValueError(
                f"pool_blocks={pool_blocks} < slots*blocks_per_row+1="
                f"{min_blocks}: a full pool could deadlock admission "
                f"(eviction frees only refcount-0 blocks)")
        hk, hd = model.kv_cache_spec()
        # per-layer block pools [2(k/v), P, hk, bt, hd] in the model's
        # float dtype, or int8 beside f32 scales [2, P, hk, bt, 1]; written
        # in place by the kv_pool_insert kernel (admission) and the fused
        # decode tick (their int8 forms quantize)
        shape = (2, pool_blocks, hk, self.bt)
        self._caches = [
            {"kv": torch.zeros(*shape, hd, device=self.device,
                               dtype=torch.int8 if kv_dtype == "int8"
                               else model.dtype),
             **({"scale": torch.zeros(*shape, 1, device=self.device)}
                if kv_dtype == "int8" else {})}
            for _ in model.blocks]
        # the segment's static buffers, at the addresses a captured segment
        # reads and writes on every replay: the block tables and each row's
        # last written slot (filled before each dispatch), the carried
        # current token and logical position (rewritten in place by each
        # segment and by admission), each row's sampling settings (filled
        # by admission: temperature, top-k (0 = none), top-p (>= 1 =
        # none), seed), the segment's tokens
        dev = self.device
        self._tables_dev = torch.zeros(slots, self.nb, dtype=torch.int32,
                                       device=dev)
        self._pos0 = torch.zeros(slots, dtype=torch.int32, device=dev)
        self._cur_tok = torch.zeros(slots, dtype=torch.long, device=dev)
        self._n_logical = torch.zeros(slots, dtype=torch.long, device=dev)
        self._temp = torch.zeros(slots, device=dev)
        self._topk = torch.zeros(slots, dtype=torch.long, device=dev)
        self._topp = torch.full((slots,), 2.0, device=dev)
        self._seed = torch.zeros(slots, dtype=torch.long, device=dev)
        self._toks = torch.zeros(slots, segment, dtype=torch.long, device=dev)
        # their host copies, set at admission
        self._temp_h = np.zeros(slots, np.float32)
        self._topk_h = np.zeros(slots, np.int64)
        self._topp_h = np.full(slots, 2.0, np.float32)
        self._seed_h = np.zeros(slots, np.int64)
        # on CUDA each segment program (greedy: False, sampled: True) is
        # captured at its second dispatch (False: the eager loop on the
        # card, the reference the card's checks hold the graphs to); the
        # captured programs (``graphs.Program``) and each program's eager
        # dispatches so far; the merge scratch of its decode reads
        self._capture = dev.type == "cuda"
        self._programs: dict = {}
        self._eager_runs = {False: 0, True: 0}
        self._scratch: dict = {}
        self._pool = BlockPool(pool_blocks)
        self._tables = np.full((slots, self.nb), BlockPool.TRASH, np.int32)
        self._radix = RadixCache(self._pool, self.bt) if prefix_cache else None
        # per-row slot of the last written token (host-tracked: admission
        # rewinds a row to its head length - 1; each segment advances
        # every row by S; parked rows sit at 0 writing into trash)
        self._row_pos = [0] * slots
        self.ticks = 0
        self.stats = {"prefill_calls": 0, "prefill_rows": 0,
                      "prefill_forwards": 0,
                      "fetches_overlapped": 0, "eager_segments": 0,
                      "graph_captures": 0, "graph_replays": 0,
                      "sampled_segments": 0, "prefix_hits": 0,
                      "cached_prefix_tokens": 0, "prefill_tokens_saved": 0,
                      "cow_copies": 0, "block_pool_occupancy": 0.0}
        self.prefill = {"chunked_admissions": 0, "chunk_waves": 0,
                        "chunk_tokens": 0, "stall_ticks": 0}
        self.last_slot_leaks = 0   # rows still owned at serve() exit
        self.last_block_leaks = 0  # pool refs unaccounted at serve() exit
        self.last_ttft_s: list = []  # per request: serve start -> 1st token
        self.last_cached_prefix: list = []  # per request: attached length
        self.last_admissions: list = []     # request indices, a list a wave

    @property
    def _graph(self):
        """The captured greedy segment (``None`` until it is captured)."""
        return self._programs.get(False)

    def clear_prefix_cache(self) -> None:
        """Drop every radix entry and the pool references it holds (between
        ``serve`` calls), so the next call starts from a cold cache."""
        if self._radix is not None:
            self._radix.clear()

    # ---- device work -----------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the batcher's device without waiting for the
        card: on CUDA staged through a fresh pinned buffer and copied
        ``non_blocking`` (PyTorch's caching host allocator keeps the buffer
        until the copy has run, so no later call can overwrite it)."""
        t = torch.from_numpy(a)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _fill(self, dst: torch.Tensor, a: np.ndarray) -> None:
        """Copy a host array into the device buffer ``dst`` in place
        without waiting for the card (on CUDA through a fresh pinned buffer,
        ``non_blocking``, as :meth:`_to_device`), ordered on the stream
        before the dispatch that reads it."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        dst.copy_(t, non_blocking=True)

    def _copy_blocks(self, pairs: list) -> None:
        """Copy-on-write: pool blocks ``src`` duplicated into ``dst`` for
        every ``(src, dst)`` of ``pairs``, across every layer's leaves (the
        int8 pool's scales with its bytes), by tensor indexing (reference
        ``_copy_impl``, ``:1443-1455``, an XLA gather and scatter). Issued
        on the stream before the wave's prefill. The copy's tail past the
        attacher's matched length is the donor's K/V, never attended and
        overwritten as the attacher writes its own suffix."""
        src = self._to_device(np.array([s for s, _ in pairs], np.int64))
        dst = self._to_device(np.array([d for _, d in pairs], np.int64))
        for cache in self._caches:
            for leaf in cache.values():
                leaf.index_copy_(1, dst, leaf.index_select(1, src))

    def _prefill_wave(self, entries):
        """ONE multi-row prefill of ``entries`` ``(row, known, from_m,
        upto)`` (reference ``:3025-3130``): each entry's head tokens
        ``known[from_m:upto]`` at logical positions ``from_m..upto-1``
        (past its resident prefix: the attached length at admission, or
        chunked prefill's progress mark) from column 0 of a ``window``-wide
        batch, their K/V scattered to the row's blocks. ``window`` is
        ``prompt_buf`` when nothing is resident, the chunk with chunking
        on, else the block-rounded longest suffix. An entry reaching its
        head (``upto == len(known) - 1``) finalises: its last known token
        becomes the row's current token and the row rewinds to ``head_len
        - 1``; a mid-chunk entry stays parked. A wave with no suffix token
        runs no device work but that. Dispatch only — no fetch."""
        bt = self.bt
        suffixes = [upto - m for _, _, m, upto in entries]
        max_m = max(m for _, _, m, _ in entries)
        if self._chunk is not None:
            window = self._chunk
        else:
            window = (self.Tb if max_m == 0 else
                      max(bt, -(-max(suffixes) // bt) * bt))
        Lp = -(-max_m // bt) * bt        # the gathered prefix, whole blocks
        if max(suffixes) > 0:
            K = len(entries)
            prompt = np.zeros((K, window), np.int64)
            pmask = np.zeros((K, window), np.float32)
            positions = np.arange(window, dtype=np.int64)
            if max_m:
                positions = np.tile(positions, (K, 1))
            prefix_mask = np.zeros((K, Lp), np.float32)
            tables = np.full((K, Lp // bt), BlockPool.TRASH, np.int32)
            blk = np.full((K, window), self._pool.num_blocks, np.int32)
            off = np.zeros((K, window), np.int32)
            for j, (b, known, m, upto) in enumerate(entries):
                sn = upto - m
                prompt[j, :sn] = known[m:upto]
                pmask[j, :sn] = 1.0
                if m:
                    positions[j] += m
                    prefix_mask[j, :m] = 1.0
                tables[j] = self._tables[b, :Lp // bt]
                logical = m + np.arange(sn)
                blk[j, :sn] = self._tables[b][logical // bt]
                off[j, :sn] = logical % bt
            self._admit(*(self._to_device(a) for a in (
                prompt, pmask, positions, blk, off)),
                prefix=(self._to_device(tables),
                        self._to_device(prefix_mask)) if Lp else None)
            self.stats["prefill_forwards"] += 1
        final = [(b, known) for b, known, _, upto in entries
                 if upto >= len(known) - 1]
        if final:
            rows = self._to_device(np.array([b for b, _ in final], np.int64))
            self._cur_tok[rows] = self._to_device(
                np.array([known[-1] for _, known in final], np.int64))
            self._n_logical[rows] = self._to_device(
                np.array([len(known) - 1 for _, known in final], np.int64))
            for b, known in final:
                self._row_pos[b] = len(known) - 2    # head_len - 1

    def _admit(self, prompt, pmask, positions, blk, off, prefix=None):
        """The admission forward (reference ``_admit_impl``,
        ``:1340-1441``): every block's ``forward`` over the wave's suffix
        window with the pad mask; with ``prefix`` ``(tables [K, Lp/bt],
        prefix_mask [K, Lp])`` each layer first gathers the rows' resident
        prefix K/V from its pool (an int8 pool's dequantized with its
        scales to the compute dtype) and the blocks attend the suffix
        against it (``kv_prefix``). Each layer's captured suffix K/V is
        written to the pool (``kv_pool_insert``; an int8 pool's write
        quantizes it)."""
        model = self.model
        K, W = prompt.shape
        x = model.embed(prompt, positions)
        blk, off = blk.reshape(-1), off.reshape(-1)
        kw = {"positions": positions} if self._block_takes_positions else {}
        for block, cache in zip(model.blocks, self._caches):
            sink: list = []
            if prefix is not None:
                tables, prefix_mask = prefix
                pk = gather_kv_blocks(cache["kv"], tables)
                if "scale" in cache:
                    ps = gather_kv_blocks(cache["scale"], tables)
                    pk = (pk.float() * ps).to(model.dtype)
                kw["kv_prefix"] = (pk[0], pk[1], prefix_mask)
            x = block(x, kv_mask=pmask, kv_sink=sink, **kw)
            (k, v), = sink                     # [K, hk, W, hd] views
            hk, hd = k.shape[1], k.shape[3]
            kv_pool_insert(cache["kv"],
                           k.transpose(1, 2).reshape(K * W, hk, hd),
                           v.transpose(1, 2).reshape(K * W, hk, hd),
                           blk, off, scale=cache.get("scale"))

    def _segment(self, tables, positions0, sampling: bool) -> torch.Tensor:
        """Dispatch ``S`` decode ticks for every row at its OWN position
        (``positions0 [B]`` = each row's last written slot; tick ``i``
        writes slot ``positions0 + 1 + i``), drawing with
        ``infer.sample_rows`` when ``sampling``. Returns the static ``[B,
        S]`` token buffer, which the next dispatch overwrites (reference
        ``_segment_impl``). On CUDA each program's first dispatch runs
        eagerly, its second is captured as a CUDA graph, and it and every
        later one replay it; a failed capture or replay raises."""
        self._fill(self._tables_dev, tables)
        self._fill(self._pos0, np.asarray(positions0, np.int32))
        self.stats["sampled_segments"] += sampling
        program = self._programs.get(sampling)
        if program is None:
            if not (self._capture and self._eager_runs[sampling]):
                self._decode_segment(sampling)
                self._eager_runs[sampling] += 1
                self.stats["eager_segments"] += 1
                return self._toks
            program = self._programs[sampling] = capture(
                functools.partial(self._decode_segment, sampling))
            self.stats["graph_captures"] += 1
        program.replay()
        self.stats["graph_replays"] += 1
        return self._toks

    def _decode_segment(self, sampling: bool = False) -> None:
        """The segment's work over the static buffers (a captured
        program): ``S`` ticks, then the carried token and logical position
        and the ``[B, S]`` tokens written in place. ``sampling`` draws
        each row's token with its own settings, keyed on (its seed, the
        logical position of the token it consumes), as the reference
        folds ``n_logical + i`` into the row's key (``:1494-1500``)."""
        model = self.model
        tok, n_log = self._cur_tok, self._n_logical
        out = []
        with merge_scratch(self._scratch):
            for i in range(self.S):
                pos = self._pos0 + (1 + i)
                x = model.embed(tok[:, None], n_log[:, None])
                for block, cache in zip(model.blocks, self._caches):
                    x, _ = block.decode_step(
                        x, {**cache, "table": self._tables_dev}, pos)
                logits = model.readout(x)[:, -1]
                if sampling:
                    tok = sample_rows(logits, self._temp, self._topk,
                                      self._topp, self._seed, n_log)
                else:
                    tok = torch.argmax(logits, dim=-1)
                n_log = n_log + 1
                out.append(tok)
        self._cur_tok.copy_(tok)
        self._n_logical.copy_(n_log)
        torch.stack(out, dim=1, out=self._toks)

    # ---- host scheduler --------------------------------------------------

    def _rounded_need(self, max_new: int) -> int:
        """Decode slots a request consumes past its head: the
        segment-rounded budget (a row runs whole segments)."""
        return -(-max_new // self.S) * self.S

    def _fits(self, req: Request) -> bool:
        return self.Tb + self._rounded_need(req.max_new) <= self.t_max

    def _validate_one(self, r: Request) -> str | None:
        """One request's validation (reference ``:1852-1888``); returns
        the error string, ``None`` = valid."""
        if len(r.tokens) > self.Tb:
            return (f"prompt of {len(r.tokens)} tokens exceeds "
                    f"prompt_buf={self.Tb}")
        if len(r.tokens) == 0:
            return "empty prompt"
        if r.max_new < 1:
            return f"max_new must be >= 1, got {r.max_new}"
        if r.temperature < 0.0:
            return f"temperature must be >= 0, got {r.temperature}"
        if r.temperature == 0.0 and (r.top_k is not None
                                     or r.top_p is not None):
            return ("top_k/top_p require temperature > 0 "
                    "(temperature 0 is greedy)")
        if r.top_k is not None and r.top_k < 1:
            return f"top_k must be >= 1, got {r.top_k}"
        if r.top_p is not None and not 0.0 < r.top_p <= 1.0:
            return f"top_p must be in (0, 1], got {r.top_p}"
        vocab = self.model.config.vocab_size
        bad = [t for t in r.tokens if not 0 <= t < vocab]
        if bad:
            return (f"token ids {bad[:8]} outside the model vocab "
                    f"[0, {vocab})")
        return None

    def _alloc(self, n: int) -> list:
        """``n`` fresh blocks, evicting least-recently-used radix entries
        first when the free list runs short (reference ``:1580-1594``;
        eviction frees refcount-0 blocks only, so live rows keep theirs);
        raises ``PoolExhausted`` if that is not enough."""
        if self._pool.free_count < n and self._radix is not None:
            self._radix.evict_for(n)
        return self._pool.alloc(n)

    def _assign_blocks(self, b: int, slot: _Slot, known: list,
                       remaining: int):
        """Build row ``b``'s block table for ``known`` (the prompt) with
        ``remaining`` budget (reference ``:1650-1697``): attach the radix
        cache's longest prefix of the head (full blocks shared read-only,
        a partial tail block copy-on-write), allocate fresh blocks for the
        rest of the row's worst-case extent and point the table at them.
        Returns ``(m, cow_pairs)``: the attached length and the ``(src,
        dst)`` copies to issue before the wave's prefill."""
        head = known[:-1]
        extent = len(head) + self._rounded_need(remaining)
        nblocks = -(-extent // self.bt)
        m, src = 0, []
        if self._radix is not None:
            m, src = self._radix.match(head)
            m = min(m, len(head))
            src = src[:-(-m // self.bt)] if m else []
        f, r = divmod(m, self.bt)
        row_blocks = []
        for blk in src[:f]:
            self._pool.acquire(blk)          # shared, read-only
            row_blocks.append(blk)
        cow = []
        if r:
            dst = self._alloc(1)[0]
            cow.append((src[f], dst))        # partial block: copy-on-write
            row_blocks.append(dst)
        row_blocks += self._alloc(nblocks - len(row_blocks))
        self._tables[b, :] = BlockPool.TRASH
        self._tables[b, :nblocks] = row_blocks
        slot.blocks = row_blocks
        self.stats["block_pool_occupancy"] = max(
            self.stats["block_pool_occupancy"],
            self._pool.allocated / self._pool.num_blocks)
        return m, cow

    def _insert_head(self, b: int, known: list) -> None:
        """Enter row ``b``'s fully prefilled head into the radix tree (after
        its prefill was dispatched: the stream's order makes the blocks
        valid before any attacher's wave reads them)."""
        head = known[:-1]
        if self._radix is not None and head:
            nb_head = -(-len(head) // self.bt)
            self._radix.insert(head, [int(x)
                                      for x in self._tables[b, :nb_head]])

    def serve(self, requests: list[Request]) -> list[list[int]]:
        """Run every request through the pool; returns each request's
        generated tokens (trimmed at eos), in request order. Invalid
        requests raise ``ValueError``; requests that can never fit a row
        raise :class:`HorizonError` after the rest complete."""
        for r in requests:
            err = self._validate_one(r)
            if err is not None:
                raise ValueError(err)
        with torch.no_grad():
            outputs, rejected = self._run(requests)
        if rejected:
            worst = max(self._rounded_need(requests[i].max_new)
                        for i in rejected)
            raise HorizonError(
                f"per-row horizon exhausted for {len(rejected)} "
                f"request(s): prompt_buf={self.Tb} + segment-rounded "
                f"max_new (worst {worst}) exceeds t_max={self.t_max} — "
                f"raise t_max or shrink max_new (completed outputs are "
                f"on this error's .outputs)", outputs)
        return outputs

    def _run(self, requests: list[Request]):
        """The overlapped dispatch/harvest loop. Returns ``(outputs,
        horizon-rejected indices)``."""
        t0 = time.monotonic()
        n = len(requests)
        results: list = [None] * n
        ttft: list = [None] * n
        cached = [0] * n
        admissions: list = []
        if self.admit_policy == "fifo":
            # a request that can never fit would block the head forever:
            # set it aside now
            queue = [i for i in range(n) if self._fits(requests[i])]
        else:
            # skip_fit: never-fitting requests are skipped in place at
            # admission and reported at the end
            queue = list(range(n))
        table = [_Slot() for _ in range(self.B)]

        def free_row(b):
            slot = table[b]
            if slot.blocks:
                self._pool.release(slot.blocks)
            self._tables[b, :] = BlockPool.TRASH
            slot.free()

        def pick_admissions(k_free: int) -> list[int]:
            """The next requests to admit (reference ``:2290-2309``): the
            queue's head for FIFO; for skip_fit the first ones that fit,
            in queue order."""
            if self.admit_policy == "fifo":
                take = queue[:k_free]
                del queue[:len(take)]
                return take
            take = [i for i in queue if self._fits(requests[i])][:k_free]
            for i in take:
                queue.remove(i)
            return take

        def admit_wave():
            """ONE prefill for every queued request that has a free row
            (reference ``:2311-2397``): sampling settings, the radix
            attach, block allocation and copy-on-write on the host before
            the wave's device work. With chunked prefill the wave shares
            one suffix budget: rows past it admit mid-prompt."""
            free = [b for b, s in enumerate(table) if s.req_index < 0]
            take = pick_admissions(len(free))
            if not take:
                return
            admissions.append(take)
            entries, cow_all = [], []
            budget = self._chunk
            for b, ri in zip(free, take):
                req, slot = requests[ri], table[b]
                self._temp_h[b] = req.temperature
                self._topk_h[b] = req.top_k or 0
                self._topp_h[b] = 2.0 if req.top_p is None else req.top_p
                self._seed_h[b] = (ri if req.seed is None
                                   else req.seed) & 0xFFFFFFFF
                slot.req_index, slot.out = ri, []
                slot.remaining = req.max_new
                m, cow = self._assign_blocks(b, slot, list(req.tokens),
                                             req.max_new)
                cow_all.extend(cow)
                cached[ri] = m
                self.stats["prefix_hits"] += m > 0
                self.stats["cached_prefix_tokens"] += m
                self.stats["prefill_tokens_saved"] += m
                head_len = len(req.tokens) - 1
                upto = head_len
                if budget is not None:
                    give = min(head_len - m, budget)
                    budget -= give
                    upto = m + give
                    if upto < head_len:
                        slot.pf_known, slot.pf_done = list(req.tokens), upto
                        self.prefill["chunked_admissions"] += 1
                entries.append((b, list(req.tokens), m, upto))
            for dst, a in ((self._temp, self._temp_h),
                           (self._topk, self._topk_h),
                           (self._topp, self._topp_h),
                           (self._seed, self._seed_h)):
                self._fill(dst, a)
            self.stats["cow_copies"] += len(cow_all)
            if cow_all:
                self._copy_blocks(cow_all)
            self._prefill_wave(entries)
            self.stats["prefill_calls"] += 1
            self.stats["prefill_rows"] += len(take)
            # mid-chunk rows defer their insert until the head is whole: a
            # partial head in the tree would hand attachers unwritten
            # blocks
            for b, known, _, upto in entries:
                if upto >= len(known) - 1:
                    self._insert_head(b, known)

        def chunk_wave():
            """ONE chunk-budgeted extension prefill for every row admitted
            mid-prompt (reference ``:2399-2444``), between segments; rows
            reaching their head join the next decode plan and the tree."""
            if self._chunk is None:
                return
            budget = self._chunk
            entries = []
            for b, slot in enumerate(table):
                if slot.req_index < 0 or slot.pf_known is None:
                    continue
                give = min(len(slot.pf_known) - 1 - slot.pf_done, budget)
                if give <= 0:
                    continue          # this wave's budget is spent
                budget -= give
                entries.append((b, slot.pf_known, slot.pf_done,
                                slot.pf_done + give))
                slot.pf_done += give
            if not entries:
                return
            self._prefill_wave(entries)
            self.stats["prefill_calls"] += 1
            self.prefill["chunk_waves"] += 1
            self.prefill["chunk_tokens"] += sum(upto - m
                                                for _, _, m, upto in entries)
            for b, known, _, upto in entries:
                if upto < len(known) - 1:
                    continue          # still mid-prompt
                table[b].pf_known, table[b].pf_done = None, 0
                self._insert_head(b, known)

        def dispatch_segment():
            """Dispatch ONE segment (no fetch), or None when no row has
            budget left. Budget depletion is applied here, at dispatch,
            so the next segment can be decided before this one's tokens
            arrive. Rows outside the plan (free, done, or mid-chunk, whose
            head is not all written) park at position 0 behind an
            all-trash table."""
            plan = []
            for b, slot in enumerate(table):
                if (slot.req_index >= 0 and slot.remaining > 0
                        and slot.pf_known is None):
                    take = min(slot.remaining, self.S)
                    plan.append((b, slot.req_index, take,
                                 slot.remaining - take <= 0))
            if not plan:
                return None
            active = {b for b, _, _, _ in plan}
            tables_now = self._tables.copy()
            for b in range(self.B):
                if b not in active:
                    tables_now[b, :] = BlockPool.TRASH
                    self._row_pos[b] = 0
                    if table[b].pf_known is not None:
                        self.prefill["stall_ticks"] += self.S
            sampling = bool((self._temp_h[sorted(active)] > 0).any())
            # the fetch's copy of the static token buffer is queued on the
            # stream right after this segment and before the next
            # dispatch's fills and replay, which overwrite the buffer: the
            # stream's order keeps segment N's tokens until they are copied
            fetch = _Fetch(self._segment(tables_now, self._row_pos,
                                         sampling))
            for b in range(self.B):
                self._row_pos[b] += self.S
            self.ticks += self.S
            for b, _, take, _ in plan:
                table[b].remaining -= take
            return fetch, plan

        def dispatch_or_chunk():
            """:func:`dispatch_segment`, extending mid-chunk rows while no
            row can decode (each chunk wave advances them by a block at
            least, so this ends)."""
            while True:
                seg = dispatch_segment()
                if seg is not None or not any(
                        s.req_index >= 0 and s.pf_known is not None
                        for s in table):
                    return seg
                chunk_wave()

        def harvest(seg, overlapped: bool):
            """THE one device->host fetch per segment."""
            fetch, plan = seg
            if overlapped:
                self.stats["fetches_overlapped"] += 1
            toks = fetch.result()
            now = time.monotonic()
            for b, ri, take, done in plan:
                slot = table[b]
                if results[ri] is not None or slot.req_index != ri:
                    continue   # finished (eos) while this was in flight
                slot.out.extend(int(t) for t in toks[b, :take])
                if ttft[ri] is None and slot.out:
                    ttft[ri] = now - t0
                if self.eos_id is not None and self.eos_id in slot.out:
                    slot.out = slot.out[:slot.out.index(self.eos_id) + 1]
                    done = True
                if done:
                    results[ri] = slot.out
                    free_row(b)

        admit_wave()
        chunk_wave()
        seg = dispatch_or_chunk()
        while seg is not None:
            nxt = dispatch_segment()      # overlap: N+1 before fetching N
            harvest(seg, overlapped=nxt is not None)
            admit_wave()                  # freed rows -> next wave
            chunk_wave()                  # mid-chunk rows -> next chunk
            if nxt is None:
                nxt = dispatch_or_chunk()  # revived by fresh admissions
            seg = nxt

        # whatever never entered the queue or is still in it can never be
        # admitted: horizon rejects, reported by ``serve``
        queued = set(queue)
        rejected = [i for i in range(n) if results[i] is None
                    and (i in queued or not self._fits(requests[i]))]
        leaked = [b for b, s in enumerate(table) if s.req_index >= 0]
        self.last_slot_leaks = len(leaked)
        for b in leaked:
            free_row(b)
        # with every row freed, the only live pool references are the
        # radix tree's (and the pinned trash block)
        self.last_block_leaks = self._pool.leak_check(
            self._radix.held() if self._radix is not None else None)
        self.stats["block_pool_occupancy"] = max(
            self.stats["block_pool_occupancy"],
            self._pool.high_water / self._pool.num_blocks)
        self.last_ttft_s = ttft
        self.last_cached_prefix = cached
        self.last_admissions = admissions
        return [r if r is not None else [] for r in results], rejected
