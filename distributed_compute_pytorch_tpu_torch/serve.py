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

- **Width buckets** (``decode_width_buckets``): a dispatch hands its
  program the block tables cut to the narrowest rung of a ladder (powers
  of two of blocks, capped at the table's ``nb``; the widest ``N`` rungs
  kept) that covers the live rows' reach. The port's reads already read
  only each row's live keys, so a rung sets the decode read's split count
  and nothing else; each rung is a program (and a captured graph) of its
  own, from its own static ``[B, nb_w]`` table buffer. The default is one
  full-width rung. :meth:`ContinuousBatcher.prewarm_widths` captures every
  rung's program up front.
- **Speculative decoding** (``speculate``): a proposer (``spec_decode``:
  the n-gram self-drafter by default) drafts ``k`` tokens a row; ONE
  verify program scores each row's current token and its drafts at
  consecutive slots (the blocks' ``verify_step``: one launch of the
  ``paged_verify_write`` kernel a layer writes the window through the
  table and attends it under the per-query staircase) and returns the
  model's own token after each column (argmax, or ``infer.
  verify_sample_rows`` keyed exactly as plain decode keys that position).
  The host accepts the longest matching draft prefix plus the model's
  token at the first mismatch, clamped to the budget and trimmed at eos,
  and advances each row by what it emitted: the whole rollback, since K/V
  past a row's position is never attended. Outputs are token-identical to
  ``speculate=None``; the verify path runs off host mirrors of each row's
  current token and logical count, and sustained low acceptance switches
  back to plain segments for good (auto-disable). Verify steps never
  overlap (the next drafts need this step's tokens); every block under a
  window's writes is made private first (copy-on-write).

- **KV tiers and the prefix handoff** (``host_cache_mb`` /
  ``host_cache_blocks``, ``disk_cache_dir``; ``kv_tier.py``): with a host
  tier, an evicted radix entry is DEMOTED instead of discarded — its
  blocks gathered on the card and copied D2H into a pinned host block pool
  (asynchronously: nothing waits for the card) — and keeps its place in
  the tree; an admission that matches it PROMOTES it — fresh pool blocks,
  an H2D copy from the pinned pool (or from a disk part), scattered into
  the pool in place — before the wave's copy-on-write and prefill are
  enqueued, so stream order lands the bytes before any reader. Promoted
  blocks are fresh allocations, so the in-flight argument above holds for
  them unchanged. A host tier under pressure spills its least recently
  used entries to CRC-checked parts on disk (a corrupt part is a miss):
  the spill copies the entry out through the card into fresh pinned
  memory, stream-ordered, and the disk writer thread waits for that
  copy, so the scheduler waits for nothing; a new batcher on the same
  directory adopts its parts (warm restart).
  :meth:`ContinuousBatcher.export_prefix` / :meth:`ContinuousBatcher.
  import_prefix` move a cached prefix between batchers as bytes.

- **The request lifecycle** (:meth:`ContinuousBatcher.serve_detailed`,
  ``serve_lifecycle.py``): a ``RequestResult`` per request — ``ok``,
  ``failed``, ``timeout`` (``Request.deadline_s``), ``cancelled``
  (:meth:`ContinuousBatcher.cancel`, the drain deadline) or ``shed``
  (``max_pending`` overflow, a drain's queue) — with whatever tokens
  reached the host. Open-loop arrivals (``Request.arrival_s``) are admitted
  no sooner than they arrive. The lifecycle's transitions are host
  bookkeeping between device calls; a row cut while its next segment is in
  flight is freed as a row at eos is (the argument above holds: reuse of
  its blocks is enqueued after that segment, and the harvest skips its
  plan entry).
- **Session reconstruction**: a raised harvest, or one past
  ``tick_timeout_s`` (the tick watchdog: the harvest polls its event and
  raises ``TickTimeout``, no thread, no blocking sync; on the card an
  eager or capturing segment first waits for the one in flight under the
  same budget, since its launches could block the host behind a hung
  device, so with the watchdog on only replays overlap), rebuilds every live
  row from host state — the pool and the static buffers zeroed IN PLACE
  (the captured programs keep their addresses and replay on), then
  ``prompt + harvested tokens`` re-prefilled — at most ``max_recoveries``
  a call, evicting the newest admission when a fault survives one. A
  segment the watchdog cut stays on the stream: the zeroing and the
  re-prefill are enqueued behind it, and the next harvest's clock starts
  once it is done, so a hang that never ends blocks the process (the
  journal and the CLI's ``--supervise`` recover its sessions).
- **The write-ahead journal** (``journal_dir`` / ``journal``,
  ``serve_journal.py``): an admit frame before a request's first device
  work, a delta frame a harvest (after the eos trim), an end frame at its
  terminal event, committed at each harvest; ``serve_detailed(recovery=)``
  dedups a journal's completed requests and re-admits its open sessions as
  prompt + emitted continuations (the seed materialised first).

Admission is FIFO by default: a free row always takes the queue head. A
request whose segment-rounded budget can never fit a row would block the
head forever, so it fails up front, everything else is served; the legacy
:meth:`ContinuousBatcher.serve` then raises :class:`HorizonError` carrying
the completed outputs. ``admit_policy="skip_fit"`` keeps that no-leapfrog
order among requests that fit and skips the others in place, reporting
them the same way.

Not ported yet: ``reload_weights`` and telemetry (the int8 pool's other
``kvq`` counters, the gauges of ``spec``, ``width``, ``tier``, ``kvq``,
``journal`` and ``fleet``, which the batcher keeps as plain counter dicts,
the SLO histograms, heartbeats and flight records), and the router's
width- and verify-priced load estimates.
"""

from __future__ import annotations

import functools
import inspect
import threading
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from distributed_compute_pytorch_tpu_torch.device import resolve_device
from distributed_compute_pytorch_tpu_torch.infer import (
    sample_rows, verify_sample_rows)
from distributed_compute_pytorch_tpu_torch.kv_pool import (
    TIER_DEVICE, TIER_HOST, BlockPool, PoolExhausted, RadixCache)
from distributed_compute_pytorch_tpu_torch.kv_tier import (
    TIER_STATS, DiskTier, HostBlockPool, KVTierManager, _crc, as_bits,
    dtype_name, host_blocks_for_mb, to_numpy, to_torch)
from distributed_compute_pytorch_tpu_torch.ops.attention import (
    gather_kv_blocks)
from distributed_compute_pytorch_tpu_torch.ops.cache_update import (
    kv_pool_insert)
from distributed_compute_pytorch_tpu_torch.ops.decode_attention import (
    merge_scratch)
from distributed_compute_pytorch_tpu_torch.serve_journal import (
    JOURNAL_STATS, ServeJournal)
from distributed_compute_pytorch_tpu_torch.serve_lifecycle import (
    CANCELLED, FAILED, OK, SHED, TIMEOUT, RequestResult, TickTimeout, spin)
from distributed_compute_pytorch_tpu_torch.spec_decode import (
    SpecConfig, make_proposer)
from distributed_compute_pytorch_tpu_torch.utils.graphs import capture

# the reference's default block size for float pools (its Pallas slot
# window); the CUDA kernels take any block size, int8 pools too (the
# reference's 32-slot int8 alignment is a TPU tiling rule)
DEFAULT_BLOCK_TOKENS = 8
KV_DTYPES = ("bf16", "int8")
ADMIT_POLICIES = ("fifo", "skip_fit")
# the tick watchdog's poll interval: the timed harvest checks its segment's
# event this often (``_Fetch.result``)
POLL_S = 1e-4


@dataclass
class Request:
    """One generation request: ``tokens`` (prompt ids) in, up to
    ``max_new`` continuations out (fewer if ``eos_id`` fires).

    ``temperature`` 0 (default) decodes greedily; above 0 samples, with
    optional ``top_k`` / ``top_p`` truncation (both need a temperature
    above 0). ``seed`` fixes the request's sampling stream; ``None`` means
    the request's index in the ``serve`` call, so a whole call is
    deterministic by default.

    ``deadline_s`` is a wall-clock budget from submission (the
    ``serve_detailed`` call): a request still queued when it expires ends
    ``timeout`` with no device work, one in flight is cut at the next
    segment boundary with its partial stream. ``arrival_s`` is an
    open-loop arrival offset from the call's start: the request is not
    admitted before it (0 = everything arrives at submission).
    ``request_id`` is the stable identity journal recovery dedups by
    (``None`` = ``req-{i}``, the request's position in the call)."""

    tokens: list
    max_new: int
    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    seed: int | None = None
    deadline_s: float | None = None
    arrival_s: float = 0.0
    request_id: str | None = None


@dataclass
class _Slot:
    """Host-side bookkeeping for one cache row."""

    req_index: int = -1        # position in the request list (-1 = free)
    remaining: int = 0
    out: list = field(default_factory=list)
    admit_seq: int = -1        # admission order (poison-row eviction)
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
        self.admit_seq = -1
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

    def done(self) -> bool:
        """Has the copy landed? (``event.query()``: no sync.)"""
        return self._event is None or self._event.query()

    def result(self, timeout_s: float | None = None,
               hang_s: float = 0.0) -> np.ndarray:
        """The tokens. Without ``timeout_s`` the wait is the event's
        ``synchronize``; with it (the tick watchdog) the wait polls
        ``event.query()`` every ``POLL_S`` and raises
        :class:`~serve_lifecycle.TickTimeout` once ``timeout_s`` is spent:
        no thread, no blocking sync. ``hang_s`` (a CPU chaos drill) holds
        the data back that long, inside the poll."""
        if timeout_s is None:
            if hang_s:
                time.sleep(hang_s)
            if self._event is not None:
                # the harvest's wait for its own segment, the serve loop's
                # one intended host sync: allowed even under
                # torch.cuda.set_sync_debug_mode("error"), and only here
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode(0)
                try:
                    self._event.synchronize()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            return self._host.numpy()
        t0 = time.monotonic()
        while not (self.done() and time.monotonic() - t0 >= hang_s):
            if time.monotonic() - t0 >= timeout_s:
                raise TickTimeout(f"tick harvest exceeded {timeout_s:g}s "
                                  f"(hung device)")
            time.sleep(POLL_S)
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
      speculate: speculative decoding (module docstring): an int ``k``
        (``k`` drafts a verify step from the n-gram proposer) or a
        ``spec_decode.SpecConfig``; ``None`` = off. Needs a block with
        ``verify_step``.
      decode_width_buckets: keep the widest this many rungs of the width
        ladder (module docstring); ``1`` (default) = the full-width table
        alone, ``None`` = every rung.
      host_cache_mb, host_cache_blocks: the host tier (module docstring),
        sized in MB of K/V (scales included) or in blocks; needs
        ``prefix_cache``.
      disk_cache_dir: the disk tier's directory, below a host tier; parts
        already there whose geometry, dtype and weights version match are
        adopted.
      max_pending: bounded admission: ``serve_detailed`` accepts at most
        ``slots + max_pending`` requests and sheds the rest at submission;
        ``None`` = unbounded.
      tick_timeout_s: the tick watchdog's budget a harvest (module
        docstring); ``None`` = off.
      max_recoveries: reconstructions a call before the remaining requests
        fail with the device's error (default 2).
      journal, journal_dir, journal_fsync: the write-ahead session journal
        (a shared ``serve_journal.ServeJournal``, or one opened in
        ``journal_dir`` with its fsync policy, which stamps this pool's
        ``kv_dtype`` and ``weights_version`` in a config frame).
      device: ``None``/``"cuda"`` (raises without CUDA) or ``"cpu"``.

    Counters: ``stats`` (prefill waves, their rows and those that ran a
    device forward (``prefill_forwards``), dispatched ``segments`` (verify
    steps included; the chaos hooks count these), ``fetches`` and the
    overlapped ones, eager, captured, replayed and sampled segments,
    ``faults``, ``reconstructions``, ``reconstruction_rows`` and
    ``recovery_s``, and the prefix cache's
    ``prefix_hits``, ``cached_prefix_tokens``, ``prefill_tokens_saved``,
    ``cow_copies`` and peak ``block_pool_occupancy``), ``prefill`` (the
    chunk counters: ``chunked_admissions``, ``chunk_waves``,
    ``chunk_tokens``, ``stall_ticks``), and after each serve call
    ``last_slot_leaks``, ``last_block_leaks`` (pool references the radix
    tree does not account for), ``last_ttft_s`` (each request's arrival to
    its first harvested token), ``last_cached_prefix``
    (each request's attached length) and ``last_admissions`` (request
    indices, one list a wave, in admission order); ``spec`` (speculation:
    ``proposed`` and ``accepted`` drafts, ``acceptance_rate``,
    ``emitted_tokens``, ``wasted_verify_tokens``, ``verify_segments``,
    ``autodisabled``) and ``width`` (the ladder: ``bucket_growths``, the
    last ``bucket_blocks`` and ``bucket_occupancy``, ``gathered_block_reads``
    against ``full_width_block_reads`` (table blocks a dispatch's programs
    see, row by layer by tick), ``bytes_saved_vs_full``,
    ``prewarmed_programs``); ``tier`` (demotions, promotions, host and
    disk hits, disk spills, CRC misses and adoptions, bytes D2H and H2D,
    ``promote_overlap_ms``, peak ``host_pool_occupancy``) and
    ``last_host_block_leaks``; the handoff's ``prefill["handoff_*"]``,
    ``kvq`` (``bytes_saved_d2h``, ``bytes_saved_handoff``,
    ``handoff_dtype_declined``), ``fleet["version_declined"]`` and
    ``journal`` (``serve_journal.JOURNAL_STATS``: frames, bytes, fsyncs,
    torn tails, recovered sessions, deduped completions, replayed tokens),
    under the reference's keys.
    """

    def __init__(self, model, params=None, *, slots: int, t_max: int,
                 prompt_buf: int, segment: int = 16,
                 eos_id: int | None = None, admit_policy: str = "fifo",
                 kv_block_tokens: int | None = None,
                 prefix_cache: bool = False,
                 pool_blocks: int | None = None,
                 prefill_chunk_tokens: int | None = None,
                 kv_dtype: str = "bf16", speculate=None,
                 decode_width_buckets: int | None = 1,
                 host_cache_mb: float | None = None,
                 host_cache_blocks: int | None = None,
                 disk_cache_dir: str | None = None,
                 max_pending: int | None = None,
                 tick_timeout_s: float | None = None,
                 max_recoveries: int = 2, journal=None,
                 journal_dir: str | None = None,
                 journal_fsync: str = "every_harvest", device=None):
        self.device = resolve_device(device)
        if max_pending is not None and max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        if tick_timeout_s is not None and tick_timeout_s <= 0:
            raise ValueError(
                f"tick_timeout_s must be > 0, got {tick_timeout_s}")
        if max_recoveries < 0:
            raise ValueError(
                f"max_recoveries must be >= 0, got {max_recoveries}")
        self.max_pending = max_pending
        self.tick_timeout_s = tick_timeout_s
        self.max_recoveries = max_recoveries
        if host_cache_mb is not None and host_cache_mb <= 0:
            raise ValueError(
                f"host_cache_mb must be > 0, got {host_cache_mb}")
        if host_cache_blocks is not None and host_cache_blocks < 1:
            raise ValueError(
                f"host_cache_blocks must be >= 1, got {host_cache_blocks}")
        tier_on = (host_cache_mb is not None or host_cache_blocks is not None
                   or disk_cache_dir is not None)
        if tier_on and not prefix_cache:
            raise ValueError(
                "host_cache_mb/host_cache_blocks/disk_cache_dir extend the "
                "radix prefix cache — they require prefix_cache=True")
        if (disk_cache_dir is not None and host_cache_mb is None
                and host_cache_blocks is None):
            raise ValueError(
                "disk_cache_dir needs a host tier to stage through (set "
                "host_cache_mb or host_cache_blocks)")
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
        if decode_width_buckets is not None and decode_width_buckets < 1:
            raise ValueError(f"decode_width_buckets must be >= 1 (1 = the "
                             f"full-width table alone), got "
                             f"{decode_width_buckets}")
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
        if speculate is not None:
            if not isinstance(speculate, SpecConfig):
                speculate = SpecConfig(k=int(speculate))
            if not hasattr(model.blocks[0], "verify_step"):
                raise ValueError(
                    f"speculate needs a block with verify_step; "
                    f"{type(model.blocks[0]).__name__} has none")
            self._proposer = make_proposer(speculate)
        else:
            self._proposer = None
        self._spec = speculate
        self._spec_w = speculate.k + 1 if speculate is not None else 0
        self._spec_on = speculate is not None
        self._spec_win = [0, 0]       # (proposed, accepted) this window
        self.B = slots
        self.Tb = prompt_buf
        self.S = segment
        self.eos_id = eos_id
        self.admit_policy = admit_policy
        self.bt = kv_block_tokens or DEFAULT_BLOCK_TOKENS
        self.t_max = -(-t_max // self.bt) * self.bt
        self.nb = self.t_max // self.bt          # table entries per row
        # the width ladder: powers of two of blocks capped at nb, the
        # widest ``decode_width_buckets`` kept (reference ``:612-632``)
        ladder, w = [], 1
        while w < self.nb:
            ladder.append(w)
            w *= 2
        ladder.append(self.nb)
        if decode_width_buckets is not None:
            ladder = ladder[-decode_width_buckets:]
        self._width_ladder = tuple(ladder)
        self._cur_width = self._width_ladder[0]
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
        # one static table buffer a rung (the full width's is _tables_dev)
        self._tables_w = {w: torch.zeros(slots, w, dtype=torch.int32,
                                         device=dev)
                          for w in self._width_ladder}
        self._tables_dev = self._tables_w[self.nb]
        self._pos0 = torch.zeros(slots, dtype=torch.int32, device=dev)
        self._cur_tok = torch.zeros(slots, dtype=torch.long, device=dev)
        self._n_logical = torch.zeros(slots, dtype=torch.long, device=dev)
        self._temp = torch.zeros(slots, device=dev)
        self._topk = torch.zeros(slots, dtype=torch.long, device=dev)
        self._topp = torch.full((slots,), 2.0, device=dev)
        self._seed = torch.zeros(slots, dtype=torch.long, device=dev)
        self._toks = torch.zeros(slots, segment, dtype=torch.long, device=dev)
        # the verify program's: each row's window (current token, drafts),
        # its logical count and the model's own tokens ``true``
        W = max(self._spec_w, 1)
        self._vtok = torch.zeros(slots, W, dtype=torch.long, device=dev)
        self._vnlog = torch.zeros(slots, dtype=torch.long, device=dev)
        self._vtrue = torch.zeros(slots, W, dtype=torch.long, device=dev)
        self._wrange = torch.arange(W, dtype=torch.int32, device=dev)
        # their host copies, set at admission
        self._temp_h = np.zeros(slots, np.float32)
        self._topk_h = np.zeros(slots, np.int64)
        self._topp_h = np.full(slots, 2.0, np.float32)
        self._seed_h = np.zeros(slots, np.int64)
        # host mirrors of _cur_tok/_n_logical (reference ``:736-744``): the
        # verify path builds its windows on the host and runs off these,
        # so under speculation the device copies go stale; admission sets
        # both, and auto-disable pushes the mirrors back before the next
        # plain segment
        self._cur_h = np.zeros(slots, np.int64)
        self._nlog_h = np.zeros(slots, np.int64)
        # on CUDA each program, keyed (kind "segment" or "verify",
        # sampling, rung), is captured at its second dispatch (False: the
        # eager loop on the card, the reference the card's checks hold the
        # graphs to), all into one memory pool: they replay on one stream,
        # never at once, and hand back only static buffers. The captured
        # programs (``graphs.Program``) and each one's eager dispatches so
        # far; the merge scratch of the segments' decode reads and of the
        # verify steps' reads (apart: their sizes differ)
        self._capture = dev.type == "cuda"
        self._mempool = (torch.cuda.graph_pool_handle() if self._capture
                         else None)
        self._programs: dict = {}
        self._eager_runs: dict = {}
        self._scratch: dict = {}
        self._vscratch: dict = {}
        self._pool = BlockPool(pool_blocks)
        self._tables = np.full((slots, self.nb), BlockPool.TRASH, np.int32)
        self._radix = RadixCache(self._pool, self.bt) if prefix_cache else None
        self.kv_dtype = kv_dtype
        # the version of the weights that computed the pool's K/V: stamped
        # into disk sidecars and handoff payloads, and checked on adoption
        # and import
        self.weights_version = 0
        # hierarchical KV (kv_tier.py): a host block pool (pinned on CUDA)
        # and an optional CRC-checked disk tier below it, that eviction
        # demotes into and admission promotes from (reference ``:702-725``)
        self._tier = None
        self._tier_promote_t0 = None
        self.tier = dict(TIER_STATS)
        self.fleet = {"version_declined": 0}
        if tier_on:
            leaf = self._caches[0]["kv"]
            q8 = kv_dtype == "int8"
            hb = (host_cache_blocks if host_cache_blocks is not None
                  else host_blocks_for_mb(host_cache_mb, len(self._caches),
                                          hk, self.bt, hd, leaf.element_size(),
                                          scale_itemsize=4 if q8 else 0))
            self._tier = KVTierManager(
                self._radix,
                HostBlockPool(hb, len(self._caches), hk, self.bt, hd,
                              leaf.dtype,
                              scale_dtype=torch.float32 if q8 else None,
                              device=self.device),
                DiskTier(disk_cache_dir, async_writes=True)
                if disk_cache_dir else None, stats=self.tier)
            self._tier.weights_version = self.weights_version
            self._tier.fleet_stats = self.fleet
        # per-row slot of the last written token (host-tracked: admission
        # rewinds a row to its head length - 1; each segment advances
        # every row by S; parked rows sit at 0 writing into trash)
        self._row_pos = [0] * slots
        self.ticks = 0
        self.stats = {"prefill_calls": 0, "prefill_rows": 0,
                      "prefill_forwards": 0, "segments": 0, "fetches": 0,
                      "fetches_overlapped": 0, "eager_segments": 0,
                      "graph_captures": 0, "graph_replays": 0,
                      "sampled_segments": 0, "prefix_hits": 0,
                      "cached_prefix_tokens": 0, "prefill_tokens_saved": 0,
                      "cow_copies": 0, "block_pool_occupancy": 0.0,
                      "faults": 0, "reconstructions": 0,
                      "reconstruction_rows": 0, "recovery_s": 0.0}
        self.prefill = {"chunked_admissions": 0, "chunk_waves": 0,
                        "chunk_tokens": 0, "stall_ticks": 0,
                        "handoff_exports": 0, "handoff_imports": 0,
                        "handoff_declined": 0, "handoff_bytes": 0}
        # the int8 pool's byte savings on the tier's and the handoff's
        # copies, and handoffs declined for a pool-dtype mismatch
        self.kvq = {"bytes_saved_d2h": 0, "bytes_saved_handoff": 0,
                    "handoff_dtype_declined": 0}
        self.spec = {"proposed": 0, "accepted": 0, "acceptance_rate": 0.0,
                     "wasted_verify_tokens": 0, "verify_segments": 0,
                     "emitted_tokens": 0, "autodisabled": 0}
        self.width = {"bucket_blocks": 0, "bucket_occupancy": 0.0,
                      "gathered_block_reads": 0, "full_width_block_reads": 0,
                      "bytes_saved_vs_full": 0, "bucket_growths": 0,
                      "prewarmed_programs": 0}
        # the bytes one gathered table block stands for in a (row, layer):
        # both planes of every pool leaf (the unit of bytes_saved_vs_full)
        self._gather_block_bytes = sum(
            leaf.element_size() * leaf.numel() // leaf.shape[1]
            for leaf in self._caches[0].values())
        self.last_slot_leaks = 0   # rows still owned at serve() exit
        self.last_block_leaks = 0  # pool refs unaccounted at serve() exit
        self.last_ttft_s: list = []  # per request: arrival -> 1st token
        self.last_cached_prefix: list = []  # per request: attached length
        self.last_admissions: list = []     # request indices, a list a wave
        self.last_host_block_leaks = 0  # host blocks unaccounted at exit
        # the request lifecycle: cancel() marks a request of the call in
        # flight (from any thread), police() reads the marks between device
        # calls
        self._cancel_mu = threading.Lock()
        self._cancelled: set[int] = set()
        # segments cut by the tick watchdog (and segments dispatched past a
        # fault), still on the stream: kept until their events complete, so
        # their pinned buffers live as long as their copies, and never read
        self._stale: list[_Fetch] = []
        # the write-ahead session journal (serve_journal.py): a shared
        # writer wins over journal_dir; one opened here stamps this pool's
        # kv_dtype and weights_version in a config frame. Its counters are
        # the writer's (``journal``); these are used only without a writer
        if journal is None and journal_dir is not None:
            journal = ServeJournal(journal_dir, fsync=journal_fsync)
            journal.config({"kv_dtype": kv_dtype,
                            "weights_version": self.weights_version})
        self._journal = journal
        self._no_journal_stats = dict(JOURNAL_STATS)
        # recovery replays' admission records for the duration of one
        # _run: sub-request index -> (request id, original prompt, tokens
        # already emitted), so the admit frame records the true session
        self._replay_admits: dict = {}
        # a restarted disk tier re-enters the radix (reference ``:762-779``):
        # parts whose sidecars carry their prefix tokens and match this
        # pool's geometry, dtype and weights version become TIER_DISK
        # entries, promoted on their first hit
        if self._tier is not None and self._tier.disk is not None:
            L = len(self._caches)
            name = dtype_name(self._caches[0]["kv"].dtype)

            def expect(n):
                shape = (L, 2, -(-n // self.bt), hk, self.bt)
                if kv_dtype == "int8":
                    return (*shape, hd), name, (*shape, 1), "float32"
                return (*shape, hd), name
            self._tier.adopt_disk_index(expect)

    @property
    def _graph(self):
        """The captured full-width greedy segment (``None`` until it is
        captured)."""
        return self._programs.get(("segment", False, self.nb))

    def clear_prefix_cache(self) -> None:
        """Drop every radix entry and the pool references it holds, and zero
        and sweep every tier below it (between ``serve`` calls), so the next
        call starts from a cold cache."""
        if self._radix is not None:
            self._radix.clear()
        if self._tier is not None:
            self._tier.reset()

    def reset(self) -> None:
        """A fresh session on the same programs (reference ``:1275-1300``):
        the pool zeroed in place, every block freed, the radix cache
        dropped, every row rewound, and speculation's auto-disable
        un-stuck, every tier zeroed and swept. The static buffers keep their
        addresses, so captured programs stay valid."""
        self.clear_prefix_cache()
        self._pool.reset()
        self._tables[:] = BlockPool.TRASH
        for cache in self._caches:
            for leaf in cache.values():
                leaf.zero_()
        for buf in (self._cur_tok, self._n_logical, self._temp, self._topk,
                    self._seed):
            buf.zero_()
        self._topp.fill_(2.0)
        self._row_pos = [0] * self.B
        self._temp_h[:] = 0.0
        self._topk_h[:] = 0
        self._topp_h[:] = 2.0
        self._seed_h[:] = 0
        self._cur_h[:] = 0
        self._nlog_h[:] = 0
        self._spec_win = [0, 0]
        self._spec_on = self._spec is not None
        self._cur_width = self._width_ladder[0]
        self.ticks = 0

    # ---- the prefix handoff ----------------------------------------------

    def prefix_match_len(self, tokens) -> int:
        """Affinity probe (reference ``:1006-1021``): how many of
        ``tokens``'s prompt-head tokens the radix cache holds, in ANY tier
        (a demoted prefix is one copy from the device). Read-only: no LRU
        stamp, no refcount. 0 with the cache off."""
        if self._radix is None or len(tokens) < 2:
            return 0
        return self._radix.longest_match_len(list(tokens)[:-1])

    def export_prefix(self, tokens) -> dict | None:
        """Handoff export (reference ``:1023-1079``): the longest cached
        prefix of ``tokens``'s prompt head as portable bytes — ``{"tokens",
        "n_tokens", "kv" [L, 2, nb, hk, bt, hd], "crc", "bt", "kv_dtype",
        "weights_version"}``, plus ``"scale"`` and ``"scale_crc"`` for an
        int8 pool — for another batcher's :meth:`import_prefix`. Numpy in
        the reference's layout; a bf16 pool's ``kv`` is its ``uint16`` bit
        patterns (so its ``crc`` is the reference's for the same bits).
        Read-only: a device entry is gathered and copied D2H (this host
        call waits for that copy), a demoted one read without releasing
        its tier copy. None = nothing to export (cache off, no match, or a
        disk part failing its CRC): the caller prefills instead."""
        if self._radix is None or len(tokens) < 2:
            return None
        head = list(tokens)[:-1]
        m, entry = self._radix.match_entry(head)
        m = min(m, len(head))
        if m < 1:
            return None
        k = -(-m // self.bt)
        if entry.tier == TIER_DEVICE:
            content = self._host_copy(self._peek_blocks(entry.blocks[:k]))
        elif entry.tier == TIER_HOST:
            content = self._tier.host.read(entry.host_blocks[:k])
        else:                               # TIER_DISK
            self._tier.disk.drain()         # the part as written: numpy
            got, _corrupt = self._tier.disk.get(entry.disk_key)
            if got is None:
                return None                 # CRC miss: the caller prefills
            content = {name: leaf[:, :, :k]
                       for name, leaf in self._as_content(got).items()}
        content = self._as_content(content)
        kv = content["kv"]
        total = sum(int(leaf.nbytes) for leaf in content.values())
        self.prefill["handoff_exports"] += 1
        self.prefill["handoff_bytes"] += total
        payload = {"tokens": tuple(head[:m]), "n_tokens": m,
                   "kv": kv, "crc": _crc(kv), "bt": self.bt,
                   "kv_dtype": self.kv_dtype,
                   "weights_version": self.weights_version}
        if "scale" in content:
            payload["scale"] = content["scale"]
            payload["scale_crc"] = _crc(content["scale"])
            # the float payload would be 2 bytes an element of kv alone
            self.kvq["bytes_saved_handoff"] += int(kv.nbytes) * 2 - total
        return payload

    @staticmethod
    def _as_content(content) -> dict:
        """Tier and handoff content as a dict: a bare array is the float
        pool's ``kv``-only form (reference ``:1090-1095``)."""
        return content if isinstance(content, dict) else {"kv": content}

    def import_prefix(self, payload) -> bool:
        """Handoff import (reference ``:1097-1195``): land an
        :meth:`export_prefix` payload (this package's or the reference's) in
        this batcher's prefix cache, so the next admission of the same
        prompt attaches instead of prefilling. With a host tier the bytes
        enter as a demoted entry (promoted on the first match); without
        one they are scattered into fresh pool blocks. False = declined,
        nothing changed: a ``kv_dtype`` stamp mismatch
        (``kvq["handoff_dtype_declined"]``), a ``weights_version`` mismatch
        (``fleet["version_declined"]``), or a block size, shape, element
        type, ``crc`` or (int8) scale shape or ``scale_crc`` mismatch, or no
        room; each counts ``prefill["handoff_declined"]``, none raises."""
        if self._radix is None or not payload:
            return False
        if payload.get("kv_dtype", "bf16") != self.kv_dtype:
            self.kvq["handoff_dtype_declined"] += 1
            self.prefill["handoff_declined"] += 1
            return False
        if int(payload.get("weights_version", 0)) != self.weights_version:
            self.fleet["version_declined"] += 1
            self.prefill["handoff_declined"] += 1
            return False
        kv = payload.get("kv")
        scale = payload.get("scale")
        n = int(payload.get("n_tokens", 0))
        toks = tuple(payload.get("tokens", ()))
        leaf = self._caches[0]["kv"]
        k = -(-n // self.bt)
        want = (len(self._caches), 2, k, leaf.shape[2], self.bt,
                leaf.shape[4])
        swant = (*want[:-1], 1)
        # the pool's element type as numpy holds it (bf16: uint16 bits)
        elem = dtype_name(leaf.dtype)
        elem = "uint16" if elem == "bfloat16" else elem
        if kv is not None:
            kv = as_bits(kv)
        if (kv is None or n < 1 or len(toks) != n
                or payload.get("bt") != self.bt
                or tuple(kv.shape) != want
                or str(kv.dtype) != elem
                or payload.get("crc") != _crc(kv)
                or (self.kv_dtype == "int8"
                    and (scale is None or tuple(scale.shape) != swant
                         or payload.get("scale_crc") != _crc(scale)))
                or (self.kv_dtype != "int8" and scale is not None)):
            self.prefill["handoff_declined"] += 1
            return False
        content = {"kv": np.ascontiguousarray(kv)}
        if scale is not None:
            content["scale"] = np.ascontiguousarray(scale, np.float32)
        total = sum(int(a.nbytes) for a in content.values())
        saved = int(kv.nbytes) * 2 - total if scale is not None else 0
        if self._tier is not None:
            entry = self._radix.insert_demoted(toks)
            if entry is None:      # already cached here: a handoff hit
                self.prefill["handoff_imports"] += 1
                return True
            if self._tier.store(entry, content if scale is not None
                                else content["kv"]):
                self.prefill["handoff_imports"] += 1
                self.prefill["handoff_bytes"] += total
                self.kvq["bytes_saved_handoff"] += saved
                return True
            # no host room even after spilling: drop the placeholder and
            # take the direct-device path
            self._tier._remove(entry)
        try:
            blocks = self._alloc(k)
        except PoolExhausted:
            self.prefill["handoff_declined"] += 1
            return False
        self._scatter_blocks(blocks, content)
        # the tree owns the references from here; drop the alloc's
        self._radix.insert(toks, blocks)
        self._pool.release(blocks)
        self.prefill["handoff_imports"] += 1
        self.prefill["handoff_bytes"] += total
        self.kvq["bytes_saved_handoff"] += saved
        return True

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

    def _peek_blocks(self, blocks) -> dict:
        """Pool ``blocks`` across every layer, gathered on the device (the
        reference's XLA gather, ``:1081-1088``): ``{"kv"[, "scale"]}``, each
        one fresh block-major ``[n, L, 2, hk, bt, hd]`` tensor (the host
        slab's layout: a run of host blocks is one D2H copy) filled by one
        ``index_select`` a layer and handed back as its ``[L, 2, n, hk, bt,
        hd]`` view; enqueued on the stream, so before any later write into
        those blocks."""
        idx = self._to_device(np.asarray(blocks, np.int64))
        out = {}
        for name, leaf in self._caches[0].items():
            buf = torch.empty(len(blocks), len(self._caches), 2,
                              *leaf.shape[2:], dtype=leaf.dtype,
                              device=leaf.device)
            for li, cache in enumerate(self._caches):
                torch.index_select(cache[name], 1, idx,
                                   out=buf[:, li].transpose(0, 1))
            out[name] = buf.movedim(0, 2)
        return out

    def _host_copy(self, content: dict) -> dict:
        """Device content as numpy (bf16 as ``uint16`` bits), for an export:
        on CUDA through pinned memory and an event this host call waits on
        (between ``serve`` calls)."""
        if self.device.type == "cpu":
            return {k: to_numpy(v) for k, v in content.items()}
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in content.items()}
        for k, v in content.items():
            host[k].copy_(v, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        return {k: to_numpy(v) for k, v in host.items()}

    def _scatter_blocks(self, blocks, content: dict) -> None:
        """Write ``content`` (``{"kv"[, "scale"]}``, ``[L, 2, n, ...]``:
        device tensors from the host tier, numpy from the disk tier or a
        handoff, or a spill's pinned CPU tensors not yet written to disk)
        into pool ``blocks`` of every layer, IN PLACE (the reference rebinds
        its caches to ``_promote_c``'s output; the captured programs here
        hold the pool's addresses). Int8 bytes and scales land as they are.
        On CUDA host content is staged through pinned memory (a pinned
        tensor is its own stage) and every copy is ``non_blocking``,
        enqueued before the wave that reads the blocks."""
        dst = self._to_device(np.asarray(blocks, np.int64))
        for name, src in content.items():
            if not isinstance(src, torch.Tensor):
                src = to_torch(src, self._caches[0][name].dtype)
            if src.device.type != self.device.type:
                src = src.pin_memory().to(self.device, non_blocking=True)
            for li, cache in enumerate(self._caches):
                cache[name].index_copy_(1, dst, src[li])

    def _prefill_wave(self, entries, window: int | None = None):
        """ONE multi-row prefill of ``entries`` ``(row, known, from_m,
        upto)`` (reference ``:3025-3130``): each entry's head tokens
        ``known[from_m:upto]`` at logical positions ``from_m..upto-1``
        (past its resident prefix: the attached length at admission, or
        chunked prefill's progress mark) from column 0 of a ``window``-wide
        batch, their K/V scattered to the row's blocks. ``window`` defaults
        to ``prompt_buf`` when nothing is resident, the chunk with chunking
        on, else the block-rounded longest suffix; reconstruction passes
        the width its grown heads need. An entry reaching its
        head (``upto == len(known) - 1``) finalises: its last known token
        becomes the row's current token and the row rewinds to ``head_len
        - 1``; a mid-chunk entry stays parked. A wave with no suffix token
        runs no device work but that. Dispatch only — no fetch."""
        bt = self.bt
        suffixes = [upto - m for _, _, m, upto in entries]
        max_m = max(m for _, _, m, _ in entries)
        if window is None and self._chunk is not None:
            window = self._chunk
        elif window is None:
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
                self._cur_h[b] = known[-1]           # the host mirrors
                self._nlog_h[b] = len(known) - 1

    def _reconstruct(self, table, requests, fin, free_row) -> None:
        """Device-failure session reconstruction (reference
        ``:3131-3213``): rebuild every live row's K/V by re-prefilling
        ``prompt + harvested tokens`` from host state, then resume decode.

        The host knows each live row's whole prefix and its true remaining
        budget; re-prefilling it at the same logical positions reproduces
        the lost K/V, and a row's draws depend on (seed, logical position)
        alone, so the resumed stream is the uninterrupted one (exactly in
        f32; in bf16 the one-wave prefill rounds otherwise than the ticks
        that wrote those keys). Tokens generated but never harvested are
        recomputed.

        The reference rebinds its caches to fresh zeros; here the captured
        segment, verify and width programs hold the pool's and the static
        buffers' addresses, so each is zeroed IN PLACE (``zero_``: the
        pool's leaves, the int8 scales with them, the device block tables
        and the carried tokens and logical counts) and the programs replay
        afterwards, uncaptured again. Everything is enqueued on the stream
        behind whatever is still running there (a segment the watchdog cut
        included), so stream order keeps the zeroing and the re-prefill
        after its writes. The radix cache is cleared before the pool resets
        (its entries point at zeroed blocks) and the tiers reset with it (a
        stale entry promoted later would attach to the pre-fault K/V).

        Rows whose grown head no longer fits (window + segment-rounded
        remaining > ``t_max``) end ``failed`` with their partial stream.
        Rows re-prefill in waves grouped by window: ``prompt_buf`` while the
        head fits it, else the next block-aligned width; a row that was
        mid-chunk replays its whole head in one wave."""
        if self._radix is not None:
            self._radix.clear()
        if self._tier is not None:
            self._tier.reset()
        for slot in table:
            slot.blocks = []
        self._pool.reset()
        self._tables[:] = BlockPool.TRASH
        for cache in self._caches:
            for leaf in cache.values():
                leaf.zero_()
        for buf in (self._cur_tok, self._n_logical, self._pos0,
                    *self._tables_w.values()):
            buf.zero_()              # the trash block's id is 0
        self._row_pos = [0] * self.B
        waves: dict[int, list] = {}
        for b, slot in enumerate(table):
            if slot.req_index < 0:
                continue
            slot.pf_known, slot.pf_done = None, 0
            req = requests[slot.req_index]
            known = list(req.tokens) + list(slot.out)
            head = len(known) - 1
            W = self.Tb if head <= self.Tb else -(-head // self.bt) * self.bt
            remaining = req.max_new - len(slot.out)
            if W + self._rounded_need(remaining) > self.t_max:
                fin(slot.req_index, FAILED, slot.out,
                    f"reconstruction needs window {W} + "
                    f"{self._rounded_need(remaining)} decode slots > "
                    f"t_max={self.t_max} (raise t_max for "
                    f"fault-tolerance headroom)")
                free_row(b)
                continue
            waves.setdefault(W, []).append((b, slot, known, remaining))
        for W, rows in sorted(waves.items()):
            for b, slot, known, remaining in rows:
                # the radix is empty: always fresh blocks, never dead K/V
                self._assign_blocks(b, slot, known, remaining)
            self._prefill_wave([(b, known, 0, len(known) - 1)
                                for b, _, known, _ in rows], W)
            for b, slot, known, remaining in rows:
                # the in-flight plan's budget decrement died with the
                # segment: the host's count is the truth
                slot.remaining = remaining
            self.stats["reconstruction_rows"] += len(rows)

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

    @property
    def journal(self) -> dict:
        """The journal's counters (``serve_journal.JOURNAL_STATS``): the
        writer's own dict, or the batcher's when it has no writer (a
        ``recovery=`` call still counts its dedups and replays)."""
        return (self._no_journal_stats if self._journal is None
                else self._journal.stats)

    def _dispatch(self, key, fn, wait=None):
        """Run program ``key`` (kind, sampling, rung) whose work is ``fn``:
        on CUDA its first dispatch eagerly, its second captured as a CUDA
        graph (into the batcher's memory pool) and replayed, every later
        one replayed; on the CPU every dispatch eagerly. A failed capture
        or replay raises. ``wait`` is called before an eager run or a
        capture, never before a replay (one launch)."""
        program = self._programs.get(key)
        if program is None:
            if wait is not None:
                wait()
            if not (self._capture and self._eager_runs.get(key)):
                fn()
                self._eager_runs[key] = self._eager_runs.get(key, 0) + 1
                self.stats["eager_segments"] += 1
                return
            kw = {} if self._mempool is None else {"pool": self._mempool}
            program = self._programs[key] = capture(fn, **kw)
            self.stats["graph_captures"] += 1
        program.replay()
        self.stats["graph_replays"] += 1

    def _segment(self, tables, positions0, sampling: bool,
                 width: int, wait=None) -> torch.Tensor:
        """Dispatch ``S`` decode ticks for every row at its OWN position
        (``positions0 [B]`` = each row's last written slot; tick ``i``
        writes slot ``positions0 + 1 + i``), drawing with
        ``infer.sample_rows`` when ``sampling``, over the first ``width``
        (a rung) table entries of ``tables``; ``wait`` as in
        :meth:`_dispatch`.
        Returns the static ``[B, S]`` token buffer, which the next dispatch
        overwrites (reference ``_segment_impl``)."""
        self._fill(self._tables_w[width],
                   np.ascontiguousarray(tables[:, :width]))
        self._fill(self._pos0, np.asarray(positions0, np.int32))
        self.stats["sampled_segments"] += sampling
        self._dispatch(("segment", sampling, width), functools.partial(
            self._decode_segment, sampling, width), wait)
        return self._toks

    def _decode_segment(self, sampling: bool, width: int) -> None:
        """The segment's work over the static buffers (a captured
        program): ``S`` ticks through rung ``width``'s table buffer, then
        the carried token and logical position and the ``[B, S]`` tokens
        written in place. ``sampling`` draws each row's token with its own
        settings, keyed on (its seed, the logical position of the token it
        consumes), as the reference folds ``n_logical + i`` into the row's
        key (``:1494-1500``)."""
        model = self.model
        table = self._tables_w[width]
        tok, n_log = self._cur_tok, self._n_logical
        out = []
        with merge_scratch(self._scratch):
            for i in range(self.S):
                pos = self._pos0 + (1 + i)
                x = model.embed(tok[:, None], n_log[:, None])
                for block, cache in zip(model.blocks, self._caches):
                    x, _ = block.decode_step(x, {**cache, "table": table},
                                             pos)
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

    def _verify(self, tables, toks, positions0, n_logical, sampling: bool,
                width: int) -> torch.Tensor:
        """Dispatch ONE verify step (reference ``_verify_impl``,
        ``:1530-1578``): ``toks [B, W]`` (column 0 each row's current
        token, then its drafts) at slots ``positions0 + 1 + i`` and logical
        counts ``n_logical + i``, over rung ``width``'s table. Returns the
        static ``[B, W]`` buffer of the model's own token after each column
        (argmax, or ``infer.verify_sample_rows``), which the next dispatch
        overwrites. Captured as :meth:`_segment` is."""
        self._fill(self._tables_w[width],
                   np.ascontiguousarray(tables[:, :width]))
        self._fill(self._pos0, np.asarray(positions0, np.int32))
        self._fill(self._vtok, np.asarray(toks, np.int64))
        self._fill(self._vnlog, np.asarray(n_logical, np.int64))
        self._dispatch(("verify", sampling, width), functools.partial(
            self._verify_step, sampling, width))
        return self._vtrue

    def _verify_step(self, sampling: bool, width: int) -> None:
        """The verify step's work over the static buffers (a captured
        program): the window embedded at its logical counts, every block's
        ``verify_step`` at its slots (one ``paged_verify_write`` launch a
        layer on the card), the readout, and the ``[B, W]`` ``true`` tokens
        written in place."""
        model = self.model
        table = self._tables_w[width]
        pos = self._pos0[:, None] + 1 + self._wrange[None, :]
        x = model.embed(self._vtok, self._vnlog[:, None] + self._wrange)
        with merge_scratch(self._vscratch):
            for block, cache in zip(model.blocks, self._caches):
                x, _ = block.verify_step(x, {**cache, "table": table}, pos)
        logits = model.readout(x)                       # [B, W, V]
        if sampling:
            true = verify_sample_rows(logits, self._temp, self._topk,
                                      self._topp, self._seed, self._vnlog)
        else:
            true = torch.argmax(logits, dim=-1)
        self._vtrue.copy_(true)

    # ---- width buckets ---------------------------------------------------

    def _bucket_width(self, need_slots: int) -> int:
        """The narrowest ladder rung (a table width, in blocks) covering
        ``need_slots`` logical slots, capped at the full table (reference
        ``:1726-1739``)."""
        need = min(self.nb, -(-max(1, need_slots) // self.bt))
        for w in self._width_ladder:
            if w >= need:
                return w
        return self._width_ladder[-1]

    def _note_width(self, nb_w: int, ticks: int, need_blocks: int) -> None:
        """A dispatch's width accounting (reference ``:1741-1765``): the
        rung chosen, how full it runs, a growth past the last rung, and the
        table blocks its programs see against the full width's (a row, a
        layer, a tick)."""
        if nb_w > self._cur_width:
            self.width["bucket_growths"] += 1
        self._cur_width = nb_w
        self.width["bucket_blocks"] = nb_w
        self.width["bucket_occupancy"] = need_blocks / nb_w
        layers = len(self._caches)
        reads = self.B * nb_w * layers * ticks
        full = self.B * self.nb * layers * ticks
        self.width["gathered_block_reads"] += reads
        self.width["full_width_block_reads"] += full
        self.width["bytes_saved_vs_full"] += (
            (full - reads) * self._gather_block_bytes)

    def prewarm_widths(self, *, sampling: bool = False) -> int:
        """Build every rung's programs NOW (reference ``:1767-1797``): the
        decode segment's (and, with speculation, the verify step's) for
        each ladder rung, over all-trash tables with every row parked at
        slot 0, so traffic never pays a rung's first eager run and capture
        mid-stream. On CUDA each program runs once eagerly and is captured
        (a program already captured is skipped); on the CPU each runs once.
        The throwaway ticks write only into the trash block; the carried
        tokens, logical counts and the trash block are rewound after, so
        the batcher serves as a fresh one does. Returns the number of
        rungs; ``width["prewarmed_programs"]`` counts the programs built."""
        kinds = ["segment"] + (["verify"] if self._spec is not None else [])
        with torch.no_grad():
            for w in self._width_ladder:
                tables = np.full((self.B, w), BlockPool.TRASH, np.int32)
                zeros = [0] * self.B
                for kind in kinds:
                    if (kind, sampling, w) in self._programs:
                        continue
                    for _ in range(2 if self._capture else 1):
                        if kind == "segment":
                            self._segment(tables, zeros, sampling, w)
                        else:
                            self._verify(tables, np.zeros(
                                (self.B, self._spec_w), np.int64), zeros,
                                zeros, sampling, w)
                    self.width["prewarmed_programs"] += 1
            for buf in (self._cur_tok, self._n_logical):
                buf.zero_()
            for cache in self._caches:
                for leaf in cache.values():
                    leaf[:, BlockPool.TRASH].zero_()
        return len(self._width_ladder)

    # ---- host scheduler --------------------------------------------------

    def _rounded_need(self, max_new: int) -> int:
        """Decode slots a request consumes past its head: the
        segment-rounded budget (a row runs whole segments). Under
        speculation exactly ``max_new`` (reference ``:1712-1722``): a verify
        step's emission is clamped to the budget, its drafted writes past
        the row's extent land in trash table entries or drop at the
        horizon, and a plain tail after auto-disable overshoots only into
        the row's own tail block or trash."""
        if self._spec is not None:
            return max_new
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
        if r.deadline_s is not None and r.deadline_s <= 0:
            return f"deadline_s must be > 0, got {r.deadline_s}"
        if r.arrival_s < 0:
            return f"arrival_s must be >= 0, got {r.arrival_s}"
        return None

    def _alloc(self, n: int) -> list:
        """``n`` fresh blocks, evicting least-recently-used radix entries
        first when the free list runs short (reference ``:1580-1594``;
        eviction frees refcount-0 blocks only, so live rows keep theirs);
        with a tier, eviction DEMOTES the victim to host memory instead of
        discarding it. Raises ``PoolExhausted`` if that is not enough."""
        if self._pool.free_count < n and self._radix is not None:
            self._radix.evict_for(n, on_evict=(
                self._tier_demote if self._tier is not None else None))
        return self._pool.alloc(n)

    def _tier_demote(self, entry, doomed) -> bool:
        """``RadixCache.evict_for``'s demotion hook (reference
        ``:1595-1611``): the WHOLE entry's blocks gathered on the device and
        copied D2H into the host tier, asynchronously — the gather is
        enqueued before any write that reuses the freed blocks, and nothing
        waits for the card. ``doomed`` is the hook's contract only: a block
        a live row shares survives on the device only as long as that row.
        True = demoted in place of discarded."""
        content = self._peek_blocks(entry.blocks)
        if "scale" in content:
            self.kvq["bytes_saved_d2h"] += (
                int(content["kv"].nbytes) - int(content["scale"].nbytes))
            return self._tier.store(entry, content)
        return self._tier.store(entry, content["kv"])

    def _promote_entry(self, entry) -> bool:
        """Restore a demoted entry to the device pool (reference
        ``:1613-1648``): fresh blocks (whose allocation may demote colder
        entries, never this one: the tier pins it), its bytes taken from
        the host tier (an H2D copy from the pinned slabs) or the disk tier,
        scattered into the blocks in place — enqueued now, before the
        wave's copy-on-write, prefill and first read. False = declined
        (pool pressure) or the disk part failed its CRC: the caller
        prefills instead, tokens unchanged."""
        k = -(-entry.n_tokens // self.bt)
        self._tier.pin = entry
        try:
            blocks = self._alloc(k)
        except PoolExhausted:
            return False
        finally:
            self._tier.pin = None
        content = self._tier.fetch(entry)
        if content is None:                  # disk CRC miss: entry gone
            self._pool.release(blocks)
            return False
        t0 = time.monotonic()
        self._scatter_blocks(blocks, self._as_content(content))
        entry.blocks = blocks                # the tree owns the refs now
        entry.tier = TIER_DEVICE
        self.tier["promotions"] += 1
        if self._tier_promote_t0 is None:
            self._tier_promote_t0 = t0
        return True

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
            # a demoted prefix is still a hit: promote it (reference
            # ``:1660-1676``); a declined promotion is a plain miss
            m, entry = self._radix.match_entry(head)
            if m and entry.tier != TIER_DEVICE and not self._promote_entry(
                    entry):
                m = 0
            src = list(entry.blocks) if m else []
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


    # ---- the request lifecycle ---------------------------------------------

    def cancel(self, request_index: int) -> None:
        """Cancel one request of the serve call in flight, by its index in
        that call's list (reference ``:1895``). Thread-safe: a front end
        calls it from another thread, a drill from a chaos ``on_segment``
        hook. A queued request ends ``cancelled`` with no device work; one
        in flight is cut at the next segment boundary with its partial
        tokens. Unknown or finished indices are ignored; the marks clear
        when a new serve call starts."""
        with self._cancel_mu:
            self._cancelled.add(int(request_index))

    def serve(self, requests: list[Request]) -> list[list[int]]:
        """Run every request through the pool; returns each request's
        generated tokens (trimmed at eos), in request order. The legacy
        all-or-nothing surface over the same engine as
        :meth:`serve_detailed` (reference ``:1907-1938``): invalid requests
        raise ``ValueError``; requests that can never fit a row raise
        :class:`HorizonError` after the rest complete."""
        for r in requests:
            err = self._validate_one(r)
            if err is not None:
                raise ValueError(err)
        with torch.no_grad():
            results = self._run(requests)
        outputs = [r.tokens if r.status == OK else [] for r in results]
        rejected = [i for i, r in enumerate(results)
                    if r.status != OK and r.error is not None
                    and "horizon" in r.error]
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

    def serve_detailed(self, requests: list[Request], *, drain=None,
                       drain_deadline_s: float | None = None,
                       chaos=None, recovery=None) -> list:
        """Fault-tolerant serving (reference ``:1940``): a
        :class:`~serve_lifecycle.RequestResult` per request, in request
        order; nothing raises the call away and no completed work is
        discarded.

        Validation failures and horizon-infeasible budgets come back
        ``failed`` with no device work; ``Request.deadline_s`` expiry
        returns the partial stream ``timeout``; :meth:`cancel` returns
        ``cancelled``; ``max_pending`` overflow is ``shed`` at submission.

        ``drain``: any object with a ``preempted`` attribute
        (``train/elastic.PreemptionGuard``, so SIGTERM drives it). Once it
        is set, admission stops (queued requests are ``shed``), rows in
        flight run on within ``drain_deadline_s`` (None = unbounded) and
        end ``ok``; rows still live at that deadline end ``cancelled`` with
        their partial streams.

        A raised harvest, or one past ``tick_timeout_s`` (the watchdog),
        triggers session reconstruction (:meth:`_reconstruct`), at most
        ``max_recoveries`` a call; a fault that survives a reconstruction
        evicts the newest admission as a suspected poison row. A hang that
        never ends cannot be recovered in-process: the stream stays busy,
        so the next harvest waits behind it (the journal and the CLI's
        ``--supervise`` recover the sessions in a new process). An error
        raised while reconstructing (a sticky CUDA error: every later call
        fails) propagates out of the call; nothing moves to the CPU.
        ``chaos`` (:class:`~serve_lifecycle.ChaosInjector`) injects faults
        for drills.

        ``recovery``: a :class:`~serve_journal.RecoveryManifest` of an
        earlier process's journal. Requests it shows completed return their
        recorded stream with no device work (dedup by request id);
        incomplete ones re-enter admission as prompt + emitted-so-far
        continuations with the journaled seed."""
        with torch.no_grad():
            if recovery is not None and getattr(recovery, "sessions", None):
                return self._run_recovered(
                    requests, recovery, drain=drain,
                    drain_deadline_s=drain_deadline_s, chaos=chaos)
            return self._run(requests, drain=drain,
                             drain_deadline_s=drain_deadline_s, chaos=chaos)

    def _run_recovered(self, requests, recovery, **kw) -> list:
        """Split a resubmitted request list against a recovery manifest
        (reference ``:1993-2075``): journal-completed requests dedup (their
        recorded stream is the result), incomplete ones become continuation
        replays (prompt + emitted, the remaining budget, the journaled
        seed), the rest pass through. Replayed sessions' results carry the
        whole stream (recorded prefix + new suffix), ``recoveries`` + 1."""
        n = len(requests)
        pre: list = [None] * n
        sub: list[Request] = []
        sub_meta: list[tuple[int, list]] = []   # (original index, emitted)
        replay_admits: dict = {}
        for i, r in enumerate(requests):
            rid = r.request_id or f"req-{i}"
            # the positional default seed materialised NOW, before dedup
            # shifts positions: a sampled replay must draw under the seed
            # the original run used
            seed = r.seed
            if seed is None and r.temperature > 0.0:
                seed = i
            sess = recovery.sessions.get(rid)
            if sess is None or sess.prompt is None:
                sub_meta.append((i, []))
                sub.append(replace(r, request_id=rid, seed=seed))
                continue
            if sess.completed:
                self.journal["deduped_completions"] += 1
                pre[i] = RequestResult(status=sess.status,
                                       tokens=list(sess.emitted),
                                       error=sess.error, request_id=rid)
                continue
            emitted = [int(t) for t in sess.emitted]
            seed = sess.seed if sess.seed is not None else seed
            prompt = [int(t) for t in sess.prompt]
            remaining = r.max_new - len(emitted)
            cont = prompt + emitted
            self.journal["recovered_sessions"] += 1
            self.journal["recovery_replay_tokens"] += len(emitted)
            if emitted and remaining < 1:
                # the crash fell between the last delta and the end frame
                pre[i] = RequestResult(status=OK, tokens=emitted[:r.max_new],
                                       request_id=rid)
                continue
            if emitted and len(cont) <= self.Tb:
                # the emitted tokens become prompt: same (seed, logical
                # position) schedule, so the stream continues
                sub_meta.append((i, emitted))
                replay_admits[len(sub)] = (rid, prompt, emitted)
                sub.append(replace(r, tokens=cont, max_new=remaining,
                                   seed=seed, request_id=rid, arrival_s=0.0))
            else:
                # replay from scratch (nothing emitted, or the continuation
                # outgrows the prompt window): same seed, same stream
                sub_meta.append((i, []))
                sub.append(replace(r, request_id=rid, seed=seed,
                                   arrival_s=0.0))
        self._replay_admits = replay_admits
        try:
            sub_results = self._run(sub, **kw)
        finally:
            self._replay_admits = {}
        for (i, emitted), res in zip(sub_meta, sub_results):
            if emitted:
                res = replace(res, tokens=emitted + list(res.tokens),
                              recoveries=res.recoveries + 1)
            pre[i] = res
        return pre

    def _run(self, requests: list[Request], *, drain=None,
             drain_deadline_s: float | None = None, chaos=None) -> list:
        """The scheduler behind :meth:`serve` and :meth:`serve_detailed`
        (reference ``:2077``): the overlapped dispatch/harvest loop with the
        request lifecycle, the drain, fault recovery, the journal and the
        block accounting at its host-side decision points. Returns a
        :class:`~serve_lifecycle.RequestResult` per request."""
        t0 = time.monotonic()
        with self._cancel_mu:
            self._cancelled.clear()
        n = len(requests)
        results: list = [None] * n
        ticks_charged = [0] * n
        recs = [0] * n
        cached = [0] * n
        admissions: list = []
        arrive_at = [t0 + requests[i].arrival_s for i in range(n)]
        admit_at: list = [None] * n
        first_tok_at: list = [None] * n
        jr = self._journal
        jids = [requests[i].request_id or f"req-{i}" for i in range(n)]
        cuda = self.device.type == "cuda"

        def fin(i, status, tokens, error=None):
            """Request ``i``'s terminal event; the first one wins."""
            if results[i] is not None:
                return
            now = time.monotonic()
            latency = max(0.0, now - arrive_at[i])
            ttft = (first_tok_at[i] - arrive_at[i]
                    if first_tok_at[i] is not None else None)
            tokens = list(tokens)
            results[i] = RequestResult(
                status=status, tokens=tokens, error=error,
                ticks=ticks_charged[i], latency_s=latency,
                recoveries=recs[i], cached_prefix_tokens=cached[i],
                queue_wait_s=(admit_at[i] - arrive_at[i]
                              if admit_at[i] is not None else None),
                ttft_s=ttft,
                tpot_s=((latency - ttft) / (len(tokens) - 1)
                        if ttft is not None and len(tokens) > 1 else None),
                request_id=jids[i])
            if jr is not None:
                jr.end(jids[i], status, error=error)

        # submission: validation failures are results, not raises
        valid = []
        for i, r in enumerate(requests):
            err = self._validate_one(r)
            if err is not None:
                fin(i, FAILED, [], err)
            else:
                valid.append(i)
        deadline_at = [None] * n
        for i in valid:
            if requests[i].deadline_s is not None:
                deadline_at[i] = t0 + requests[i].deadline_s

        def horizon_msg(req):
            return (f"per-row horizon exhausted: prompt_buf={self.Tb} + "
                    f"segment-rounded max_new "
                    f"({self._rounded_need(req.max_new)}) exceeds "
                    f"t_max={self.t_max}")

        if self.admit_policy == "fifo":
            # a request that can never fit would block the head forever:
            # it fails now
            queue = []
            for i in valid:
                if self._fits(requests[i]):
                    queue.append(i)
                else:
                    fin(i, FAILED, [], horizon_msg(requests[i]))
        else:
            # skip_fit: never-fitting requests are skipped in place at
            # admission and fail at the end
            queue = list(valid)
        # bounded admission: overload sheds at submission
        if self.max_pending is not None:
            cap = self.B + self.max_pending
            if len(queue) > cap:
                for i in queue[cap:]:
                    fin(i, SHED, [],
                        f"shed: admission queue full ({len(queue)} "
                        f"requests > slots ({self.B}) + max_pending "
                        f"({self.max_pending}))")
                queue = queue[:cap]
        # write-ahead admission records, before any device work; a replayed
        # session records its true shape (original prompt + emitted)
        if jr is not None:
            for qi in queue:
                r = requests[qi]
                rep = self._replay_admits.get(qi)
                if rep is not None:
                    rid, prompt, emitted = rep
                    total_new = r.max_new + len(emitted)
                else:
                    rid, prompt, emitted = jids[qi], list(r.tokens), []
                    total_new = r.max_new
                jr.admit(rid, prompt, total_new, temperature=r.temperature,
                         top_k=r.top_k, top_p=r.top_p,
                         seed=(r.seed if r.seed is not None else
                               qi if r.temperature > 0.0 else None),
                         deadline_s=r.deadline_s, emitted=emitted)
            jr.commit()

        table = [_Slot() for _ in range(self.B)]
        admit_seq = [0]
        draining = {"on": False, "deadline": None}
        fault_state = {"recoveries": 0, "consecutive": 0}

        def free_row(b):
            """Release row ``b``'s pool references and park its table at
            trash; every terminal row transition comes here. A row freed
            while its next segment is in flight is safe as one freed at
            eos is (module docstring): any reuse of its blocks is enqueued
            after that segment, and the harvest skips its plan entry."""
            slot = table[b]
            if slot.blocks:
                self._pool.release(slot.blocks)
            self._tables[b, :] = BlockPool.TRASH
            slot.free()

        def police():
            """The lifecycle's host transitions between device calls
            (reference ``:2232-2288``): drain start (admission stops, the
            queue is shed), cancels and deadlines, queued and in flight,
            and the drain deadline. Host bookkeeping only."""
            now = time.monotonic()
            if (drain is not None and getattr(drain, "preempted", False)
                    and not draining["on"]):
                draining["on"] = True
                if drain_deadline_s is not None:
                    draining["deadline"] = now + drain_deadline_s
                for i in queue:
                    fin(i, SHED, [], "shed: draining (admission stopped)")
                queue.clear()
            with self._cancel_mu:
                cancelled = set(self._cancelled)
            for i in list(queue):
                if i in cancelled:
                    queue.remove(i)
                    fin(i, CANCELLED, [], "cancelled while queued")
                elif deadline_at[i] is not None and now >= deadline_at[i]:
                    queue.remove(i)
                    fin(i, TIMEOUT, [], f"deadline_s="
                        f"{requests[i].deadline_s} expired while queued")
            for b, slot in enumerate(table):
                i = slot.req_index
                if i < 0:
                    continue
                if i in cancelled:
                    fin(i, CANCELLED, slot.out, "cancelled in flight")
                    free_row(b)
                elif deadline_at[i] is not None and now >= deadline_at[i]:
                    fin(i, TIMEOUT, slot.out, f"deadline_s="
                        f"{requests[i].deadline_s} expired in flight")
                    free_row(b)
            if (draining["on"] and draining["deadline"] is not None
                    and now > draining["deadline"]):
                for b, slot in enumerate(table):
                    if slot.req_index >= 0:
                        fin(slot.req_index, CANCELLED, slot.out,
                            f"drain deadline ({drain_deadline_s}s) expired")
                        free_row(b)

        def pick_admissions(k_free: int) -> list[int]:
            """The next requests to admit (reference ``:2290-2309``), none
            while draining: the queue's arrived head for FIFO (an unarrived
            head blocks the wave: no leapfrog), for skip_fit the first
            arrived ones that fit, in queue order."""
            take: list[int] = []
            if draining["on"]:
                return take
            now = time.monotonic()
            if self.admit_policy == "fifo":
                while (queue and len(take) < k_free
                       and arrive_at[queue[0]] <= now):
                    take.append(queue.pop(0))
            else:
                i = 0
                while i < len(queue) and len(take) < k_free:
                    if (self._fits(requests[queue[i]])
                            and arrive_at[queue[i]] <= now):
                        take.append(queue.pop(i))
                    else:
                        i += 1
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
            now = time.monotonic()
            entries, cow_all = [], []
            budget = self._chunk
            for b, ri in zip(free, take):
                req, slot = requests[ri], table[b]
                admit_at[ri] = now
                self._temp_h[b] = req.temperature
                self._topk_h[b] = req.top_k or 0
                self._topp_h[b] = 2.0 if req.top_p is None else req.top_p
                self._seed_h[b] = (ri if req.seed is None
                                   else req.seed) & 0xFFFFFFFF
                slot.req_index, slot.out = ri, []
                slot.remaining = req.max_new
                slot.admit_seq = admit_seq[0]
                admit_seq[0] += 1
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
            if self._tier_promote_t0 is not None:
                # the wave's promotion copies were enqueued in
                # _assign_blocks and ran while the host built and enqueued
                # this prefill: the overlapped window (reference
                # ``:2373-2381``)
                self.tier["promote_overlap_ms"] += (
                    time.monotonic() - self._tier_promote_t0) * 1e3
                self._tier_promote_t0 = None
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

        def park_others(active, ticks: int):
            """The tables a dispatch ships: rows outside ``active`` (free,
            done, or mid-chunk, whose head is not all written) park at
            position 0 behind an all-trash table."""
            tables_now = self._tables.copy()
            for b in range(self.B):
                if b not in active:
                    tables_now[b, :] = BlockPool.TRASH
                    self._row_pos[b] = 0
                    if table[b].pf_known is not None:
                        self.prefill["stall_ticks"] += ticks
            return tables_now

        def rung(active, ticks: int) -> int:
            """The narrowest rung covering the live rows' reach: ``ticks``
            writes past each row's last written slot (reference
            ``:2480-2491``)."""
            need = max(self._row_pos[b] for b in active) + ticks + 1
            nb_w = self._bucket_width(need)
            self._note_width(nb_w, ticks, min(self.nb, -(-need // self.bt)))
            return nb_w

        def dispatched(out: torch.Tensor) -> _Fetch:
            """A dispatch's bookkeeping after its launches: the segment
            count, a chaos drill's device-side hang (a spin enqueued before
            the fetch's event, on the card) and the host hook, then the
            fetch of ``out``."""
            self.stats["segments"] += 1
            if chaos is not None and cuda:
                hang_s = chaos.in_fetch(self.stats["segments"])
                if hang_s:
                    spin(torch, hang_s)
            fetch = _Fetch(out)
            if chaos is not None and chaos.on_segment is not None:
                chaos.on_segment(self.stats["segments"])
            return fetch

        def dispatch_segment(wait=None):
            """Dispatch ONE segment (no fetch), or None when no row has
            budget left. Budget depletion is applied here, at dispatch,
            so the next segment can be decided before this one's tokens
            arrive. ``wait`` runs before an eager launch or a capture (it
            may raise: nothing after it has run)."""
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
            tables_now = park_others(active, self.S)
            nb_w = rung(active, self.S)
            sampling = bool((self._temp_h[sorted(active)] > 0).any())
            # the fetch's copy of the static token buffer is queued on the
            # stream right after this segment and before the next
            # dispatch's fills and replay, which overwrite the buffer: the
            # stream's order keeps segment N's tokens until they are copied
            out = self._segment(tables_now, self._row_pos, sampling, nb_w,
                                wait)
            for b in range(self.B):
                self._row_pos[b] += self.S
            self.ticks += self.S
            for b, ri, take, _ in plan:
                table[b].remaining -= take
                ticks_charged[ri] += take
            return "plain", dispatched(out), plan

        def cow_for_write(plan):
            """Every block under a verify window's writes (slots ``row_pos +
            1 .. row_pos + W``) made exclusively the row's before the
            dispatch (reference ``:2535-2569``): a shared one (a radix
            entry's tail block past its valid tokens) is copied, the row
            re-pointed at the copy and its reference to the original
            dropped, so a rejected draft never touches a block another
            owner reads."""
            pairs = []
            for b, _ri, _d in plan:
                slot = table[b]
                lo = (self._row_pos[b] + 1) // self.bt
                hi = min((self._row_pos[b] + self._spec_w) // self.bt,
                         self.nb - 1)
                for idx in range(lo, hi + 1):
                    blk = int(self._tables[b, idx])
                    if blk == BlockPool.TRASH or not self._pool.shared(blk):
                        continue
                    dst = self._alloc(1)[0]
                    pairs.append((blk, dst))
                    self._tables[b, idx] = dst
                    slot.blocks[slot.blocks.index(blk)] = dst
                    self._pool.release([blk])
            if pairs:
                self.stats["cow_copies"] += len(pairs)
                self._copy_blocks(pairs)

        def dispatch_verify():
            """Dispatch ONE verify step (no fetch; reference
            ``:2571-2660``): ``k`` drafts a live row from its host history
            (prompt + emitted) behind its current token, scored in one
            program. The budget moves at harvest, by what the row emits:
            the next drafts depend on this step's outcome, so verify steps
            never overlap."""
            W = self._spec_w
            toks = np.zeros((self.B, W), np.int64)
            plan = []
            for b, slot in enumerate(table):
                if (slot.req_index >= 0 and slot.remaining > 0
                        and slot.pf_known is None):
                    ri = slot.req_index
                    ctx = list(requests[ri].tokens) + slot.out
                    drafts = [int(t) for t in
                              self._proposer.propose(ctx, W - 1)][:W - 1]
                    if len(drafts) < W - 1:
                        tail = drafts[-1] if drafts else 0
                        drafts += [tail] * (W - 1 - len(drafts))
                    toks[b, 0] = self._cur_h[b]
                    toks[b, 1:] = drafts
                    plan.append((b, ri, drafts))
            if not plan:
                return None
            # copy-on-write BEFORE the tables are snapshotted: the window's
            # first write must land in the copy the row now points at
            cow_for_write(plan)
            active = {b for b, _, _ in plan}
            tables_now = park_others(active, W)
            # the rung must cover max(row_pos) + W + 1 slots: the program
            # drops writes at or past its horizon
            nb_w = rung(active, W)
            sampling = bool((self._temp_h[sorted(active)] > 0).any())
            out = self._verify(tables_now, toks, self._row_pos,
                               self._nlog_h, sampling, nb_w)
            # no row advances here: the verify harvest moves each by what
            # it emits (the rollback: K/V past a row's position is never
            # read)
            self.ticks += W
            self.spec["verify_segments"] += 1
            return "spec", dispatched(out), plan

        def maybe_autodisable():
            """Over each window of ``autodisable_window`` proposed drafts,
            an acceptance rate under ``autodisable_below`` switches to
            plain segments for good (reference ``:2662-2690``; sticky until
            :meth:`reset`). The verify path ran off the host mirrors, so
            they are pushed into the device's carried token and logical
            count before the next plain segment."""
            prop, acc = self._spec_win
            if prop < self._spec.autodisable_window:
                return
            self._spec_win = [0, 0]
            if acc / prop >= self._spec.autodisable_below:
                return
            self._spec_on = False
            self.spec["autodisabled"] += 1
            self._fill(self._cur_tok, self._cur_h)
            self._fill(self._n_logical, self._nlog_h)

        def watch(fetch, hang_s: float = 0.0) -> np.ndarray:
            """``fetch``'s tokens under the tick watchdog. Segments cut
            earlier and still on the stream run ahead of this one, so the
            clock starts once they are done (their time was charged to the
            harvest that timed out): a hang that never ends blocks here."""
            while self._stale:
                if self._stale[0].done():
                    self._stale.pop(0)
                else:
                    time.sleep(POLL_S)
            try:
                return fetch.result(self.tick_timeout_s, hang_s)
            except TickTimeout:
                self._stale.append(fetch)
                raise

        def fetch_tokens(fetch, plan_requests) -> np.ndarray:
            """THE wait of a harvest, the loop's one host sync: the chaos
            hooks, then the fetch, under the tick watchdog when it is
            set."""
            self.stats["fetches"] += 1
            self._stale = [f for f in self._stale if not f.done()]
            if chaos is not None:
                chaos.pre_fetch(self.stats["segments"], plan_requests)
            hang_s = (chaos.in_fetch(self.stats["segments"])
                      if chaos is not None and not cuda else 0.0)
            if self.tick_timeout_s is None:
                return fetch.result(hang_s=hang_s)
            return watch(fetch, hang_s)

        def deliver(b, ri, emit, done, now):
            """A harvested row's tokens: the first token's time, the eos
            trim, the journal delta (post-trim: only delivered tokens), and
            the row's end when done."""
            slot = table[b]
            prev = len(slot.out)
            slot.out.extend(emit)
            if slot.out and first_tok_at[ri] is None:
                first_tok_at[ri] = now
            if self.eos_id is not None and self.eos_id in slot.out:
                slot.out = slot.out[:slot.out.index(self.eos_id) + 1]
                done = True
            if jr is not None and len(slot.out) > prev:
                jr.delta(jids[ri], slot.out[prev:])
            if done:
                fin(ri, OK, slot.out)
                free_row(b)

        def harvest_verify(fetch, plan):
            """THE fetch of a verify step (reference ``:2692-2770``): each
            row emits its longest accepted draft prefix plus the model's
            token at the first mismatch (the deterministic rejection
            resample), clamped to its budget, and advances by what it
            emitted."""
            true_h = fetch_tokens(fetch, [ri for _, ri, _ in plan])
            now = time.monotonic()
            W = self._spec_w
            for b, ri, drafts in plan:
                slot = table[b]
                if results[ri] is not None or slot.req_index != ri:
                    continue   # cut or done while this was in flight
                row = true_h[b]
                j = 0
                while j < W - 1 and drafts[j] == int(row[j]):
                    j += 1
                emit = [int(t) for t in row[:j + 1]][:slot.remaining]
                self.spec["proposed"] += W - 1
                self.spec["accepted"] += j
                self.spec["emitted_tokens"] += len(emit)
                self.spec["wasted_verify_tokens"] += W - len(emit)
                self._spec_win[0] += W - 1
                self._spec_win[1] += j
                ticks_charged[ri] += W
                slot.remaining -= len(emit)
                self._row_pos[b] += len(emit)
                self._nlog_h[b] += len(emit)
                if emit:
                    self._cur_h[b] = emit[-1]
                deliver(b, ri, emit, slot.remaining <= 0, now)
            if jr is not None:
                jr.commit()        # the harvest is the durability boundary
            if self.spec["proposed"]:
                self.spec["acceptance_rate"] = (self.spec["accepted"]
                                                / self.spec["proposed"])
            maybe_autodisable()

        def dispatch_next():
            """Speculative verify while speculation is configured and not
            auto-disabled, plain segments otherwise."""
            if self._spec is not None and self._spec_on:
                return dispatch_verify()
            return dispatch_segment()

        def harvest(seg, overlapped: bool):
            """THE one device->host fetch per dispatch."""
            kind, fetch, plan = seg
            if kind == "spec":
                harvest_verify(fetch, plan)
                return
            if overlapped:
                self.stats["fetches_overlapped"] += 1
            toks = fetch_tokens(fetch, [ri for _, ri, _, _ in plan])
            now = time.monotonic()
            for b, ri, take, done in plan:
                if results[ri] is not None or table[b].req_index != ri:
                    # finished (eos), cut (cancel, deadline, drain) or its
                    # row re-admitted while this was in flight: the ticks
                    # are overlap waste, never tokens
                    continue
                deliver(b, ri, [int(t) for t in toks[b, :take]], done, now)
            if jr is not None:
                jr.commit()        # the harvest is the durability boundary

        def handle_fault(e: Exception) -> bool:
            """A harvest raised or hung (reference ``:2841-2892``): recover
            by reconstruction, at most ``max_recoveries`` a call; a fault
            that survives a reconstruction evicts the newest admission as a
            suspected poison row first. False once the budget is spent:
            every remaining request fails with the error."""
            self.stats["faults"] += 1
            fault_state["consecutive"] += 1
            err = f"{type(e).__name__}: {e}"
            t_fault = time.monotonic()
            if fault_state["recoveries"] >= self.max_recoveries:
                msg = (f"device lost after {fault_state['recoveries']} "
                       f"recovery attempt(s) ({err})")
                for b, slot in enumerate(table):
                    if slot.req_index >= 0:
                        fin(slot.req_index, FAILED, slot.out, msg)
                        free_row(b)
                for i in queue:
                    fin(i, FAILED, [], msg)
                queue.clear()
                return False
            fault_state["recoveries"] += 1
            if fault_state["consecutive"] >= 2:
                live = [b for b, s in enumerate(table) if s.req_index >= 0]
                if live:
                    victim = max(live, key=lambda b: table[b].admit_seq)
                    fin(table[victim].req_index, FAILED, table[victim].out,
                        f"evicted as suspected poison row after repeated "
                        f"faults ({err})")
                    free_row(victim)
            for slot in table:
                if slot.req_index >= 0:
                    recs[slot.req_index] += 1
            self._reconstruct(table, requests, fin, free_row)
            self.stats["reconstructions"] += 1
            self.stats["recovery_s"] += time.monotonic() - t_fault
            return True

        def dispatch_or_wait():
            """:func:`dispatch_next` across mid-chunk rows and open-loop
            arrival gaps (reference ``:2894-2940``): while no row can
            decode, mid-chunk rows extend (each chunk wave advances one by
            a block at least, so this ends); with nothing live and future
            arrivals queued, nap to the earliest in bounded steps
            (``police`` keeps cancels, deadlines and drain live) and admit.
            The overlapped dispatch never calls this."""
            while True:
                seg = dispatch_next()
                if seg is not None:
                    return seg
                if any(s.req_index >= 0 and s.pf_known is not None
                       for s in table):
                    chunk_wave()
                    police()
                    continue
                if draining["on"]:
                    return None
                now = time.monotonic()
                future = [arrive_at[i] for i in queue if arrive_at[i] > now]
                if not future:
                    return None
                time.sleep(min(min(future) - now, 0.02))
                police()
                admit_wave()
                chunk_wave()

        police()
        admit_wave()
        chunk_wave()
        seg = dispatch_or_wait()
        while seg is not None:
            nxt = None
            waited = []
            try:
                if seg[0] == "plain":
                    # overlap: plain segment N+1 before fetching N; a
                    # verify step waits (its drafts need this harvest).
                    # Under the watchdog on the card an eager or capturing
                    # N+1 first waits for N under the watchdog: its
                    # thousands of launches would fill the launch queue
                    # behind a hung N and block the host in a launch,
                    # where no poll runs (a replay is one launch)
                    nxt = dispatch_segment(
                        (lambda f=seg[1]: waited.append(watch(f)))
                        if cuda and self.tick_timeout_s is not None
                        else None)
                harvest(seg, overlapped=nxt is not None and not waited)
                fault_state["consecutive"] = 0
            except Exception as e:  # noqa: BLE001 — the fault path: chaos,
                # the watchdog or a runtime error at the harvest. Degrade
                # per request; an error while reconstructing propagates
                if nxt is not None:
                    self._stale.append(nxt[1])
                nxt = None
                if not handle_fault(e):
                    break
            police()
            admit_wave()                  # freed rows -> next wave
            chunk_wave()                  # mid-chunk rows -> next chunk
            if nxt is None:
                nxt = dispatch_or_wait()  # fresh admissions, a
                # reconstruction, or the next arrival
            seg = nxt

        # whatever is still queued can never be admitted: skip_fit's
        # never-fitting requests fail with their horizon error
        for i in queue:
            req = requests[i]
            fin(i, FAILED, [], horizon_msg(req) if not self._fits(req) else
                "not served (scheduler exited with work queued)")
        leaked = [b for b, s in enumerate(table) if s.req_index >= 0
                  and results[s.req_index] is None]
        self.last_slot_leaks = len(leaked)
        for b in leaked:
            fin(table[b].req_index, FAILED, table[b].out,
                "slot leak (scheduler bug)")
        for b, s in enumerate(table):
            if s.req_index >= 0:
                free_row(b)
        # with every row freed, the only live pool references are the
        # radix tree's (and the pinned trash block)
        self.last_block_leaks = self._pool.leak_check(
            self._radix.held() if self._radix is not None else None)
        # ... and the host pool: every allocated host block owned by
        # exactly one demoted entry, with the disk writer drained so the
        # part directory is whole when serve returns (reference
        # ``:2991-3000``)
        if self._tier is not None:
            if self._tier.disk is not None:
                self._tier.disk.drain()
            self.last_host_block_leaks = self._tier.leak_check()
            self.tier["host_pool_occupancy"] = max(
                self.tier["host_pool_occupancy"],
                self._tier.host.high_water / self._tier.host.num_blocks)
        self.stats["block_pool_occupancy"] = max(
            self.stats["block_pool_occupancy"],
            self._pool.high_water / self._pool.num_blocks)
        for i in range(n):
            if results[i] is None:
                fin(i, FAILED, [], "not served (scheduler bug)")
        if jr is not None:
            jr.commit()   # the exit path's end frames reach the log too
        self.last_ttft_s = [None if first_tok_at[i] is None
                            else first_tok_at[i] - arrive_at[i]
                            for i in range(n)]
        self.last_cached_prefix = cached
        self.last_admissions = admissions
        return results
