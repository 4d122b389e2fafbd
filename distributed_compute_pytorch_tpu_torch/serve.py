"""Segment-wise continuous batching — the port of
``distributed_compute_pytorch_tpu/serve.py``'s serving core (greedy).

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
  per-tick garbage writes never touch a live block.
- **Batched admission.** Every pending request that has a free row is
  stacked into ONE prefill per admission wave, laid out from logical
  slot 0 in a ``prompt_buf``-wide window (the ``flash_fwd`` kernel,
  causal with the pad mask). Each prompt's tokens but the last are
  prefilled and their K/V scattered to the row's blocks (pad tokens aim
  at an out-of-range block id and are dropped); the LAST prompt token
  becomes the row's current token, consumed by its first decode tick.
- **Per-row positions.** Every row advances its own write position, so
  ``t_max`` bounds one request (``prompt_buf + ceil(max_new / segment) *
  segment``), not the stream; rows recycle indefinitely.
- **Overlapped host scheduler.** Segment N+1 is dispatched BEFORE segment
  N's tokens are fetched: each segment's tokens are copied to pinned host
  memory behind a CUDA event right after its launches, and the harvest
  waits on that event alone, so the card runs segment N+1 while the host
  harvests N and admits. No dispatch waits for the card: every
  host-to-device copy (admission arrays, block tables, positions) is
  staged through pinned memory and issued ``non_blocking``, and the
  harvest's wait (``_Fetch.result``) is the loop's one host sync. Sound
  because rows are independent and budget
  completion is host-known; an eos'd row burns at most the one segment
  in flight, whose late writes land in blocks the next admission
  overwrites or in slots past any live position.
- **The segment as one CUDA graph** (the reference jits ``_segment_impl``,
  a ``lax.scan`` of ticks). A segment reads and writes static device
  buffers made once per batcher: the block tables, each row's last written
  slot, the carried current token and logical position (rewritten in
  place by each segment and by admission) and the segment's tokens. On
  CUDA the batcher's first segment runs eagerly (the capture's warm-up:
  kernels loaded, the decode reads' merge scratch sized), the second
  dispatch captures the segment (``utils/graphs.py``) and replays it, and
  every later dispatch, in this ``serve`` call or a later one, fills the
  table and position buffers by non-blocking copies and replays: one
  ``cudaGraphLaunch`` a segment. The admission wave stays eager (its width
  varies). On the CPU every segment runs eagerly over the same buffers.

Admission is strict FIFO: a free row always takes the queue head. A
request whose segment-rounded budget can never fit a row would block the
head forever, so it is set aside up front, everything else is served,
then :class:`HorizonError` is raised carrying the completed outputs.

This slice is greedy only (a request with ``temperature > 0`` raises) and
leaves out the reference's radix prefix cache, width buckets, chunked
prefill, speculation, tiers, handoff, the journal, deadlines, cancel,
shed, drain, reconstruction and telemetry (the int8 pool's ``kvq``
counters among them).
"""

from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from distributed_compute_pytorch_tpu_torch.device import resolve_device
from distributed_compute_pytorch_tpu_torch.kv_pool import BlockPool
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


@dataclass
class Request:
    """One generation request: ``tokens`` (prompt ids) in, up to
    ``max_new`` greedy continuations out (fewer if ``eos_id`` fires).
    ``temperature`` must be 0: sampling is not ported yet."""

    tokens: list
    max_new: int
    temperature: float = 0.0


@dataclass
class _Slot:
    """Host-side bookkeeping for one cache row."""

    req_index: int = -1        # position in the request list (-1 = free)
    remaining: int = 0
    out: list = field(default_factory=list)
    blocks: list = field(default_factory=list)   # owned pool blocks

    def free(self):
        self.req_index = -1
        self.remaining = 0
        self.out = []
        self.blocks = []


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
    block-table KV cache (greedy decoding).

    Args:
      model: a ``models.gpt2.GPT2`` or ``models.llama.LlamaLM`` (any
        model with ``embed``, ``blocks[i].forward/decode_step``,
        ``readout``, ``kv_cache_spec``) on the batcher's device; it serves
        in its parameter dtype. A block that ropes (Llama's) ropes the
        admission window at its logical slots from 0 and each tick at the
        row's slot ``pos``; the pool holds post-rope keys at kv-head width
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
      admit_policy: ``"fifo"`` (the only policy ported).
      kv_block_tokens: logical slots per pool block (default 8).
      kv_dtype: ``"bf16"`` (the pool in the model's compute dtype, whatever
        it is) or ``"int8"`` (int8 K/V with per-row f32 scales).
      pool_blocks: physical blocks per layer pool (default and minimum
        ``slots * (t_max // bt) + 1``: every row's worst case plus the
        trash block).
      device: ``None``/``"cuda"`` (raises without CUDA) or ``"cpu"``.
    """

    def __init__(self, model, params=None, *, slots: int, t_max: int,
                 prompt_buf: int, segment: int = 16,
                 eos_id: int | None = None, admit_policy: str = "fifo",
                 kv_block_tokens: int | None = None,
                 pool_blocks: int | None = None, kv_dtype: str = "bf16",
                 device=None):
        self.device = resolve_device(device)
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}")
        if prompt_buf > t_max:
            raise ValueError(f"prompt_buf {prompt_buf} > t_max {t_max}")
        if admit_policy != "fifo":
            raise ValueError(f"admit_policy {admit_policy!r} is not ported; "
                             f"only 'fifo'")
        if slots < 1 or segment < 1:
            raise ValueError("slots and segment must be >= 1")
        if kv_block_tokens is not None and kv_block_tokens < 1:
            raise ValueError(
                f"kv_block_tokens must be >= 1, got {kv_block_tokens}")
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, the batcher on "
                             f"{self.device}")
        if params is not None:
            model.load_state_dict(params)
        self.model = model
        # does the block rope internally (Llama)? Then admission hands it
        # the prompt's logical slots from 0 (reference
        # ``_block_takes_positions``, ``:495``); GPT-2 embeds its positions
        # instead, and its blocks are called as they were
        self._block_takes_positions = "positions" in inspect.signature(
            model.blocks[0].forward).parameters
        self.B = slots
        self.Tb = prompt_buf
        self.S = segment
        self.eos_id = eos_id
        self.bt = kv_block_tokens or DEFAULT_BLOCK_TOKENS
        self.t_max = -(-t_max // self.bt) * self.bt
        self.nb = self.t_max // self.bt          # table entries per row
        min_blocks = slots * self.nb + 1         # + the trash block
        if pool_blocks is None:
            pool_blocks = min_blocks
        if pool_blocks < min_blocks:
            raise ValueError(
                f"pool_blocks={pool_blocks} < slots*blocks_per_row+1="
                f"{min_blocks}: a full pool could deadlock admission")
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
        # segment and by admission), the segment's tokens
        dev = self.device
        self._tables_dev = torch.zeros(slots, self.nb, dtype=torch.int32,
                                       device=dev)
        self._pos0 = torch.zeros(slots, dtype=torch.int32, device=dev)
        self._cur_tok = torch.zeros(slots, dtype=torch.long, device=dev)
        self._n_logical = torch.zeros(slots, dtype=torch.long, device=dev)
        self._toks = torch.zeros(slots, segment, dtype=torch.long, device=dev)
        # on CUDA the segment is captured at the second dispatch (False: the
        # eager loop on the card, the reference the card's checks hold the
        # graph to); the captured segment (``graphs.Program``); the merge
        # scratch of its decode reads
        self._capture = dev.type == "cuda"
        self._graph = None
        self._scratch: dict = {}
        self._pool = BlockPool(pool_blocks)
        self._tables = np.full((slots, self.nb), BlockPool.TRASH, np.int32)
        # per-row slot of the last written token (host-tracked: admission
        # rewinds a row to its head length - 1; each segment advances
        # every row by S; parked rows sit at 0 writing into trash)
        self._row_pos = [0] * slots
        self.ticks = 0
        self.stats = {"prefill_calls": 0, "fetches_overlapped": 0,
                      "eager_segments": 0, "graph_captures": 0,
                      "graph_replays": 0}
        self.last_slot_leaks = 0   # rows still owned at serve() exit
        self.last_block_leaks = 0  # pool refs unaccounted at serve() exit
        self.last_ttft_s: list = []  # per request: serve start -> 1st token

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

    def _prefill_wave(self, entries):
        """ONE multi-row prefill of ``entries`` ``(row, tokens)``: every
        prompt's head (all but the last token) at logical positions
        ``0..n-2`` from column 0 of the ``prompt_buf``-wide window, its
        K/V scattered into the row's blocks (pad columns aim at block id
        ``P`` and are dropped). Each row then rewinds to ``head_len - 1``
        with its last prompt token current. Dispatch only — no fetch."""
        heads = [len(tokens) - 1 for _, tokens in entries]
        if max(heads) > 0:
            K, W, bt = len(entries), self.Tb, self.bt
            prompt = np.zeros((K, W), np.int64)
            pmask = np.zeros((K, W), np.float32)
            blk = np.full((K, W), self._pool.num_blocks, np.int32)
            off = np.zeros((K, W), np.int32)
            for j, ((b, tokens), n) in enumerate(zip(entries, heads)):
                prompt[j, :n] = tokens[:n]
                pmask[j, :n] = 1.0
                logical = np.arange(n)
                blk[j, :n] = self._tables[b][logical // bt]
                off[j, :n] = logical % bt
            self._admit(*(self._to_device(a)
                          for a in (prompt, pmask, blk, off)))
        rows = self._to_device(np.array([b for b, _ in entries], np.int64))
        self._cur_tok[rows] = self._to_device(
            np.array([tokens[-1] for _, tokens in entries], np.int64))
        self._n_logical[rows] = self._to_device(np.array(heads, np.int64))
        for (b, _), n in zip(entries, heads):
            self._row_pos[b] = n - 1

    def _admit(self, prompt, pmask, blk, off):
        """The admission forward (reference ``_admit_impl``, prefix cache
        off): every block's ``forward`` over the wave with the pad mask,
        each layer's captured K/V written to the pool (an int8 pool's
        write quantizes it, as the reference's admission scatter does)."""
        model = self.model
        K, W = prompt.shape
        positions = torch.arange(W, device=self.device)
        x = model.embed(prompt, positions)
        blk, off = blk.reshape(-1), off.reshape(-1)
        kw = {"positions": positions} if self._block_takes_positions else {}
        for block, cache in zip(model.blocks, self._caches):
            sink: list = []
            x = block(x, kv_mask=pmask, kv_sink=sink, **kw)
            (k, v), = sink                     # [K, hk, W, hd] views
            hk, hd = k.shape[1], k.shape[3]
            kv_pool_insert(cache["kv"],
                           k.transpose(1, 2).reshape(K * W, hk, hd),
                           v.transpose(1, 2).reshape(K * W, hk, hd),
                           blk, off, scale=cache.get("scale"))

    def _segment(self, tables, positions0) -> torch.Tensor:
        """Dispatch ``S`` greedy decode ticks for every row at its OWN
        position (``positions0 [B]`` = each row's last written slot; tick
        ``i`` writes slot ``positions0 + 1 + i``). Returns the static ``[B,
        S]`` token buffer, which the next dispatch overwrites (reference
        ``_segment_impl``). On CUDA the batcher's first segment runs
        eagerly, the second is captured as a CUDA graph, and it and every
        later one replay it; a failed capture or replay raises."""
        self._fill(self._tables_dev, tables)
        self._fill(self._pos0, np.asarray(positions0, np.int32))
        if self._graph is None:
            if not (self._capture and self.stats["eager_segments"]):
                self._decode_segment()
                self.stats["eager_segments"] += 1
                return self._toks
            self._graph = capture(self._decode_segment)
            self.stats["graph_captures"] += 1
        self._graph.replay()
        self.stats["graph_replays"] += 1
        return self._toks

    def _decode_segment(self) -> None:
        """The segment's work over the static buffers (the captured
        program): ``S`` ticks, then the carried token and logical position
        and the ``[B, S]`` tokens written in place."""
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
                tok = torch.argmax(model.readout(x)[:, -1], dim=-1)
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
        if len(r.tokens) > self.Tb:
            return (f"prompt of {len(r.tokens)} tokens exceeds "
                    f"prompt_buf={self.Tb}")
        if len(r.tokens) == 0:
            return "empty prompt"
        if r.max_new < 1:
            return f"max_new must be >= 1, got {r.max_new}"
        if r.temperature < 0.0:
            return f"temperature must be >= 0, got {r.temperature}"
        if r.temperature > 0.0:
            return ("sampling (temperature > 0) is not ported yet: this "
                    "batcher serves greedy requests only")
        vocab = self.model.config.vocab_size
        bad = [t for t in r.tokens if not 0 <= t < vocab]
        if bad:
            return (f"token ids {bad[:8]} outside the model vocab "
                    f"[0, {vocab})")
        return None

    def _assign_blocks(self, b: int, slot: _Slot, head_len: int,
                       max_new: int) -> None:
        """Allocate row ``b``'s worst-case extent and point its table at
        it (reference ``_assign_blocks`` without the prefix attach)."""
        extent = head_len + self._rounded_need(max_new)
        nblocks = -(-extent // self.bt)
        slot.blocks = self._pool.alloc(nblocks)
        self._tables[b, :] = BlockPool.TRASH
        self._tables[b, :nblocks] = slot.blocks

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
        queue = [i for i in range(n) if self._fits(requests[i])]
        rejected = [i for i in range(n) if not self._fits(requests[i])]
        table = [_Slot() for _ in range(self.B)]

        def free_row(b):
            slot = table[b]
            if slot.blocks:
                self._pool.release(slot.blocks)
            self._tables[b, :] = BlockPool.TRASH
            slot.free()

        def admit_wave():
            """ONE prefill for every queued request that has a free row,
            strictly in arrival order."""
            free = [b for b, s in enumerate(table) if s.req_index < 0]
            take = queue[:len(free)]
            if not take:
                return
            del queue[:len(take)]
            entries = []
            for b, ri in zip(free, take):
                req, slot = requests[ri], table[b]
                slot.req_index, slot.out = ri, []
                slot.remaining = req.max_new
                self._assign_blocks(b, slot, len(req.tokens) - 1,
                                    req.max_new)
                entries.append((b, list(req.tokens)))
            self._prefill_wave(entries)
            self.stats["prefill_calls"] += 1

        def dispatch_segment():
            """Dispatch ONE segment (no fetch), or None when no row has
            budget left. Budget depletion is applied here, at dispatch,
            so the next segment can be decided before this one's tokens
            arrive. Rows outside the plan park at position 0 behind an
            all-trash table."""
            plan = []
            for b, slot in enumerate(table):
                if slot.req_index >= 0 and slot.remaining > 0:
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
            # the fetch's copy of the static token buffer is queued on the
            # stream right after this segment and before the next
            # dispatch's fills and replay, which overwrite the buffer: the
            # stream's order keeps segment N's tokens until they are copied
            fetch = _Fetch(self._segment(tables_now, self._row_pos))
            for b in range(self.B):
                self._row_pos[b] += self.S
            self.ticks += self.S
            for b, _, take, _ in plan:
                table[b].remaining -= take
            return fetch, plan

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
        seg = dispatch_segment()
        while seg is not None:
            nxt = dispatch_segment()      # overlap: N+1 before fetching N
            harvest(seg, overlapped=nxt is not None)
            admit_wave()                  # freed rows -> next wave
            if nxt is None:
                nxt = dispatch_segment()  # revived by fresh admissions
            seg = nxt

        leaked = [b for b, s in enumerate(table) if s.req_index >= 0]
        self.last_slot_leaks = len(leaked)
        for b in leaked:
            free_row(b)
        self.last_block_leaks = self._pool.leak_check()
        self.last_ttft_s = ttft
        return [r if r is not None else [] for r in results], rejected
