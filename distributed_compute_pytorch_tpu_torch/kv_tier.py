"""Hierarchical KV for the port: a host-RAM block pool and a CRC-checked
disk tier under the radix prefix cache, so the cache's working set can
outlive the card's pool — the port's own copy of
``distributed_compute_pytorch_tpu/kv_tier.py`` (the port imports nothing
of the JAX package).

The serve engine's device pool (per-layer ``[2, blocks, hk, block_tokens,
hd]`` leaves) is the only tier a captured program touches. Two tiers lie
below it:

- :class:`HostBlockPool` — block-major storage, one ``[num_blocks, L, 2,
  hk, bt, hd]`` slab (plus an f32 ``[num_blocks, L, 2, hk, bt, 1]`` scale
  slab for int8 pools), made once with the batcher, so a run of
  consecutive host blocks is one copy each way. For a CUDA batcher the
  slabs are pinned CPU tensors and the tier's copies are stream-ordered:
  a demotion copies the victim's blocks D2H ``non_blocking`` and a
  promotion copies them H2D from the pinned slab itself, so neither waits
  for the card. Every host block remembers the CUDA event recorded after
  the last copy into or out of it, and every CPU-side access (an export,
  an import's write, a reset, a test) waits on those events first: the
  bytes of a demotion may not have landed yet, and a block released by a
  promotion may still be under its H2D copy. A disk spill reads no host
  bytes on the CPU: it copies the victim's blocks out through the card
  into fresh pinned memory, stream-ordered, and the disk writer thread
  waits for that copy.
- :class:`DiskTier` — optional overflow below the host pool: one
  ``part-NNNNN.npz`` a spilled entry (key ``kv``, plus ``scale`` for int8)
  and a ``part-NNNNN.json`` sidecar with the entry's CRC-32, shape, dtype,
  prefix tokens and weights version. A part that fails its CRC or cannot
  be read is a cache MISS, never an exception (``disk_crc_miss`` counts
  it). Float32 and int8 parts are byte for byte the reference's, so
  either package adopts the other's directory. A bf16 part stores its
  16-bit patterns (``uint16``) with the sidecar's ``dtype`` ``"bfloat16"``
  and reads back bit-exact; the reference's own bf16 parts (``|V2`` on
  load) read back too.

Host-side content is numpy: ``[L, 2, n, hk, bt, hd]`` (a bf16 pool's as
``uint16`` bit patterns), or a ``{"kv", "scale"}`` dict for int8 pools.

Tier state machine (``entry.tier``)::

    DEVICE --evict_for/demote--> HOST --host pressure--> DISK
      ^                            |                       |
      +------- promote (H2D) ------+---- promote (read) ---+
                                   CRC miss / no disk -> dropped

Movement is always a MOVE: a promoted entry releases its host or disk
bytes, a spill frees its host blocks. One copy of the truth an entry
keeps the leak accounting (:meth:`KVTierManager.leak_check`) exact.
:class:`KVTierManager` owns the bookkeeping; the serve engine owns the
device halves (the gather before a demotion, the scatter after a
promotion).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import zlib

import numpy as np
import torch

from distributed_compute_pytorch_tpu_torch.kv_pool import (
    TIER_DISK, TIER_HOST)

# the tier counters (the reference's serve.tier.* keys; a plain dict)
TIER_STATS = {
    "demotions": 0, "promotions": 0,
    "host_hits": 0, "disk_hits": 0,
    "disk_spills": 0, "disk_crc_miss": 0, "disk_adopted": 0,
    "bytes_d2h": 0, "bytes_h2d": 0,
    "promote_overlap_ms": 0.0,
    "host_pool_occupancy": 0.0,
}

BF16 = "bfloat16"


def _crc(arr: np.ndarray) -> int:
    """The v2 checkpoint shard entry checksum: CRC-32 over the raw
    contiguous bytes."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return zlib.crc32(flat) & 0xFFFFFFFF


def _content_nbytes(content) -> int:
    """Total bytes of a tier content payload: a bare K/V array (float
    pools) or a ``{"kv", "scale"}`` dict (int8 pools); numpy arrays or
    torch tensors."""
    if isinstance(content, dict):
        return sum(int(v.nbytes) for v in content.values())
    return int(content.nbytes)


def host_blocks_for_mb(mb: float, n_layers: int, hk: int, bt: int,
                       hd: int, itemsize: int,
                       scale_itemsize: int = 0) -> int:
    """How many host blocks a ``host_cache_mb`` budget buys: one logical
    block spans every layer's K and V slab (and, for int8 pools with
    ``scale_itemsize`` 4, the f32 per-row scales beside them)."""
    per_block = 2 * n_layers * hk * bt * (hd * itemsize + scale_itemsize)
    return max(1, int(mb * 2**20) // per_block)


def as_bits(arr: np.ndarray) -> np.ndarray:
    """A bf16 array in its 16-bit patterns: an ml_dtypes ``bfloat16``
    array, or the ``|V2`` that ``np.load`` gives back for one, viewed as
    ``uint16``; any other array unchanged."""
    arr = np.asarray(arr)
    if arr.dtype.itemsize == 2 and (arr.dtype.name == BF16
                                    or arr.dtype.kind == "V"):
        return arr.view(np.uint16)
    return arr


def dtype_name(dtype: torch.dtype) -> str:
    """The name a host array of ``dtype`` carries in sidecars and
    payloads: numpy's name, ``"bfloat16"`` for bf16 (its bits ride as
    ``uint16``)."""
    if dtype == torch.bfloat16:
        return BF16
    return str(torch.empty(0, dtype=dtype).numpy().dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's numpy view; bf16 as its ``uint16`` bit patterns."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_torch(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A numpy array as a CPU tensor of ``dtype`` sharing its memory;
    ``uint16`` bit patterns become bf16 again."""
    arr = np.ascontiguousarray(arr)
    if dtype == torch.bfloat16:
        return torch.from_numpy(as_bits(arr).view(np.int16)).view(dtype)
    return torch.from_numpy(arr)


def _runs(blocks) -> list:
    """``(i0, b0, n)`` for each run of consecutive ids in ``blocks``:
    positions ``i0 .. i0 + n - 1`` hold blocks ``b0 .. b0 + n - 1``, one
    contiguous range of the block-major host slab (and one copy)."""
    out = []
    for i, b in enumerate(blocks):
        if out and out[-1][1] + out[-1][2] == b:
            out[-1][2] += 1
        else:
            out.append([i, b, 1])
    return out


class HostBlockPool:
    """Host-side block storage: one block-major slab ``[num_blocks, L, 2,
    hk, bt, hd]`` (``slab``, its numpy view ``data``), so a host block holds
    every layer's K and V and a run of consecutive host blocks is one
    contiguous range, copied in one call each way. Content crosses the API
    in the reference's layout ``[L, 2, n, hk, bt, hd]``. Allocation is a
    plain free list — a host block has exactly one owner (the demoted radix
    entry), so no refcounts.

    ``dtype`` is a torch or numpy dtype. With ``device`` a CUDA device the
    slabs are pinned, :meth:`write` takes device tensors as asynchronous
    D2H copies and :meth:`load` hands back device tensors through
    asynchronous H2D copies, each followed by a CUDA event the touched
    blocks keep; every CPU-side :meth:`read`, :meth:`write` of numpy
    content and :meth:`reset` waits on those events first."""

    def __init__(self, num_blocks: int, n_layers: int, hk: int, bt: int,
                 hd: int, dtype, scale_dtype=None, device=None):
        if num_blocks < 1:
            raise ValueError(f"need >= 1 host blocks, got {num_blocks}")
        self.num_blocks = num_blocks
        self.bt = bt
        self.device = None if device is None else torch.device(device)
        self.cuda = self.device is not None and self.device.type == "cuda"
        self.dtype = _torch_dtype(dtype)
        self.slab = torch.zeros(num_blocks, n_layers, 2, hk, bt, hd,
                                dtype=self.dtype, pin_memory=self.cuda)
        self.data = to_numpy(self.slab)
        # quantized pools: per-row f32 scales in a mirrored [blocks, L, 2,
        # hk, bt, 1] slab, so a demoted block round-trips bit-exactly
        self.scale_dtype = (None if scale_dtype is None
                            else _torch_dtype(scale_dtype))
        self.scale_slab = (
            None if self.scale_dtype is None else
            torch.zeros(num_blocks, n_layers, 2, hk, bt, 1,
                        dtype=self.scale_dtype, pin_memory=self.cuda))
        self.scale = (None if self.scale_slab is None
                      else to_numpy(self.scale_slab))
        self._free = list(range(num_blocks - 1, -1, -1))
        self._events: dict = {}      # block -> event after its last copy
        self.high_water = 0
        self.waits = 0               # CPU waits on a copy still running

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self, n: int) -> list[int]:
        """``n`` free blocks, ascending (a run of consecutive ids is one
        copy)."""
        assert n <= len(self._free), (n, len(self._free))
        out = sorted(self._free.pop() for _ in range(n))
        self.high_water = max(self.high_water, self.allocated)
        return out

    def release(self, blocks) -> None:
        """Free ``blocks``. A copy still running out of them keeps its
        event, so a later CPU write waits for it."""
        for b in blocks:
            assert b not in self._free, b
            self._free.append(b)

    def _leaves(self):
        yield "kv", self.slab
        if self.scale_slab is not None:
            yield "scale", self.scale_slab

    def _arrays(self):
        yield "kv", self.data
        if self.scale is not None:
            yield "scale", self.scale

    def wait(self, blocks) -> None:
        """Wait until every copy into or out of ``blocks`` has run (a copy
        already done costs an event query). ``torch.cuda``'s sync-debug
        mode does not see an event wait, so ``waits`` counts the ones that
        found a copy still running: no serve call makes one."""
        seen = set()
        for b in blocks:
            ev = self._events.pop(b, None)
            if ev is None or id(ev) in seen:
                continue
            seen.add(id(ev))
            if not ev.query():
                self.waits += 1
                ev.synchronize()

    def _mark(self, blocks) -> None:
        """Record an event after the copies just queued on ``blocks``."""
        ev = torch.cuda.Event()
        ev.record()
        for b in blocks:
            self._events[b] = ev

    def _bare(self, out: dict):
        return out["kv"] if self.scale is None else out

    def read(self, blocks):
        """The stored K/V for ``blocks`` as numpy ``[L, 2, n, hk, bt, hd]``
        (a copy — callers release the blocks right after); with scale
        slabs, a ``{"kv", "scale"}`` dict."""
        self.wait(blocks)
        return self._bare({
            name: np.ascontiguousarray(np.moveaxis(arr[blocks], 0, 2))
            for name, arr in self._arrays()})

    def write(self, blocks, content) -> None:
        """Store ``content [L, 2, n, hk, bt, hd]`` (or the dict form with
        scales) at ``blocks``: numpy arrays are written on the CPU (after
        any copy still running on those blocks), torch tensors on the
        batcher's device are copied in, on CUDA asynchronously, one copy a
        run of consecutive blocks."""
        if isinstance(content, dict):
            if ("scale" in content) != (self.scale is not None):
                raise ValueError("scale payload/slab mismatch")
        elif self.scale is not None:
            raise ValueError("quantized host pool needs a scale payload")
        else:
            content = {"kv": content}
        if not isinstance(content["kv"], torch.Tensor):
            self.wait(blocks)
            for name, arr in self._arrays():
                arr[blocks] = np.moveaxis(as_bits(content[name]), 2, 0)
            return
        runs = _runs(blocks)
        for name, slab in self._leaves():
            src = content[name].movedim(2, 0)
            for i0, b0, n in runs:
                slab[b0:b0 + n].copy_(src[i0:i0 + n], non_blocking=True)
        if content["kv"].is_cuda:
            self._mark(blocks)

    def load(self, blocks) -> dict:
        """The stored K/V for ``blocks`` on ``device`` (the CPU without
        one) as a ``{"kv"[, "scale"]}`` dict of ``[L, 2, n, hk, bt, hd]``
        views of block-major tensors: on CUDA copied H2D from the pinned
        slab, one copy a run, stream-ordered after the copies that filled
        it and waiting for nothing; the blocks keep an event after these
        copies, so a CPU write into them once they are released waits."""
        runs = _runs(blocks)
        out = {}
        for name, slab in self._leaves():
            dst = torch.empty(len(blocks), *slab.shape[1:], dtype=slab.dtype,
                              device=self.device)
            for i0, b0, n in runs:
                dst[i0:i0 + n].copy_(slab[b0:b0 + n], non_blocking=True)
            out[name] = dst.movedim(0, 2)
        if self.cuda:
            self._mark(blocks)
        return out

    def snapshot(self, blocks):
        """A copy of ``blocks`` that outlives their release, for a disk
        spill: ``(content, ready)``. On CUDA ``content`` is pinned CPU
        tensors ``[L, 2, n, hk, bt, hd]`` (bare, or the int8 dict) filled by
        a stream-ordered round trip — H2D out of the slab, D2H into fresh
        pinned memory — and ``ready`` the event after it, so the scheduler
        waits for nothing and the disk writer waits on ``ready``. Without
        CUDA, :meth:`read` and None."""
        if not self.cuda:
            return self.read(blocks), None
        out = {}
        for name, t in self.load(blocks).items():
            out[name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out[name].copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return self._bare(out), ready

    def reset(self) -> None:
        """Zero everything and free every block (after every copy still
        running)."""
        self.wait(list(self._events))
        for _, slab in self._leaves():
            slab.zero_()
        self._free = list(range(self.num_blocks - 1, -1, -1))


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class DiskTier:
    """CRC-verified spill directory below the host pool. One radix entry a
    ``part-NNNNN.npz`` (key ``kv``, ``[L, 2, n, hk, bt, hd]``; int8 entries
    add ``scale``, whose CRC, shape and dtype ride the sidecar as
    ``scale_crc``, ``scale_shape``, ``scale_dtype``) with a
    ``part-NNNNN.json`` sidecar. Reads verify both leaves against the
    sidecar; any mismatch or I/O error is a miss — the serving path never
    raises on tier-3 bytes.

    With ``async_writes=True`` (the serve engine's setting) ``put`` returns
    once the bytes are queued: a daemon writer thread waits for them to
    land (``ready``, a CUDA event it polls), computes the CRCs and writes
    the part and its sidecar, ``get`` serves still-queued parts from
    memory, and :meth:`drain` blocks until the queue is flat. A failed
    background write drops its key from the index (a miss). The caller
    must not mutate ``content`` after an async ``put``."""

    def __init__(self, root: str, async_writes: bool = False):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._seq = 0
        self.index: dict[str, dict] = {}
        self.async_writes = async_writes
        self._mu = threading.Lock()
        self._pending: dict = {}     # key -> array or {"kv", "scale"}
        self._q: queue.Queue = queue.Queue()
        self._writer: threading.Thread | None = None
        self._scan_on_open()

    def _scan_on_open(self) -> None:
        """Rebuild the index from the sidecars already in the directory,
        so a restarted process finds the previous one's parts. A sidecar
        that fails to parse or disagrees with its filename skips that
        entry (its sequence number still counts); the lowest-numbered part
        is CRC-checked at once, the rest lazily on every ``get``."""
        found: dict[str, dict] = {}
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return
        for name in names:
            if not (name.startswith("part-") and name.endswith(".json")):
                continue
            key = name[:-len(".json")]
            try:
                seq = int(key.split("-", 1)[1])
            except ValueError:
                continue
            self._seq = max(self._seq, seq + 1)
            try:
                with open(os.path.join(self.root, name)) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            if (not isinstance(rec, dict) or rec.get("key") != key
                    or not isinstance(rec.get("crc"), int)
                    or not isinstance(rec.get("shape"), list)
                    or not isinstance(rec.get("dtype"), str)
                    or not os.path.exists(
                        os.path.join(self.root, key + ".npz"))):
                continue
            found[key] = rec
        if found:
            spot = min(found)
            self.index = found
            if self.get(spot)[0] is None:
                self.index.pop(spot, None)

    def _write_part(self, key: str, content, rec: dict) -> None:
        """Complete ``rec`` with the CRCs (and the scale's shape and dtype)
        of ``content`` (numpy, or CPU tensors) and write the part and its
        sidecar."""
        arrays = {name: to_numpy(v) if isinstance(v, torch.Tensor) else v
                  for name, v in (content.items() if isinstance(content, dict)
                                  else (("kv", content),))}
        crcs = {"crc": _crc(arrays["kv"])}
        if "scale" in arrays:
            sc = arrays["scale"]
            crcs.update(scale_crc=_crc(sc), scale_shape=list(sc.shape),
                        scale_dtype=str(sc.dtype))
        rec.update(crcs)
        np.savez(os.path.join(self.root, key + ".npz"), **arrays)
        with open(os.path.join(self.root, key + ".json"), "w") as f:
            json.dump(rec, f)

    def _write_loop(self) -> None:
        while True:
            key, ready = self._q.get()
            try:
                # the spill's copies still running: polled, so this thread
                # never blocks in the driver
                while ready is not None and not ready.query():
                    time.sleep(5e-4)
                with self._mu:
                    content = self._pending.get(key)
                    rec = self.index.get(key)
                if content is None or rec is None:
                    continue         # dropped before the write landed
                try:
                    self._write_part(key, content, rec)
                except OSError:
                    with self._mu:   # degrade to a miss, never raise
                        self.index.pop(key, None)
                with self._mu:
                    self._pending.pop(key, None)
                    dead = key not in self.index
                if dead:             # dropped (or failed) mid-write
                    self._remove_files(key)
            finally:
                self._q.task_done()

    def _remove_files(self, key: str) -> None:
        for ext in (".npz", ".json"):
            try:
                os.remove(os.path.join(self.root, key + ext))
            except OSError:
                pass

    def put(self, content, tokens=(), weights_version: int = 0,
            dtype: str | None = None, ready=None) -> str:
        """Spill ``content`` (numpy, or pinned CPU tensors that are still
        being filled until the CUDA event ``ready`` has passed: async
        writes only); ``dtype`` names the kv dtype for the sidecar where
        numpy cannot (``"bfloat16"`` for bf16). Returns the part's key. The
        CRCs are computed where the part is written, on the writer thread
        with async writes."""
        key = f"part-{self._seq:05d}"
        self._seq += 1
        kv = content["kv"] if isinstance(content, dict) else content
        rec = {"key": key, "shape": list(kv.shape),
               "dtype": dtype or str(kv.dtype),
               "tokens": [int(t) for t in tokens],
               "weights_version": int(weights_version)}
        if not self.async_writes:
            if ready is not None:
                ready.synchronize()
            self._write_part(key, content, rec)
            self.index[key] = rec
            return key
        with self._mu:
            self.index[key] = rec
            self._pending[key] = content
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._write_loop, daemon=True, name="kv-disk-writer")
            self._writer.start()
        self._q.put((key, ready))
        return key

    def get(self, key: str):
        """``(content, corrupt)``: the verified bytes (a bare ``kv`` array,
        or a ``{"kv", "scale"}`` dict), ``(None, True)`` when the part
        fails its CRC, shape or dtype check on either leaf or cannot be
        read, ``(None, False)`` for an unknown key. A ``"bfloat16"`` part
        comes back as ``uint16`` bit patterns; a part still queued comes
        back as it was put (after :meth:`drain`, always numpy)."""
        with self._mu:
            rec = self.index.get(key)
            content = self._pending.get(key)
        if rec is None:
            return None, False
        if content is not None:
            return content, False    # not yet flushed: memory is truth
        path = os.path.join(self.root, key + ".npz")
        try:
            with np.load(path) as z:
                arr = np.asarray(z["kv"])
                sc = (np.asarray(z["scale"])
                      if "scale_crc" in rec else None)
        except Exception:            # noqa: BLE001 — any unreadable part
            return None, True        # (zip, header, pickle) is a miss
        want = rec["dtype"]
        if want == BF16:
            arr = as_bits(arr)
            got = BF16 if arr.dtype == np.uint16 else str(arr.dtype)
        else:
            got = str(arr.dtype)
        if (list(arr.shape) != rec["shape"] or got != want
                or _crc(arr) != rec["crc"]):
            return None, True
        if sc is None:
            return arr, False
        if (list(sc.shape) != rec.get("scale_shape")
                or str(sc.dtype) != rec.get("scale_dtype")
                or _crc(sc) != rec.get("scale_crc")):
            return None, True
        return {"kv": arr, "scale": sc}, False

    def drop(self, key: str) -> None:
        with self._mu:
            self.index.pop(key, None)
            self._pending.pop(key, None)
        self._remove_files(key)

    def drain(self) -> None:
        """Block until every queued write has landed (or been dropped); a
        no-op without async writes."""
        if self.async_writes:
            self._q.join()

    def reset(self) -> None:
        """Drop every indexed part and sweep stray ``part-*`` files the
        index never adopted."""
        self.drain()
        for key in list(self.index):
            self.drop(key)
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            if name.startswith("part-") and (name.endswith(".npz")
                                             or name.endswith(".json")):
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass


class KVTierManager:
    """Bookkeeping for the demoted half of the radix tree: which entries
    live in which tier, where their bytes are, and the LRU order that
    decides host-to-disk spills. The serve engine supplies the device
    halves (the gather handed to :meth:`store`, the scatter after
    :meth:`fetch`)."""

    def __init__(self, radix, host: HostBlockPool,
                 disk: DiskTier | None = None, stats=None):
        self.radix = radix
        self.host = host
        self.disk = disk
        self.stats = dict(TIER_STATS) if stats is None else stats
        # the weights-version stamp: spills write it into their sidecars,
        # adoption declines parts stamped otherwise
        self.weights_version = 0
        self.fleet_stats = {"version_declined": 0}
        self._demoted: list = []     # entries in the HOST or DISK tier
        # an entry mid-promotion: its device-block allocation may demote
        # or spill colder entries, never this one (the engine pins it)
        self.pin = None
        radix.on_tier_drop = self._drop

    # ---- demotion (device -> host [-> disk]) -----------------------------

    def store(self, entry, content) -> bool:
        """Capture an evicted entry's K/V ``[L, 2, n, hk, bt, hd]`` (bare,
        or the ``{"kv", "scale"}`` dict of an int8 pool; device tensors
        from a demotion, numpy from an import) into the host tier,
        spilling host-LRU entries to disk (or dropping them, diskless) to
        make room. False = no room even after spilling everything: the
        entry is discarded, the tier-off behaviour."""
        kv = content["kv"] if isinstance(content, dict) else content
        n = kv.shape[2]
        if n > self.host.num_blocks:
            return False
        while self.host.free_count < n:
            if not self._spill_one():
                return False
        hb = self.host.alloc(n)
        self.host.write(hb, content)
        entry.tier = TIER_HOST
        entry.host_blocks = hb
        entry.disk_key = None
        self._demoted.append(entry)
        self.stats["demotions"] += 1
        self.stats["bytes_d2h"] += _content_nbytes(content)
        self.stats["host_pool_occupancy"] = max(
            self.stats["host_pool_occupancy"],
            self.host.allocated / self.host.num_blocks)
        return True

    def _spill_one(self) -> bool:
        """Push the LRU host-tier entry one level down: to disk when
        configured, out of existence otherwise. The spill frees the host
        blocks at once and waits for nothing: the disk tier gets a
        :meth:`HostBlockPool.snapshot` and its writer thread waits for the
        copy, computes the CRCs and writes the part."""
        hosted = [e for e in self._demoted
                  if e.tier == TIER_HOST and e is not self.pin]
        if not hosted:
            return False
        victim = min(hosted, key=lambda e: e.last_used)
        if self.disk is not None:
            content, ready = self.host.snapshot(victim.host_blocks)
            victim.disk_key = self.disk.put(
                content, tokens=getattr(victim, "tokens", ()) or (),
                weights_version=getattr(victim, "weights_version",
                                        self.weights_version),
                dtype=dtype_name(self.host.dtype), ready=ready)
            self.host.release(victim.host_blocks)
            victim.host_blocks = []
            victim.tier = TIER_DISK
            self.stats["disk_spills"] += 1
        else:
            self._remove(victim)
        return True

    # ---- promotion (host/disk -> device) ---------------------------------

    def fetch(self, entry):
        """Take a demoted entry's bytes for promotion (a MOVE: the spill
        copy is released): from the host tier a ``{"kv"[, "scale"]}`` dict
        of tensors on the pool's device (:meth:`HostBlockPool.load`), from
        the disk tier numpy, bare or the int8 dict. None on a disk miss —
        the entry is already gone from the tree and the caller prefills
        again."""
        if entry.tier == TIER_HOST:
            content = self.host.load(entry.host_blocks)
            self.host.release(entry.host_blocks)
            entry.host_blocks = []
            self._demoted.remove(entry)
            self.stats["host_hits"] += 1
            self.stats["bytes_h2d"] += _content_nbytes(content)
            return content
        if entry.tier == TIER_DISK:
            content, corrupt = self.disk.get(entry.disk_key)
            if content is None:
                if corrupt:
                    self.stats["disk_crc_miss"] += 1
                self._remove(entry)
                return None
            self.disk.drop(entry.disk_key)
            entry.disk_key = None
            self._demoted.remove(entry)
            self.stats["disk_hits"] += 1
            self.stats["bytes_h2d"] += _content_nbytes(content)
            return content
        raise AssertionError(f"fetch on resident entry {entry.tier}")

    # ---- restart adoption (disk -> radix) --------------------------------

    def adopt_disk_index(self, expect) -> int:
        """Warm the radix tree from a restarted :class:`DiskTier`'s index:
        every part whose sidecar carries its prefix tokens re-enters the
        tree as a ``TIER_DISK`` entry. ``expect(n_tokens) -> (shape,
        dtype)``, or ``(shape, dtype, scale_shape, scale_dtype)`` for an
        int8 engine, is the adopting engine's geometry: a part of another
        geometry or dtype is skipped, a scale-carrying part never adopts
        into a float pool nor the reverse, and a prefix already in the
        tree is skipped. A part stamped with another ``weights_version``
        declines and counts ``fleet_stats["version_declined"]``. Returns
        the number adopted."""
        if self.disk is None:
            return 0
        adopted = 0
        for key in sorted(self.disk.index):
            rec = self.disk.index[key]
            toks = rec.get("tokens") or []
            if not toks:
                continue             # no prefix tokens: no identity
            if (int(rec.get("weights_version", 0))
                    != int(self.weights_version)):
                self.fleet_stats["version_declined"] += 1
                continue
            exp = expect(len(toks))
            shape, dtype = exp[0], exp[1]
            want_scale = exp[2:] if len(exp) > 2 else None
            if (list(rec.get("shape", [])) != list(shape)
                    or rec.get("dtype") != str(dtype)):
                continue
            has_scale = "scale_crc" in rec
            if want_scale is None:
                if has_scale:        # int8 part, float engine
                    continue
            elif (not has_scale
                  or list(rec.get("scale_shape", []))
                  != list(want_scale[0])
                  or rec.get("scale_dtype") != str(want_scale[1])):
                continue
            entry = self.radix.insert_demoted([int(t) for t in toks])
            if entry is None:        # prefix already in the tree
                continue
            entry.tier = TIER_DISK
            entry.host_blocks = []
            entry.disk_key = key
            self._demoted.append(entry)
            adopted += 1
        self.stats["disk_adopted"] += adopted
        return adopted

    # ---- drops / lifecycle -----------------------------------------------

    def _drop(self, entry) -> None:
        """Release an entry's spill bytes without promoting them (the
        radix revived or discarded it: ``RadixCache.on_tier_drop``)."""
        if entry.tier == TIER_HOST and entry.host_blocks:
            self.host.release(entry.host_blocks)
        if entry.tier == TIER_DISK and entry.disk_key is not None:
            self.disk.drop(entry.disk_key)
        entry.host_blocks = []
        entry.disk_key = None
        if entry in self._demoted:
            self._demoted.remove(entry)

    def _remove(self, entry) -> None:
        """Drop a demoted entry from the tree and its tier bytes."""
        self._drop(entry)
        if entry in self.radix.entries:
            self.radix.entries.remove(entry)
            self.radix._detach(entry)

    def reset(self) -> None:
        """Zero all tiers (a fresh session; the radix is cleared by the
        caller)."""
        self._demoted = []
        self.host.reset()
        if self.disk is not None:
            self.disk.reset()

    def leak_check(self) -> int:
        """Host blocks whose ownership is unaccounted: every allocated host
        block must belong to exactly one tracked HOST-tier entry."""
        owned: set[int] = set()
        leaks = 0
        for e in self._demoted:
            if e.tier != TIER_HOST:
                continue
            for b in e.host_blocks:
                if b in owned:
                    leaks += 1       # double-owned
                owned.add(b)
        live = set(range(self.host.num_blocks)) - set(self.host._free)
        return leaks + len(live ^ owned)
