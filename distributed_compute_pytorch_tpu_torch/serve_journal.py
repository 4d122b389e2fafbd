"""The write-ahead session journal — the port of
``distributed_compute_pytorch_tpu/serve_journal.py``, frame for frame.

An append-only, CRC-32-framed log records, for every request, (a) an
ADMISSION frame — stable request id, prompt tokens, sampling settings, the
materialised seed, deadline — written before the request's first device
work, (b) a DELTA frame per harvest with the tokens that reached the host,
and (c) an END frame with its final status; and once per process a CONFIG
frame (the pool's ``kv_dtype`` and ``weights_version``). A restarted
process replays the log into a :class:`RecoveryManifest`;
``ContinuousBatcher.serve_detailed(recovery=)`` dedups the requests the
journal shows completed (their recorded stream, no device work) and
re-admits incomplete sessions as prompt + emitted-so-far continuations.

Soundness: a row's next token depends only on (its seed, the logical
position it consumes) — the port's sampling noise is keyed on exactly that
(``infer.sample_rows``), and greedy on neither — so re-admitting ``prompt +
emitted`` with the journaled seed continues the uninterrupted stream. The
journal records only tokens that reached the host, so a crash between a
dispatch and its harvest loses nothing recorded.

Frame format, the reference's byte for byte (a journal written by either
package recovers in the other)::

    [4B length LE] [4B CRC-32 of payload LE] [length bytes of JSON payload]

with compact separators. A torn tail — a short header, a short payload, a
CRC mismatch or undecodable JSON — truncates the log at the last valid
frame: recovery treats it as a clean end and never raises. Both
:func:`recover` and the :class:`ServeJournal` writer repair the tail on
open.

Durability is the ``fsync`` policy: ``every_frame`` (an fsync a frame),
``every_harvest`` (one a harvest boundary, the default) or ``os`` (flush to
the page cache at each commit, never fsync: survives any process death,
not a power loss). The reference's tracer instants and flight records of a
torn tail and a recovery wait for the port's telemetry.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from dataclasses import dataclass, field

FSYNC_POLICIES = ("every_frame", "every_harvest", "os")

# the journal's counters, under the reference's keys
JOURNAL_STATS = {
    "frames": 0, "bytes": 0, "fsyncs": 0,
    "torn_tail_truncations": 0,
    "recovered_sessions": 0,
    "deduped_completions": 0,
    "recovery_replay_tokens": 0,
}

_HDR = struct.Struct("<II")
_WAL = "serve.wal"


def _scan(path: str):
    """Every valid frame of ``path``: ``(frames, valid_end, file_size)``,
    ``frames`` the decoded payload dicts in order and ``valid_end`` the
    byte offset where the last valid frame ends. Whatever follows is a torn
    tail: scanning stops there, nothing raises."""
    frames: list[dict] = []
    if not os.path.exists(path):
        return frames, 0, 0
    with open(path, "rb") as f:
        data = f.read()
    size = len(data)
    off = 0
    while off + _HDR.size <= size:
        length, crc = _HDR.unpack_from(data, off)
        end = off + _HDR.size + length
        if end > size:
            break
        payload = data[off + _HDR.size:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break
        try:
            obj = json.loads(payload)
        except ValueError:
            break
        if isinstance(obj, dict):
            frames.append(obj)
        off = end
    return frames, off, size


def _repair_tail(path: str, stats=None) -> int:
    """Truncate ``path`` at its last valid frame; returns the torn bytes
    removed (0 = the file was clean)."""
    _frames, valid_end, size = _scan(path)
    torn = size - valid_end
    if torn > 0:
        with open(path, "rb+") as f:
            f.truncate(valid_end)
        if stats is not None:
            stats["torn_tail_truncations"] += 1
    return torn


class ServeJournal:
    """The log's writer. Thread-safe; frames of different sessions
    interleave freely (recovery keys everything by request id). ``stats``
    is a live counter dict, the one a batcher writing here reports as its
    ``journal``."""

    def __init__(self, root: str, fsync: str = "every_harvest",
                 stats=None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync must be one of {FSYNC_POLICIES}, "
                             f"got {fsync!r}")
        self.root = root
        self.fsync = fsync
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, _WAL)
        self.stats = dict(JOURNAL_STATS) if stats is None else stats
        self._mu = threading.Lock()
        # appending after a torn tail would bury good frames behind a bad
        # one: repair before the first append
        _repair_tail(self.path, self.stats)
        self._f = open(self.path, "ab")

    def _append(self, obj: dict) -> None:
        payload = json.dumps(obj, separators=(",", ":")).encode()
        hdr = _HDR.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
        with self._mu:
            self._f.write(hdr)
            self._f.write(payload)
            self.stats["frames"] += 1
            self.stats["bytes"] += len(hdr) + len(payload)
            if self.fsync == "every_frame":
                self._f.flush()
                os.fsync(self._f.fileno())
                self.stats["fsyncs"] += 1

    def admit(self, rid: str, prompt, max_new: int, *,
              temperature: float = 0.0, top_k=None, top_p=None,
              seed=None, deadline_s=None, emitted=()) -> None:
        """The admission record, appended (and committed) before the
        request's first device work. ``emitted`` carries the prefix already
        generated when the admission is itself a recovery replay, so a
        second crash recovers the whole stream."""
        self._append({"kind": "admit", "id": rid,
                      "prompt": [int(t) for t in prompt],
                      "max_new": int(max_new),
                      "temperature": float(temperature),
                      "top_k": top_k, "top_p": top_p,
                      "seed": None if seed is None else int(seed),
                      "deadline_s": deadline_s,
                      "emitted": [int(t) for t in emitted]})

    def config(self, obj: dict) -> None:
        """The process's serving configuration whose change across a
        restart would change recovered streams: the pool's ``kv_dtype``
        (refused on mismatch) and ``weights_version`` (warned on mismatch;
        tokens replay). :func:`recover` surfaces the last one."""
        self._append({"kind": "config", "config": dict(obj)})

    def delta(self, rid: str, tokens) -> None:
        """The tokens that reached the host at one harvest (after the eos
        trim: only delivered tokens)."""
        self._append({"kind": "delta", "id": rid,
                      "tokens": [int(t) for t in tokens]})

    def end(self, rid: str, status: str, error=None) -> None:
        """The terminal status; the stream is the admit's ``emitted`` plus
        every delta since."""
        self._append({"kind": "end", "id": rid, "status": status,
                      "error": error})

    def commit(self) -> None:
        """The harvest-boundary durability point: always flush to the
        kernel (an ``os`` journal must survive SIGKILL), fsync under
        ``every_harvest``."""
        with self._mu:
            self._f.flush()
            if self.fsync == "every_harvest":
                os.fsync(self._f.fileno())
                self.stats["fsyncs"] += 1

    def close(self) -> None:
        with self._mu:
            try:
                self._f.flush()
                if self.fsync != "os":
                    os.fsync(self._f.fileno())
            except ValueError:
                return               # already closed
            self._f.close()


@dataclass
class JournalSession:
    """One request's state rebuilt from the log."""

    request_id: str
    prompt: list | None = None       # None = an end frame with no admit
    max_new: int = 0
    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    seed: int | None = None
    deadline_s: float | None = None
    emitted: list = field(default_factory=list)
    status: str | None = None        # None = still open at the crash
    error: str | None = None

    @property
    def completed(self) -> bool:
        """Dedupable: a terminal status other than ``shed`` (a shed request
        spent no device work; running it again is always sound)."""
        return self.status is not None and self.status != "shed"


@dataclass
class RecoveryManifest:
    """What :func:`recover` found: ``sessions`` by request id, the scan's
    accounting, and the last ``config`` frame (``None`` without one)."""

    sessions: dict = field(default_factory=dict)
    frames: int = 0
    torn_bytes: int = 0
    path: str | None = None
    config: dict | None = None

    @property
    def weights_version(self) -> int | None:
        """The ``weights_version`` the journaling process served under, or
        ``None`` for a journal without the stamp."""
        if self.config is None or "weights_version" not in self.config:
            return None
        return int(self.config["weights_version"])

    @property
    def completed(self) -> dict:
        return {rid: s for rid, s in self.sessions.items() if s.completed}

    @property
    def incomplete(self) -> dict:
        return {rid: s for rid, s in self.sessions.items()
                if not s.completed and s.prompt is not None}


def recover(root: str) -> RecoveryManifest:
    """Replay the journal under ``root`` into a manifest. A torn tail
    truncates at the last valid frame; a missing or empty journal is an
    empty manifest.

    Per-id rules (the reference's):

    - a ``config`` frame has no id; the last one lands in ``config``;
    - a later admit whose prompt EXTENDS the session's is a continuation
      (a crash replay, or a router migration's prompt + partial): its
      extension plus its ``emitted`` replace the deltas so far, and the
      session re-opens;
    - a later admit with the same prompt is a replay from scratch: its
      ``emitted`` replaces the deltas, the session re-opens;
    - an end frame without an admit still records a completion (tokens
      ``[]``).
    """
    path = os.path.join(root, _WAL)
    torn = _repair_tail(path)
    frames, _end, _size = _scan(path)
    sessions: dict[str, JournalSession] = {}
    config: dict | None = None
    for f in frames:
        rid = f.get("id")
        kind = f.get("kind")
        if kind == "config":
            c = f.get("config")
            if isinstance(c, dict):
                config = c
            continue
        if not isinstance(rid, str):
            continue
        s = sessions.get(rid)
        if kind == "admit":
            prompt = [int(t) for t in f.get("prompt", [])]
            emitted = [int(t) for t in f.get("emitted", [])]
            if s is None or s.prompt is None:
                s = sessions[rid] = JournalSession(request_id=rid)
                s.prompt = prompt
                s.emitted = emitted
            else:
                base = s.prompt
                if len(prompt) > len(base) and prompt[:len(base)] == base:
                    s.emitted = prompt[len(base):] + emitted
                else:
                    if prompt != base:
                        s.prompt = prompt
                    s.emitted = emitted
            s.max_new = int(f.get("max_new", 0))
            s.temperature = float(f.get("temperature", 0.0))
            s.top_k = f.get("top_k")
            s.top_p = f.get("top_p")
            s.seed = f.get("seed")
            s.deadline_s = f.get("deadline_s")
            s.status = None          # an admit re-opens the session
            s.error = None
        elif kind == "delta":
            if s is not None:
                s.emitted.extend(int(t) for t in f.get("tokens", []))
        elif kind == "end":
            if s is None:
                s = sessions[rid] = JournalSession(request_id=rid)
            s.status = f.get("status")
            s.error = f.get("error")
    return RecoveryManifest(sessions=sessions, frames=len(frames),
                            torn_bytes=torn, path=path, config=config)
