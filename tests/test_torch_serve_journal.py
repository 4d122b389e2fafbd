"""The port's write-ahead session journal (``serve_journal.py``) and crash
recovery against the JAX package's, on the CPU in f32 — the drills of
``tests/test_serve_journal.py`` pointed at the port: frame round trips,
torn-tail truncation, the re-admission rules and the fsync policies; a
journal written by either package recovered by the other into the same
manifest (the bytes are the same); crash-restart parity (a
``BaseException`` from a chaos hook stands in for a kill: frames just
stop), greedy tokens equal to the JAX batcher's uninterrupted run and
sampled ones to the port's, a third process deduping everything with no
segment; journal on and off serving the same tokens; explicit ids; a crash
restart over the disk tier; a mid-stream journal the JAX batcher wrote
completed by the port's batcher; the CLI's journal and lifecycle flags, its
``kv_dtype`` refusal, its drain and its supervisor."""

import dataclasses
import json
import os
import signal

import jax
import numpy as np
import pytest

from distributed_compute_pytorch_tpu import serve_journal as jsj
from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.serve import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest)
from distributed_compute_pytorch_tpu.serve_lifecycle import (
    ChaosInjector as JaxChaos)
from distributed_compute_pytorch_tpu_torch import cli_serve, interop
from distributed_compute_pytorch_tpu_torch import serve_journal as sj
from distributed_compute_pytorch_tpu_torch import serve_lifecycle
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.serve import (
    ContinuousBatcher, Request)
from distributed_compute_pytorch_tpu_torch.serve_lifecycle import (
    ChaosInjector)
from distributed_compute_pytorch_tpu_torch.train.elastic import (
    EXIT_PREEMPTED, PreemptionGuard, backoff_delays)

from torch_threads import one_thread  # noqa: F401 (autouse)

KW = dict(slots=2, t_max=48, prompt_buf=32, segment=4)


class Boom(BaseException):
    """The crash lever: past every ``except Exception`` of the serve loop,
    so to the journal it is a kill (its frames just stop)."""


def _crash_at(threshold, cls=ChaosInjector):
    def hook(seg):
        if seg >= threshold:
            raise Boom(f"injected process death at segment {seg}")
    return cls(on_segment=hook)


@pytest.fixture(scope="module")
def gpt2():
    """JAX GPT-2-tiny (positions lifted to 128), its weights and the port's
    copy."""
    jm = JaxGPT2(dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=128))
    params, _ = jm.init(jax.random.key(0))
    tm = interop.load_gpt2_params(
        GPT2(dataclasses.replace(GPT2Config.tiny(), max_seq_len=128),
             device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def _port(gpt2, **kw):
    return ContinuousBatcher(gpt2[2], **{**KW, **kw}, device="cpu")


def _prompts():
    rng = np.random.default_rng(3)
    return [[int(t) for t in rng.integers(0, 50, size=n)] for n in (6, 9, 5)]


def _reqs(cls=Request, sampled=True):
    """Three requests of 12 tokens; the second sampled (top-k 5)."""
    return [cls(list(p), 12, temperature=0.8 if i == 1 and sampled else 0.0,
                top_k=5 if i == 1 and sampled else None)
            for i, p in enumerate(_prompts())]


def _write_frames(j):
    j.config({"kv_dtype": "bf16", "weights_version": 0})
    j.admit("r1", [1, 2, 3], 8, temperature=0.7, top_k=5, seed=5,
            deadline_s=9.5)
    j.delta("r1", [10, 11])
    j.admit("r2", [4, 5], 4)
    j.delta("r2", [20])
    j.end("r2", "ok")
    j.admit("r3", [7, 8], 6)
    j.delta("r3", [30, 31])
    j.admit("r3", [7, 8, 30, 31], 4)
    j.delta("r3", [32])
    j.end("r4", "failed", error="bad prompt")
    j.admit("r5", [9], 3)
    j.end("r5", "shed")
    j.admit("r6", [1, 2, 3], 8, emitted=[10, 11], seed=5)
    j.delta("r6", [12])
    j.end("r6", "ok")
    j.commit()
    j.close()


def _manifest(m):
    return ({rid: dataclasses.asdict(s) for rid, s in m.sessions.items()},
            m.frames, m.torn_bytes, m.config, sorted(m.completed),
            sorted(m.incomplete), m.weights_version)


# ---- the journal alone -------------------------------------------------------


def test_frames_and_readmit_rules(tmp_path):
    """Interleaved frames replay into per-id state: completed and
    incomplete partition by terminal status; a prompt-extension admit folds
    its extension into ``emitted``; a continuation admit resets the deltas;
    an end frame without an admit is a completion; ``shed`` never dedups;
    the last config frame is surfaced."""
    d = str(tmp_path)
    j = sj.ServeJournal(d)
    _write_frames(j)
    assert j.stats["frames"] == 16 and j.stats["fsyncs"] >= 1
    m = sj.recover(d)
    assert m.frames == 16 and m.torn_bytes == 0
    assert m.config == {"kv_dtype": "bf16", "weights_version": 0}
    assert m.weights_version == 0
    s1 = m.sessions["r1"]
    assert (s1.prompt, s1.emitted, s1.status) == ([1, 2, 3], [10, 11], None)
    assert (s1.temperature, s1.top_k, s1.seed, s1.deadline_s) == \
        (0.7, 5, 5, 9.5)
    assert m.sessions["r2"].completed and m.sessions["r2"].emitted == [20]
    s3 = m.sessions["r3"]
    assert s3.prompt == [7, 8] and s3.emitted == [30, 31, 32]
    assert not s3.completed
    s4 = m.sessions["r4"]
    assert s4.completed and s4.prompt is None and s4.error == "bad prompt"
    assert m.sessions["r5"].status == "shed" and "r5" in m.incomplete
    assert m.sessions["r6"].emitted == [10, 11, 12]
    assert sorted(m.completed) == ["r2", "r4", "r6"]
    assert sorted(m.incomplete) == ["r1", "r3", "r5"]


def test_torn_tail_truncates(tmp_path):
    """A short payload, a short header and a flipped CRC are torn tails:
    recovery truncates at the last valid frame and never raises; the repair
    is idempotent; the writer repairs before its first append."""
    d = str(tmp_path)
    j = sj.ServeJournal(d)
    j.admit("r1", [1, 2], 4)
    j.delta("r1", [7])
    j.commit()
    j.close()
    wal = os.path.join(d, "serve.wal")
    clean = os.path.getsize(wal)
    with open(wal, "ab") as f:
        f.write(b"\x40\x00\x00\x00junk")
    m = sj.recover(d)
    assert m.frames == 2 and m.torn_bytes == 8
    assert os.path.getsize(wal) == clean and sj.recover(d).torn_bytes == 0
    with open(wal, "ab") as f:
        f.write(b"\x03\x00")
    assert sj.recover(d).torn_bytes == 2
    with open(wal, "rb") as f:
        data = f.read()
    with open(wal, "wb") as f:
        f.write(data[:-1] + bytes([data[-1] ^ 0xFF]))
    m = sj.recover(d)
    assert m.frames == 1 and m.torn_bytes > 0
    assert m.sessions["r1"].emitted == []
    with open(wal, "ab") as f:
        f.write(b"\xff\xff")
    j2 = sj.ServeJournal(d)
    assert j2.stats["torn_tail_truncations"] == 1
    j2.delta("r1", [8])
    j2.commit()
    j2.close()
    assert sj.recover(d).sessions["r1"].emitted == [8]


def test_fsync_policies(tmp_path):
    """``every_frame`` fsyncs each frame, ``every_harvest`` each commit,
    ``os`` never (yet a commit reaches the page cache); an unknown policy is
    refused."""
    with pytest.raises(ValueError, match="fsync"):
        sj.ServeJournal(str(tmp_path / "bad"), fsync="always")
    jf = sj.ServeJournal(str(tmp_path / "f"), fsync="every_frame")
    jf.admit("r", [1], 2)
    jf.delta("r", [3])
    assert jf.stats["fsyncs"] == 2
    jf.commit()
    assert jf.stats["fsyncs"] == 2
    jf.close()
    jh = sj.ServeJournal(str(tmp_path / "h"))
    jh.admit("r", [1], 2)
    jh.commit()
    jh.commit()
    assert jh.stats["fsyncs"] == 2
    jh.close()
    jo = sj.ServeJournal(str(tmp_path / "o"), fsync="os")
    jo.admit("r", [1], 2)
    jo.commit()
    assert jo.stats["fsyncs"] == 0
    assert sj.recover(str(tmp_path / "o")).frames == 1
    jo.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_crosses_packages(tmp_path, writer):
    """The same frames written by either package are the same bytes, and
    each package's ``recover`` turns either file into the same manifest."""
    dirs = {w: str(tmp_path / w) for w in ("jax", "port")}
    _write_frames(jsj.ServeJournal(dirs["jax"]))
    _write_frames(sj.ServeJournal(dirs["port"]))
    with open(os.path.join(dirs["jax"], "serve.wal"), "rb") as f:
        jax_bytes = f.read()
    with open(os.path.join(dirs["port"], "serve.wal"), "rb") as f:
        assert f.read() == jax_bytes
    other = "port" if writer == "jax" else "jax"
    got = sj.recover(dirs[writer]) if other == "port" else \
        jsj.recover(dirs[writer])
    want = jsj.recover(dirs[writer]) if other == "port" else \
        sj.recover(dirs[writer])
    assert _manifest(got) == _manifest(want)


# ---- crash and recovery through the batcher ----------------------------------


def test_crash_restart_parity(gpt2, tmp_path):
    """A journaling batcher dies mid-stream; a new one recovers from the
    journal and completes every session: greedy streams equal the JAX
    batcher's uninterrupted run, the sampled one the port's; ids thread
    through; no leak; a third process dedups everything with no segment.
    A journal-on run without a crash serves the journal-off tokens."""
    jm, params, _ = gpt2
    want_jax = JaxBatcher(jm, params, decode_width_buckets=1, **KW).serve(
        _reqs(JaxRequest, sampled=False))
    ref = _port(gpt2)
    want = ref.serve_detailed(_reqs())
    assert all(r.ok for r in want)
    assert [r.request_id for r in want] == ["req-0", "req-1", "req-2"]
    assert want[0].tokens == want_jax[0] and want[2].tokens == want_jax[2]
    jd = str(tmp_path / "wal")
    on = _port(gpt2, journal_dir=str(tmp_path / "on"), journal_fsync="os")
    assert on.serve(_reqs()) == [r.tokens for r in want]
    assert on.journal["frames"] >= 2 * 3 and on.journal["fsyncs"] == 0
    cb1 = _port(gpt2, journal_dir=jd)
    with pytest.raises(Boom):
        cb1.serve_detailed(_reqs(), chaos=_crash_at(3))
    man = sj.recover(jd)
    assert man.incomplete and man.config == {"kv_dtype": "bf16",
                                             "weights_version": 0}
    assert any(s.emitted for s in man.incomplete.values())
    cb2 = _port(gpt2, journal_dir=jd)
    got = cb2.serve_detailed(_reqs(), recovery=man)
    for w, g in zip(want, got):
        assert g.ok and g.tokens == w.tokens, (w.tokens, g.tokens, g.error)
        assert g.request_id == w.request_id
    assert cb2.journal["recovered_sessions"] >= 1
    assert cb2.journal["recovery_replay_tokens"] >= 1
    assert cb2.last_slot_leaks == 0 and cb2.last_block_leaks == 0
    cb3 = _port(gpt2, journal_dir=jd)
    again = cb3.serve_detailed(_reqs(), recovery=sj.recover(jd))
    assert [r.tokens for r in again] == [r.tokens for r in want]
    assert cb3.stats["segments"] == 0
    assert cb3.journal["deduped_completions"] == 3


def test_jax_journal_completed_by_port(gpt2, tmp_path):
    """A JAX batcher journals and dies mid-stream; the port's batcher
    recovers that journal and completes every greedy session to the JAX
    batcher's uninterrupted tokens. Explicit ids thread through, and
    recovery dedups by id whatever the order."""
    jm, params, _ = gpt2
    ids = ["alpha", "beta", "gamma"]

    def reqs(cls):
        return [cls(list(p), 12, request_id=i)
                for p, i in zip(_prompts(), ids)]
    want = JaxBatcher(jm, params, decode_width_buckets=1, **KW).serve(
        reqs(JaxRequest))
    jd = str(tmp_path)
    jb = JaxBatcher(jm, params, decode_width_buckets=1, journal_dir=jd,
                    **KW)
    with pytest.raises(Boom):
        jb.serve_detailed(reqs(JaxRequest), chaos=_crash_at(3, JaxChaos))
    jb._journal.close()
    man = sj.recover(jd)
    assert set(man.incomplete) == set(ids)
    cb = _port(gpt2, journal_dir=jd)
    got = cb.serve_detailed(reqs(Request), recovery=man)
    assert [r.tokens for r in got] == want
    assert [r.request_id for r in got] == ids
    swapped = _port(gpt2).serve_detailed(
        list(reversed(reqs(Request))), recovery=sj.recover(jd))
    assert [r.tokens for r in swapped] == list(reversed(want))


_TIER_KW = dict(slots=1, t_max=32, prompt_buf=24, segment=4,
                prefix_cache=True, pool_blocks=8)


def _tier_reqs(heads, seed=1, ids=None):
    r = np.random.default_rng(seed)
    return [Request(h + [int(t) for t in r.integers(0, 256, 2)], 6,
                    request_id=None if ids is None else ids[i])
            for i, h in enumerate(heads)]


def test_crash_restart_with_disk_tier(gpt2, tmp_path):
    """The journal and the disk tier together: a process warms the disk
    tier and dies mid-stream; a new one adopts the spilled parts, recovers
    the journaled sessions, hits the previous process's K/V on disk, and
    every stream equals the uncrashed run's."""
    rng = np.random.default_rng(17)
    heads = [[int(t) for t in rng.integers(0, 256, 17)] for _ in range(3)]
    off = _port(gpt2, **_TIER_KW)
    hot = _tier_reqs(heads, seed=7, ids=["hot-0", "hot-1", "hot-2"])
    want = off.serve_detailed([dataclasses.replace(r) for r in hot])
    dd, jd = str(tmp_path / "disk"), str(tmp_path / "wal")
    tier = dict(host_cache_blocks=3, disk_cache_dir=dd, journal_dir=jd)
    b1 = _port(gpt2, **_TIER_KW, **tier)
    for p in range(2):
        for i, h in enumerate(heads):
            s = 3 * p + i
            assert b1.serve_detailed(_tier_reqs(
                [h], seed=s, ids=[f"warm-{p}-{i}"]))[0].tokens == \
                off.serve_detailed(_tier_reqs([h], seed=s))[0].tokens
    b1._tier.disk.drain()
    assert b1.tier["disk_spills"] >= 1
    with pytest.raises(Boom):
        b1.serve_detailed([dataclasses.replace(r) for r in hot],
                          chaos=_crash_at(2))
    man = sj.recover(jd)
    assert {"hot-0", "hot-1", "hot-2"} <= man.sessions.keys()
    b2 = _port(gpt2, **_TIER_KW, **tier)
    assert b2.tier["disk_adopted"] >= 1
    got = b2.serve_detailed([dataclasses.replace(r) for r in hot],
                            recovery=man)
    for w, g in zip(want, got):
        assert g.ok and g.tokens == w.tokens, (w.tokens, g.tokens, g.error)
    assert b2.tier["disk_hits"] >= 1 and b2.stats["prefix_hits"] >= 1
    assert b2.last_block_leaks == 0 and b2.last_host_block_leaks == 0


# ---- the CLI -----------------------------------------------------------------


def _cli(tmp_path, lines, *extra):
    reqs = tmp_path / "reqs.txt"
    reqs.write_text("".join(line + "\n" for line in lines))
    return ["--device", "cpu", "--init_seed", "0", "--model_preset", "tiny",
            "--requests", str(reqs), "--slots", "2", "--segment", "4",
            "--max_new_tokens", "6", *extra]


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def test_cli_journal_recovery_and_checks(tmp_path, capsys):
    """The CLI journals a drilled run (a raised harvest, the watchdog on)
    and a rerun on the same directory dedups it line for line; a journal of
    another ``kv_dtype`` is refused; the lifecycle flags are checked; JSON
    requests carry ``deadline`` and ``id``; an expired deadline prints its
    status and error."""
    jd = str(tmp_path / "wal")
    lines = ["1,2,3", '{"tokens": [4, 5, 6], "max_new": 5, "id": "x", '
             '"deadline": 100}', "7 8"]
    base = _cli(tmp_path, lines, "--journal_dir", jd)
    assert cli_serve.main(base + ["--fault_at_segment", "2",
                                  "--tick_timeout", "5"]) == 0
    first = _lines(capsys)
    assert [r["id"] for r in first] == ["req-00000", "x", "req-00002"]
    assert all(r["status"] == "ok" and "error" not in r for r in first)
    assert cli_serve.main(base) == 0
    assert _lines(capsys) == first
    with pytest.raises(SystemExit, match="kv_dtype"):
        cli_serve.main(base + ["--kv_dtype", "int8"])
    for bad, msg in ((["--supervise", "2"], "journal_dir"),
                     (["--supervise", "-1"], "supervise"),
                     (["--max_pending", "-1"], "max_pending"),
                     (["--tick_timeout", "0"], "tick_timeout"),
                     (["--fault_mode", "poison", "--fault_at_segment", "1"],
                      "poison_request"),
                     (["--weights_version", "1"], "not ported")):
        with pytest.raises(SystemExit, match=msg):
            cli_serve.main(_cli(tmp_path, lines, *bad))
    assert cli_serve.main(_cli(
        tmp_path, ['{"tokens": [1, 2], "deadline": 1e-9}', "3 4"])) == 1
    out = _lines(capsys)
    assert out[0]["status"] == "timeout" and "expired" in out[0]["error"]
    assert out[1]["status"] == "ok"


def test_cli_drain_and_supervisor(tmp_path, capsys, monkeypatch):
    """SIGTERM mid-run drains: admission stops, the queue is shed, the rows
    in flight finish, every line prints and the CLI exits 75. The
    supervisor strips its flag for the child, respawns it after an abnormal
    death with the backoff schedule and passes clean exits through."""
    class Signalling(ChaosInjector):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.on_segment = lambda s: (os.kill(os.getpid(), signal.SIGTERM)
                                         if s == 1 else None)
    monkeypatch.setattr(serve_lifecycle, "ChaosInjector", Signalling)
    before = signal.getsignal(signal.SIGTERM)
    lines = [f"{i + 1},2,3" for i in range(6)]
    rc = cli_serve.main(_cli(tmp_path, lines, "--fault_mode", "slow",
                             "--fault_at_segment", "99"))
    assert rc == EXIT_PREEMPTED
    out = _lines(capsys)
    assert len(out) == 6
    assert [r["status"] for r in out] == ["ok"] * 2 + ["shed"] * 4
    assert all("drain" in r["error"] for r in out[2:])
    assert signal.getsignal(signal.SIGTERM) == before   # handler restored
    with PreemptionGuard() as g:
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.preempted
    assert cli_serve._strip_supervise(
        ["--a", "1", "--supervise", "2", "--supervise=3", "--b"]) == \
        ["--a", "1", "--b"]
    calls, sleeps = [], []
    codes = iter([-9, 70, 0])
    monkeypatch.setattr(cli_serve.subprocess, "call",
                        lambda cmd: calls.append(cmd) or next(codes))
    monkeypatch.setattr(cli_serve.time, "sleep", sleeps.append)
    assert cli_serve.main(["--init_seed", "0", "--requests", "r.txt",
                           "--journal_dir", "wal", "--supervise", "2"]) == 0
    assert len(calls) == 3 and "--supervise" not in calls[0]
    assert calls[0][1:3] == ["-m",
                             "distributed_compute_pytorch_tpu_torch.cli_serve"]
    assert sleeps == backoff_delays(2, 1.0)
    codes = iter([-9, -9, 1])
    assert cli_serve._supervise(1, ["--journal_dir", "w"]) == 1
    assert backoff_delays(0, 1.0) == []
    with pytest.raises(ValueError, match="budget"):
        backoff_delays(-1, 1.0)
