"""The port's KV tiers (``kv_tier.py`` and the batcher's wiring) against the
JAX package's, on the CPU in f32 (the scenarios of ``tests/test_kv_tier.py``
and the tier cases of ``tests/test_serve_journal.py``, pointed at the
port): ``HostBlockPool`` and ``DiskTier`` round trips, corruption as a
miss, the disk index rebuilt on open, ``host_blocks_for_mb`` equal to the
reference's; tier-on serving equal to the JAX batcher's tier-on serving
token for token (greedy rows and sampled rows at ``top_k=1``) with the
same tier counters, and to the port's own tier-off run (sampled rows
too), GPT-2 and Llama; a demotion then promotion bit-exact into other
blocks; disk spill, CRC misses, the warm restart that adopts a directory
(one written by the JAX tier included, and the reverse); leak discipline
across cycles; config and CLI validation; a bf16 part read back bit-exact.

The recipe the serving tests share (the reference's): 8-slot blocks,
``t_max`` 32 (4 blocks a row), an 8-block pool (7 usable), so two cached
17-token heads (3 blocks each) and a live row never fit together and the
least recently used head is evicted at the next admission; one slot, so
admissions and evictions are in a fixed order."""

import dataclasses
import glob
import json
import os
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu import kv_tier as jax_tier
from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, LlamaLM as JaxLlama)
from distributed_compute_pytorch_tpu.serve import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest)
from distributed_compute_pytorch_tpu_torch import interop
from distributed_compute_pytorch_tpu_torch.kv_pool import (
    TIER_DEVICE, TIER_DISK, TIER_HOST)
from distributed_compute_pytorch_tpu_torch.kv_tier import (
    DiskTier, HostBlockPool, host_blocks_for_mb)
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.models.llama import (
    LlamaConfig, LlamaLM)
from distributed_compute_pytorch_tpu_torch.serve import (
    ContinuousBatcher, Request)

COMMON = dict(slots=1, t_max=32, prompt_buf=24, segment=4,
              prefix_cache=True, pool_blocks=8)
# the counters a tier-on run must share with the JAX batcher's
TIER_KEYS = ("demotions", "promotions", "host_hits", "disk_hits",
             "disk_spills", "disk_crc_miss", "bytes_d2h", "bytes_h2d")


@pytest.fixture(scope="module")
def models():
    """JAX GPT-2-tiny and Llama-tiny (positions lifted to 128) and the
    port's copies of their weights."""
    out = {}
    jm = JaxGPT2(dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=128))
    params, _ = jm.init(jax.random.key(0))
    tm = interop.load_gpt2_params(
        GPT2(dataclasses.replace(GPT2Config.tiny(), max_seq_len=128),
             device="cpu"), jax.tree.map(np.asarray, params))
    out["gpt2"] = (jm, params, tm)
    jm = JaxLlama(dataclasses.replace(JaxLlamaConfig.tiny(), max_seq_len=128))
    params, _ = jm.init(jax.random.key(0))
    tm = LlamaLM(dataclasses.replace(LlamaConfig.tiny(), max_seq_len=128),
                 device="cpu")
    tm.load_state_dict(interop.llama_params_from_jax(
        jax.tree.map(np.asarray, params)))
    out["llama"] = (jm, params, tm)
    return out


def _port(models, name="gpt2", **kw):
    return ContinuousBatcher(models[name][2], **{**COMMON, **kw},
                             device="cpu")


def _jax(models, name="gpt2", **kw):
    jm, params, _ = models[name]
    return JaxBatcher(jm, params, decode_width_buckets=1,
                      **{**COMMON, **kw})


def _hot(rng, n=3, ln=17):
    """``n`` hot prefixes, each ending mid-block (copy-on-write attaches)."""
    return [[int(t) for t in rng.integers(0, 256, ln)] for _ in range(n)]


def _reqs(heads, seed=1, sampled=(), top_k=None, cls=Request):
    """One request a head: the head and a 2-token tail of its own; rows in
    ``sampled`` at temperature 0.8 (``top_k``), with their own seeds."""
    r = np.random.default_rng(seed)
    out = []
    for i, h in enumerate(heads):
        req = cls(h + [int(t) for t in r.integers(0, 256, 2)], 6)
        if i in sampled:
            req.temperature, req.top_k, req.seed = 0.8, top_k, 900 + i
        out.append(req)
    return out


def _stream(cb, stream, cls=Request):
    return [cb.serve(_reqs(heads, seed=s, sampled=sm, top_k=k, cls=cls))
            for heads, s, sm, k in stream]


# ---- the tiers alone --------------------------------------------------------


def test_host_pool_roundtrip_and_reset():
    """Writes and reads through the host pool are bit-exact (f32, and bf16
    as its bit patterns), the free list balances, and ``reset`` zeroes the
    slabs."""
    pool = HostBlockPool(4, n_layers=2, hk=2, bt=4, hd=8, dtype=np.float32)
    rng = np.random.default_rng(0)
    content = rng.standard_normal((2, 2, 2, 2, 4, 8)).astype(np.float32)
    blocks = pool.alloc(2)
    pool.write(blocks, content)
    assert pool.allocated == 2 and pool.high_water == 2
    np.testing.assert_array_equal(pool.read(blocks), content)
    pool.release(blocks)
    assert pool.free_count == 4 and pool.high_water == 2
    more = pool.alloc(2)
    pool.write(more, content)
    pool.reset()
    assert pool.free_count == 4
    assert not pool.data.any()
    # bf16: device tensors in (the demotion's path), their bits out
    bf = HostBlockPool(3, n_layers=2, hk=2, bt=4, hd=8, dtype=torch.bfloat16,
                       device="cpu")
    t = torch.from_numpy(content).to(torch.bfloat16)
    hb = bf.alloc(2)
    bf.write(hb, t)
    got = bf.read(hb)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, t.view(torch.int16).numpy().view(
        np.uint16))
    assert torch.equal(bf.load(hb)["kv"], t)


def test_disk_tier_crc_roundtrip_and_corruption(tmp_path):
    """put/get round-trips bit-exact; a flipped byte or a truncated part is
    ``(None, True)``, never an exception; an unknown key is a plain miss;
    drop removes both files."""
    disk = DiskTier(str(tmp_path))
    rng = np.random.default_rng(1)
    content = rng.standard_normal((2, 2, 3, 2, 4, 8)).astype(np.float32)
    key = disk.put(content)
    assert os.path.exists(tmp_path / f"{key}.npz")
    assert os.path.exists(tmp_path / f"{key}.json")
    got, corrupt = disk.get(key)
    assert not corrupt
    np.testing.assert_array_equal(got, content)
    path = tmp_path / f"{key}.npz"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    assert disk.get(key) == (None, True)
    path.write_bytes(bytes(raw[:len(raw) // 3]))
    assert disk.get(key) == (None, True)
    assert disk.get("part-99999") == (None, False)
    disk.drop(key)
    assert not list(tmp_path.glob(f"{key}.*"))


@pytest.mark.parametrize("args", [(1, 2, 2, 4, 8, 4), (0.001, 2, 2, 4, 8, 4),
                                  (2, 2, 2, 4, 8, 4), (128, 12, 12, 16, 64, 2),
                                  (128, 12, 12, 16, 64, 1, 4),
                                  (32, 12, 4, 16, 64, 2)])
def test_host_blocks_for_mb_equals_reference(args):
    """The host budget's block count equals the reference's for the same
    arguments (whole blocks, never below one; scales counted for int8)."""
    assert host_blocks_for_mb(*args) == jax_tier.host_blocks_for_mb(*args)
    assert host_blocks_for_mb(1, 2, 2, 4, 8, 4) == 1024


def test_disk_tier_scan_on_open(tmp_path):
    """A restarted DiskTier rebuilds its index from the sidecars: valid
    parts come back with their tokens, a corrupt sidecar skips (its
    sequence number still burned), and ``reset`` removes every part,
    strays included."""
    d = str(tmp_path)
    t1 = DiskTier(d)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 2, 1, 2, 4, 3)).astype(np.float32)
    b = rng.standard_normal((2, 2, 2, 2, 4, 3)).astype(np.float32)
    ka = t1.put(a, tokens=[1, 2, 3])
    kb = t1.put(b, tokens=[4, 5])
    t2 = DiskTier(d)
    assert sorted(t2.index) == sorted([ka, kb])
    assert t2.index[ka]["tokens"] == [1, 2, 3]
    got, corrupt = t2.get(ka)
    assert not corrupt and np.array_equal(got, a)
    kc = t2.put(a, tokens=[6])
    assert kc not in (ka, kb)
    with open(os.path.join(d, kb + ".json"), "w") as f:
        f.write("{not json")
    t3 = DiskTier(d)
    assert kb not in t3.index and {ka, kc} <= set(t3.index)
    assert int(t3.put(a).split("-")[1]) > int(kb.split("-")[1])
    t3.reset()
    assert t3.index == {}
    assert [n for n in os.listdir(d) if n.startswith("part-")] == []


def test_bf16_disk_part_reads_back_bit_exact(tmp_path):
    """A bf16 part (its bits as uint16, sidecar dtype "bfloat16") reads back
    bit-exact in the port, async or not, and so does one the reference
    wrote; the reference's own tier reads neither back (its ``np.load``
    gives ``|V2``, which its dtype check refuses: ROADMAP §3)."""
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((2, 2, 2, 2, 4, 8)).astype(np.float32)
    bits = torch.from_numpy(vals).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)
    for sub, async_writes in (("sync", False), ("async", True)):
        disk = DiskTier(str(tmp_path / sub), async_writes=async_writes)
        key = disk.put(bits, tokens=[1, 2], dtype="bfloat16")
        disk.drain()
        got, corrupt = DiskTier(str(tmp_path / sub)).get(key)
        assert not corrupt and got.dtype == np.uint16
        np.testing.assert_array_equal(got, bits)
        with open(tmp_path / sub / f"{key}.json") as f:
            rec = json.load(f)
        assert rec["dtype"] == "bfloat16"
        assert rec["crc"] == jax_tier._crc(bits.view(ml_dtypes.bfloat16))
    ref = jax_tier.DiskTier(str(tmp_path / "ref"))
    key = ref.put(bits.view(ml_dtypes.bfloat16), tokens=[1, 2])
    assert ref.get(key) == (None, True)         # the reference's defect
    got, corrupt = DiskTier(str(tmp_path / "ref")).get(key)
    assert not corrupt
    np.testing.assert_array_equal(got, bits)


def test_async_spill_waits_for_its_copy_on_the_writer(tmp_path):
    """An async ``put`` of CPU tensors with a ``ready`` event still pending
    (a spill's pinned snapshot on the card): ``get`` serves the tensors
    from memory, the writer writes nothing until ``ready`` has passed, then
    writes the part with the CRCs it computed, and the part reads back
    bit-exact (bf16 as its bits, an int8 part's scales too)."""
    class Ready:                       # a CUDA event's query() on the CPU
        def __init__(self):
            self.done = threading.Event()

        def query(self):
            return self.done.is_set()

    disk = DiskTier(str(tmp_path), async_writes=True)
    g = torch.Generator().manual_seed(3)
    kv = torch.randn(2, 2, 3, 2, 4, 8, generator=g).to(torch.bfloat16)
    q8 = {"kv": torch.randint(-127, 128, (2, 2, 3, 2, 4, 8), generator=g,
                              dtype=torch.int8),
          "scale": torch.rand(2, 2, 3, 2, 4, 1, generator=g)}
    for content, dtype in ((kv, "bfloat16"), (q8, "int8")):
        ready = Ready()
        key = disk.put(content, tokens=[1, 2], dtype=dtype, ready=ready)
        got, corrupt = disk.get(key)
        assert got is content and not corrupt
        time.sleep(0.05)
        assert not os.path.exists(tmp_path / f"{key}.json")
        ready.done.set()
        disk.drain()
        with open(tmp_path / f"{key}.json") as f:
            rec = json.load(f)
        got, corrupt = disk.get(key)
        assert not corrupt and rec["dtype"] == dtype
        if dtype == "int8":
            np.testing.assert_array_equal(got["scale"],
                                          content["scale"].numpy())
            assert rec["scale_crc"] == jax_tier._crc(content["scale"].numpy())
            got, content = got["kv"], content["kv"]
        want = (content.view(torch.int16).numpy().view(np.uint16)
                if dtype == "bfloat16" else content.numpy())
        np.testing.assert_array_equal(got, want)
        assert rec["crc"] == jax_tier._crc(want)


# ---- serving: the port against the JAX batcher -----------------------------

# waves of (heads, request seed, sampled rows, top_k): the hot set (A, B)
# outgrows the starved pool, so tier-on demotes and promotes the rehits
def _waves(A, B, top_k):
    return [((A,), 1, (), None), ((B,), 2, (), None),
            ((A, A), 3, (1,), top_k), ((B, B), 4, (0,), top_k)]


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_tier_parity_with_jax(models, name):
    """Tier on (host blocks only) through the starved pool, greedy rows and
    sampled rows at ``top_k=1``: the tokens equal the JAX batcher's with its
    tier on, and the port's own tier-off run's; the tier counters (demotions,
    promotions, hits, bytes each way) equal the JAX batcher's; no device or
    host block leaks."""
    rng = np.random.default_rng(5 if name == "gpt2" else 7)
    A, B = _hot(rng, 2)
    waves = _waves(A, B, top_k=1)
    jcb = _jax(models, name, host_cache_blocks=64)
    want = _stream(jcb, waves, cls=JaxRequest)
    on = _port(models, name, host_cache_blocks=64)
    assert _stream(on, waves) == want
    assert _stream(_port(models, name), waves) == want
    for key in TIER_KEYS:
        assert on.tier[key] == jcb.tier[key], key
    assert on.tier["demotions"] >= 1 and on.tier["promotions"] >= 1
    assert on.tier["host_hits"] >= 1
    assert 0 < on.tier["host_pool_occupancy"] <= 1
    assert on.tier["host_pool_occupancy"] == pytest.approx(
        jcb.tier["host_pool_occupancy"])
    assert on.stats["prefix_hits"] == jcb.stats["prefix_hits"]
    assert on.last_block_leaks == on.last_slot_leaks == 0
    assert on.last_host_block_leaks == 0


def test_sampled_rows_tier_on_equal_tier_off(models):
    """Sampled rows (temperature 0.8, no truncation): a promotion changes
    where K/V bytes come from, never a logical position, so the draws keyed
    on (seed, position) repeat the tier-off run's."""
    rng = np.random.default_rng(9)
    A, B = _hot(rng, 2)
    waves = _waves(A, B, top_k=None)
    want = _stream(_port(models), waves)
    on = _port(models, host_cache_blocks=64)
    assert _stream(on, waves) == want
    assert on.tier["promotions"] >= 1 and on.last_host_block_leaks == 0


def test_demote_promote_block_bit_exact(models):
    """A cached head's device bytes, demoted by pressure and promoted into
    other blocks by its rehit, equal the originals bit for bit, every layer
    and plane; the affinity probe counts the demoted prefix."""
    rng = np.random.default_rng(11)
    A, B, C = _hot(rng, 3)
    on = _port(models, host_cache_blocks=64)
    on.serve(_reqs([A], seed=1))
    (entry,) = on._radix.entries
    before_blocks = list(entry.blocks)
    before = [c["kv"][:, before_blocks].clone() for c in on._caches]
    on.serve(_reqs([B], seed=2))
    on.serve(_reqs([C], seed=3))
    assert entry.tier == TIER_HOST and entry.blocks == []
    assert on.prefix_match_len(A + [1, 2]) == len(A)
    on.serve(_reqs([A], seed=4))
    assert entry.tier == TIER_DEVICE
    assert entry.blocks != before_blocks
    for li, (b, c) in enumerate(zip(before, on._caches)):
        assert torch.equal(b, c["kv"][:, entry.blocks]), li
    assert on.tier["promotions"] >= 1 and on.last_host_block_leaks == 0


def test_int8_demote_promote_bit_exact(models):
    """An int8 pool's entry demotes its int8 bytes and f32 scales as they
    are and promotes them back without requantizing; tokens equal the
    tier-off run's."""
    rng = np.random.default_rng(12)
    A, B, C = _hot(rng, 3)
    stream = [((h,), i, (), None) for i, h in enumerate((A, B, C, A))]
    want = _stream(_port(models, kv_dtype="int8"), stream)
    on = _port(models, kv_dtype="int8", host_cache_blocks=64)
    assert _stream(on, stream[:1]) == want[:1]
    (entry,) = on._radix.entries
    before = [{k: v[:, entry.blocks].clone() for k, v in c.items()}
              for c in on._caches]
    assert _stream(on, stream[1:]) == want[1:]
    assert entry.tier == TIER_DEVICE and on.tier["promotions"] >= 1
    for b, c in zip(before, on._caches):
        for k in ("kv", "scale"):
            assert torch.equal(b[k], c[k][:, entry.blocks]), k
    assert on.kvq["bytes_saved_d2h"] > 0 and on.last_host_block_leaks == 0


# ---- the disk tier and the warm restart ---------------------------------------


def _parts(d):
    return {os.path.basename(p)[:-len(".npz")]
            for p in glob.glob(os.path.join(d, "*.npz"))}


def test_disk_spill_roundtrip_and_warm_restart(models, tmp_path):
    """A host tier that holds one head spills the other to disk; disk hits
    promote with token parity; no orphan part. A second batcher on the
    directory adopts its parts and serves the stream again, token for token,
    with disk hits."""
    rng = np.random.default_rng(17)
    stream = [((h,), i, (), None) for i, h in enumerate(_hot(rng, 3) * 2)]
    want = _stream(_port(models), stream)
    dd = str(tmp_path)
    b1 = _port(models, host_cache_blocks=3, disk_cache_dir=dd)
    assert _stream(b1, stream) == want
    t = b1.tier
    assert t["disk_spills"] >= 1 and t["disk_hits"] >= 1
    assert t["disk_crc_miss"] == 0
    assert b1.last_block_leaks == 0 and b1.last_host_block_leaks == 0
    assert _parts(dd) == {e.disk_key for e in b1._radix.entries
                          if e.tier == TIER_DISK}
    b2 = _port(models, host_cache_blocks=3, disk_cache_dir=dd)
    assert b2.tier["disk_adopted"] >= 1
    assert _stream(b2, stream) == want
    assert b2.tier["disk_hits"] >= 1 and b2.stats["prefix_hits"] >= 1
    assert b2.last_block_leaks == 0 and b2.last_host_block_leaks == 0


def test_warm_restart_across_packages(models, tmp_path):
    """f32 parts are the reference's byte for byte: a directory the JAX
    tier filled is adopted by the port, and one the port filled by the JAX
    batcher; each serves the stream as the tier-off run does, with disk
    hits. A part of another weights version declines."""
    rng = np.random.default_rng(19)
    stream = [((h,), i, (), None) for i, h in enumerate(_hot(rng, 3) * 2)]
    want = _stream(_port(models), stream)
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jw = _jax(models, host_cache_blocks=3, disk_cache_dir=jd)
    assert _stream(jw, stream, cls=JaxRequest) == want
    jw._tier.disk.drain()
    pw = _port(models, host_cache_blocks=3, disk_cache_dir=pd)
    assert _stream(pw, stream) == want
    for key in ("disk_spills", "disk_hits"):
        assert pw.tier[key] == jw.tier[key] >= 1, key
    port = _port(models, host_cache_blocks=3, disk_cache_dir=jd)
    assert port.tier["disk_adopted"] == len(_parts(jd)) >= 1
    assert _stream(port, stream) == want
    assert port.tier["disk_hits"] >= 1
    assert port.last_block_leaks == 0 and port.last_host_block_leaks == 0
    ref = _jax(models, host_cache_blocks=3, disk_cache_dir=pd)
    assert ref.tier["disk_adopted"] == len(_parts(pd)) >= 1
    assert _stream(ref, stream, cls=JaxRequest) == want
    assert ref.tier["disk_hits"] >= 1
    # a part computed under other weights is not adopted
    for p in glob.glob(os.path.join(pd, "*.json")):
        with open(p) as f:
            rec = json.load(f)
        rec["weights_version"] = 1
        with open(p, "w") as f:
            json.dump(rec, f)
    other = _port(models, host_cache_blocks=3, disk_cache_dir=pd)
    assert other.tier["disk_adopted"] == 0
    assert other.fleet["version_declined"] == len(_parts(pd)) >= 1


def test_disk_crc_corruption_degrades_to_miss(models, tmp_path):
    """Every part corrupted on disk: the rehit's promotion fails its CRC,
    the entry leaves the tree, the request prefills again with the same
    tokens, nothing leaks."""
    rng = np.random.default_rng(23)
    A, B, C = _hot(rng, 3)
    stream = [((h,), i, (), None) for i, h in enumerate((A, B, C, A))]
    want = _stream(_port(models), stream)
    on = _port(models, host_cache_blocks=16, disk_cache_dir=str(tmp_path))
    assert _stream(on, stream[:3]) == want[:3]
    on._tier._spill_one()              # push the demoted head to disk
    on._tier.disk.drain()
    parts = glob.glob(str(tmp_path / "*.npz"))
    assert parts and [e for e in on._radix.entries if e.tier == TIER_DISK]
    for p in parts:
        raw = bytearray(open(p, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(p, "wb").write(bytes(raw))
    assert _stream(on, stream[3:]) == want[3:]
    assert on.tier["disk_crc_miss"] >= 1 and on.tier["disk_hits"] == 0
    assert not [e for e in on._radix.entries if e.disk_key is not None]
    assert on.last_block_leaks == 0 and on.last_host_block_leaks == 0


def test_tier_leak_discipline_across_cycles(models):
    """Many demote and promote cycles: after each serve call the host
    blocks allocated are exactly the HOST entries' holdings, and ``reset``
    and ``clear_prefix_cache`` drain every tier."""
    rng = np.random.default_rng(29)
    A, B, C = _hot(rng, 3)
    on = _port(models, host_cache_blocks=64)
    for i, h in enumerate((A, B, C, A, C, B, A, B)):
        on.serve(_reqs([h], seed=i))
        assert on.last_host_block_leaks == 0 and on.last_block_leaks == 0
        owned = sum(len(e.host_blocks) for e in on._radix.entries
                    if e.tier == TIER_HOST)
        assert owned == on._tier.host.allocated, i
    assert on.tier["demotions"] >= 3 and on.tier["promotions"] >= 2
    on.reset()
    assert on._tier.host.allocated == 0 and not on._radix.entries
    on.serve(_reqs([A], seed=9))
    on.serve(_reqs([B], seed=9))
    on.serve(_reqs([C], seed=9))
    assert on._tier.host.allocated > 0
    on.clear_prefix_cache()
    assert on._tier.host.allocated == 0 and not on._radix.entries
    assert not on._tier.host.data.any()


# ---- configuration and the CLI ------------------------------------------------


def test_tier_config_validation(models):
    """The tier extends the radix cache: tier options without
    ``prefix_cache``, a disk tier without a host tier, or a budget at or
    below zero are errors, as in the JAX batcher."""
    tm = models["gpt2"][2]
    kw = dict(slots=1, t_max=32, prompt_buf=24, segment=4, device="cpu")
    with pytest.raises(ValueError, match="prefix_cache"):
        ContinuousBatcher(tm, **kw, host_cache_mb=8)
    with pytest.raises(ValueError, match="host"):
        ContinuousBatcher(tm, **kw, prefix_cache=True, disk_cache_dir="d")
    with pytest.raises(ValueError, match="host_cache_mb"):
        ContinuousBatcher(tm, **kw, prefix_cache=True, host_cache_mb=-1)
    with pytest.raises(ValueError, match="host_cache_blocks"):
        ContinuousBatcher(tm, **kw, prefix_cache=True, host_cache_blocks=0)
    cb = ContinuousBatcher(tm, **kw, prefix_cache=True, host_cache_mb=1)
    cfg = tm.config
    hd = cfg.d_model // cfg.num_heads
    assert cb._tier.host.num_blocks == host_blocks_for_mb(
        1, cfg.num_layers, cfg.num_heads, cb.bt, hd, 4)
    assert cb._tier.host.slab.shape == (cb._tier.host.num_blocks,
                                        cfg.num_layers, 2, cfg.num_heads,
                                        cb.bt, hd)


def test_cli_tier_flags(tmp_path, capsys):
    """``cli_serve`` refuses inconsistent tier flags before loading
    anything, and with ``--prefix_cache --host_cache_mb --disk_cache_dir``
    serves the tokens it serves without a tier, attaching more: the
    evicted heads are demoted, and some spilled to disk."""
    from distributed_compute_pytorch_tpu_torch.cli_serve import main
    base = ["--init_seed", "0", "--requests", "nope.txt", "--device", "cpu"]
    with pytest.raises(SystemExit, match="prefix_cache"):
        main(base + ["--host_cache_mb", "8"])
    with pytest.raises(SystemExit, match="host_cache_mb"):
        main(base + ["--prefix_cache", "--disk_cache_dir", "/tmp/d"])
    with pytest.raises(SystemExit, match="> 0"):
        main(base + ["--prefix_cache", "--host_cache_mb", "0"])
    rng = np.random.default_rng(31)
    heads = _hot(rng, 8)              # 24 head blocks, 20 in the pool
    reqfile = tmp_path / "reqs.txt"
    reqfile.write_text("".join(
        ",".join(map(str, h + [i, i + 1])) + "\n"
        for i, h in enumerate(heads * 2)))
    common = ["--init_seed", "0", "--model_preset", "tiny", "--max_seq_len",
              "64", "--requests", str(reqfile), "--slots", "1", "--segment",
              "4", "--max_new_tokens", "6", "--device", "cpu",
              "--prefix_cache", "--t_max", "32", "--prompt_buf", "24"]
    assert main(common) == 0
    want = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert main(common + ["--host_cache_mb", "0.05", "--disk_cache_dir",
                          str(tmp_path / "disk")]) == 0
    got = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [g["new"] for g in got] == [w["new"] for w in want]
    # the second pass finds evicted heads demoted, not gone
    assert (sum(g["cached_prefix"] for g in got)
            > sum(w["cached_prefix"] for w in want))
    assert glob.glob(str(tmp_path / "disk" / "part-*.json"))
