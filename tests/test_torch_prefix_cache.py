"""The port's radix prefix cache against the JAX package's, on the CPU in
f32: ``kv_pool.BlockPool`` and ``kv_pool.RadixCache`` driven side by side
with the JAX classes through the same operation sequences (the scenarios
of ``tests/test_kv_pool.py``), then ``ContinuousBatcher(prefix_cache=
True)`` against the JAX batcher with its prefix cache on, GPT-2 and
Llama, float and int8 pools: the same greedy tokens, the same
``prefix_hits``, ``cached_prefix_tokens``, ``cow_copies`` and per-request
attached lengths, no leaked block — for a shared prompt ending mid-block
(copy-on-write), one ending on a block boundary in a pool so tight that
admission evicts, and rows that stop early at eos while their segment is
still in flight."""

import dataclasses

import jax
import numpy as np
import pytest

from distributed_compute_pytorch_tpu import kv_pool as jax_kv
from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, LlamaLM as JaxLlama)
from distributed_compute_pytorch_tpu.serve import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest)
from distributed_compute_pytorch_tpu_torch import interop, kv_pool
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.models.llama import (
    LlamaConfig, LlamaLM)
from distributed_compute_pytorch_tpu_torch.serve import (
    ContinuousBatcher, Request)

# the float pool's block size; the int8 pool's is the JAX int8 alignment
BT = {"bf16": 8, "int8": 32}
COMMON = dict(slots=2, t_max=64, prompt_buf=24, segment=3)
COUNTERS = ("prefix_hits", "cached_prefix_tokens", "prefill_tokens_saved",
            "cow_copies", "prefill_calls", "prefill_rows")


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


def _shared_prefix_requests(seed, n, prefix_len=19, new=6):
    """One shared system prompt (19 tokens: mid-block at 8 and at 32
    slots a block) and short distinct tails."""
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, 256, prefix_len)]
    return [(shared + [int(t) for t in rng.integers(
        0, 256, int(rng.integers(1, 5)))], new) for _ in range(n)]


def _both(models, name, kv, reqs, **kw):
    """The same requests through the JAX batcher (``serve_detailed``, for
    the per-request attached lengths) and the port's, same options."""
    jm, params, tm = models[name]
    kw = {**COMMON, "kv_block_tokens": BT[kv], "kv_dtype": kv, **kw}
    jcb = JaxBatcher(jm, params, decode_width_buckets=1, **kw)
    jres = jcb.serve_detailed([JaxRequest(list(t), n) for t, n in reqs])
    cb = ContinuousBatcher(tm, device="cpu", **kw)
    got = cb.serve([Request(list(t), n) for t, n in reqs])
    assert [r.status for r in jres] == ["ok"] * len(reqs)
    return jcb, jres, cb, got


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_prefix_cache_token_identical_to_jax(models, name, kv):
    """Eight requests sharing a 19-token prompt through 2 slots, prefix
    cache on on both sides: the first wave prefills whole heads, later
    waves attach (the partial block copy-on-write) and prefill their
    suffixes against the gathered prefix. Tokens, counters and
    per-request attached lengths equal the JAX batcher's."""
    reqs = _shared_prefix_requests(61, 8)
    jcb, jres, cb, got = _both(models, name, kv, reqs, prefix_cache=True)
    assert got == [r.tokens for r in jres]
    for key in COUNTERS:
        assert cb.stats[key] == jcb.stats[key], key
    assert cb.stats["block_pool_occupancy"] == pytest.approx(
        jcb.stats["block_pool_occupancy"])
    assert cb.last_cached_prefix == [r.cached_prefix_tokens for r in jres]
    assert cb.stats["prefix_hits"] > 0 and cb.stats["cow_copies"] > 0
    assert max(cb.last_cached_prefix) >= 19
    assert cb.last_block_leaks == jcb.last_block_leaks == 0
    assert cb.last_slot_leaks == 0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_block_boundary_attach_and_eviction_like_jax(models, kv):
    """A shared prompt of whole blocks (no copy-on-write: the blocks are
    shared read-only) in the smallest legal pool, so admissions evict
    least-recently-used tree entries: tokens and counters equal the JAX
    batcher's, and nothing leaks."""
    rng = np.random.default_rng(67)
    shared = [int(t) for t in rng.integers(0, 256, 2 * BT[kv])]
    reqs = [(shared + [int(t) for t in rng.integers(0, 256, 3)], 5)
            for _ in range(6)]
    t_max = 3 * BT[kv] + 16
    nb = -(-t_max // BT[kv])
    jcb, jres, cb, got = _both(models, "gpt2", kv, reqs, prefix_cache=True,
                               t_max=t_max, prompt_buf=2 * BT[kv] + 8,
                               segment=5, pool_blocks=2 * nb + 1)
    assert got == [r.tokens for r in jres]
    for key in COUNTERS:
        assert cb.stats[key] == jcb.stats[key], key
    assert cb.stats["prefix_hits"] > 0 and cb.stats["cow_copies"] == 0
    assert cb.last_block_leaks == 0 and cb.last_slot_leaks == 0
    # the second call attaches to the first call's entries and evicts
    again = cb.serve([Request(list(t), n) for t, n in reqs])
    assert again == got and cb.last_block_leaks == 0


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_eos_early_rows_under_the_prefix_cache(models, name):
    """Rows that stop at eos free their blocks while their next segment is
    already in flight, writing through the old table; with shared prefix
    blocks and copy-on-write copies in play the tokens still equal the
    JAX batcher's and every pool reference is the tree's."""
    jm, params, tm = models[name]
    reqs = _shared_prefix_requests(5, 7, new=9)
    first = JaxBatcher(jm, params, decode_width_buckets=1, kv_block_tokens=8,
                       **COMMON).serve([JaxRequest(list(reqs[0][0]), 9)])[0]
    eos = first[1]                   # early in request 0's stream
    jcb, jres, cb, got = _both(models, name, "bf16", reqs,
                               prefix_cache=True, eos_id=eos)
    assert got == [r.tokens for r in jres]
    assert got[0] == first[:first.index(eos) + 1]
    assert sum(len(o) < 9 for o in got) >= 1
    assert cb.stats["prefix_hits"] == jcb.stats["prefix_hits"] > 0
    assert cb.last_block_leaks == 0 and cb.last_slot_leaks == 0
    held = cb._radix.held()
    assert cb._pool.leak_check(held) == 0 and held


def test_prefix_on_equals_prefix_off(models):
    """Attaching changes where K/V come from, never a logical position:
    the port's prefix-on tokens equal its prefix-off tokens."""
    _, _, tm = models["llama"]
    reqs = [Request(list(t), n) for t, n in _shared_prefix_requests(71, 6)]
    off = ContinuousBatcher(tm, device="cpu", kv_block_tokens=8, **COMMON)
    on = ContinuousBatcher(tm, device="cpu", kv_block_tokens=8,
                           prefix_cache=True, **COMMON)
    assert on.serve(reqs) == off.serve(reqs)
    assert on.stats["prefix_hits"] > 0 and off.stats["prefix_hits"] == 0


# ---------------------------------------------- the host-side structures


def _pool_ops(mod):
    """One alloc/acquire/shared/release/reset sequence on a 6-block pool;
    every observation in order."""
    pool, seen = mod.BlockPool(6), []
    seen.append((pool.free_count, pool.allocated))
    a, b = pool.alloc(2)
    seen.append((a, b, pool.allocated, pool.shared(a)))
    pool.acquire(a)
    seen.append((pool.shared(a), pool.ref[a]))
    pool.release([a])
    seen.append((pool.ref[a], pool.shared(a)))
    pool.acquire(a)                       # pretend the tree holds a
    pool.release([a, b])
    seen.append((pool.leak_check({a: 1}), pool.leak_check({}),
                 pool.free_count, pool.high_water))
    pool.reset()
    seen.append((pool.free_count, pool.ref[0], pool.leak_check({})))
    return seen


def test_block_pool_api_matches_jax():
    assert _pool_ops(kv_pool) == _pool_ops(jax_kv)


def _tree(mod, bt=4, blocks=32):
    pool = mod.BlockPool(blocks)
    return pool, mod.RadixCache(pool, bt)


def _scenario_insert_match(mod):
    """test_kv_pool.py's longest-prefix contract: exact hits, mid-edge
    prefixes, divergent branches, misses, duplicate inserts."""
    pool, tree = _tree(mod)
    seq_a = list(range(10))
    blocks_a = pool.alloc(3)
    seen = [tree.insert(seq_a, blocks_a), tree.match(seq_a),
            tree.match(seq_a[:6] + [99, 98])]
    seq_b = seq_a[:6] + [50, 51, 52]
    seen += [tree.insert(seq_b, pool.alloc(3)), tree.match(seq_b),
             tree.match([77, 78]), tree.insert(seq_a, blocks_a),
             pool.ref[blocks_a[0]]]
    for q in (seq_a, seq_a[:6] + [99, 98], seq_b, [77, 78], seq_a[:3],
              seq_a + [1, 2, 3]):
        seen.append((tree.longest_match_len(q), tree.match_entry(q)[0]))
    seen.append(sorted(tree.held().items()))
    return seen


def _scenario_lru_eviction(mod):
    """LRU eviction frees refcount-0 blocks only; a block a live row
    shares survives its entry; probes never move the LRU order."""
    pool, tree = _tree(mod, blocks=8)
    a = pool.alloc(2)
    tree.insert(list(range(8)), a)
    b = pool.alloc(2)
    tree.insert([9, 9] + list(range(6)), b)
    pool.release(a)
    pool.release(b)
    seen = [tree.match([9, 9])]
    for _ in range(5):                    # a probe storm
        seen.append((tree.longest_match_len(list(range(8))),
                     tree.longest_match_len([77])))
    seen.append((list(pool.ref), tree._clock, pool.free_count))
    pool.acquire(a[0])
    seen.append(tree.evict_for(pool.free_count + 1))
    seen += [pool.ref[a[0]], pool.ref[a[1]], tree.match(list(range(8))),
             tree.match([9, 9]), sorted(tree.held().items())]
    tree.clear()
    pool.release([a[0]])
    seen.append(pool.leak_check({}))
    return seen


def _scenario_on_evict(mod):
    """The eviction hook sees only the blocks the eviction frees; a
    truthy return demotes the entry in place (a miss for ``match``, a
    hit for ``match_entry``), a falsy one discards it."""
    pool, tree = _tree(mod, blocks=8)
    a = pool.alloc(3)
    tree.insert(list(range(12)), a)
    pool.release(a)
    pool.acquire(a[0])
    seen = []

    def hook(entry, blocks):
        seen.append((list(entry.blocks), list(blocks)))
        return False

    tree.evict_for(pool.free_count + 1, on_evict=hook)
    pool.release([a[0]])
    seq_a, seq_b = list(range(8)), [9, 9] + list(range(6))
    for seq in (seq_a, seq_b):
        blocks = pool.alloc(2)
        tree.insert(seq, blocks)
        pool.release(blocks)
    tree.match(seq_b)

    def demote(entry, blocks):
        entry.tier = mod.TIER_HOST
        return True

    tree.evict_for(pool.free_count + 1, on_evict=demote)
    m, entry = tree.match_entry(seq_a)
    seen += [tree.match(seq_a), m, entry.tier, entry.blocks,
             tree.longest_match_len(seq_a)]
    tree.evict_for(pool.free_count + 1, on_evict=lambda e, b: False)
    seen += [tree.match_entry(seq_b), pool.leak_check(tree.held())]
    return seen


@pytest.mark.parametrize("scenario", [_scenario_insert_match,
                                      _scenario_lru_eviction,
                                      _scenario_on_evict])
def test_radix_cache_matches_jax(scenario):
    """Each scenario observes the same values from the port's
    ``RadixCache`` as from the JAX package's."""
    assert scenario(kv_pool) == scenario(jax_kv)
