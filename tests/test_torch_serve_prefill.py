"""The port's chunked prefill and ``skip_fit`` admission against the JAX
package's, on the CPU in f32 (the scenarios of
``tests/test_serve_prefill.py`` and ``tests/test_serve.py``'s skip-fit
test, pointed at the port): ``ContinuousBatcher(prefill_chunk_tokens=
...)`` against the JAX batcher with the same chunk, GPT-2 and Llama,
float and int8 pools, at chunk sizes 8, 16 and 32 — the same greedy
tokens, the same chunk counters, no leak — chunking together with the
prefix cache (a follower attaching to a head built chunk by chunk), and
``admit_policy="skip_fit"`` with an infeasible request at the queue's
head: the same outputs, admission waves and ``HorizonError.outputs``."""

import dataclasses

import jax
import numpy as np
import pytest

from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, LlamaLM as JaxLlama)
from distributed_compute_pytorch_tpu.serve import (
    ContinuousBatcher as JaxBatcher, HorizonError as JaxHorizonError,
    Request as JaxRequest)
from distributed_compute_pytorch_tpu_torch import interop
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.models.llama import (
    LlamaConfig, LlamaLM)
from distributed_compute_pytorch_tpu_torch.serve import (
    ContinuousBatcher, HorizonError, Request)

BT = {"bf16": 8, "int8": 32}
COMMON = dict(slots=2, t_max=64, prompt_buf=24, segment=3)
CHUNK_COUNTERS = ("chunked_admissions", "chunk_waves", "chunk_tokens",
                  "stall_ticks")


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


def _reqs(seed, n, lo=3, hi=22, min_new=3, max_new=8):
    """Mixed-length prompts, several longer than the chunk."""
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(0, 256, int(rng.integers(
        lo, hi + 1)))], int(rng.integers(min_new, max_new + 1)))
        for _ in range(n)]


def _both(models, name, reqs, kv="bf16", **kw):
    jm, params, tm = models[name]
    kw = {**COMMON, "kv_block_tokens": BT[kv], "kv_dtype": kv, **kw}
    jcb = JaxBatcher(jm, params, decode_width_buckets=1, **kw)
    want = jcb.serve([JaxRequest(list(t), n) for t, n in reqs])
    cb = ContinuousBatcher(tm, device="cpu", **kw)
    got = cb.serve([Request(list(t), n) for t, n in reqs])
    return jcb, want, cb, got


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chunked_token_identical_to_jax(models, chunk):
    """GPT-2, prompts up to 38 tokens through 2 slots: long prompts admit
    a chunk, park, and extend between segments (a wave's budget is
    shared by its rows). Tokens and chunk counters equal the JAX
    batcher's with the same chunk."""
    reqs = _reqs(100 + chunk, 8, hi=38)
    jcb, want, cb, got = _both(models, "gpt2", reqs, prompt_buf=40,
                               t_max=72, prefill_chunk_tokens=chunk)
    assert got == want
    for key in CHUNK_COUNTERS:
        assert cb.prefill[key] == jcb.prefill[key], key
    assert cb.stats["prefill_calls"] == jcb.stats["prefill_calls"]
    assert cb.prefill["chunked_admissions"] > 0
    assert cb.prefill["chunk_waves"] > 0
    assert cb.last_block_leaks == 0 and cb.last_slot_leaks == 0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_chunked_llama_token_identical_to_jax(models, kv):
    """Llama (each chunk ropes its keys at their absolute slots), float
    and int8 pools (whose 32-slot blocks round the chunk up to 32):
    tokens equal the JAX batcher's with the same chunk."""
    reqs = _reqs(5, 6, hi=38)
    jcb, want, cb, got = _both(models, "llama", reqs, kv=kv, prompt_buf=40,
                               t_max=72, prefill_chunk_tokens=5)
    assert got == want
    for key in CHUNK_COUNTERS:
        assert cb.prefill[key] == jcb.prefill[key], key
    assert cb.prefill["chunk_waves"] > 0
    assert cb.last_block_leaks == 0


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_chunked_equals_unchunked(models, name):
    """The port's chunked tokens equal its unchunked tokens."""
    _, _, tm = models[name]
    reqs = [Request(list(t), n) for t, n in _reqs(3, 6, hi=18)]
    plain = ContinuousBatcher(tm, device="cpu", kv_block_tokens=8, **COMMON)
    chunked = ContinuousBatcher(tm, device="cpu", kv_block_tokens=8,
                                prefill_chunk_tokens=6, **COMMON)
    assert chunked.serve(reqs) == plain.serve(reqs)
    assert chunked.prefill["chunk_tokens"] > 0


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_chunk_boundary_prefix_attach_like_jax(models, name):
    """Prefix cache and chunking together: a head admitted chunk by chunk
    enters the radix tree only once it is whole, and a follower sharing
    the prompt attaches to the chunk-built blocks. Tokens and the prefix
    and chunk counters equal the JAX batcher's."""
    rng = np.random.default_rng(9)
    head = [int(t) for t in rng.integers(0, 256, 14)]
    reqs = [(list(head), 4),
            ([int(t) for t in rng.integers(0, 256, 5)], 9),
            (head + [int(t) for t in rng.integers(0, 256, 3)], 4),
            (head[:11] + [7, 7], 5)]
    jcb, want, cb, got = _both(models, name, reqs, prefix_cache=True,
                               prefill_chunk_tokens=4)
    assert got == want
    for key in ("prefix_hits", "cached_prefix_tokens", "cow_copies"):
        assert cb.stats[key] == jcb.stats[key], key
    for key in CHUNK_COUNTERS:
        assert cb.prefill[key] == jcb.prefill[key], key
    assert cb.stats["prefix_hits"] > 0 and cb.prefill["chunk_waves"] > 0
    assert cb.last_block_leaks == 0 and cb.last_slot_leaks == 0


def _waves(results):
    """The JAX batcher's admission waves, read from its per-request queue
    waits (one wave's requests share their admission instant)."""
    by_wait: dict = {}
    for i, r in enumerate(results):
        if r.status == "ok":
            by_wait.setdefault(r.queue_wait_s, []).append(i)
    return [by_wait[w] for w in sorted(by_wait)]


def test_skip_fit_like_jax(models):
    """skip_fit with the infeasible request first: it does not block the
    queue, the feasible ones are served in the same waves as the JAX
    batcher's, and the ``HorizonError`` carries the same outputs (``[]``
    for the infeasible one)."""
    jm, params, tm = models["gpt2"]
    good = _reqs(43, 5, lo=2, hi=8, min_new=3, max_new=5)
    reqs = [([1, 2], 64)] + good
    kw = dict(slots=2, t_max=32, prompt_buf=8, segment=4, kv_block_tokens=8)
    jcb = JaxBatcher(jm, params, decode_width_buckets=1,
                     admit_policy="skip_fit", **kw)
    jres = jcb.serve_detailed([JaxRequest(list(t), n) for t, n in reqs])
    with pytest.raises(JaxHorizonError) as jexc:
        jcb.serve([JaxRequest(list(t), n) for t, n in reqs])
    cb = ContinuousBatcher(tm, device="cpu", admit_policy="skip_fit", **kw)
    with pytest.raises(HorizonError, match="horizon") as exc:
        cb.serve([Request(list(t), n) for t, n in reqs])
    assert exc.value.outputs == jexc.value.outputs
    assert exc.value.outputs[0] == [] and all(exc.value.outputs[1:])
    assert cb.last_admissions == _waves(jres)
    assert cb.last_admissions[0] == [1, 2]
    assert cb.last_block_leaks == 0 and cb.last_slot_leaks == 0
    fifo = ContinuousBatcher(tm, device="cpu", **kw)
    with pytest.raises(HorizonError) as fexc:
        fifo.serve([Request(list(t), n) for t, n in reqs])
    assert fexc.value.outputs == exc.value.outputs
    with pytest.raises(ValueError, match="admit_policy"):
        ContinuousBatcher(tm, device="cpu", admit_policy="lifo", **kw)
