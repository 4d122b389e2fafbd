"""The decode-width ladder of the port's ``ContinuousBatcher``
(``decode_width_buckets``, ``prewarm_widths``) on the CPU in f32, held to
the JAX package's batcher with its ladder on.

The ladder's shape (powers of two of blocks capped at the table, the
widest N rungs kept) and its checks, the CLI's refusal of
``--decode_width_buckets 0``. One long-decode request among short ones
grows its rung past bucket edges: greedy tokens equal the JAX batcher's
(every rung on both sides) for GPT-2, Llama and the int8 pool, with the
``width`` counters under the JAX keys; sampled tokens with the ladder on
equal them with it off. ``prewarm_widths`` returns the rung count, builds
each rung's programs and leaves the batcher serving as a fresh one. A
verify step at a bucket edge (speculation with the ladder on) gives the
JAX tokens too. Each JAX batcher is built once."""

import dataclasses

import jax
import numpy as np
import pytest

from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, LlamaLM as JaxLlama)
from distributed_compute_pytorch_tpu.serve import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest)
from distributed_compute_pytorch_tpu_torch import interop
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.models.llama import (
    LlamaConfig, LlamaLM)
from distributed_compute_pytorch_tpu_torch.serve import (
    ContinuousBatcher, Request)

COMMON = dict(slots=2, t_max=64, prompt_buf=8, segment=4)
# the float pool's block size (8 rungs of 1-8 blocks); the int8 pool's is
# the JAX int8 alignment (rungs of 1 and 2 blocks)
BT = {"bf16": 8, "int8": 32}
WIDTH_KEYS = {"bucket_blocks", "bucket_occupancy", "gathered_block_reads",
              "full_width_block_reads", "bytes_saved_vs_full",
              "bucket_growths", "prewarmed_programs"}
CASES = [("gpt2", "bf16"), ("llama", "bf16"), ("gpt2", "int8")]


@pytest.fixture(scope="module")
def models():
    out = {}
    jm = JaxGPT2(dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=128))
    params, _ = jm.init(jax.random.key(1))
    tm = interop.load_gpt2_params(
        GPT2(dataclasses.replace(GPT2Config.tiny(), max_seq_len=128),
             device="cpu"), jax.tree.map(np.asarray, params))
    out["gpt2"] = (jm, params, tm)
    jm = JaxLlama(dataclasses.replace(JaxLlamaConfig.tiny(), max_seq_len=128))
    params, _ = jm.init(jax.random.key(1))
    tm = LlamaLM(dataclasses.replace(LlamaConfig.tiny(), max_seq_len=128),
                 device="cpu")
    tm.load_state_dict(interop.llama_params_from_jax(
        jax.tree.map(np.asarray, params)))
    out["llama"] = (jm, params, tm)
    return out


def _requests():
    """One long decode (52 new tokens: its rung grows edge by edge) among
    four short requests."""
    rng = np.random.default_rng(5)
    reqs = [([int(t) for t in rng.integers(0, 256, 5)], 52)]
    for _ in range(4):
        reqs.append(([int(t) for t in rng.integers(
            0, 256, int(rng.integers(2, 8)))], int(rng.integers(3, 7))))
    return reqs


REQS = _requests()


@pytest.fixture(scope="module")
def jax_tokens(models):
    """The JAX batcher's greedy tokens, its full ladder on."""
    out = {}
    for name, kv in CASES:
        jm, params, _ = models[name]
        jcb = JaxBatcher(jm, params, kv_block_tokens=BT[kv], kv_dtype=kv,
                         **COMMON)
        assert len(jcb._width_ladder) > 1
        out[name, kv] = jcb.serve([JaxRequest(list(t), n) for t, n in REQS])
    return out


def _port(models, name, kv="bf16", reqs=None, **kw):
    cb = ContinuousBatcher(models[name][2], device="cpu",
                           kv_block_tokens=BT[kv], kv_dtype=kv,
                           **{**COMMON, **kw})
    got = cb.serve([dataclasses.replace(r, tokens=list(r.tokens))
                    for r in reqs] if reqs else
                   [Request(list(t), n) for t, n in REQS])
    assert cb.last_slot_leaks == 0 and cb.last_block_leaks == 0
    return got, cb


def test_ladder_shape_and_checks(models):
    tm = models["gpt2"][2]
    ladder = lambda n: ContinuousBatcher(    # noqa: E731
        tm, device="cpu", kv_block_tokens=8, decode_width_buckets=n,
        **COMMON)._width_ladder
    assert ladder(None) == (1, 2, 4, 8)
    assert ladder(2) == (4, 8)
    assert ladder(1) == (8,) == ladder(9)[-1:]
    assert ContinuousBatcher(tm, device="cpu", kv_block_tokens=8,
                             **COMMON)._width_ladder == (8,)
    assert ladder(9) == (1, 2, 4, 8)
    with pytest.raises(ValueError, match="decode_width_buckets"):
        ladder(0)
    cb = ContinuousBatcher(tm, device="cpu", kv_block_tokens=8,
                           decode_width_buckets=None, **COMMON)
    assert [cb._bucket_width(n) for n in (1, 8, 9, 17, 33, 64, 99)] == [
        1, 1, 2, 4, 8, 8, 8]


def test_cli_refuses_zero_buckets():
    from distributed_compute_pytorch_tpu_torch.cli_serve import main
    with pytest.raises(SystemExit, match="decode_width_buckets must be"):
        main(["--init_seed", "0", "--model_preset", "tiny", "--requests",
              "-", "--device", "cpu", "--decode_width_buckets", "0"])


@pytest.mark.parametrize("name,kv", CASES)
def test_buckets_match_jax_across_edges(models, jax_tokens, name, kv):
    got, cb = _port(models, name, kv, decode_width_buckets=None)
    assert got == jax_tokens[name, kv]
    w = cb.width
    assert set(w) == WIDTH_KEYS
    assert w["bucket_growths"] >= 1
    assert w["gathered_block_reads"] < w["full_width_block_reads"]
    assert w["bytes_saved_vs_full"] > 0
    off, cb_off = _port(models, name, kv)
    assert off == got
    assert (cb_off.width["gathered_block_reads"]
            == cb_off.width["full_width_block_reads"])


def test_sampled_buckets_equal_full_width(models):
    reqs = [Request(list(t), n, temperature=0.8, top_k=[None, 30][i % 2],
                    seed=7 + i) for i, (t, n) in enumerate(REQS)]
    on, cb = _port(models, "gpt2", reqs=reqs, decode_width_buckets=None)
    off, _ = _port(models, "gpt2", reqs=reqs)
    assert on == off and cb.stats["sampled_segments"] > 0
    assert cb.width["bucket_growths"] >= 1


@pytest.mark.parametrize("spec", [None, 3])
def test_prewarm_widths_serves_as_a_fresh_batcher(models, jax_tokens, spec):
    cb = ContinuousBatcher(models["gpt2"][2], device="cpu", kv_block_tokens=8,
                           decode_width_buckets=None, speculate=spec,
                           **COMMON)
    assert cb.prewarm_widths() == 4
    programs = 4 * (1 if spec is None else 2)
    assert cb.width["prewarmed_programs"] == programs
    assert cb.stats["eager_segments"] == programs
    assert cb.prewarm_widths(sampling=True) == 4
    got = cb.serve([Request(list(t), n) for t, n in REQS])
    assert got == jax_tokens["gpt2", "bf16"]
    assert cb.last_block_leaks == 0


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_verify_at_a_bucket_edge(models, jax_tokens, name):
    """Speculation with the ladder on: each verify window picks the rung
    covering ``row_pos + W + 1`` slots, so a window that crosses a bucket
    edge takes the wider rung and no accepted token loses its K/V."""
    got, cb = _port(models, name, decode_width_buckets=None, speculate=3)
    assert got == jax_tokens[name, "bf16"]
    assert cb.spec["verify_segments"] > 0
    assert cb.width["bucket_growths"] >= 1
