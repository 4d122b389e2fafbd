"""Speculative decoding in the port's ``ContinuousBatcher(speculate=...)``
on the CPU in f32, held to the JAX package's batcher: the accept rule is
exact, so spec-on tokens equal spec-off tokens, whatever the proposer.

GPT-2-tiny and Llama-tiny with the JAX test file's mixed random and
period-3 requests (the n-gram proposer accepts on the loops, so both the
accept and the reject paths run): the port's spec-on greedy tokens equal
the JAX batcher's with and without speculation, with the JAX counter keys
and no leak. Then, against those JAX tokens: a proposer that always
misses (every step resamples at the first column), auto-disable flipping
to plain segments mid-stream (sticky until ``reset``), speculation under
chunked prefill, a k x segment sweep, and the int8 pool with the prefix
cache (spec-on equal to spec-off, copy-on-write copies made, no leak).
Sampled spec-on is bit-identical to sampled spec-off, and rows at
``top_k=1`` give JAX's greedy tokens. The proposers: ``SpecConfig``'s
checks, the n-gram suffix lookup, the draft model's k tokens through the
port's ``generate`` (the JAX draft proposer's). The CLI: ``--speculate 3``
prints the ``--speculate 0`` lines. Each JAX batcher is built once."""

import dataclasses
import json

import jax
import numpy as np
import pytest

from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, LlamaLM as JaxLlama)
from distributed_compute_pytorch_tpu.serve import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest)
from distributed_compute_pytorch_tpu.spec_decode import (
    DraftModelProposer as JaxDraftProposer)
from distributed_compute_pytorch_tpu_torch import interop
from distributed_compute_pytorch_tpu_torch.models import transformer
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.models.llama import (
    LlamaConfig, LlamaLM)
from distributed_compute_pytorch_tpu_torch.serve import (
    ContinuousBatcher, Request)
from distributed_compute_pytorch_tpu_torch.spec_decode import (
    DraftModelProposer, NGramProposer, SpecConfig)

COMMON = dict(slots=2, t_max=64, prompt_buf=12, segment=3)
SPEC_KEYS = {"proposed", "accepted", "acceptance_rate", "emitted_tokens",
             "wasted_verify_tokens", "verify_segments", "autodisabled"}


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


def _requests(seed):
    """The JAX file's mix: four random prompts and three period-3 loops
    (the n-gram proposer's home ground)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(4):
        reqs.append(([int(t) for t in rng.integers(
            0, 256, int(rng.integers(2, 10)))], int(rng.integers(4, 10))))
    for _ in range(3):
        reqs.append(([int(t) for t in rng.integers(0, 256, 3)] * 3, 8))
    return reqs


REQS = _requests(3)


@pytest.fixture(scope="module")
def jax_tokens(models):
    """Each family's JAX tokens for ``REQS``: spec-off and ``speculate=3``
    (full-width tables, as the port's default)."""
    out = {}
    for name, (jm, params, _) in models.items():
        for spec in (None, 3):
            jcb = JaxBatcher(jm, params, decode_width_buckets=1,
                             speculate=spec, **COMMON)
            out[name, spec] = jcb.serve([JaxRequest(list(t), n)
                                         for t, n in REQS])
    return out


def _port(models, name, reqs=REQS, **kw):
    """``reqs`` (``(tokens, max_new)`` pairs or ``Request``s) through the
    port's batcher; returns its tokens and the batcher, leak-checked."""
    cb = ContinuousBatcher(models[name][2], device="cpu", **{**COMMON, **kw})
    got = cb.serve([dataclasses.replace(r, tokens=list(r.tokens))
                    if isinstance(r, Request) else Request(list(r[0]), r[1])
                    for r in reqs])
    assert cb.last_slot_leaks == 0 and cb.last_block_leaks == 0
    return got, cb


class _WrongProposer:
    """Drafts that almost always miss: every verify step rejects."""

    def propose(self, context, k):
        return [(context[-1] * 31 + 7 * i + 13) % 256 for i in range(k)]


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_spec_greedy_equals_jax_with_and_without(models, jax_tokens, name):
    got, cb = _port(models, name, speculate=3)
    assert got == jax_tokens[name, None] == jax_tokens[name, 3]
    s = cb.spec
    assert set(s) == SPEC_KEYS
    assert s["verify_segments"] > 0 and 0 < s["accepted"] <= s["proposed"]
    assert s["emitted_tokens"] == sum(len(o) for o in got)
    # each row-step scores k + 1 columns: emitted or wasted, once
    assert 4 * s["proposed"] == 3 * (s["emitted_tokens"]
                                     + s["wasted_verify_tokens"])
    assert s["acceptance_rate"] == s["accepted"] / s["proposed"]


def test_forced_rejection_resamples_exactly(models, jax_tokens):
    spec = SpecConfig(k=3, proposer=_WrongProposer(),
                      autodisable_window=10 ** 9)
    got, cb = _port(models, "gpt2", speculate=spec)
    assert got == jax_tokens["gpt2", None]
    assert cb.spec["wasted_verify_tokens"] > 0
    assert cb.spec["acceptance_rate"] < 0.5


def test_autodisable_flips_to_plain_and_keeps_parity(models, jax_tokens):
    spec = SpecConfig(k=3, proposer=_WrongProposer(), autodisable_window=6,
                      autodisable_below=0.34)
    got, cb = _port(models, "gpt2", speculate=spec)
    assert got == jax_tokens["gpt2", None]
    assert cb.spec["autodisabled"] == 1 and not cb._spec_on
    assert cb.stats["eager_segments"] > cb.spec["verify_segments"]
    assert cb.serve([Request(list(t), n) for t, n in REQS]) == got
    assert cb.spec["autodisabled"] == 1        # sticky...
    cb.reset()
    assert cb._spec_on                         # ...until reset
    assert cb.serve([Request(list(t), n) for t, n in REQS]) == got


@pytest.mark.parametrize("k,segment", [(1, 1), (2, 3), (5, 2)])
def test_spec_sweep_k_and_segment(models, jax_tokens, k, segment):
    got, _ = _port(models, "gpt2", speculate=k, segment=segment)
    assert got == jax_tokens["gpt2", None]


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_spec_with_chunked_prefill(models, jax_tokens, name):
    got, cb = _port(models, name, speculate=2, prefill_chunk_tokens=4)
    assert got == jax_tokens[name, None]
    assert cb.prefill["chunked_admissions"] > 0


def test_int8_pool_with_prefix_cache_spec_equals_off(models):
    """The int8 pool with the radix prefix cache: a shared prompt whose
    head ends mid-block enters the tree, so a row's first verify window
    writes into a block the tree shares and copies it first; spec-on
    tokens equal spec-off's, and no block leaks."""
    rng = np.random.default_rng(9)
    shared = [int(t) for t in rng.integers(0, 256, 3)] * 4
    reqs = [(shared + [int(t) for t in rng.integers(0, 256, 2)], 7)
            for _ in range(5)]
    kw = dict(kv_dtype="int8", kv_block_tokens=8, prefix_cache=True,
              prompt_buf=16)
    off, cb_off = _port(models, "gpt2", reqs, **kw)
    on, cb_on = _port(models, "gpt2", reqs, speculate=3, **kw)
    assert on == off
    assert cb_on.stats["cow_copies"] > cb_off.stats["cow_copies"]
    assert cb_on.stats["prefix_hits"] > 0 and cb_on.spec["accepted"] > 0


def test_sampled_spec_bit_identical_and_top_k1_is_greedy(models,
                                                          jax_tokens):
    reqs = [Request(list(t), n, temperature=0.9,
                    top_k=[None, 20, 1][i % 3],
                    top_p=[None, 0.8, None][i % 3], seed=100 + i)
            for i, (t, n) in enumerate(REQS)]
    off, _ = _port(models, "gpt2", reqs)
    on, cb = _port(models, "gpt2", reqs, speculate=4)
    assert on == off and cb.spec["verify_segments"] > 0
    greedy = jax_tokens["gpt2", None]
    for i in range(2, len(reqs), 3):        # the top_k=1 rows
        assert on[i] == greedy[i]


def test_spec_config_and_refusals(models, monkeypatch):
    with pytest.raises(ValueError, match="k must be"):
        SpecConfig(k=0)
    with pytest.raises(ValueError, match="ngram_min"):
        SpecConfig(ngram_max=2, ngram_min=3)
    with pytest.raises(ValueError, match="draft_model"):
        ContinuousBatcher(models["gpt2"][2], device="cpu",
                          speculate=SpecConfig(proposer="draft"), **COMMON)
    cb = ContinuousBatcher(models["gpt2"][2], device="cpu", speculate=2,
                           **COMMON)
    assert cb._spec == SpecConfig(k=2) and cb._spec_w == 3
    monkeypatch.delattr(transformer.TransformerBlock, "verify_step")
    with pytest.raises(ValueError, match="verify_step"):
        ContinuousBatcher(models["gpt2"][2], device="cpu", speculate=2,
                          **COMMON)


def test_ngram_proposer_suffix_lookup():
    p = NGramProposer(ngram_max=3, ngram_min=1)
    assert p.propose([7, 8, 9, 1, 7, 8], 2) == [9, 1]
    assert p.propose([5, 6, 5], 3) == [6, 5, 5]
    assert p.propose([1, 2, 3], 2) == [3, 3]
    assert p.propose([], 2) == [0, 0]


def test_draft_model_proposer_drafts_like_jax(models):
    jm, params, tm = models["gpt2"]
    want = JaxDraftProposer(jm, params, window=8).propose([1, 2, 3], 3)
    p = DraftModelProposer(tm, window=8)
    got = p.propose([1, 2, 3], 3)
    assert got == want and len(got) == 3
    assert p.propose([1, 2, 3], 3) == got


def test_cli_speculate_prints_the_plain_lines(tmp_path, capsys):
    from distributed_compute_pytorch_tpu_torch.cli_serve import main
    path = tmp_path / "reqs.txt"
    path.write_text("".join(json.dumps({"tokens": t, "max_new": n}) + "\n"
                            for t, n in REQS))
    outs = []
    for k in ("0", "3"):
        assert main(["--init_seed", "0", "--model_preset", "tiny",
                     "--max_seq_len", "64", "--requests", str(path),
                     "--slots", "2", "--segment", "3", "--device", "cpu",
                     "--speculate", k]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].count("\n") == len(REQS)
