"""The port's Llama decoding against the JAX package's, on the CPU in f32:
serving (``ContinuousBatcher``) and one-shot generation (``infer``) with
Llama-tiny weights (GQA 4:2, so each decode read groups G = 2 query heads
a kv head) carried across by ``interop.llama_params_from_jax``.

- Serving: staggered requests longer than one segment through 2 slots,
  the JAX batcher with its prefix cache off, on the float pool and on the
  int8 pool (32-slot blocks on both sides, the JAX int8 alignment): the
  same greedy tokens, no leaks. Admission ropes each prompt's keys at its
  logical slots from 0 and every tick ropes each row at its own slot.
- Generation: left-padded prompts of different lengths, float and int8
  dense caches: the same tokens as the JAX ``generate``. The blocks rope
  at cache slots while the embedding takes the rows' logical positions
  (a query roped at its logical position against slot-roped keys skews
  every score by the row's pad count); ``prefill``'s logits to 1e-5 and
  its caches, which hold post-rope keys at kv-head width, to 1e-5 (int8
  bytes exact).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu import infer as jax_infer
from distributed_compute_pytorch_tpu.models.llama import (
    LlamaConfig as JaxConfig, LlamaLM as JaxLlama)
from distributed_compute_pytorch_tpu.serve import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest)
from distributed_compute_pytorch_tpu_torch import infer, interop
from distributed_compute_pytorch_tpu_torch.models.llama import (
    LlamaConfig, LlamaLM)
from distributed_compute_pytorch_tpu_torch.serve import (
    ContinuousBatcher, Request)

TOL = 1e-5
SLOTS, SEGMENT, T_MAX, PROMPT_BUF = 2, 3, 128, 10
# the float pool's block size; the int8 pool's is the JAX int8 alignment
BT = {"bf16": 8, "int8": 32}


@pytest.fixture(scope="module")
def models():
    """JAX Llama-tiny (positions lifted to 128, as the serve horizon) and
    the port's copy of its weights."""
    jm = JaxLlama(dataclasses.replace(JaxConfig.tiny(), max_seq_len=128))
    params, _ = jm.init(jax.random.key(0))
    tm = LlamaLM(dataclasses.replace(LlamaConfig.tiny(), max_seq_len=128),
                 device="cpu")
    tm.load_state_dict(interop.llama_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _requests(seed, n):
    """``n`` requests of 1-10 prompt tokens and 4-11 new tokens: most
    budgets run past one segment of 3."""
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(0, 256, int(rng.integers(
        1, PROMPT_BUF + 1)))], int(rng.integers(4, 12))) for _ in range(n)]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_serve_token_identical_to_jax(models, kv_dtype):
    jm, params, tm = models
    reqs = _requests(3, 7)
    jcb = JaxBatcher(jm, params, slots=SLOTS, t_max=T_MAX,
                     prompt_buf=PROMPT_BUF, segment=SEGMENT,
                     kv_block_tokens=BT[kv_dtype], decode_width_buckets=1,
                     prefix_cache=False, kv_dtype=kv_dtype)
    want = jcb.serve([JaxRequest(list(t), n) for t, n in reqs])
    cb = ContinuousBatcher(tm, slots=SLOTS, t_max=T_MAX,
                           prompt_buf=PROMPT_BUF, segment=SEGMENT,
                           kv_block_tokens=BT[kv_dtype], kv_dtype=kv_dtype,
                           device="cpu")
    assert cb._block_takes_positions
    got = cb.serve([Request(list(t), n) for t, n in reqs])
    assert got == want
    assert [len(o) for o in got] == [n for _, n in reqs]
    assert cb.stats["prefill_calls"] > 1               # staggered
    assert cb.last_block_leaks == 0 and cb.last_slot_leaks == 0
    hk, hd = tm.kv_cache_spec()
    assert cb._caches[0]["kv"].shape[2:] == (hk, BT[kv_dtype], hd)


def _batch(seed=1):
    """Three prompts of 7, 4 and 1 real tokens, left-padded to 7."""
    prompt = np.random.default_rng(seed).integers(0, 256, (3, 7)).astype(
        np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, :3] = 0
    mask[2, :6] = 0
    return prompt, mask


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("masked", [False, True])
def test_generate_token_identical_to_jax(models, kv_quant, masked):
    jm, params, tm = models
    prompt, mask = _batch()
    mask = mask if masked else None
    want = jax_infer.generate(
        jm, params, jnp.asarray(prompt), 10, kv_quant=kv_quant,
        prompt_mask=None if mask is None else jnp.asarray(mask))
    got = infer.generate(tm, prompt, 10, prompt_mask=mask,
                         kv_quant=kv_quant)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
def test_prefill_matches_jax(models, kv_quant):
    jm, params, tm = models
    prompt, mask = _batch(2)
    want_logits, want = jax_infer.prefill(
        jm, params, jnp.asarray(prompt), 12, prompt_mask=jnp.asarray(mask),
        kv_quant=kv_quant)
    with torch.no_grad():
        logits, caches = infer.prefill(tm, torch.from_numpy(prompt).long(),
                                       12, torch.from_numpy(mask),
                                       kv_quant=kv_quant)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=TOL, rtol=TOL)
    hk, hd = tm.kv_cache_spec()
    for got, ref in zip(caches, want):
        assert tuple(got["kv"].shape) == (2, 3, hk, 12, hd)
        if kv_quant:
            np.testing.assert_array_equal(got["kv"].numpy(),
                                          np.asarray(ref["kv"]))
            np.testing.assert_allclose(got["scale"].numpy(),
                                       np.asarray(ref["scale"]), atol=1e-6,
                                       rtol=0)
        else:
            np.testing.assert_allclose(got["kv"].numpy(),
                                       np.asarray(ref["kv"]), atol=TOL,
                                       rtol=TOL)
