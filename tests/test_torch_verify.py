"""The speculative verify step's op on the CPU: the port's plain
``cache_verify_and_attend`` (``decode_attention.paged_verify_write_plain``,
the plain version of ``csrc/paged_verify.cu``) against the JAX package's
``ops/attention.py::cache_verify_and_attend`` on the same numpy inputs, in
f32, float and int8 pools, at G = 1 and G = 3 query heads a kv head and
windows of 2 and 5: outputs to 1e-5 and every pool byte (and scale) equal,
with windows that cross a block edge and one that crosses the table's
horizon, where its writes are dropped. The verify step also equals W
sequential decode ticks (``paged_write_decode_plain``), outputs and pool,
and its sampled form draws column i as plain decode draws at that logical
position."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.ops.attention import (
    cache_verify_and_attend as jax_verify)
from distributed_compute_pytorch_tpu_torch import infer
from distributed_compute_pytorch_tpu_torch.ops import attention as A
from distributed_compute_pytorch_tpu_torch.ops import decode_attention as DA
from distributed_compute_pytorch_tpu_torch.utils.quantize import quantize_kv

BT, NB, P, HD = 4, 4, 14, 16


def _case(G, W, q8, seed=0):
    """Three live rows on blocks of their own (row 2's window crosses the
    horizon ``NB * BT``), windows crossing block edges; the pool filled
    with random rows (int8 codes and scales for the int8 pool)."""
    rng = np.random.default_rng(seed)
    hk, B = 2, 3
    H = G * hk
    q = rng.standard_normal((B, H, W, HD), np.float32)
    k = rng.standard_normal((B, hk, W, HD), np.float32)
    v = rng.standard_normal((B, hk, W, HD), np.float32)
    blocks = rng.permutation(np.arange(1, P))[:B * NB].reshape(B, NB)
    table = blocks.astype(np.int32)
    pos0 = np.array([2, 6, NB * BT - 2], np.int64)   # last written slots
    positions = (pos0[:, None] + 1 + np.arange(W)).astype(np.int32)
    pool = rng.standard_normal((2, P, hk, BT, HD), np.float32)
    scale = None
    if q8:
        codes, scale = quantize_kv(torch.from_numpy(pool))
        pool, scale = codes.numpy(), scale.numpy()
    return q, k, v, pool, scale, table, positions


def _port(q, k, v, pool, scale, table, positions):
    t = torch.from_numpy
    cache = {"kv": t(pool.copy()), "table": t(table)}
    if scale is not None:
        cache["scale"] = t(scale.copy())
    o, cache = A.cache_verify_and_attend(t(q), t(k), t(v), cache,
                                         t(positions))
    return o.numpy(), cache


@pytest.mark.parametrize("q8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("G,W", [(1, 2), (1, 5), (3, 2), (3, 5)])
def test_plain_verify_matches_jax(G, W, q8):
    q, k, v, pool, scale, table, positions = _case(G, W, q8)
    o, cache = _port(q, k, v, pool, scale, table, positions)
    jcache = {"kv": jnp.asarray(pool), "table": jnp.asarray(table)}
    if q8:
        jcache["scale"] = jnp.asarray(scale)
    jo, jc = jax_verify(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jcache, jnp.asarray(positions))
    np.testing.assert_allclose(o, np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cache["kv"].numpy(), np.asarray(jc["kv"]))
    if q8:
        np.testing.assert_array_equal(cache["scale"].numpy(),
                                      np.asarray(jc["scale"]))
    # the horizon row wrote only its slots under NB * BT
    assert 0 < (positions[2] < NB * BT).sum() < W


@pytest.mark.parametrize("q8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("G", [1, 3])
def test_verify_equals_sequential_decode_ticks(G, q8):
    """W = 5 fused decode ticks, one a window position, leave the same
    pool and give the same outputs as one verify step (rows whose windows
    stay under the horizon: a tick past it clamps where verify drops)."""
    W = 5
    q, k, v, pool, scale, table, positions = _case(G, W, q8, seed=1)
    rows = [0, 1]
    q, k, v, table, positions = (x[rows] for x in (q, k, v, table,
                                                   positions))
    o, cache = _port(q, k, v, pool, scale, table, positions)
    t = torch.from_numpy
    tpool = t(pool.copy())
    tscale = None if scale is None else t(scale.copy())
    for w in range(W):
        ow = DA.paged_write_decode_plain(
            t(q[:, :, w:w + 1].copy()), t(k[:, :, w:w + 1].copy()),
            t(v[:, :, w:w + 1].copy()), tpool, t(table),
            t(positions[:, w].copy()), kv_scale=tscale)
        np.testing.assert_allclose(o[:, :, w:w + 1], ow.numpy(), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(cache["kv"].numpy(), tpool.numpy())
    if q8:
        np.testing.assert_array_equal(cache["scale"].numpy(),
                                      tscale.numpy())


def test_verify_sample_rows_draws_as_plain_decode():
    """Column i of ``verify_sample_rows`` is ``sample_rows`` at logical
    position ``n_logical + i``: the key plain decode draws with there."""
    rng = np.random.default_rng(4)
    B, W, V = 3, 4, 50
    logits = torch.from_numpy(rng.standard_normal((B, W, V), np.float32))
    temp = torch.tensor([0.0, 0.8, 1.3])
    topk = torch.tensor([0, 5, 0])
    topp = torch.tensor([2.0, 2.0, 0.9])
    seeds = torch.tensor([3, 11, 7])
    nlog = torch.tensor([4, 9, 20])
    got = infer.verify_sample_rows(logits, temp, topk, topp, seeds, nlog)
    for i in range(W):
        want = infer.sample_rows(logits[:, i], temp, topk, topp, seeds,
                                 nlog + i)
        assert torch.equal(got[:, i], want)
    assert torch.equal(got[0], logits[0].argmax(-1))
