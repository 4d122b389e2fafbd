"""The port's dense KV-cache writes and dense decode read against the JAX
package, on the CPU.

- The plain ``cache_insert`` / ``kv_insert`` / ``kv_insert_rows`` (what a
  CPU tensor runs; the ``csrc/kv_insert.cu`` kernel's reference) against
  the Pallas ``cache_insert_pallas`` / ``kv_insert_pallas`` /
  ``kv_insert_rows_pallas`` in interpret mode: exact, in f32 and bf16, at
  window-edge and interior slots and per-row positions, with the updates
  given as strided split-head views.
- The plain dense decode read (``csrc/dense_decode.cu``'s reference)
  against the JAX ``cached_attention`` with ``slot_mask``, scalar and
  ``[B]`` ``pos``, MHA and GQA, to 1e-5 in f32 (only the summation order
  differs). The Pallas ``decode_attention_pallas`` body needs a TPU
  (``tests/test_decode_attention.py`` skips it off-TPU), so its XLA
  reference is the oracle.
- The dense ``cache_write_and_attend`` tick against the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.ops.attention import (
    cache_write_and_attend as jax_cache_write_and_attend,
    cached_attention as jax_cached_attention)
from distributed_compute_pytorch_tpu.ops.pallas.cache_update import (
    cache_insert_pallas, kv_insert_pallas, kv_insert_rows_pallas)
from distributed_compute_pytorch_tpu_torch.ops import attention as A
from distributed_compute_pytorch_tpu_torch.ops import cache_update as CU
from distributed_compute_pytorch_tpu_torch.ops.decode_attention import (
    decode_attention, dense_decode_plain)
from distributed_compute_pytorch_tpu_torch.utils.quantize import quantize_kv

TOL = 1e-5   # f32, both sides: only the summation order differs
B, HK, T, HD = 2, 3, 128, 64
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}

_jax_cache_insert = jax.jit(
    lambda c, u, p: cache_insert_pallas(c, u, p, interpret=True))
_jax_kv_insert = jax.jit(
    lambda c, u, p: kv_insert_pallas(c, u, p, interpret=True))
_jax_kv_insert_rows = jax.jit(
    lambda c, u, p: kv_insert_rows_pallas(c, u, p, interpret=True))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _split_views(x, s):
    """``s`` strided ``[B, HK, 1, HD]`` split-head views of one fused
    ``[B, 1, s * HK * HD]`` tensor, as the model's QKV projection makes
    them."""
    return [A.split_heads(p, HK) for p in x.split(HK * HD, dim=-1)]


def _as_f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _case(seed, s, dt):
    """A random cache and update, the same values (rounded once from f32)
    on both sides."""
    rng = np.random.default_rng(seed)
    tdt, jdt = DTYPES[dt]
    cache = _randn(rng, s, B, HK, T, HD)
    upd = _randn(rng, B, 1, s * HK * HD)
    ups = _split_views(torch.from_numpy(upd).to(tdt), s)
    jups = jnp.stack([jnp.asarray(u.float().numpy()) for u in ups]
                     ).astype(jdt)                      # [s, B, HK, 1, HD]
    return (torch.from_numpy(cache).to(tdt), ups,
            jnp.asarray(cache).astype(jdt), jups)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 1, 7, 8, 63, 127])
def test_cache_insert_plain_matches_pallas(dt, pos):
    cache, (u,), jcache, jups = _case(0, 1, dt)
    want = _jax_cache_insert(jcache[0], jups[0], jnp.int32(pos))
    got = CU.cache_insert(cache[0], u, torch.tensor(pos, dtype=torch.int32))
    assert got.data_ptr() == cache.data_ptr()            # in place
    np.testing.assert_array_equal(got.float().numpy(), _as_f32(want))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 7, 31, 32, 96, 127])
def test_kv_insert_plain_matches_pallas(dt, pos):
    cache, (k, v), jcache, jups = _case(1, 2, dt)
    want = _jax_kv_insert({"kv": jcache}, {"kv": jups}, jnp.int32(pos))["kv"]
    # the lockstep tick's form: a 0-dim view of a device arange
    got = CU.kv_insert(cache, k, v,
                       torch.arange(pos, pos + 2, dtype=torch.int32)[0])
    assert got is cache
    np.testing.assert_array_equal(got.float().numpy(), _as_f32(want))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [(0, 127), (7, 33), (127, 8)])
def test_kv_insert_rows_plain_matches_pallas(dt, pos):
    cache, (k, v), jcache, jups = _case(2, 2, dt)
    want = _jax_kv_insert_rows({"kv": jcache}, {"kv": jups},
                               jnp.asarray(pos, jnp.int32))["kv"]
    got = CU.kv_insert_rows(cache, k, v, torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_array_equal(got.float().numpy(), _as_f32(want))


def test_dense_insert_drops_out_of_range_slot():
    """A slot outside ``[0, T)`` drops the row (as ``kv_pool_insert`` drops
    one), where the JAX fallback, ``dynamic_update_slice``, clamps it:
    generation's capacity check keeps every slot in range."""
    cache, (k, v), jcache, jups = _case(3, 2, "f32")
    before = cache.clone()
    CU.kv_insert(cache, k, v, T)
    CU.kv_insert_rows(cache, k, v, torch.tensor([-1, T], dtype=torch.int32))
    assert torch.equal(cache, before)
    clamped = jax.lax.dynamic_update_slice_in_dim(jcache, jups, T, axis=3)
    np.testing.assert_array_equal(np.asarray(clamped)[:, :, :, T - 1],
                                  np.asarray(jups)[:, :, :, 0])


def test_dense_insert_refuses_int8_and_wrong_shapes():
    """The int8 cache is written only with its scale plane and from float
    updates (quantized as they land: ``tests/test_torch_kv_quant.py`` holds
    that write to the Pallas one); int8 updates, a missing or misshapen
    scale plane and a scale beside a float cache are refused, as are
    misshapen updates and positions."""
    cache = torch.zeros(2, B, HK, T, HD, dtype=torch.int8)
    scale = torch.zeros(2, B, HK, T, 1)
    upd = torch.zeros(B, HK, 1, HD, dtype=torch.int8)
    with pytest.raises(ValueError, match="float K/V"):
        CU.kv_insert(cache, upd, upd, 0, scale=scale)
    k = torch.randn(B, HK, 1, HD)
    with pytest.raises(ValueError, match="needs its scale plane"):
        CU.kv_insert(cache, k, k, 0)
    with pytest.raises(ValueError, match="scale must be f32"):
        CU.kv_insert(cache, k, k, 0, scale=scale[..., :3, :])
    with pytest.raises(ValueError, match="goes with an int8 cache"):
        CU.kv_insert(cache.float(), k, k, 0, scale=scale)
    CU.kv_insert(cache, k, k, 5, scale=scale)
    q, s = quantize_kv(k[:, :, 0])
    assert torch.equal(cache[1, :, :, 5], q) and torch.equal(
        scale[0, :, :, 5], s)
    f = torch.zeros(2, B, HK, T, HD)
    with pytest.raises(ValueError, match=r"\[B, Hk, 1, hd\]"):
        CU.kv_insert(f, f[0, :, :, :2], f[0, :, :, :2], 0)
    with pytest.raises(ValueError, match="scalar"):
        CU.kv_insert(f, f[0, :, :, :1], f[0, :, :, :1],
                     torch.zeros(B, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[B\]"):
        CU.kv_insert_rows(f, f[0, :, :, :1], f[0, :, :, :1], 3)


# ---- the dense decode read --------------------------------------------------

def _decode_case(rng, H, hk, Bd=3, Td=80, hd=16):
    q = _randn(rng, Bd, H, 1, hd)
    cache = _randn(rng, 2, Bd, hk, Td, hd)
    # left pads: row 1 masks a run longer than one 32-key chunk
    mask = np.ones((Bd, Td), np.int32)
    mask[1, :45] = 0
    mask[2, :3] = 0
    return q, cache, mask


@pytest.mark.parametrize("H,hk", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("pos", [50, (47, 79, 5)])
@pytest.mark.parametrize("masked", [False, True])
def test_dense_decode_plain_matches_jax_cached_attention(H, hk, pos, masked):
    rng = np.random.default_rng(4)
    q, cache, mask = _decode_case(rng, H, hk)
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = torch.tensor(pos, dtype=torch.int32)
    want = jax_cached_attention(
        jnp.asarray(q), jnp.asarray(cache[0]), jnp.asarray(cache[1]), jpos,
        slot_mask=jnp.asarray(mask) if masked else None)
    tmask = torch.from_numpy(mask != 0) if masked else None
    got = dense_decode_plain(torch.from_numpy(q), torch.from_numpy(cache),
                             tpos, slot_mask=tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # the dispatcher takes the plain version for CPU tensors
    np.testing.assert_allclose(
        decode_attention(torch.from_numpy(q), torch.from_numpy(cache), tpos,
                         slot_mask=tmask).numpy(),
        np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("pos", [60, (60, 45, 79)])
def test_dense_cache_write_and_attend_matches_jax_tick(pos):
    """The whole dense tick: the write (in place in the port) and the
    masked read, against the JAX ``cache_write_and_attend`` on the same
    cache: the output and the updated cache."""
    rng = np.random.default_rng(5)
    H = hk = 4
    q, cache, mask = _decode_case(rng, H, hk)
    k, v = (_randn(rng, 3, hk, 1, 16) for _ in range(2))
    want, new = jax_cache_write_and_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        {"kv": jnp.asarray(cache)}, jnp.asarray(pos, jnp.int32),
        slot_mask=jnp.asarray(mask))
    t_cache = torch.from_numpy(cache.copy())
    got, out = A.cache_write_and_attend(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        {"kv": t_cache}, torch.tensor(pos, dtype=torch.int32),
        slot_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(t_cache.numpy(), np.asarray(new["kv"]))
    assert out["kv"] is t_cache


def test_cache_write_and_attend_refuses_int8_form():
    """The int8 form is a cache format of its own now (the whole tick is
    held to the JAX one in ``tests/test_torch_kv_quant.py``): an int8
    ``"kv"`` without its ``"scale"`` leaf is still refused, and so is a
    paged pool with a ``slot_mask``; with the leaf, the tick writes the
    quantized row and reads it back."""
    q = torch.randn(1, 2, 1, 8)
    cache = {"kv": torch.zeros(2, 1, 2, 4, 8, dtype=torch.int8),
             "scale": torch.zeros(2, 1, 2, 4, 1)}
    with pytest.raises(ValueError, match="scale"):
        A.cache_write_and_attend(q, q, q, {"kv": cache["kv"]}, 0)
    with pytest.raises(NotImplementedError, match="slot_mask"):
        A.cache_write_and_attend(
            q, q, q, {**cache, "table": torch.zeros(1, 1, dtype=torch.int32)},
            0, slot_mask=torch.ones(1, 4))
    o, out = A.cache_write_and_attend(q, q, q, cache, 0)
    kq, ks = quantize_kv(q[:, :, 0])
    assert out is cache and torch.equal(cache["kv"][0, :, :, 0], kq)
    # one attended slot: the output is that slot's dequantized V row
    torch.testing.assert_close(o[:, :, 0], kq.float() * ks, atol=1e-6,
                               rtol=0)
