"""The port's kernel modules against the JAX package, on the CPU.

Each hand-written CUDA kernel of the port has a plain PyTorch version
beside it, which is what a CPU tensor runs. Here each plain version gets
the same numpy inputs as the JAX function it replaces — the Pallas
kernels in interpret mode where they run off-TPU, the XLA path where the
Pallas kernel needs a TPU — and must agree to 1e-5 in f32 (the two sides
sum in different orders; nothing else differs). The CUDA kernels
themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.ops.attention import (
    cache_write_and_attend as jax_cache_write_and_attend,
    cached_attention as jax_cached_attention,
    gather_kv_blocks as jax_gather_kv_blocks)
from distributed_compute_pytorch_tpu.ops.pallas.cache_update import (
    _pool_scatter, kv_pool_insert_rows_pallas)
from distributed_compute_pytorch_tpu.ops.pallas.flash_attention import (
    _flash_fwd, flash_attention as jax_flash_attention)
from distributed_compute_pytorch_tpu_torch.ops import attention as A
from distributed_compute_pytorch_tpu_torch.ops.cache_update import (
    kv_pool_insert, kv_pool_insert_plain)
from distributed_compute_pytorch_tpu_torch.ops.decode_attention import (
    paged_decode_attention, paged_decode_plain)
from distributed_compute_pytorch_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain, flash_fwd_plain)

TOL = 1e-5   # f32, both sides: only the summation order differs


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---- flash forward (kernel 1) ---------------------------------------------

@pytest.mark.parametrize("causal,t,tk,lengths", [
    (True, 16, 16, None),            # causal self-attention
    (True, 5, 12, None),             # causal, t < tk: bottom-right offset
    (True, 13, 13, (13, 7)),         # causal + ragged kv_mask (prefill)
    (False, 7, 9, None),             # odd lengths, non-causal
    (False, 6, 11, (11, 3)),         # non-causal + ragged kv_mask
])
def test_flash_plain_matches_jax_flash(causal, t, tk, lengths):
    rng = np.random.default_rng(0)
    b, h, d = 2, 2, 16
    q, k, v = _randn(rng, b, h, t, d), _randn(rng, b, h, tk, d), \
        _randn(rng, b, h, tk, d)
    mask = None
    if lengths is not None:
        mask = (np.arange(tk)[None, :] < np.asarray(lengths)[:, None]
                ).astype(np.float32)
    want = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_mask=None if mask is None else jnp.asarray(mask),
        block_q=32, block_k=32)
    tm = None if mask is None else torch.from_numpy(mask)
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                kv_mask=tm)
    _close(got, want)
    # the dispatcher takes the plain version for CPU tensors
    _close(flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal, kv_mask=tm),
           want)


# bf16: both sides round the softmax weights to bf16 before the value
# product, the JAX kernel the running unnormalised ones, the plain version
# the normalised ones, and each rounds its output to bf16. Measured over
# four seeds: 7.8e-3 at most, one bf16 ulp of outputs in [1, 2); the limit
# (atol + rtol * |want|) allows about two. lse comes from the same exact
# bf16 products summed in f32 in another order: 4.8e-7 measured.
BF16_O_TOL, BF16_LSE_TOL = 8e-3, 1e-5


@pytest.mark.parametrize("causal,t,tk,lengths,dtype", [
    (True, 32, 32, None, "float32"),           # causal square
    (True, 16, 48, None, "float32"),           # causal t < tk: offset 32
    (True, 32, 32, (32, 11), "float32"),       # causal + ragged kv_mask
    (False, 16, 32, (32, 5), "float32"),       # non-causal + kv_mask
    (True, 32, 48, (48, 20), "bfloat16"),      # offset + mask, in bf16
], ids=["causal", "causal_offset", "causal_masked", "masked",
        "causal_offset_masked_bf16"])
def test_flash_fwd_plain_lse_matches_jax_flash_fwd(causal, t, tk, lengths,
                                                   dtype):
    """``flash_fwd_plain``'s output and logsumexp (the residual the
    backward kernels read) against the JAX ``_flash_fwd``, its Pallas
    ``_fwd_kernel`` in interpret mode, at 16 x 16 blocks with the kv mask
    as ``[B, 1, tk]``."""
    rng = np.random.default_rng(1)
    b, h, d = 2, 2, 16
    q, k, v = _randn(rng, b, h, t, d), _randn(rng, b, h, tk, d), \
        _randn(rng, b, h, tk, d)
    mask = None
    if lengths is not None:
        mask = (np.arange(tk)[None, :] < np.asarray(lengths)[:, None]
                ).astype(np.float32)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(x.reshape(b * h, -1, d), dtype=dtype)
                  for x in (q, k, v))
    o_want, lse_want = _flash_fwd(
        jq, jk, jv, None if mask is None else jnp.asarray(mask[:, None]),
        h, scale, causal, tk - t if causal else 0, 16, 16)
    tq, tk_, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                   for x in (q, k, v))
    o_got, lse_got = flash_fwd_plain(
        tq, tk_, tv, causal=causal,
        kv_mask=None if mask is None else torch.from_numpy(mask))
    assert o_got.dtype == getattr(torch, dtype)
    assert lse_got.dtype == torch.float32
    o_tol = TOL if dtype == "float32" else BF16_O_TOL
    lse_tol = TOL if dtype == "float32" else BF16_LSE_TOL
    _close(o_got.float().reshape(b * h, t, d),
           np.asarray(o_want.astype(jnp.float32)), o_tol)
    _close(lse_got.reshape(b * h, t, 1), np.asarray(lse_want), lse_tol)


def test_flash_rejects_causal_q_longer_than_kv():
    q = torch.zeros(1, 1, 5, 8)
    kv = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="q_len <= kv_len"):
        flash_attention(q, kv, kv, causal=True)


# ---- paged pool write (kernel 2) -------------------------------------------

def _pool_case(rng, P=9, H=3, bt=8, hd=16, n=5):
    pool = _randn(rng, 2, P, H, bt, hd)
    upd = _randn(rng, 2, n, H, 1, hd)
    blocks = rng.permutation(np.arange(1, P))[:n].astype(np.int32)
    offsets = rng.integers(0, bt, n).astype(np.int32)
    return pool, upd, blocks, offsets


def _port_insert(pool, upd, blocks, offsets):
    out = torch.from_numpy(pool.copy())
    u = torch.from_numpy(upd)
    kv_pool_insert(out, u[0, :, :, 0], u[1, :, :, 0],
                   torch.from_numpy(blocks), torch.from_numpy(offsets))
    return out


def test_pool_insert_plain_matches_jax_pallas_kernel():
    rng = np.random.default_rng(1)
    pool, upd, blocks, offsets = _pool_case(rng)
    want = kv_pool_insert_rows_pallas(
        {"kv": jnp.asarray(pool)}, {"kv": jnp.asarray(upd)},
        jnp.asarray(blocks), jnp.asarray(offsets), interpret=True)["kv"]
    np.testing.assert_array_equal(_port_insert(pool, upd, blocks, offsets),
                                  np.asarray(want))


def test_pool_insert_drops_out_of_range_ids_like_jax_scatter():
    """Admission pad tokens aim at block id P: the write drops them, the
    ``mode="drop"`` contract of the reference's ``_pool_scatter``."""
    rng = np.random.default_rng(2)
    P = 9
    pool, upd, blocks, offsets = _pool_case(rng, P=P, n=6)
    blocks[[1, 4]] = P                          # out of range: dropped
    want = _pool_scatter(jnp.asarray(pool), jnp.asarray(upd),
                         jnp.asarray(blocks), jnp.asarray(offsets))
    np.testing.assert_array_equal(_port_insert(pool, upd, blocks, offsets),
                                  np.asarray(want))


def test_pool_insert_plain_is_in_place():
    rng = np.random.default_rng(3)
    pool, upd, blocks, offsets = _pool_case(rng)
    t = torch.from_numpy(pool.copy())
    u = torch.from_numpy(upd)
    out = kv_pool_insert_plain(t, u[0, :, :, 0], u[1, :, :, 0],
                               torch.from_numpy(blocks),
                               torch.from_numpy(offsets))
    assert out.data_ptr() == t.data_ptr()


# ---- paged decode read (kernel 3) ------------------------------------------

def _decode_case(rng, B=4, H=4, hk=4, P=12, bt=8, nb=4, hd=16):
    q = _randn(rng, B, H, 1, hd)
    pool = _randn(rng, 2, P, hk, bt, hd)
    table = np.stack([rng.permutation(np.arange(1, P))[:nb]
                      for _ in range(B)]).astype(np.int32)
    return q, pool, table


def _jax_paged_read(q, pool, table, pos):
    kv = jax_gather_kv_blocks(jnp.asarray(pool), jnp.asarray(table))
    return jax_cached_attention(jnp.asarray(q), kv[0], kv[1],
                                jnp.asarray(pos))


@pytest.mark.parametrize("H,hk", [(4, 4), (4, 2)])
def test_paged_decode_plain_matches_jax_gather_read(H, hk):
    """Ragged pos, one row past the table horizon (attends all of it),
    and one parked row: all-trash table at pos 3."""
    rng = np.random.default_rng(4)
    q, pool, table = _decode_case(rng, H=H, hk=hk)
    nb, bt = table.shape[1], pool.shape[3]
    table[3] = 0                                    # parked: all trash
    pos = np.array([0, 13, nb * bt + 5, 3], np.int32)
    want = _jax_paged_read(q, pool, table, pos)
    got = paged_decode_plain(torch.from_numpy(q), torch.from_numpy(pool),
                             torch.from_numpy(table), torch.from_numpy(pos))
    _close(got, want)
    assert np.isfinite(got.numpy()).all()
    _close(paged_decode_attention(torch.from_numpy(q), torch.from_numpy(pool),
                                  torch.from_numpy(table),
                                  torch.from_numpy(pos)), want)


def test_paged_decode_plain_sliced_table_matches_jax():
    """A ``[B, nb_w]`` slice of the tables: the horizon is the slice's."""
    rng = np.random.default_rng(5)
    q, pool, table = _decode_case(rng, nb=6)
    sliced = np.ascontiguousarray(table[:, :2])
    pos = np.array([1, 15, 30, 7], np.int32)        # 30 is past 2 * bt
    want = _jax_paged_read(q, pool, sliced, pos)
    got = paged_decode_plain(torch.from_numpy(q), torch.from_numpy(pool),
                             torch.from_numpy(sliced), torch.from_numpy(pos))
    _close(got, want)


def test_cache_write_and_attend_matches_jax_paged_tick():
    """The whole paged tick: the write through the table (in place in
    the port) and the read, against the JAX ``cache_write_and_attend``
    on the same pool and table — both the output and the updated pool."""
    rng = np.random.default_rng(6)
    B, H, hd, P, bt, nb = 4, 4, 16, 14, 8, 3
    q, k, v = (_randn(rng, B, H, 1, hd) for _ in range(3))
    pool = _randn(rng, 2, P, H, bt, hd)
    table = np.stack([rng.permutation(np.arange(1, P))[:nb]
                      for _ in range(B)]).astype(np.int32)
    table[2] = 0                                    # parked row
    pos = np.array([0, 9, 2, 23], np.int32)
    want, new = jax_cache_write_and_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        {"kv": jnp.asarray(pool), "table": jnp.asarray(table)},
        jnp.asarray(pos))
    t_pool = torch.from_numpy(pool.copy())
    got, cache = A.cache_write_and_attend(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        {"kv": t_pool, "table": torch.from_numpy(table)},
        torch.from_numpy(pos))
    _close(got, want)
    live = [0, 1, 3]     # the parked row's trash write races nothing here
    np.testing.assert_array_equal(t_pool.numpy()[:, table[live]],
                                  np.asarray(new["kv"])[:, table[live]])
    assert cache["kv"] is t_pool


def test_dense_math_matches_jax():
    """``dot_product_attention`` (causal + mask) and ``cached_attention``
    (per-row pos) — the reference math every plain version rests on."""
    from distributed_compute_pytorch_tpu.ops.attention import (
        dot_product_attention as jax_dpa)
    rng = np.random.default_rng(7)
    q, k, v = _randn(rng, 2, 3, 5, 8), _randn(rng, 2, 3, 9, 8), \
        _randn(rng, 2, 3, 9, 8)
    mask = rng.random((2, 1, 1, 9)) > 0.3
    want = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, mask=jnp.asarray(mask))
    got = A.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True,
                                  mask=torch.from_numpy(mask))
    _close(got, want)
    pos = np.array([2, 8], np.int32)
    _close(A.cached_attention(torch.from_numpy(q[:, :, :1]),
                              torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(pos)),
           jax_cached_attention(jnp.asarray(q[:, :, :1]), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos)))
