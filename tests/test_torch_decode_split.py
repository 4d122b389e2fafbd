"""The split-key decode read's arithmetic against the JAX package, on the
CPU.

The CUDA reads (``csrc/decode_common.cuh``) split each (row, kv head)'s
live keys over S blocks, walk each split in tiles with an online softmax,
and merge the splits' partial (m, l, acc) in split order. The kernels run
only on the card, so this file writes that partition and merge out in f32
PyTorch, as the kernel computes it: a split's share of the live length
``n`` is ``ceil(n / S)`` rounded up to ``gran`` keys, a tile with no valid
key is skipped, an empty or wholly masked split merges as (-inf, 0, 0), and
a masked slot adds exactly 0. It is held to the JAX ``cached_attention``
(gathered through the block table for the paged read) and to
``cached_attention_q8`` for the int8 form, on numpy inputs from a seed, at
S in {1, 2, 5}, to 1e-5 in f32 (the two sides sum in different orders).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.ops.attention import (
    cached_attention as jax_cached_attention,
    cached_attention_q8 as jax_cached_attention_q8,
    gather_kv_blocks as jax_gather_kv_blocks)

TOL = 1e-5
HD = 8
TILE = 4      # keys a tile holds: small, so a split spans several tiles
DENSE_GRAN = 16


def _split_partial(q, k, v, valid, lo, hi, scale, ks, vs):
    """One split's (m, l, acc) over keys [lo, hi), tile by tile."""
    m, l, acc = -math.inf, torch.tensor(0.0), torch.zeros(q.shape[-1])
    for t0 in range(lo, hi, TILE):
        t = slice(t0, min(t0 + TILE, hi))
        vm = valid[t]
        if not vm.any():            # no valid key: no loads, no change
            continue
        s = (k[t] @ q) * scale
        if ks is not None:
            s = s * ks[t]           # the K scale after the product
        s = torch.where(vm, s, -math.inf)
        m_new = max(m, s.max().item())
        alpha = math.exp(m - m_new)
        p = torch.where(vm, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum()
        w = p if vs is None else p * vs[t]   # p * v_scale, in f32
        acc = acc * alpha + w @ v[t]
        m = m_new
    return m, l, acc


def split_read(q, k, v, valid, n, S, gran, scale, ks=None, vs=None):
    """The kernel's read of one head: ``q [hd]`` over ``k, v [cap, hd]``
    (f32; int8 values with their scales ``ks, vs [cap]``), slots ``0..n-1``
    where ``valid``, in S splits merged in split order."""
    per = -(-(-(-n // S)) // gran) * gran
    parts = []
    for s in range(S):
        lo = min(s * per, n)
        parts.append(_split_partial(q, k, v, valid, lo, min(lo + per, n),
                                    scale, ks, vs))
    M = max(m for m, _, _ in parts)
    L, out = torch.tensor(0.0), torch.zeros(q.shape[-1])
    for m, l, acc in parts:
        f = 0.0 if m == -math.inf else math.exp(m - M)
        L = L + l * f
        out = out + acc * f
    return out / max(L.item(), 1e-30)


def read_all(q, k, v, valid, n, S, gran, ks=None, vs=None):
    """``split_read`` of every (row, head): q ``[B, H, 1, hd]``, k and v
    ``[B, Hk, cap, hd]`` (scales ``[B, Hk, cap]``), valid ``[B, cap]``,
    live lengths ``n [B]``."""
    B, H, _, hd = q.shape
    G = H // k.shape[1]
    out = torch.zeros(B, H, 1, hd)
    for b in range(B):
        for h in range(H):
            hk = h // G
            out[b, h, 0] = split_read(
                q[b, h, 0], k[b, hk], v[b, hk], valid[b], int(n[b]), S, gran,
                hd ** -0.5, None if ks is None else ks[b, hk],
                None if vs is None else vs[b, hk])
    return out


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("S", [1, 2, 5])
@pytest.mark.parametrize("H,hk", [(4, 4), (4, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_dense_split_merge_matches_jax(S, H, hk, masked):
    """Per-row positions (one past the cache: clamped); the mask leaves one
    row a pad run covering whole splits and another a single valid slot."""
    rng = np.random.default_rng(50)
    B, T = 4, 40
    q, k, v = (_randn(rng, B, H, 1, HD), _randn(rng, B, hk, T, HD),
               _randn(rng, B, hk, T, HD))
    pos = np.array([0, 17, T, 25], np.int32)
    mask = np.ones((B, T), bool)
    if masked:
        mask[1, :16] = False
        mask[3, :25] = False
    want = jax_cached_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos),
                                slot_mask=jnp.asarray(mask))
    n = np.minimum(pos, T - 1) + 1
    got = read_all(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), torch.from_numpy(mask), n, S,
                   DENSE_GRAN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("S", [1, 2, 5])
@pytest.mark.parametrize("H,hk", [(4, 4), (8, 2)])
def test_paged_split_merge_matches_jax_gathered(S, H, hk):
    """Splits of whole table blocks (gran = bt): a parked all-trash row, a
    row past its table's horizon (clamped), a one-key row."""
    rng = np.random.default_rng(51)
    B, nb, bt, P = 4, 5, 4, 21
    q = _randn(rng, B, H, 1, HD)
    pool = _randn(rng, 2, P, hk, bt, HD)
    table = np.stack([rng.permutation(P - 1)[:nb] + 1 for _ in range(B)]
                     ).astype(np.int32)
    table[2] = 0                                  # parked: all trash
    pos = np.array([0, 13, 6, nb * bt + 3], np.int32)
    kv = jax_gather_kv_blocks(jnp.asarray(pool), jnp.asarray(table))
    want = jax_cached_attention(jnp.asarray(q), kv[0], kv[1],
                                jnp.asarray(pos))
    kv = torch.from_numpy(np.array(kv))
    n = np.minimum(pos, nb * bt - 1) + 1
    got = read_all(torch.from_numpy(q), kv[0], kv[1],
                   torch.ones(B, nb * bt, dtype=torch.bool), n, S, bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("S", [1, 2, 5])
@pytest.mark.parametrize("paged", [False, True])
def test_int8_split_merge_matches_jax_q8(S, paged):
    """The int8 form: the score times the K scale after its product, the V
    row weighted by p * v_scale in f32; masked (dense) or gathered through
    a table (paged)."""
    rng = np.random.default_rng(52)
    B, H, hk, T = 3, 4, 2, 32
    q = _randn(rng, B, H, 1, HD)
    mask = np.ones((B, T), bool)
    pos = np.array([20, 31, 7], np.int32)
    gran = DENSE_GRAN
    if paged:                             # T = nb * bt logical slots a row
        gran, nb, P = 8, 4, 13
        pool = rng.integers(-127, 128, (2, P, hk, gran, HD)).astype(np.int8)
        spool = rng.uniform(1e-3, 1e-1, (2, P, hk, gran, 1)
                            ).astype(np.float32)
        table = jnp.asarray(np.stack([rng.permutation(P)[:nb]
                                      for _ in range(B)]).astype(np.int32))
        kv = np.array(jax_gather_kv_blocks(jnp.asarray(pool), table))
        sc = np.array(jax_gather_kv_blocks(jnp.asarray(spool), table))
    else:
        kv = rng.integers(-127, 128, (2, B, hk, T, HD)).astype(np.int8)
        sc = rng.uniform(1e-3, 1e-1, (2, B, hk, T, 1)).astype(np.float32)
        mask[0, :16] = False                      # a whole split's pad
        mask[2, 3] = False
    view = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]),
            "k_scale": jnp.asarray(sc[0]), "v_scale": jnp.asarray(sc[1])}
    want = jax_cached_attention_q8(jnp.asarray(q), view, jnp.asarray(pos),
                                   slot_mask=jnp.asarray(mask))
    f = torch.from_numpy(kv.astype(np.float32))
    s = torch.from_numpy(sc[..., 0])
    got = read_all(torch.from_numpy(q), f[0], f[1], torch.from_numpy(mask),
                   pos + 1, S, gran, ks=s[0], vs=s[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("name", ["SMAX", "SPLIT_KEYS"])
def test_wrapper_constants_match_the_kernel_header(name):
    """The wrapper sizes the merge's workspace with SMAX and states the
    split length SPLIT_KEYS; both must be the header's."""
    import re
    from pathlib import Path

    from distributed_compute_pytorch_tpu_torch.ops import decode_attention
    header = (Path(decode_attention.__file__).parents[1] / "csrc"
              / "decode_common.cuh").read_text()
    found = re.search(rf"constexpr int {name} = (\d+);", header)
    assert found and int(found.group(1)) == getattr(decode_attention, name)
