"""The fused decode ticks (``ops/decode_attention.py``: the slot write and
the flash-decode read in one launch) against the JAX package, on the CPU.

``paged_write_decode`` (serving's tick on the paged pool) and
``dense_write_decode`` (generation's tick on the dense pair cache) run
their plain versions here, the plain write followed by the plain read.
Each gets the same numpy inputs as the JAX ``cache_write_and_attend``
(``_paged_write_and_attend`` for the pool; the XLA write and read, as the
JAX package runs them off-TPU):

- the paged pool at per-row positions: a row writing the first slot of
  its first block, a row crossing into a new block (its write the first
  slot of its second block), a row at the last slot of its table, and one
  parked row on an all-trash table with ``pos`` past ``nb * bt``;
- the dense pair cache at a lockstep (0-dim) and at per-row positions,
  with a left-pad ``slot_mask`` that masks the written slot of one row
  (that row attends no slot, and both sides average V over the cache);
- f32 and bf16 float caches, and the int8 forms (f32 and bf16 rows,
  quantized as they are written); MHA and 2 query heads per kv head.

Tolerances: the caches' float leaves and int8 bytes exact, the scales to
1e-6 (the same IEEE quotients on both sides); the outputs to 1e-5 in f32
(the two sides sum in different orders) and 2e-2 in bf16 (both round the
softmax weights to bf16 before the value product, each at its own place).
The parked row is left out of the comparison: the port clamps its slot to
the table's last entry and writes the trash block, where the JAX gather
fills the out-of-range lookup and its scatter drops the write; its output
is discarded by the scheduler on both sides, and the trash block is never
attended by a live row. The CUDA kernels are held to these plain versions
and to the unfused kernel pair on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.ops.attention import (
    cache_write_and_attend as jax_cache_write_and_attend)
from distributed_compute_pytorch_tpu_torch.ops import attention as A
from distributed_compute_pytorch_tpu_torch.ops import decode_attention as DA

OUT_TOL = {"f32": 1e-5, "bf16": 2e-2}
SCALE_TOL = 1e-6
# cache: "f32" / "bf16" float caches; "int8-<rows>" an int8 cache taking
# f32 or bf16 rows
CACHES = ["f32", "bf16", "int8-f32", "int8-bf16"]
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _rows_dt(cache: str) -> str:
    return cache.split("-")[-1]


def _float(rng, dt, *shape):
    """Normal floats rounded once to ``dt``: a torch tensor and a JAX array
    of the same values."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        TORCH_DT[dt])
    return t, jnp.asarray(t.float().numpy()).astype(JAX_DT[dt])


def _cache(rng, cache, *shape):
    """A cache of ``shape`` as torch leaves ``(kv, scale or None)`` and the
    JAX tree of the same values."""
    if cache.startswith("int8"):
        kv = rng.integers(-127, 128, shape).astype(np.int8)
        sc = rng.uniform(1e-3, 1e-1, shape[:-1] + (1,)).astype(np.float32)
        return (torch.from_numpy(kv.copy()), torch.from_numpy(sc.copy()),
                {"kv": jnp.asarray(kv), "scale": jnp.asarray(sc)})
    kv, jkv = _float(rng, cache, *shape)
    return kv, None, {"kv": jkv}


def _assert_leaves(kv, sc, tree, keep):
    """The port's cache leaves (updated in place) against the JAX tree's,
    along axis 1 at ``keep``: float leaves and int8 bytes exact, scales to
    SCALE_TOL."""
    np.testing.assert_array_equal(
        kv[:, keep].float().numpy(),
        np.asarray(tree["kv"][:, keep].astype(jnp.float32)))
    if sc is not None:
        np.testing.assert_allclose(sc[:, keep].numpy(),
                                   np.asarray(tree["scale"][:, keep]),
                                   atol=SCALE_TOL, rtol=SCALE_TOL)


def _assert_out(got, want, dt, rows):
    np.testing.assert_allclose(
        got[rows].float().numpy(),
        np.asarray(want.astype(jnp.float32))[rows],
        atol=OUT_TOL[dt], rtol=OUT_TOL[dt])


def _paged_case(cache, H, hk, seed=0):
    """Four rows over nb = 3 blocks of bt = 4, hd 16 (hd 32 for GQA), a
    pool of 4 * 3 + 1 blocks (block 0 the trash block)."""
    rng = np.random.default_rng(seed)
    B, bt, nb = 4, 4, 3
    hd = 16 if H == hk else 32
    P = B * nb + 1
    dt = _rows_dt(cache)
    q, jq = _float(rng, dt, B, H, 1, hd)
    k, jk = _float(rng, dt, B, hk, 1, hd)
    v, jv = _float(rng, dt, B, hk, 1, hd)
    kv, sc, tree = _cache(rng, cache, 2, P, hk, bt, hd)
    table = (rng.permutation(P - 1)[:B * nb] + 1).reshape(B, nb).astype(
        np.int32)
    table[2] = 0                                   # parked: all trash
    # the first slot; into a new block; parked, past nb * bt; the last slot
    pos = np.array([0, bt, nb * bt + 5, nb * bt - 1], np.int32)
    return (q, k, v, kv, sc, torch.from_numpy(table), torch.from_numpy(pos),
            (jq, jk, jv, {**tree, "table": jnp.asarray(table)},
             jnp.asarray(pos)))


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("H,hk", [(4, 4), (4, 2)])
def test_paged_write_decode_matches_jax_tick(cache, H, hk):
    q, k, v, kv, sc, table, pos, jax_args = _paged_case(cache, H, hk)
    want, new = jax_cache_write_and_attend(*jax_args)
    got = DA.paged_write_decode(q, k, v, kv, table, pos, kv_scale=sc)
    live = [0, 1, 3]
    assert got.shape == q.shape and got.dtype == q.dtype
    _assert_out(got, want, _rows_dt(cache), live)
    # every block but the trash block, which the parked row writes here
    _assert_leaves(kv, sc, new, slice(1, None))


@pytest.mark.parametrize("cache", ["bf16", "int8-f32"])
def test_cache_write_and_attend_takes_the_fused_paged_tick(cache,
                                                           monkeypatch):
    """The decode tick's call site sends a paged pool to the fused tick
    (its plain version on the CPU), once, with the table and ``pos``
    through: the same output and pool as the JAX tick."""
    q, k, v, kv, sc, table, pos, jax_args = _paged_case(cache, 4, 2, seed=1)
    calls = []
    plain = DA.paged_write_decode_plain
    monkeypatch.setattr(DA, "paged_write_decode_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    want, new = jax_cache_write_and_attend(*jax_args)
    leaves = {"kv": kv, "table": table} if sc is None else {
        "kv": kv, "scale": sc, "table": table}
    got, out = A.cache_write_and_attend(q, k, v, leaves, pos)
    assert calls == [1] and out is leaves and out["kv"] is kv
    _assert_out(got, want, _rows_dt(cache), [0, 1, 3])
    _assert_leaves(kv, sc, new, slice(1, None))


def _dense_case(cache, H, hk, lockstep, seed=2):
    """Three rows over T = 16 slots, hd 16 (hd 32 for GQA); a left-pad slot
    mask of 3, 11 and 0 pad slots: row 1's pad covers its written slot."""
    rng = np.random.default_rng(seed)
    B, T = 3, 16
    hd = 16 if H == hk else 32
    dt = _rows_dt(cache)
    q, jq = _float(rng, dt, B, H, 1, hd)
    k, jk = _float(rng, dt, B, hk, 1, hd)
    v, jv = _float(rng, dt, B, hk, 1, hd)
    kv, sc, tree = _cache(rng, cache, 2, B, hk, T, hd)
    mask = np.arange(T)[None, :] >= np.array([3, 11, 0])[:, None]
    pos = np.array(9 if lockstep else [9, 10, 15], np.int32)
    assert not mask[1, 10] and not mask[1, 9]      # the written slot masked
    return (q, k, v, kv, sc, torch.from_numpy(pos), torch.from_numpy(mask),
            (jq, jk, jv, tree, jnp.asarray(pos)), jnp.asarray(mask))


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("H,hk", [(4, 4), (4, 2)])
@pytest.mark.parametrize("lockstep", [True, False],
                         ids=["lockstep", "per_row"])
def test_dense_write_decode_matches_jax_tick(cache, H, hk, lockstep):
    q, k, v, kv, sc, pos, mask, jax_args, jmask = _dense_case(
        cache, H, hk, lockstep)
    want, new = jax_cache_write_and_attend(*jax_args, slot_mask=jmask)
    got = DA.dense_write_decode(q, k, v, kv, pos, slot_mask=mask,
                                kv_scale=sc)
    assert got.shape == q.shape and got.dtype == q.dtype
    _assert_out(got, want, _rows_dt(cache), [0, 1, 2])
    _assert_leaves(kv, sc, new, slice(None))


@pytest.mark.parametrize("lockstep", [True, False],
                         ids=["lockstep", "per_row"])
def test_cache_write_and_attend_takes_the_fused_dense_tick(lockstep,
                                                           monkeypatch):
    """The call site sends the dense pair cache, lockstep or per-row, to
    the fused tick (its plain version on the CPU), once."""
    q, k, v, kv, sc, pos, mask, jax_args, jmask = _dense_case(
        "int8-bf16", 4, 4, lockstep, seed=3)
    calls = []
    plain = DA.dense_write_decode_plain
    monkeypatch.setattr(DA, "dense_write_decode_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    want, new = jax_cache_write_and_attend(*jax_args, slot_mask=jmask)
    leaves = {"kv": kv, "scale": sc}
    got, out = A.cache_write_and_attend(q, k, v, leaves, pos,
                                        slot_mask=mask)
    assert calls == [1] and out is leaves
    _assert_out(got, want, "bf16", [0, 1, 2])
    _assert_leaves(kv, sc, new, slice(None))


def test_cpu_tensors_never_take_the_cuda_path(monkeypatch):
    """CPU tensors run the plain versions: the CUDA launchers are never
    called and no launch counter moves; called directly, a launcher
    refuses CPU tensors."""
    def refuse(*a, **kw):
        raise AssertionError("the CUDA path was taken for CPU tensors")
    monkeypatch.setattr(DA, "paged_write_decode_cuda", refuse)
    monkeypatch.setattr(DA, "dense_write_decode_cuda", refuse)
    counts = (DA.write_launches, DA.write_q8_launches,
              DA.dense_write_launches, DA.dense_write_q8_launches)
    q, k, v, kv, sc, table, pos, _ = _paged_case("int8-f32", 4, 4)
    DA.paged_write_decode(q, k, v, kv, table, pos, kv_scale=sc)
    q, k, v, kv, sc, pos, mask, _, _ = _dense_case("f32", 4, 2, False)
    DA.dense_write_decode(q, k, v, kv, pos, slot_mask=mask, kv_scale=sc)
    assert (DA.write_launches, DA.write_q8_launches, DA.dense_write_launches,
            DA.dense_write_q8_launches) == counts
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        DA.dense_write_decode_cuda(q, k, v, kv, pos, slot_mask=mask)
    q, k, v, kv, sc, table, pos, _ = _paged_case("f32", 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        DA.paged_write_decode_cuda(q, k, v, kv, table, pos)


@pytest.mark.parametrize("bad", ["k_no_seq_dim", "k_heads", "v_rows",
                                 "pos_rows"])
def test_fused_ticks_refuse_mismatched_rows_and_positions(bad):
    """``k``/``v`` must be ``[B, Hk, 1, hd]`` and ``pos`` ``[B]``: either
    wrapper raises otherwise, before anything is written."""
    for paged in (True, False):
        if paged:
            q, k, v, kv, sc, table, pos, _ = _paged_case("f32", 4, 2)
        else:
            q, k, v, kv, sc, pos, mask, _, _ = _dense_case("f32", 4, 2, False)
        if bad == "k_no_seq_dim":
            k = k[:, :, 0]
        elif bad == "k_heads":
            k = torch.cat([k, k], dim=1)
        elif bad == "v_rows":
            v = v[:-1]
        else:
            pos = torch.cat([pos, pos[:1]])
        before = kv.clone()
        with pytest.raises(ValueError, match="must be"):
            if paged:
                DA.paged_write_decode(q, k, v, kv, table, pos)
            else:
                DA.dense_write_decode(q, k, v, kv, pos)
        assert torch.equal(kv, before)
