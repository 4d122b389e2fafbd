"""The port's int8 KV cache against the JAX package, on the CPU.

- ``utils/quantize.py::quantize_kv`` against the JAX ``quantize_kv``:
  exact (int8 bytes and f32 scales), f32 and bf16, with an all-zero row
  and rows whose absmax lands on +-127.
- The int8 plain writes (what a CPU tensor runs; the quantizing kernels'
  reference), fed the FLOAT K/V, against the Pallas ``cache_insert_pallas``
  / ``kv_insert_pallas`` / ``kv_insert_rows_pallas`` /
  ``kv_pool_insert_rows_pallas`` in interpret mode on the int8 trees the
  JAX ``quantize_kv`` makes of the same K/V: exact.
- The int8 reads: ``cached_attention_q8`` and both plain reads
  (``dense_decode_plain``, ``paged_decode_plain`` with ``kv_scale``)
  against the JAX ``cached_attention_q8``, to 1e-5 in f32 (only the
  summation order differs) and 3e-2 in bf16 (the float decode tests'
  tolerance); the whole int8 tick (``cache_write_and_attend``, dense and
  paged) against the JAX one, output and cache leaves.
- ``ContinuousBatcher(kv_dtype="int8")`` and ``infer.generate(kv_quant=
  True)`` against the JAX ones on GPT-2-tiny in f32: greedy tokens
  identical, the served pool's int8 bytes exact and scales to 1e-6; and
  ``cli_serve --kv_dtype int8`` against the JAX ``dcp-serve --kv_dtype
  int8`` on one checkpoint.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu import infer as jax_infer
from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.ops.attention import (
    cache_write_and_attend as jax_cache_write_and_attend,
    cached_attention_q8 as jax_cached_attention_q8,
    gather_kv_blocks as jax_gather_kv_blocks)
from distributed_compute_pytorch_tpu.ops.pallas.cache_update import (
    cache_insert_pallas, kv_insert_pallas, kv_insert_rows_pallas,
    kv_pool_insert_rows_pallas)
from distributed_compute_pytorch_tpu.serve import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest)
from distributed_compute_pytorch_tpu.utils.quantize import (
    quantize_kv as jax_quantize_kv)
from distributed_compute_pytorch_tpu_torch import infer
from distributed_compute_pytorch_tpu_torch.interop import load_gpt2_params
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.ops import attention as A
from distributed_compute_pytorch_tpu_torch.ops import cache_update as CU
from distributed_compute_pytorch_tpu_torch.ops import decode_attention as DA
from distributed_compute_pytorch_tpu_torch.serve import (
    ContinuousBatcher, Request)
from distributed_compute_pytorch_tpu_torch.utils.quantize import quantize_kv

TOL = {"f32": 1e-5, "bf16": 3e-2}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# the Pallas int8 window is 32 slots, so T and the pool's bt are multiples
B, HK, T, HD, BT, P = 3, 2, 64, 16, 32, 7

_jax_cache_insert = jax.jit(
    lambda c, u, p: cache_insert_pallas(c, u, p, interpret=True))
_jax_kv_insert = jax.jit(
    lambda c, u, p: kv_insert_pallas(c, u, p, interpret=True))
_jax_kv_insert_rows = jax.jit(
    lambda c, u, p: kv_insert_rows_pallas(c, u, p, interpret=True))
_jax_pool_insert = jax.jit(
    lambda c, u, b, o: kv_pool_insert_rows_pallas(c, u, b, o,
                                                  interpret=True))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _float_pair(x, dt):
    """``x`` (numpy f32) rounded once to ``dt``, as a torch and a JAX
    array holding the same values."""
    tdt, jdt = DTYPES[dt]
    t = torch.from_numpy(x).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _int8_tree(rng, *shape):
    """A random int8 cache and its scale plane, as torch tensors and a JAX
    ``{"kv", "scale"}`` tree of the same values."""
    kv = rng.integers(-127, 128, shape).astype(np.int8)
    sc = rng.uniform(1e-3, 1e-1, shape[:-1] + (1,)).astype(np.float32)
    return (torch.from_numpy(kv.copy()), torch.from_numpy(sc.copy()),
            {"kv": jnp.asarray(kv), "scale": jnp.asarray(sc)})


def _assert_tree_equal(kv, sc, tree):
    np.testing.assert_array_equal(kv.numpy(), np.asarray(tree["kv"]))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(tree["scale"]))


# ---- quantize_kv --------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_kv_matches_jax_exactly(dt):
    rng = np.random.default_rng(0)
    x = _randn(rng, 4, 3, 9, HD) * rng.uniform(1e-4, 30, (4, 3, 9, 1)
                                              ).astype(np.float32)
    x[0, 0, 0] = 0.0                          # all zero: the 1e-12 floor
    x[1, 1, 1] = np.linspace(-2.0, 2.0, HD)   # absmax on both +-127
    x[2, 2, 2] = 1e-14 * np.arange(HD)        # absmax / 127 under the floor
    t, j = _float_pair(x, dt)
    q, s = quantize_kv(t)
    jq, js = jax_quantize_kv(j)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (q[0, 0, 0] == 0).all() and s[0, 0, 0].item() == np.float32(1e-12)
    assert q[1, 1, 1].min() == -127 and q[1, 1, 1].max() == 127


# ---- the int8 plain writes against the Pallas writes ---------------------------

def _updates(rng, dt, n=B):
    """Float K and V ``[n, HK, 1, HD]`` (torch) and their JAX int8 update
    tree ``{"kv": [2, n, HK, 1, HD], "scale": [2, n, HK, 1, 1]}``."""
    k, jk = _float_pair(_randn(rng, n, HK, 1, HD), dt)
    v, jv = _float_pair(_randn(rng, n, HK, 1, HD), dt)
    (kq, ks), (vq, vs) = jax_quantize_kv(jk), jax_quantize_kv(jv)
    return k, v, {"kv": jnp.stack([kq, vq]), "scale": jnp.stack([ks, vs])}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 31, 32, T - 1])
def test_int8_cache_insert_plain_matches_pallas(dt, pos):
    rng = np.random.default_rng(1)
    kv, sc, tree = _int8_tree(rng, B, HK, T, HD)
    k, _, upd = _updates(rng, dt)
    want_kv = _jax_cache_insert(tree["kv"], upd["kv"][0], jnp.int32(pos))
    want_sc = _jax_cache_insert(tree["scale"], upd["scale"][0],
                                jnp.int32(pos))
    got = CU.cache_insert(kv, k, torch.tensor(pos, dtype=torch.int32),
                          scale=sc)
    assert got is kv
    _assert_tree_equal(kv, sc, {"kv": want_kv, "scale": want_sc})


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 7, 33, T - 1])
def test_int8_kv_insert_plain_matches_pallas(dt, pos):
    rng = np.random.default_rng(2)
    kv, sc, tree = _int8_tree(rng, 2, B, HK, T, HD)
    k, v, upd = _updates(rng, dt)
    want = _jax_kv_insert(tree, upd, jnp.int32(pos))
    # the lockstep tick's form: a 0-dim view of a device arange
    CU.kv_insert(kv, k, v, torch.arange(pos, pos + 2, dtype=torch.int32)[0],
                 scale=sc)
    _assert_tree_equal(kv, sc, want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [(0, T - 1, 5), (32, 31, 63)])
def test_int8_kv_insert_rows_plain_matches_pallas(dt, pos):
    rng = np.random.default_rng(3)
    kv, sc, tree = _int8_tree(rng, 2, B, HK, T, HD)
    k, v, upd = _updates(rng, dt)
    want = _jax_kv_insert_rows(tree, upd, jnp.asarray(pos, jnp.int32))
    CU.kv_insert_rows(kv, k, v, torch.tensor(pos, dtype=torch.int32),
                      scale=sc)
    _assert_tree_equal(kv, sc, want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_int8_pool_insert_plain_matches_pallas(dt):
    """Four decode rows into distinct blocks at window-edge and interior
    offsets; the port's write takes the rows as ``[N, H, hd]`` views."""
    rng = np.random.default_rng(4)
    kv, sc, tree = _int8_tree(rng, 2, P, HK, BT, HD)
    k, v, upd = _updates(rng, dt, n=4)
    blocks, offsets = [3, 1, 6, 2], [0, 31, 17, 8]
    want = _jax_pool_insert(tree, upd, jnp.asarray(blocks, jnp.int32),
                            jnp.asarray(offsets, jnp.int32))
    CU.kv_pool_insert(kv, k[:, :, 0], v[:, :, 0],
                      torch.tensor(blocks, dtype=torch.int32),
                      torch.tensor(offsets, dtype=torch.int32), scale=sc)
    _assert_tree_equal(kv, sc, want)


def test_int8_pool_insert_drops_out_of_range_rows():
    """The admission scatter's pad rows aim at block ``P`` (and a bad
    offset past ``bt``): nothing of theirs lands, in either leaf."""
    rng = np.random.default_rng(5)
    kv, sc, _ = _int8_tree(rng, 2, P, HK, BT, HD)
    before = (kv.clone(), sc.clone())
    k = torch.from_numpy(_randn(rng, 3, HK, HD))
    CU.kv_pool_insert(kv, k, k, torch.tensor([P, -1, 2], dtype=torch.int32),
                      torch.tensor([0, 0, BT], dtype=torch.int32), scale=sc)
    assert torch.equal(kv, before[0]) and torch.equal(sc, before[1])


# ---- the int8 reads -------------------------------------------------------------

def _read_case(rng, dt, H, hk, Bd=3, Td=80, hd=16):
    q, jq = _float_pair(_randn(rng, Bd, H, 1, hd), dt)
    kv, sc, tree = _int8_tree(rng, 2, Bd, hk, Td, hd)
    mask = np.ones((Bd, Td), np.int32)
    mask[1, :45] = 0                      # a pad run longer than a chunk
    mask[2, :3] = 0
    view = {"k": tree["kv"][0], "v": tree["kv"][1],
            "k_scale": tree["scale"][0], "v_scale": tree["scale"][1]}
    return q, jq, kv, sc, view, mask


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("H,hk", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("pos", [50, (47, 79, 5)])
@pytest.mark.parametrize("masked", [False, True])
def test_int8_dense_read_matches_jax_cached_attention_q8(dt, H, hk, pos,
                                                         masked):
    rng = np.random.default_rng(6)
    q, jq, kv, sc, view, mask = _read_case(rng, dt, H, hk)
    want = jax_cached_attention_q8(
        jq, view, jnp.asarray(pos, jnp.int32),
        slot_mask=jnp.asarray(mask) if masked else None)
    tpos = torch.tensor(pos, dtype=torch.int32)
    tmask = torch.from_numpy(mask != 0) if masked else None
    want = np.asarray(want.astype(jnp.float32))
    for got in (A.cached_attention_q8(q, DA._q8_view(kv, sc), tpos,
                                      slot_mask=tmask),
                DA.dense_decode_plain(q, kv, tpos, slot_mask=tmask,
                                      kv_scale=sc),
                DA.decode_attention(q, kv, tpos, slot_mask=tmask,
                                    kv_scale=sc)):
        assert got.dtype == q.dtype
        np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dt],
                                   rtol=TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("H,hk", [(4, 4), (8, 2)])
def test_int8_paged_read_matches_jax_gathered_q8(dt, H, hk):
    """The paged plain read through block tables (one parked all-trash
    row, one row past its table's horizon: clamped) against the JAX
    gather of both leaves + ``cached_attention_q8``."""
    rng = np.random.default_rng(7)
    Bd, nb, bt = 4, 3, 8
    q, jq = _float_pair(_randn(rng, Bd, H, 1, HD), dt)
    kv, sc, tree = _int8_tree(rng, 2, 13, hk, bt, HD)
    table = np.stack([rng.permutation(12)[:nb] + 1 for _ in range(Bd)]
                     ).astype(np.int32)
    table[2] = 0                                  # parked: all trash
    pos = np.array([0, 13, 5, nb * bt + 4], np.int32)
    kvg = jax_gather_kv_blocks(tree["kv"], jnp.asarray(table))
    scg = jax_gather_kv_blocks(tree["scale"], jnp.asarray(table))
    want = jax_cached_attention_q8(
        jq, {"k": kvg[0], "v": kvg[1], "k_scale": scg[0],
             "v_scale": scg[1]}, jnp.asarray(pos))
    got = DA.paged_decode_attention(q, kv, torch.from_numpy(table),
                                    torch.from_numpy(pos), kv_scale=sc)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("pos", [60, (60, 45, 79)])
def test_int8_dense_tick_matches_jax(pos):
    """One whole dense int8 tick (write, then masked read), f32: the output
    to 1e-5 and both cache leaves exactly, against the JAX
    ``cache_write_and_attend`` on the int8 tree."""
    rng = np.random.default_rng(8)
    q, jq, kv, sc, _, mask = _read_case(rng, "f32", 4, 4)
    k, v = (_randn(rng, 3, 4, 1, 16) for _ in range(2))
    tree = {"kv": jnp.asarray(kv.numpy()), "scale": jnp.asarray(sc.numpy())}
    want, new = jax_cache_write_and_attend(
        jq, jnp.asarray(k), jnp.asarray(v), tree,
        jnp.asarray(pos, jnp.int32), slot_mask=jnp.asarray(mask))
    cache = {"kv": kv, "scale": sc}
    got, out = A.cache_write_and_attend(
        q, torch.from_numpy(k), torch.from_numpy(v), cache,
        torch.tensor(pos, dtype=torch.int32),
        slot_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL["f32"],
                               rtol=TOL["f32"])
    assert out is cache
    _assert_tree_equal(kv, sc, new)


def test_int8_paged_tick_matches_jax():
    """One whole paged int8 tick, f32, against the JAX
    ``cache_write_and_attend`` on ``{"kv", "scale", "table"}``
    (``_paged_write_and_attend``): the output and both pool leaves."""
    rng = np.random.default_rng(9)
    Bd, H = 3, 4
    kv, sc, tree = _int8_tree(rng, 2, P, H, BT, HD)
    table = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    pos = np.array([0, 40, 63], np.int32)
    q, k, v = (_randn(rng, Bd, H, 1, HD) for _ in range(3))
    want, new = jax_cache_write_and_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        {**tree, "table": jnp.asarray(table)}, jnp.asarray(pos))
    got, _ = A.cache_write_and_attend(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        {"kv": kv, "scale": sc, "table": torch.from_numpy(table)},
        torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL["f32"],
                               rtol=TOL["f32"])
    _assert_tree_equal(kv, sc, new)


def test_int8_reads_refuse_a_missing_or_misshapen_scale_plane():
    rng = np.random.default_rng(10)
    q, _, kv, sc, _, _ = _read_case(rng, "f32", 4, 4)
    with pytest.raises(ValueError, match="kv_scale"):
        DA.decode_attention(q, kv, 5)
    with pytest.raises(ValueError, match="kv_scale must be f32"):
        DA.decode_attention(q, kv, 5, kv_scale=sc[..., :2, :])
    with pytest.raises(ValueError, match="kv_scale goes with an int8"):
        DA.decode_attention(q, kv.float(), 5, kv_scale=sc)
    with pytest.raises(ValueError, match="kv_scale"):
        DA.paged_decode_attention(q, kv, torch.zeros(3, 2, dtype=torch.int32),
                                  torch.zeros(3, dtype=torch.int32))


# ---- serving and generation on GPT-2-tiny ------------------------------------

SLOTS, SEGMENT, T_MAX, PROMPT_BUF = 2, 3, 128, 10


@pytest.fixture(scope="module")
def models():
    """JAX tiny GPT-2 (positions lifted to 128 so the serve horizon fits)
    and the port's copy of its weights."""
    cfg = dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=128)
    jm = JaxGPT2(cfg)
    params, _ = jm.init(jax.random.key(0))
    tm = load_gpt2_params(
        GPT2(dataclasses.replace(GPT2Config.tiny(), max_seq_len=128),
             device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def _requests(seed, n):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(0, 256, int(rng.integers(
        1, PROMPT_BUF + 1)))], int(rng.integers(3, 10))) for _ in range(n)]


def test_int8_serve_token_identical_to_jax(models):
    """7 staggered requests through 2 slots, 32-slot blocks on both sides
    (the JAX int8 pool's own alignment) so the block tables match: the same
    greedy tokens, and after the run the same pool: int8 bytes exact,
    scales to 1e-6, outside the trash block (block 0, where parked rows
    write garbage); no block or slot leaks."""
    jm, params, tm = models
    reqs = _requests(3, 7)
    jcb = JaxBatcher(jm, params, slots=SLOTS, t_max=T_MAX,
                     prompt_buf=PROMPT_BUF, segment=SEGMENT,
                     kv_block_tokens=BT, decode_width_buckets=1,
                     kv_dtype="int8")
    want = jcb.serve([JaxRequest(list(t), n) for t, n in reqs])
    cb = ContinuousBatcher(tm, slots=SLOTS, t_max=T_MAX,
                           prompt_buf=PROMPT_BUF, segment=SEGMENT,
                           kv_block_tokens=BT, kv_dtype="int8", device="cpu")
    got = cb.serve([Request(list(t), n) for t, n in reqs])
    assert got == want
    assert cb.stats["prefill_calls"] > 1
    assert cb.last_block_leaks == 0 and cb.last_slot_leaks == 0
    for ours, ref in zip(cb._caches, jcb._caches):
        assert set(ours) == {"kv", "scale"} and ours["kv"].dtype == torch.int8
        np.testing.assert_array_equal(ours["kv"][:, 1:].numpy(),
                                      np.asarray(ref["kv"])[:, 1:])
        np.testing.assert_allclose(ours["scale"][:, 1:].numpy(),
                                   np.asarray(ref["scale"])[:, 1:],
                                   atol=1e-6, rtol=0)


def test_serve_refuses_an_unknown_kv_dtype(models):
    _, _, tm = models
    with pytest.raises(ValueError, match="kv_dtype must be 'bf16' or 'int8'"):
        ContinuousBatcher(tm, slots=1, t_max=16, prompt_buf=4,
                          kv_dtype="fp8", device="cpu")


@pytest.mark.parametrize("masked", [False, True])
def test_int8_generate_token_identical_to_jax(models, masked):
    jm, params, tm = models
    prompt = np.random.default_rng(1).integers(0, 256, (3, 7)
                                               ).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, :3] = 0
    mask[2, :6] = 0
    mask = mask if masked else None
    want = jax_infer.generate(
        jm, params, jnp.asarray(prompt), 8, kv_quant=True,
        prompt_mask=None if mask is None else jnp.asarray(mask))
    got = infer.generate(tm, prompt, 8, prompt_mask=mask, kv_quant=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_prefill_matches_jax(models):
    """The prompt's K/V quantized once into the int8 pair cache: the
    logits to 1e-5 and the int8 bytes and scales of both caches equal."""
    jm, params, tm = models
    prompt = np.random.default_rng(2).integers(0, 256, (2, 9)
                                               ).astype(np.int32)
    want_logits, want = jax_infer.prefill(jm, params, jnp.asarray(prompt),
                                          16, kv_quant=True)
    with torch.no_grad():
        logits, caches = infer.prefill(tm, torch.from_numpy(prompt).long(),
                                       16, kv_quant=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=1e-5)
    for got, ref in zip(caches, want):
        assert got["kv"].dtype == torch.int8
        np.testing.assert_array_equal(got["kv"].numpy(),
                                      np.asarray(ref["kv"]))
        np.testing.assert_allclose(got["scale"].numpy(),
                                   np.asarray(ref["scale"]), atol=1e-6,
                                   rtol=0)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A v1 checkpoint of GPT-2-tiny random weights (max_seq_len 128),
    written by the port's trainer in the JAX layout."""
    from distributed_compute_pytorch_tpu_torch.train import checkpoint as ck
    from distributed_compute_pytorch_tpu_torch.train.optim import (
        build_optimizer)
    from distributed_compute_pytorch_tpu_torch.train.step import make_step_fns
    model = GPT2(dataclasses.replace(GPT2Config.tiny(), max_seq_len=128),
                 device="cpu").init(torch.Generator().manual_seed(7))
    init_fn, _, _ = make_step_fns(model, build_optimizer("adamw", 1e-3))
    path = str(tmp_path_factory.mktemp("q8") / "ck.npz")
    ck.save(path, init_fn(None))
    return path


def test_cli_serve_kv_dtype_int8_matches_jax(checkpoint, tmp_path, capsys):
    from distributed_compute_pytorch_tpu.cli_serve import main as jax_main
    from distributed_compute_pytorch_tpu_torch.cli_serve import (
        main as port_main)
    reqfile = tmp_path / "reqs.txt"
    reqfile.write_text("5, 9, 12\n"
                       '{"tokens": [7], "max_new": 3}\n'
                       '{"tokens": [1, 2, 3, 4, 5], "id": "five"}\n')
    common = ["--ckpt_path", checkpoint, "--model", "gpt2", "--model_preset",
              "tiny", "--max_seq_len", "128", "--requests", str(reqfile),
              "--slots", "2", "--segment", "3", "--max_new_tokens", "5",
              "--kv_dtype", "int8"]
    capsys.readouterr()
    assert jax_main(common + ["--heartbeat", "0"]) == 0
    want = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert port_main(common + ["--device", "cpu"]) == 0
    got = [json.loads(ln) for ln in
           capsys.readouterr().out.strip().splitlines()]
    assert got == want
    assert [len(ln["new"]) for ln in got] == [5, 3, 5]


def test_cli_serve_refuses_a_bad_kv_dtype(capsys):
    from distributed_compute_pytorch_tpu_torch.cli_serve import main
    with pytest.raises(SystemExit):
        main(["--init_seed", "0", "--model_preset", "tiny", "--requests",
              "-", "--device", "cpu", "--kv_dtype", "fp8"])
    assert "invalid choice: 'fp8'" in capsys.readouterr().err


def test_cli_generate_int8_kv_still_refused_naming_the_kv_path():
    from distributed_compute_pytorch_tpu_torch.cli_generate import main
    with pytest.raises(SystemExit,
                       match=r"--quantize .*not ported.*1\.7\.1.*kv_quant"):
        main(["--init_seed", "0", "--model_preset", "tiny", "--prompt", "5",
              "--device", "cpu", "--quantize", "int8-kv"])
