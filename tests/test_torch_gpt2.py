"""The port's GPT-2 modules against the JAX package, on the CPU: the same
weights (converted by ``interop.gpt2_params_from_jax``) and the same
numpy inputs through both, GPT2Config.tiny() in f32. Logits agree to
1e-4 (two frameworks' matmuls sum in different orders through 2 layers
and a 256-way readout); the paged decode tick's output and pool to 1e-5.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu_torch.interop import (
    CheckpointCorruptError, gpt2_params_from_jax, load_gpt2_params,
    load_jax_checkpoint)
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config

LOGIT_TOL = 1e-4
TICK_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """A JAX tiny GPT-2 with random params and the port's copy of it."""
    jm = JaxGPT2(JaxGPT2Config.tiny())
    params, _ = jm.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    tm = load_gpt2_params(GPT2(GPT2Config.tiny(), device="cpu"), tree)
    return jm, params, tm


def test_tiny_config_matches_reference():
    ref, port = JaxGPT2Config.tiny(), GPT2Config.tiny()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert GPT2Config.small() == GPT2Config(
        vocab_size=50257, max_seq_len=1024, num_layers=12, num_heads=12,
        d_model=768, d_ff=3072)


def test_full_sequence_logits_match_jax(pair):
    jm, params, tm = pair
    tokens = np.random.default_rng(0).integers(0, 256, (3, 17)).astype(
        np.int32)
    want, _ = jm.apply(params, {}, jnp.asarray(tokens))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("layer", [0, 1])
def test_paged_decode_step_matches_jax(pair, layer):
    """One paged ``decode_step`` per layer on the same pool and table:
    ragged per-row positions, one parked all-trash row."""
    jm, params, tm = pair
    c = JaxGPT2Config.tiny()
    rng = np.random.default_rng(10 + layer)
    B, P, bt, nb = 4, 13, 8, 3
    hd = c.d_model // c.num_heads
    x = rng.standard_normal((B, 1, c.d_model)).astype(np.float32)
    pool = rng.standard_normal((2, P, c.num_heads, bt, hd)).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, P))[:nb]
                      for _ in range(B)]).astype(np.int32)
    table[1] = 0
    pos = np.array([5, 2, 17, 0], np.int32)
    p_l = jax.tree.map(lambda a: a[layer], params["blocks"])
    want, new = jm._block().decode_step(
        p_l, jnp.asarray(x), {"kv": jnp.asarray(pool),
                              "table": jnp.asarray(table)},
        jnp.asarray(pos))
    t_pool = torch.from_numpy(pool.copy())
    with torch.no_grad():
        got, _ = tm.blocks[layer].decode_step(
            torch.from_numpy(x), {"kv": t_pool,
                                  "table": torch.from_numpy(table)},
            torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TICK_TOL, rtol=TICK_TOL)
    live = [0, 2, 3]
    np.testing.assert_allclose(t_pool.numpy()[:, table[live]],
                               np.asarray(new["kv"])[:, table[live]],
                               atol=TICK_TOL, rtol=TICK_TOL)


def test_prefill_kv_capture_matches_jax(pair):
    """The admission forward's per-layer K/V capture (``kv_sink``) with a
    ragged pad mask, as ``_admit_impl`` runs it."""
    jm, params, tm = pair
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (2, 12)).astype(np.int32)
    pmask = (np.arange(12)[None] < np.array([[12], [5]])).astype(np.float32)
    x_j = jm.embed(params, jnp.asarray(tokens))
    p0 = jax.tree.map(lambda a: a[0], params["blocks"])
    sink_j: list = []
    out_j = jm._block().apply(p0, x_j, kv_mask=jnp.asarray(pmask),
                              kv_sink=sink_j)
    sink_t: list = []
    with torch.no_grad():
        x_t = tm.embed(torch.from_numpy(tokens).long())
        out_t = tm.blocks[0](x_t, kv_mask=torch.from_numpy(pmask),
                             kv_sink=sink_t)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=TICK_TOL, rtol=TICK_TOL)
    for got, want in zip(sink_t[0], sink_j[0]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TICK_TOL, rtol=TICK_TOL)


def test_converter_layout():
    """Dense kernels transpose to [out, in]; stacked block leaves
    unstack; LayerNorm scale -> weight."""
    jm = JaxGPT2(JaxGPT2Config.tiny())
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(1))[0])
    sd = gpt2_params_from_jax(tree)
    np.testing.assert_array_equal(sd["blocks.1.qkv.weight"].numpy(),
                                  tree["blocks"]["qkv"]["kernel"][1].T)
    np.testing.assert_array_equal(sd["blocks.0.ln2.weight"].numpy(),
                                  tree["blocks"]["ln2"]["scale"][0])
    assert set(sd) == set(GPT2(GPT2Config.tiny(), device="cpu").state_dict())


def test_checkpoint_reader_verifies_crc(tmp_path):
    """The v1 reader returns the params subtree and refuses a leaf whose
    bytes no longer match the manifest's CRC-32."""
    from distributed_compute_pytorch_tpu.train.checkpoint import save
    from distributed_compute_pytorch_tpu.train.step import TrainState
    jm = JaxGPT2(JaxGPT2Config.tiny())
    params, _ = jm.init(jax.random.key(2))
    path = str(tmp_path / "ck.npz")
    save(path, TrainState(step=jnp.int32(0), params=params, model_state={},
                          opt_state={}, rng=jax.random.key(0)))
    tree = load_jax_checkpoint(path)
    np.testing.assert_array_equal(tree["wte"]["embedding"],
                                  np.asarray(params["wte"]["embedding"]))
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    key = ".params::ln_f::bias"
    flat[key] = flat[key] + 1.0
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **flat)
    with pytest.raises(CheckpointCorruptError, match="ln_f::bias"):
        load_jax_checkpoint(bad)
    assert json.loads(str(flat["__manifest__"]))["format"] == 1
    assert os.path.exists(path)
