"""The port's train and eval steps against the JAX package's, on the CPU.

GPT-2-tiny (2 layers, d_model 64, 4 heads, vocab 256) at T = 32 on a
``synthetic_lm`` batch of 8, the JAX params converted by ``interop``, ten
steps of the JAX ``make_step_fns`` (on a ``data=1`` mesh; dense XLA
attention, what JAX runs on the CPU) and of the port's, with ``adamw``
and with ``adamw_fused``, f32.

Tolerances: losses 1e-4 relative and final parameters 1e-4 absolute (two
frameworks sum in different orders; Adam's normalised step turns those
differences of small gradients into parameter differences of up to
about lr x 1e-3). The key bias is left out of the parameter comparison:
its exact gradient is zero (a constant added to every key of a query row
leaves that row's softmax unchanged), so each framework's Adam step
normalises its own rounding noise to about lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.core.mesh import batch_sharding, make_mesh
from distributed_compute_pytorch_tpu.data.datasets import (
    synthetic_lm as jax_synthetic_lm)
from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.train.optim import (
    build_optimizer as jax_build_optimizer)
from distributed_compute_pytorch_tpu.train.step import (
    make_step_fns as jax_make_step_fns)
from distributed_compute_pytorch_tpu_torch.data.datasets import synthetic_lm
from distributed_compute_pytorch_tpu_torch.interop import (
    gpt2_params_from_jax, gpt2_params_to_jax, load_gpt2_params)
from distributed_compute_pytorch_tpu_torch.models import layers as L
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.train.optim import build_optimizer
from distributed_compute_pytorch_tpu_torch.train.step import make_step_fns

STEPS, B, T = 10, 8, 32
LOSS_TOL, PARAM_TOL = 1e-4, 1e-4
OPT = {"lr": 1e-3, "gamma": 0.7, "steps_per_epoch": STEPS,
       "warmup_steps": 2, "total_steps": STEPS}
CFG = dataclasses.replace(GPT2Config.tiny(), max_seq_len=T)


@pytest.fixture(scope="module")
def batch():
    data = synthetic_lm(B, T, 256, seed=3)
    np.testing.assert_array_equal(data.inputs,
                                  jax_synthetic_lm(B, T, 256, seed=3).inputs)
    return data.inputs


@pytest.fixture(scope="module")
def jax_params():
    cfg = dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=T)
    params, _ = JaxGPT2(cfg).init(jax.random.key(0))
    return params


def _jax_run(params, tokens, optimizer):
    cfg = dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=T)
    mesh = make_mesh("data=1", devices=jax.devices()[:1])
    tx = jax_build_optimizer(optimizer, **OPT)
    init_fn, train_step, eval_step = jax_make_step_fns(
        JaxGPT2(cfg), tx, mesh, donate=False)
    state = init_fn(jax.random.key(0))
    state = state.replace(params=params, opt_state=tx.init(params))
    x = jax.device_put(jnp.asarray(tokens), batch_sharding(mesh, 2))
    losses = []
    for _ in range(STEPS):
        state, m = train_step(state, x, x)
        losses.append(float(m["loss"]))
    ev = {k: float(v) for k, v in eval_step(state, x, x).items()}
    return losses, jax.tree.map(np.asarray, state.params), ev


def _port_model(params):
    return load_gpt2_params(GPT2(CFG, device="cpu"),
                            jax.tree.map(np.asarray, params))


def _port_run(params, tokens, optimizer, **kw):
    model = _port_model(params)
    init_fn, train_step, eval_step = make_step_fns(
        model, build_optimizer(optimizer, **OPT), **kw)
    state = init_fn(None)
    x = torch.from_numpy(tokens).long()
    losses = [float(train_step(state, x, x)[1]["loss"]) for _ in range(STEPS)]
    ev = {k: float(v) for k, v in eval_step(state, x, x).items()}
    return losses, state, ev


def test_params_to_jax_inverts_from_jax(jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    back = gpt2_params_to_jax(gpt2_params_from_jax(tree))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def _without_key_bias(name, t):
    if not name.endswith("qkv.bias"):
        return t
    d = CFG.d_model
    return torch.cat([t[:d], t[2 * d:]])


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_fused"])
def test_ten_steps_match_jax(batch, jax_params, optimizer):
    j_losses, j_params, j_eval = _jax_run(jax_params, batch, optimizer)
    losses, state, ev = _port_run(jax_params, batch, optimizer)
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)   # lr 0 at step 0
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_TOL)
    for name, want in gpt2_params_from_jax(j_params).items():
        got = state.params[name].detach()
        np.testing.assert_allclose(_without_key_bias(name, got).numpy(),
                                   _without_key_bias(name, want).numpy(),
                                   atol=PARAM_TOL, rtol=0, err_msg=name)
    assert ev["count"] == j_eval["count"] == B * (T - 1)
    assert ev["correct"] == j_eval["correct"]
    assert ev["loss_sum"] == pytest.approx(j_eval["loss_sum"], rel=LOSS_TOL)


def test_accumulation_equals_the_full_batch(batch, jax_params):
    """Two microbatches of 4 give the full batch's gradient (the mean of
    the microbatch means) and loss, as the reference's
    ``_accum_auto_step`` does."""
    x = torch.from_numpy(batch).long()
    grads, losses = [], []
    for accum in (1, 2):
        model = _port_model(jax_params)
        init_fn, train_step, _ = make_step_fns(
            model, build_optimizer("adamw_fused", **OPT), accum_steps=accum)
        state = init_fn(None)
        losses.append(float(train_step(state, x, x)[1]["loss"]))
        grads.append({n: p.grad.clone() for n, p in state.params.items()})
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        make_step_fns(_port_model(jax_params),
                      build_optimizer("adamw", **OPT),
                      accum_steps=3)[1](state, x, x)


def test_bf16_compute_keeps_f32_masters_and_grads(batch, jax_params):
    losses, state, _ = _port_run(jax_params, batch, "adamw",
                                 compute_dtype="bfloat16")
    f32, _, _ = _port_run(jax_params, batch, "adamw")
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, f32, rtol=2e-2)
    for p in state.params.values():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32


def test_dropout_is_seeded_and_off_in_eval():
    cfg = dataclasses.replace(CFG, dropout_rate=0.1)
    model = GPT2(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, T)))

    def run(seed, train=True):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return model(x, train=train, generator=gen)
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(run(1, train=False), run(None))
    ones = torch.ones(10_000)
    kept = L.dropout(ones, 0.1, torch.Generator().manual_seed(3), True)
    assert set(kept.unique().tolist()) <= {0.0, float(torch.tensor(1 / 0.9))}
    assert abs(float((kept == 0).float().mean()) - 0.1) < 0.02
    assert torch.equal(L.dropout(ones, 0.1, None, False), ones)
