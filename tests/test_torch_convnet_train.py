"""The port's ConvNet train step against the JAX package's, on the CPU.

The JAX ConvNet's weights (``init`` from key 0) converted by
``interop.convnet_params_from_jax``, a batch of 16 28 x 28 images from a
numpy seed, and ten steps of the JAX ``make_step_fns`` (a ``data=1``
mesh) and of the port's, with ``adadelta`` (lr 1.0, torch's default) and
with ``sgd`` (momentum 0.9), StepLR gamma 0.7 over 3 steps an epoch, so
the rate drops three times inside the ten steps. Dropout applies the same
fixed numpy masks in both packages (``layers.dropout`` patched in each,
as in ``test_torch_convnet.py``).

Tolerances: losses 1e-4 relative; parameters and eval sums 1e-5
absolute, BatchNorm running stats 1e-5 absolute and relative (f32; the
two frameworks sum in different orders, and after ten SGD steps the
running variance reaches about 14, where 1e-5 is ten f32 ulps). Also: a
skipped step under ``nonfinite_policy="skip"`` keeps every state
tensor's bits, checkpoints round-trip (and read both ways with the JAX
package), and the CLI trains the reference's workload.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.core.mesh import batch_sharding, make_mesh
from distributed_compute_pytorch_tpu.models import layers as JL
from distributed_compute_pytorch_tpu.models.convnet import (
    ConvNet as JaxConvNet)
from distributed_compute_pytorch_tpu.train import checkpoint as jax_checkpoint
from distributed_compute_pytorch_tpu.train.optim import (
    build_optimizer as jax_build_optimizer)
from distributed_compute_pytorch_tpu.train.step import (
    TrainState as JaxTrainState, make_step_fns as jax_make_step_fns)
from distributed_compute_pytorch_tpu_torch import cli, interop
from distributed_compute_pytorch_tpu_torch.core.config import Config
from distributed_compute_pytorch_tpu_torch.models import layers as L
from distributed_compute_pytorch_tpu_torch.models.convnet import ConvNet
from distributed_compute_pytorch_tpu_torch.train import checkpoint
from distributed_compute_pytorch_tpu_torch.train.optim import build_optimizer
from distributed_compute_pytorch_tpu_torch.train.step import make_step_fns

STEPS, B = 10, 16
LOSS_TOL, TOL = 1e-4, 1e-5
OPT = {"adadelta": {"lr": 1.0, "gamma": 0.7, "steps_per_epoch": 3},
       "sgd": {"lr": 0.05, "gamma": 0.7, "steps_per_epoch": 3}}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (B, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, B).astype(np.int32)
    masks = (rng.random((B, 64)) < 0.75, rng.random((B, 128)) < 0.5)
    params, mstate = JaxConvNet().init(jax.random.key(0))
    return x, y, masks, params, mstate


def _patch(mp, masks):
    """Both packages' dropout applies ``masks`` (as test_torch_convnet)."""
    c_mask, d_mask = masks

    def jax_dropout(x, rate, rng, train, broadcast_dims=()):
        if not train:
            return x
        m = c_mask[:, None, None, :] if rate == 0.25 else d_mask
        return jnp.where(m, x / (1 - rate), 0.0).astype(x.dtype)

    def port_dropout(x, rate, generator, train, broadcast_dims=()):
        if not train:
            return x
        m = torch.from_numpy(c_mask[:, :, None, None] if rate == 0.25
                             else d_mask)
        return torch.where(m, x / (1 - rate), 0.0).to(x.dtype)
    mp.setattr(JL, "dropout", jax_dropout)
    mp.setattr(L, "dropout", port_dropout)


def _jax_run(optimizer, data):
    x, y, _, params, mstate = data
    mesh = make_mesh("data=1", devices=jax.devices()[:1])
    tx = jax_build_optimizer(optimizer, **OPT[optimizer])
    init_fn, train_step, eval_step = jax_make_step_fns(
        JaxConvNet(), tx, mesh, donate=False)
    state = init_fn(jax.random.key(0)).replace(
        params=params, model_state=mstate, opt_state=tx.init(params))
    xs = jax.device_put(jnp.asarray(x), batch_sharding(mesh, 4))
    ys = jax.device_put(jnp.asarray(y), batch_sharding(mesh, 1))
    losses = []
    for _ in range(STEPS):
        state, m = train_step(state, xs, ys)
        losses.append(float(m["loss"]))
    ev = {k: float(v) for k, v in eval_step(state, xs, ys).items()}
    return (losses, jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.model_state), ev)


def _port_model(data):
    _, _, _, params, mstate = data
    model = ConvNet(device="cpu")
    model.load_state_dict(interop.convnet_params_from_jax(params, mstate))
    return model


@pytest.fixture(scope="module", params=["adadelta", "sgd"])
def runs(request, data):
    """Ten steps of each package on the same weights, batch and masks."""
    optimizer = request.param
    x, y, masks, _, _ = data
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, masks)
        want = _jax_run(optimizer, data)
        model = _port_model(data)
        init_fn, train_step, eval_step = make_step_fns(
            model, build_optimizer(optimizer, **OPT[optimizer]))
        state = init_fn(None)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
        losses = [float(train_step(state, xt, yt)[1]["loss"])
                  for _ in range(STEPS)]
        ev = {k: float(v) for k, v in eval_step(state, xt, yt).items()}
    return want, (losses, state, ev)


def test_losses_match_jax(runs):
    (want, _, _, _), (got, state, _) = runs
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
    assert got[-1] < got[0]
    assert int(state.opt_state.count) == STEPS


def test_params_and_batchnorm_stats_match_jax(runs):
    (_, want_p, want_s, _), (_, state, _) = runs
    got_p, got_s = interop.convnet_params_to_jax(
        {**state.params, **state.model_state})
    leaves = jax.tree_util.tree_leaves_with_path
    for tree, want, rtol in ((got_p, want_p, 0), (got_s, want_s, TOL)):
        for (path, g), (_, w) in zip(leaves(tree), leaves(want)):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=rtol,
                                       err_msg=str(path))
    # the running stats moved off their init
    assert not np.allclose(got_s["batchnorm"]["var"], 1.0)


def test_eval_sums_match_jax(runs):
    (_, _, _, want), (_, _, got) = runs
    assert got["count"] == want["count"] == B
    assert got["correct"] == want["correct"]
    assert got["loss_sum"] == pytest.approx(want["loss_sum"], abs=TOL * B)


def _bits(state) -> list:
    opt = state.opt_state
    return ([p.detach().clone() for p in state.params.values()]
            + [t.clone() for kind in opt.moments().values()
               for t in kind.values()]
            + [opt.count.clone()]
            + [t.clone() for t in state.model_state.values()])


@pytest.mark.parametrize("optimizer", ["adadelta", "sgd"])
def test_skipped_step_keeps_every_state_bit(optimizer, data):
    x, y, _, _, _ = data
    model = _port_model(data)
    init_fn, train_step, _ = make_step_fns(
        model, build_optimizer(optimizer, **OPT[optimizer]),
        nonfinite_policy="skip")
    state = init_fn(None)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    for _ in range(2):
        state, m = train_step(state, xt, yt)
        assert float(m["skipped"]) == 0.0
    before = _bits(state)
    poisoned = xt.clone()
    poisoned[3, 5, 5, 0] = float("nan")
    state, m = train_step(state, poisoned, yt)
    assert float(m["skipped"]) == 1.0 and state.step == 3
    after = _bits(state)
    assert len(before) == len(after) == 10 + 10 * len(
        state.opt_state.moments()) + 1 + 2
    for a, b in zip(before, after):
        assert torch.equal(a.view(-1).view(torch.uint8),
                           b.view(-1).view(torch.uint8))
    state, m = train_step(state, xt, yt)
    assert float(m["skipped"]) == 0.0
    assert int(state.opt_state.count) == 3
    assert not torch.equal(state.model_state["batchnorm.running_mean"],
                           before[-2])


def test_step_runs_cudnn_in_f32_and_restores_the_flags(data, monkeypatch):
    """The step, not its caller, decides cuDNN's precision: a train
    step's forward and an eval step's run with TF32 off and the
    deterministic algorithms on, and the caller's flags come back after
    each."""
    x, y, _, _, _ = data
    cudnn = torch.backends.cudnn
    seen = []
    log_softmax = L.log_softmax

    def spying(v, dim=-1):
        seen.append((cudnn.allow_tf32, cudnn.deterministic))
        return log_softmax(v, dim)
    monkeypatch.setattr(L, "log_softmax", spying)
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(cudnn, "deterministic", False)
    init_fn, train_step, eval_step = make_step_fns(
        _port_model(data), build_optimizer("adadelta", **OPT["adadelta"]))
    state = init_fn(None)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    train_step(state, xt, yt)
    eval_step(state, xt, yt)
    assert seen == [(False, True)] * 2
    assert (cudnn.allow_tf32, cudnn.deterministic) == (True, False)


def test_checkpoint_round_trip_and_jax_reads(data, tmp_path):
    """The port resumes its own ConvNet checkpoint bit for bit (params,
    Adadelta slots, count, BatchNorm stats) and trains on identically;
    the JAX ``restore_params`` reads the port's params, and the port's
    ``load_jax_checkpoint`` reads a JAX ConvNet checkpoint."""
    x, y, _, params, mstate = data
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    tx = build_optimizer("adadelta", **OPT["adadelta"])
    model = _port_model(data)
    init_fn, train_step, _ = make_step_fns(model, tx)
    state = init_fn(None)
    for _ in range(3):
        state, _ = train_step(state, xt, yt)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, state, epoch=1)
    jp, _ = interop.convnet_params_to_jax({**state.params,
                                           **state.model_state})
    other = ConvNet(device="cpu")
    init2, step2, _ = make_step_fns(other, tx)
    restored = init2(7)
    checkpoint.restore_with_fallback(path, restored)
    assert restored.step == 3
    for a, b in zip(_bits(state), _bits(restored)):
        assert torch.equal(a, b)
    _, m1 = train_step(state, xt, yt)
    _, m2 = step2(restored, xt, yt)
    assert float(m1["loss"]) == float(m2["loss"])

    got = jax_checkpoint.restore_params(path, jax.tree.map(jnp.asarray, jp))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), b)

    jpath = str(tmp_path / "jax.npz")
    jax_checkpoint.save(jpath, JaxTrainState(
        step=jnp.int32(0), params=params, model_state=mstate, opt_state={},
        rng=jax.random.key(0)))
    tree = interop.load_jax_checkpoint(jpath)
    mtree = interop.unflatten(interop.read_checkpoint(jpath)[0],
                              ".model_state")
    sd = interop.convnet_params_from_jax(tree, mtree)
    want = interop.convnet_params_from_jax(params, mstate)
    assert set(sd) == set(want)
    for k in sd:
        assert torch.equal(sd[k], want[k]), k


def test_config_defaults_are_the_reference_workload():
    cfg = Config.from_argv([])
    assert (cfg.model, cfg.dataset, cfg.optimizer, cfg.gamma, cfg.lr) == (
        "convnet", "mnist", "adadelta", 0.7, 1e-3)


def test_cli_trains_and_resumes_the_convnet(data, tmp_path, capsys):
    """``dcp-train --device cpu`` with the reference's defaults (convnet,
    adadelta) on ``synthetic-images``, starting from a reference
    ``mnist.pt`` (``--import_torch``), then resumed for a second epoch."""
    _, _, _, params, mstate = data
    ref = str(tmp_path / "mnist.pt")
    sd = interop.convnet_params_from_jax(params, mstate)
    torch.save({"module." + k: v for k, v in sd.items()}, ref)
    ck = str(tmp_path / "ck.npz")
    base = ["--device", "cpu", "--dataset", "synthetic-images",
            "--batch_size", "1024", "--lr", "1.0", "--log_every", "2",
            "--ckpt_path", ck]
    assert cli.main(base + ["--epochs", "1", "--import_torch", ref]) == 0
    out = capsys.readouterr().out
    assert f"imported torch checkpoint {ref}" in out
    assert "model: convnet" in out and "optimizer: adadelta" in out
    assert re.search(r"^epoch: 0 \[2/4 \(50%\)\]\t Loss:[\d.]+$", out, re.M)
    assert re.search(r"^Test set: Average loss: [\d.]+, Accuracy: "
                     r"\d+/4096 \(\d+%\)$", out, re.M)
    assert cli.main(base + ["--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "at epoch 1" in out
    assert "epoch: 1 [0/4" in out and "epoch: 0 [" not in out
    assert checkpoint.load_manifest(ck)["epoch"] == 1
