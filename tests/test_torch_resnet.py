"""The port's ResNet against the JAX package's, on the CPU.

Weights come from the JAX ``init`` and move through
``interop.resnet_params_from_jax``; inputs are numpy draws from a seed.
Tolerances (f32; the two frameworks sum in different orders):

- the layers (a padded, strided, bias-free ``Conv2d``; ``BatchNorm`` over
  the channel axis of an NCHW map, train and eval, with its new running
  stats), both block kinds with and without a projection and both stems
  (``depths=(1, 1)`` models at width 8 on 8 x 8 inputs), and the named
  ``resnet18``/``resnet50`` builds: forward to 1e-5; but ResNet-50's 16
  blocks in train mode (53 BatchNorms on batch statistics) carry each
  package's f32 rounding to about 3e-4 of the logits, both packages as
  far from an f64 evaluation of the same weights: there the port must be
  no further from the f64 logits than twice the JAX package's distance
  (plus 1e-5);
- ten SGD steps (momentum, StepLR) of ResNet-18 at width 8 with
  ``flip-crop`` against the JAX ``make_step_fns``, both fed the JAX
  package's augment decisions from one key every step: losses to 1e-4,
  parameters and BatchNorm stats to 1e-4 relative (1e-5 absolute);
- two gloo ranks against one process (``tests/torch_ladder_worker.py``:
  the ``Trainer``, sync-BN over NCHW maps, the global batch's augment
  draw; one epoch of two updates), data-parallel and ``--mesh fsdp=2``:
  1e-5;
- the converters round-trip exactly, a checkpoint resumes bit for bit and
  the JAX ``restore_params`` reads it, the CLI trains ``resnet18`` on
  ``cifar10`` batches this test writes with ``flip-crop`` and ``resnet50``,
  and resumes.
"""

import copy
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.core.mesh import batch_sharding, make_mesh
from distributed_compute_pytorch_tpu.models import layers as JL
from distributed_compute_pytorch_tpu.models.resnet import ResNet as JaxResNet
from distributed_compute_pytorch_tpu.ops import augment as JA
from distributed_compute_pytorch_tpu.train import checkpoint as jax_checkpoint
from distributed_compute_pytorch_tpu.train.optim import (
    build_optimizer as jax_build_optimizer)
from distributed_compute_pytorch_tpu.train.step import (
    make_step_fns as jax_make_step_fns)
from distributed_compute_pytorch_tpu_torch import cli, interop
from distributed_compute_pytorch_tpu_torch.models import layers as L
from distributed_compute_pytorch_tpu_torch.models.registry import build_model
from distributed_compute_pytorch_tpu_torch.models.resnet import ResNet
from distributed_compute_pytorch_tpu_torch.ops import augment as A
from distributed_compute_pytorch_tpu_torch.train import checkpoint
from distributed_compute_pytorch_tpu_torch.train.optim import build_optimizer
from distributed_compute_pytorch_tpu_torch.train.step import make_step_fns

from torch_ladder_worker import run_world
from torch_threads import one_thread  # noqa: F401 (autouse)

FWD_TOL, LOSS_TOL, STEP_TOL, DDP_TOL = 1e-5, 1e-4, 1e-4, 1e-5
B, S, STEPS = 16, 8, 10
OPT = {"lr": 0.05, "gamma": 0.7, "steps_per_epoch": 3}


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return (rng.normal(0, 1, (B, S, S, 3)).astype(np.float32),
            rng.integers(0, 10, B).astype(np.int32))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def test_padded_strided_conv_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 9, 4)).astype(np.float32)
    for k, stride in ((3, 1), (3, 2), (7, 2), (1, 2)):
        pad = (k - 1) // 2
        jc = JL.Conv2d(4, 6, k, stride, padding=((pad, pad), (pad, pad)),
                       use_bias=False)
        p = jc.init(jax.random.key(k + stride))
        want = np.asarray(jc.apply(p, jnp.asarray(x)))
        conv = L.Conv2d(4, 6, k, stride, padding=pad, use_bias=False,
                        device="cpu")
        assert conv.bias is None
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(
                np.array(p["kernel"]).transpose(3, 2, 0, 1)))
        got = conv(_nchw(x)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("train", [True, False])
def test_channel_batchnorm_matches_jax(train):
    rng = np.random.default_rng(2)
    x = (3.0 + 2.0 * rng.normal(size=(4, 5, 5, 6))).astype(np.float32)
    jb = JL.BatchNorm(6)
    params = {"scale": jnp.asarray(rng.normal(size=6), jnp.float32),
              "bias": jnp.asarray(rng.normal(size=6), jnp.float32)}
    state = {"mean": jnp.asarray(rng.normal(size=6), jnp.float32),
             "var": jnp.asarray(rng.uniform(0.5, 2, 6), jnp.float32)}
    want, want_state = jb.apply(params, state, jnp.asarray(x), train)
    bn = L.BatchNorm(6, channel_axis=1, device="cpu")
    with torch.no_grad():
        for name, v in (("weight", params["scale"]), ("bias", params["bias"]),
                        ("running_mean", state["mean"]),
                        ("running_var", state["var"])):
            getattr(bn, name).copy_(torch.from_numpy(np.asarray(v)))
    got, stats = bn(_nchw(x), train)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)
    if train:
        for k, jk in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(stats[k].numpy(),
                                       np.asarray(want_state[jk]),
                                       atol=FWD_TOL, rtol=FWD_TOL)
    else:
        assert stats is None


def _pair(jax_model, port_model, key=0):
    params, state = jax_model.init(jax.random.key(key))
    port_model.load_state_dict(interop.resnet_params_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)))
    return params, state


def _check_forward(jm, pm, x, params, state, f64_train=False):
    for train in (True, False):
        want, want_state = jm.apply(params, state, jnp.asarray(x),
                                    train=train)
        got, stats = pm(torch.from_numpy(x), train=train)
        if train and f64_train:
            exact, _ = copy.deepcopy(pm).double()(
                torch.from_numpy(x).double(), train=True)
            exact = exact.detach().numpy()
            port_err = np.abs(got.detach().numpy() - exact).max()
            jax_err = np.abs(np.asarray(want) - exact).max()
            assert port_err <= 2 * jax_err + FWD_TOL, (port_err, jax_err)
        else:
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), atol=FWD_TOL,
                                       rtol=FWD_TOL)
        if train:
            _, ws = interop.resnet_params_to_jax(
                {**pm.state_dict(), **stats})
            for (path, g), (_, w) in zip(
                    jax.tree_util.tree_leaves_with_path(ws),
                    jax.tree_util.tree_leaves_with_path(want_state)):
                np.testing.assert_allclose(g, np.asarray(w), atol=FWD_TOL,
                                           rtol=FWD_TOL, err_msg=str(path))
        else:
            assert stats == {}


@pytest.mark.parametrize("bottleneck", [False, True],
                         ids=["basic", "bottleneck"])
@pytest.mark.parametrize("small_input", [True, False],
                         ids=["cifar_stem", "imagenet_stem"])
def test_blocks_and_stems_match_jax(images, bottleneck, small_input):
    """Two stages of one block each: the first keeps the stride (a
    projection only where a Bottleneck widens), the second strides 2
    with a projection."""
    kw = {"depths": (1, 1), "bottleneck": bottleneck, "width": 8,
          "small_input": small_input}
    jm = JaxResNet(**kw)
    pm = ResNet(kw.pop("depths"), kw.pop("bottleneck"), **kw, device="cpu")
    params, state = _pair(jm, pm)
    assert pm.blocks[1].has_proj and pm.blocks[0].has_proj == bottleneck
    _check_forward(jm, pm, images[0], params, state)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_named_builds_match_jax(images, name):
    jm = JaxResNet.build(name, width=8)
    pm = build_model(name, device="cpu", width=8)
    assert pm.small_input == (name == "resnet18")
    assert len(pm.blocks) == (8 if name == "resnet18" else 16)
    params, state = _pair(jm, pm, key=1)
    _check_forward(jm, pm, images[0], params, state,
                   f64_train=name == "resnet50")


def test_converters_round_trip():
    jm = JaxResNet.build("resnet50", width=8)
    params, state = jm.init(jax.random.key(2))
    params, state = (jax.tree.map(np.asarray, t) for t in (params, state))
    sd = interop.resnet_params_from_jax(params, state)
    model = ResNet.build("resnet50", width=8, device="cpu")
    assert set(sd) == set(model.state_dict())
    p2, s2 = interop.params_to_jax(sd)
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    assert jax.tree.structure(s2) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves((p2, s2)), jax.tree.leaves((params,
                                                                state))):
        np.testing.assert_array_equal(a, b)
    back = interop.params_from_jax(p2, s2)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    assert interop.model_kind(sd) == interop.model_kind(params) == "resnet"


def _decisions():
    """The JAX ``flip-crop`` decisions of one key, recomputed from its
    splits, and the augment functions of both packages that apply them."""
    key = jax.random.key(11)
    r1, r2 = jax.random.split(key)
    ky, kx = jax.random.split(r2)
    flips = np.array(jax.random.bernoulli(r1, 0.5, (B,)))
    oy = np.array(jax.random.randint(ky, (B,), 0, 9))
    ox = np.array(jax.random.randint(kx, (B,), 0, 9))
    fixed = JA.build_augment("flip-crop")

    def jax_aug(x, rng):
        del rng
        return fixed(x, key)

    def port_aug(x, generator):
        del generator
        return A.crop(A.flip(x, torch.from_numpy(flips)),
                      torch.from_numpy(oy), torch.from_numpy(ox))
    return jax_aug, port_aug


@pytest.fixture(scope="module")
def runs(images):
    """Ten SGD steps of each package on the same weights, batch and
    augment decisions."""
    x, y = images
    jm = JaxResNet.build("resnet18", width=8)
    pm = ResNet.build("resnet18", width=8, device="cpu")
    params, state = _pair(jm, pm, key=3)
    jax_aug, port_aug = _decisions()
    mesh = make_mesh("data=1", devices=jax.devices()[:1])
    tx = jax_build_optimizer("sgd", **OPT)
    init_fn, train_step, _ = jax_make_step_fns(jm, tx, mesh, donate=False,
                                               augment=jax_aug)
    js = init_fn(jax.random.key(0)).replace(
        params=params, model_state=state, opt_state=tx.init(params))
    xs = jax.device_put(jnp.asarray(x), batch_sharding(mesh, 4))
    ys = jax.device_put(jnp.asarray(y), batch_sharding(mesh, 1))
    jl = []
    for _ in range(STEPS):
        js, m = train_step(js, xs, ys)
        jl.append(float(m["loss"]))
    pinit, pstep, _ = make_step_fns(pm, build_optimizer("sgd", **OPT),
                                    augment=port_aug)
    ps = pinit(None)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    pl = [float(pstep(ps, xt, yt)[1]["loss"]) for _ in range(STEPS)]
    return (jl, jax.tree.map(np.asarray, (js.params, js.model_state)),
            pl, ps)


def test_sgd_steps_with_flip_crop_match_jax(runs):
    jl, (jp, jstate), pl, ps = runs
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL)
    assert pl[-1] < pl[0]
    gp, gs = interop.resnet_params_to_jax({**ps.params, **ps.model_state})
    for tree, want in ((gp, jp), (gs, jstate)):
        for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                     jax.tree_util.tree_leaves_with_path(want)):
            np.testing.assert_allclose(g, w, rtol=STEP_TOL, atol=1e-5,
                                       err_msg=str(path))
    assert not np.allclose(gs["stem_bn"]["var"], 1.0)


def test_augment_runs_in_train_only(images):
    """The train step augments its inputs; the eval step never does."""
    x, y = images
    seen = []

    def spy(x, generator):
        seen.append(x.shape)
        return x
    model = ResNet.build("resnet18", width=8, device="cpu")
    init_fn, train_step, eval_step = make_step_fns(
        model, build_optimizer("sgd", **OPT), augment=spy)
    state = init_fn(0)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    train_step(state, xt, yt)
    eval_step(state, xt, yt)
    assert seen == [xt.shape]


def test_checkpoint_round_trip_and_jax_reads(images, tmp_path):
    x, y = images
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    tx = build_optimizer("sgd", **OPT)
    aug = A.build_augment("flip-crop")
    model = ResNet.build("resnet18", width=8, device="cpu")
    init_fn, train_step, _ = make_step_fns(model, tx, augment=aug)
    state = init_fn(4)
    for _ in range(3):
        state, _ = train_step(state, xt, yt)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, state, epoch=1)
    other = ResNet.build("resnet18", width=8, device="cpu")
    init2, step2, _ = make_step_fns(other, tx, augment=aug)
    restored = init2(9)
    checkpoint.restore_with_fallback(path, restored)
    assert restored.step == 3
    for a, b in zip([*state.params.values(), *state.model_state.values()],
                    [*restored.params.values(),
                     *restored.model_state.values()]):
        assert torch.equal(a, b)
    _, m1 = train_step(state, xt, yt)
    _, m2 = step2(restored, xt, yt)
    assert float(m1["loss"]) == float(m2["loss"])
    jp, _ = interop.resnet_params_to_jax({**restored.params,
                                          **restored.model_state})
    got = jax_checkpoint.restore_params(path, jax.tree.map(jnp.asarray, jp))
    assert jax.tree.structure(got) == jax.tree.structure(jp)


def _write_cifar(root, n):
    rng = np.random.default_rng(3)
    d = root / "cifar-10-batches-py"
    d.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_cli_trains_and_resumes(tmp_path, capsys, name):
    """``dcp-train --device cpu`` on CIFAR-10's pickle batches (5 x 8
    train images, 8 test), ``flip-crop``, SGD, then resumed."""
    _write_cifar(tmp_path, 8)
    ck = str(tmp_path / "ck.npz")
    base = ["--device", "cpu", "--model", name, "--dataset", "cifar10",
            "--data_dir", str(tmp_path), "--augment", "flip-crop",
            "--optimizer", "sgd", "--lr", "0.05", "--batch_size", "20",
            "--log_every", "1", "--ckpt_path", ck]
    assert cli.main(base + ["--epochs", "1"]) == 0
    out = capsys.readouterr().out
    assert f"model: {name}" in out and "dataset: cifar10-train" in out
    assert re.search(r"^epoch: 0 \[1/2 \(50%\)\]\t Loss:[\d.]+$", out, re.M)
    assert re.search(r"^Test set: Average loss: [\d.]+, Accuracy: "
                     r"\d+/8 \(\d+%\)$", out, re.M)
    assert cli.main(base + ["--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "at epoch 1" in out
    assert checkpoint.load_manifest(ck)["epoch"] == 1


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("one"), "resnet", 1,
                     "data=-1")[0]


@pytest.mark.parametrize("mesh, strategy", [("data=2", "DataParallel"),
                                            ("fsdp=2", "FSDP")])
def test_two_gloo_ranks_train_as_one_process(tmp_path, one_process, mesh,
                                             strategy):
    ranks = run_world(tmp_path, "resnet", 2, mesh)
    assert len(one_process["losses"]) == 2
    for r, got in enumerate(ranks):
        assert str(got.pop("strategy")) == strategy
        for key, want in one_process.items():
            if key == "strategy":
                continue
            np.testing.assert_allclose(got[key], want, atol=DDP_TOL,
                                       rtol=DDP_TOL,
                                       err_msg=f"rank {r}: {key}")
    assert ranks[0]["eval"][2] == 40
