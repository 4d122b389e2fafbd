"""The port's ConvNet and its layers against the JAX package's, on the CPU.

Inputs come from a numpy seed; weights cross with the port's converters
(``interop.convnet_params_from_jax``), never through matching init RNG.
Dropout is held to the reference by applying the same fixed numpy masks
in both packages: ``layers.dropout`` is patched in each, within the test,
to apply the mask of its call site (the 0.25 channel mask ``[B, 64]``,
the 0.5 mask ``[B, 128]``), each package in its own layout.

Tolerance: 1e-5 absolute on log-probabilities and layer outputs (f32;
XLA's and oneDNN's convolutions sum in different orders, and the port's
BatchNorm takes the variance from the sums of x and x^2 where the JAX
layer takes it in two passes); the converters are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu import interop as jax_interop
from distributed_compute_pytorch_tpu.models import layers as JL
from distributed_compute_pytorch_tpu.models.convnet import (
    ConvNet as JaxConvNet)
from distributed_compute_pytorch_tpu_torch import interop
from distributed_compute_pytorch_tpu_torch.models import layers as L
from distributed_compute_pytorch_tpu_torch.models.convnet import ConvNet

TOL = 1e-5
B = 8


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def jax_model():
    params, state = JaxConvNet().init(jax.random.key(0))
    # running stats away from their init, so eval reads real values
    rng = np.random.default_rng(5)
    state = {"batchnorm": {
        "mean": jnp.asarray(rng.normal(0, 0.2, 128), jnp.float32),
        "var": jnp.asarray(rng.uniform(0.5, 2.0, 128), jnp.float32)}}
    return params, state


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).normal(
        0, 1, (B, 28, 28, 1)).astype(np.float32)


def _port(params, state):
    model = ConvNet(device="cpu")
    model.load_state_dict(interop.convnet_params_from_jax(params, state))
    return model


def test_conv2d_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 10, 9, 3)).astype(np.float32)
    conv = JL.Conv2d(3, 5, 3, 1)
    p = conv.init(jax.random.key(1))
    want = np.asarray(conv.apply(p, jnp.asarray(x)))
    ours = L.Conv2d(3, 5, 3, 1, device="cpu")
    ours.weight.data.copy_(torch.from_numpy(
        np.asarray(p["kernel"]).transpose(3, 2, 0, 1).copy()))
    ours.bias.data.copy_(torch.from_numpy(np.array(p["bias"])))
    got = ours(_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_conv2d_init_bounds():
    conv = L.Conv2d(32, 64, 3, 1, device="cpu")
    conv.init(torch.Generator().manual_seed(0))
    bound = 1.0 / np.sqrt(32 * 9)
    for p in (conv.weight.detach(), conv.bias.detach()):
        assert float(p.abs().max()) <= bound
        assert float(p.abs().max()) > 0.9 * bound


@pytest.mark.parametrize("padding", [0, 1])
def test_max_pool_matches_jax(padding):
    x = np.random.default_rng(2).normal(0, 1, (2, 9, 8, 4)).astype(
        np.float32)
    want = np.asarray(JL.max_pool2d(jnp.asarray(x), 2, padding=padding))
    got = L.max_pool2d(_nchw(x), 2, padding=padding).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batchnorm_train_and_eval_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(1.5, 2.0, (16, 6)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    shift = rng.normal(0, 1, 6).astype(np.float32)
    mean0 = rng.normal(0, 1, 6).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    jbn = JL.BatchNorm(6)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)}
    js = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}
    bn = L.BatchNorm(6, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(shift))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    y_want, new_js = jbn.apply(jp, js, jnp.asarray(x), True)
    y, stats = bn(torch.from_numpy(x), True)
    np.testing.assert_allclose(y.detach().numpy(), y_want, atol=TOL, rtol=0)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(stats[ours].numpy(), new_js[theirs],
                                   atol=TOL, rtol=0)
    # the layer leaves its buffers to the train step
    np.testing.assert_array_equal(bn.running_mean.numpy(), mean0)
    y_want, same = jbn.apply(jp, js, jnp.asarray(x), False)
    y, stats = bn(torch.from_numpy(x), False)
    assert stats is None
    np.testing.assert_allclose(y.detach().numpy(), y_want, atol=TOL, rtol=0)


def test_channel_dropout_shape_scale_and_eval_identity():
    x = torch.ones(4, 16, 5, 5)
    gen = torch.Generator().manual_seed(0)
    y = L.dropout(x, 0.25, gen, True, broadcast_dims=(2, 3))
    per_channel = y.flatten(2)
    # one draw a (row, channel): whole maps kept (scaled 1/keep) or zeroed
    assert torch.equal(per_channel.amin(-1), per_channel.amax(-1))
    kept = float(x[0, 0, 0, 0] / 0.75)
    assert set(torch.unique(y).tolist()) <= {0.0, kept}
    assert 0 < int((per_channel[..., 0] == 0).sum()) < 64
    # the JAX layer's NHWC form draws the same [B, 1, 1, C] shape
    jy = np.asarray(JL.dropout(jnp.ones((4, 5, 5, 16)), 0.25,
                               jax.random.key(0), True,
                               broadcast_dims=(1, 2)))
    assert np.array_equal(jy.min((1, 2)), jy.max((1, 2)))
    for train, rate in ((False, 0.25), (True, 0.0)):
        assert L.dropout(x, rate, gen, train, broadcast_dims=(2, 3)) is x


def _fixed_masks(monkeypatch, c_mask, d_mask):
    """Patch both packages' ``layers.dropout`` to apply the fixed masks:
    rate 0.25 -> ``c_mask`` per (row, channel), rate 0.5 -> ``d_mask``."""
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
    monkeypatch.setattr(JL, "dropout", jax_dropout)
    monkeypatch.setattr(L, "dropout", port_dropout)


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(jax_model, images, train, monkeypatch):
    params, state = jax_model
    rng = np.random.default_rng(4)
    _fixed_masks(monkeypatch, rng.random((B, 64)) < 0.75,
                 rng.random((B, 128)) < 0.5)
    want, new_state = JaxConvNet().apply(
        params, state, jnp.asarray(images), train=train,
        rng=jax.random.key(0) if train else None)
    model = _port(params, state)
    got, stats = model(torch.from_numpy(images), train=train,
                       generator=torch.Generator() if train else None)
    assert got.shape == (B, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)
    if train:
        for ours, theirs in (("running_mean", "mean"),
                             ("running_var", "var")):
            np.testing.assert_allclose(
                stats[f"batchnorm.{ours}"].numpy(),
                np.asarray(new_state["batchnorm"][theirs]), atol=TOL, rtol=0)
    else:
        assert stats == {}


def test_eval_metrics_match_jax_classifier_sums(jax_model, images):
    params, state = jax_model
    labels = np.random.default_rng(6).integers(0, 10, B)
    valid = np.ones(B, np.float32)
    valid[-3:] = 0.0
    log_probs, _ = JaxConvNet().apply(params, state, jnp.asarray(images))
    lp = np.asarray(log_probs, np.float64)
    per_ex = -lp[np.arange(B), labels]
    hit = lp.argmax(-1) == labels
    model = _port(params, state)
    with torch.no_grad():
        out, _ = model(torch.from_numpy(images))
        y = torch.from_numpy(labels)
        full = model.eval_metrics(out, y)
        masked = model.eval_metrics(out, y, torch.from_numpy(valid))
    assert float(full["loss_sum"]) == pytest.approx(per_ex.sum(), abs=1e-4)
    assert int(full["correct"]) == hit.sum() and int(full["count"]) == B
    assert float(masked["loss_sum"]) == pytest.approx(
        (per_ex * valid).sum(), abs=1e-4)
    assert int(masked["correct"]) == (hit * valid).sum()
    assert int(masked["count"]) == B - 3


def test_converters_round_trip_and_match_jax_torch_schema(jax_model):
    params, state = jax_model
    sd = interop.convnet_params_from_jax(params, state)
    ref = jax_interop.convnet_to_torch_state_dict(params, state)
    assert set(sd) == set(ref) - {"batchnorm.num_batches_tracked"}
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    back_p, back_s = interop.convnet_params_to_jax(sd)
    for tree, orig in ((back_p, params), (back_s, state)):
        flat_b = jax.tree_util.tree_leaves_with_path(tree)
        flat_o = jax.tree_util.tree_leaves_with_path(orig)
        assert [p for p, _ in flat_b] == [p for p, _ in flat_o]
        for (path, b), (_, o) in zip(flat_b, flat_o):
            np.testing.assert_array_equal(b, np.asarray(o), err_msg=str(path))
    # and the port's state dict is the JAX reader's torch schema
    jp, js = jax_interop.convnet_from_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    for a, b in zip(jax.tree.leaves((jp, js)), jax.tree.leaves((params,
                                                                 state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("prefix", ["", "module."])
def test_reference_state_dict_loads(jax_model, images, prefix, tmp_path):
    """A reference ``mnist.pt`` (torch schema, with the BatchNorm counter;
    plain or DDP's ``module.`` keys) loads into the port's ConvNet, from a
    dict and from a file, and gives the JAX eval forward."""
    params, state = jax_model
    ref = jax_interop.convnet_to_torch_state_dict(params, state)
    sd = {prefix + k: torch.from_numpy(np.array(v)) for k, v in ref.items()}
    want, _ = JaxConvNet().apply(params, state, jnp.asarray(images))
    path = str(tmp_path / "mnist.pt")
    torch.save(sd, path)
    for load in (lambda m: interop.load_reference_state_dict(m, sd),
                 lambda m: interop.load_reference_checkpoint(m, path)):
        model = ConvNet(device="cpu")
        load(model)
        with torch.no_grad():
            got, _ = model(torch.from_numpy(images))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)
    with pytest.raises(KeyError, match="fc2.bias"):
        interop.load_reference_state_dict(
            ConvNet(device="cpu"),
            {k: v for k, v in sd.items() if not k.endswith("fc2.bias")})


def test_convnet_built_on_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ConvNet()
