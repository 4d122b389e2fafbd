"""The port's device-side augmentation and CIFAR-10 reader against the JAX
package's, on the CPU.

- ``flip`` / ``crop`` (the pure halves of ``ops/augment.py``) on the
  decisions the JAX ``random_flip`` / ``random_crop`` / ``flip-crop`` draw
  from a key (recomputed from the same key splits) give the JAX outputs
  exactly: both only move pixels.
- The draws are held to invariants, not to ``jax.random``'s bits: one seed
  gives one draw, the offsets lie in ``[0, 2 * pad]`` and cover it, the
  flip rate is 0.5 within a 5-sigma binomial margin, and the ranks of a
  world of 2 together draw what one process draws for the global batch.
- ``load_cifar10`` on a few python-pickle batches this test writes gives
  the JAX loader's arrays exactly on its numpy path (the one the port
  copies), and within 1e-6 of its host C++ path (``native``, a
  multiply-add by the reciprocal, which the JAX loader takes where a
  compiler is present: 3.6e-7 apart at most, one or two f32 ulps of
  values near 2); without them, the JAX loader's synthetic stand-in,
  with the warning.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu import native
from distributed_compute_pytorch_tpu.data import datasets as jax_datasets
from distributed_compute_pytorch_tpu.ops import augment as JA
from distributed_compute_pytorch_tpu_torch.core import mesh
from distributed_compute_pytorch_tpu_torch.data import datasets
from distributed_compute_pytorch_tpu_torch.ops import augment as A

B, H, W, C = 16, 8, 12, 3


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).normal(size=(B, H, W, C)).astype(
        np.float32)


def _jax_offsets(key, pad):
    ky, kx = jax.random.split(key)
    return (np.array(jax.random.randint(ky, (B,), 0, 2 * pad + 1)),
            np.array(jax.random.randint(kx, (B,), 0, 2 * pad + 1)))


def test_flip_on_jax_decisions_is_exact(images):
    key = jax.random.key(3)
    want = np.asarray(JA.random_flip(jnp.asarray(images), key))
    flips = np.asarray(jax.random.bernoulli(key, 0.5, (B,)))
    assert 0 < flips.sum() < B
    got = A.flip(torch.from_numpy(images), torch.from_numpy(flips.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pad", [1, 4])
def test_crop_on_jax_decisions_is_exact(images, pad):
    key = jax.random.key(5)
    want = np.asarray(JA.random_crop(jnp.asarray(images), key, pad))
    oy, ox = _jax_offsets(key, pad)
    got = A.crop(torch.from_numpy(images), torch.from_numpy(oy),
                 torch.from_numpy(ox), pad)
    np.testing.assert_array_equal(got.numpy(), want)


def test_flip_crop_on_jax_decisions_is_exact(images):
    key = jax.random.key(7)
    want = np.asarray(JA.build_augment("flip-crop")(jnp.asarray(images),
                                                    key))
    r1, r2 = jax.random.split(key)
    flips = np.array(jax.random.bernoulli(r1, 0.5, (B,)))
    oy, ox = _jax_offsets(r2, 4)
    got = A.crop(A.flip(torch.from_numpy(images), torch.from_numpy(flips)),
                 torch.from_numpy(oy), torch.from_numpy(ox), 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_build_augment_specs(images):
    assert A.build_augment("none") is None and A.build_augment(None) is None
    with pytest.raises(ValueError, match="unknown augment spec"):
        A.build_augment("rotate")
    x = torch.from_numpy(images)
    for spec in ("flip", "flip-crop"):
        fn = A.build_augment(spec)
        a = fn(x, torch.Generator().manual_seed(1))
        b = fn(x, torch.Generator().manual_seed(1))
        c = fn(x, torch.Generator().manual_seed(2))
        assert a.shape == x.shape and a.dtype == x.dtype
        assert torch.equal(a, b) and not torch.equal(a, c)


def test_draw_invariants():
    n, pad = 4096, 4
    g = torch.Generator().manual_seed(0)
    flips = A.draw_flips(n, g, "cpu")
    oy, ox = A.draw_offsets(n, g, "cpu", pad)
    # a binomial(n, 1/2) count within 5 sigma
    assert abs(int(flips.sum()) - n / 2) < 5 * (n / 4) ** 0.5
    for o in (oy, ox):
        assert o.dtype == torch.int64
        assert set(o.unique().tolist()) == set(range(2 * pad + 1))
    assert not torch.equal(oy, ox)
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(A.draw_flips(n, g2, "cpu"), flips)
    assert all(torch.equal(a, b) for a, b in
               zip(A.draw_offsets(n, g2, "cpu", pad), (oy, ox)))


def test_ranks_draw_the_global_batch(monkeypatch):
    """Each rank of a world of 2 draws the global batch and keeps its own
    rows: together they draw what one process draws."""
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return A.draw_flips(8, g, "cpu"), *A.draw_offsets(8, g, "cpu")
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    ranks = []
    for r in range(2):
        monkeypatch.setattr(mesh, "process_index", lambda r=r: r)
        ranks.append(draw(9))
    monkeypatch.setattr(mesh, "process_count", lambda: 1)
    monkeypatch.setattr(mesh, "process_index", lambda: 0)
    g = torch.Generator().manual_seed(9)
    whole = (A.draw_flips(16, g, "cpu"), *A.draw_offsets(16, g, "cpu"))
    for i in range(3):
        assert torch.equal(torch.cat([ranks[0][i], ranks[1][i]]), whole[i])


def _write_cifar(root, n_per_batch=6):
    rng = np.random.default_rng(1)
    d = root / "cifar-10-batches-py"
    d.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (n_per_batch, 3072),
                                       dtype=np.uint8),
                 b"labels": rng.integers(0, 10, n_per_batch).tolist()}
        with open(d / name, "wb") as f:
            pickle.dump(batch, f)
    return root


@pytest.mark.parametrize("split", ["train", "test"])
def test_load_cifar10_matches_the_jax_loader(tmp_path, split, monkeypatch):
    root = str(_write_cifar(tmp_path))
    got = datasets.load_cifar10(root, split)
    fused = jax_datasets.load_cifar10(root, split)
    monkeypatch.setattr(native, "chw_to_hwc_normalize", lambda *a: None)
    want = jax_datasets.load_cifar10(root, split)
    assert got.inputs.shape == (30 if split == "train" else 6, 32, 32, 3)
    assert got.inputs.dtype == np.float32 and got.targets.dtype == np.int32
    np.testing.assert_array_equal(got.inputs, want.inputs)
    np.testing.assert_allclose(got.inputs, fused.inputs, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.targets, want.targets)
    assert got.name == want.name == f"cifar10-{split}"
    reg = datasets.load_dataset("cifar10", split, data_dir=root)
    np.testing.assert_array_equal(reg.inputs, got.inputs)


def test_load_cifar10_falls_back_to_the_synthetic_stand_in(tmp_path):
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        got = datasets.load_cifar10(str(tmp_path), "test")
    with pytest.warns(UserWarning):
        want = jax_datasets.load_cifar10(str(tmp_path), "test")
    assert got.inputs.shape == (10_000, 32, 32, 3)
    np.testing.assert_array_equal(got.inputs, want.inputs)
    np.testing.assert_array_equal(got.targets, want.targets)
    assert got.name == "cifar10-test-synthetic"
    np.testing.assert_array_equal(datasets.CIFAR_MEAN,
                                  jax_datasets.CIFAR_MEAN)
    np.testing.assert_array_equal(datasets.CIFAR_STD, jax_datasets.CIFAR_STD)
