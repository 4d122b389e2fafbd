"""Dataset readers — the MNIST and synthetic parts of
``distributed_compute_pytorch_tpu/data/datasets.py``, copied (jax-free;
the port imports nothing of the JAX package) so one seed gives the port
and the reference the same arrays.

MNIST is read from its idx files under ``data_dir`` when they are there
(the reference's normalisation, in numpy); otherwise a deterministic
synthetic stand-in of the same shapes is used, with the reference's
warning. Nothing is downloaded (``--download`` stays refused).
CIFAR-10, text corpora and sharded datasets come with later slices.
Images are NHWC, as in the reference.
"""

from __future__ import annotations

import gzip
import os
import struct
import warnings
from dataclasses import dataclass

import numpy as np

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081


@dataclass(frozen=True)
class ArrayDataset:
    """An in-memory dataset of (inputs, targets) host arrays."""

    inputs: np.ndarray
    targets: np.ndarray
    name: str = "dataset"
    num_classes_override: int | None = None

    def __post_init__(self):
        if len(self.inputs) != len(self.targets):
            raise ValueError("inputs and targets differ in length")

    def __len__(self) -> int:
        return len(self.inputs)

    @property
    def num_classes(self) -> int:
        if self.num_classes_override is not None:
            return self.num_classes_override
        return int(self.targets.max()) + 1


def synthetic_images(n: int, shape: tuple[int, ...], num_classes: int,
                     seed: int = 0, name: str = "synthetic") -> ArrayDataset:
    """Class-conditional gaussian blobs (reference ``:286-303``): the
    prototypes depend only on (shape, num_classes), ``seed`` picks the
    examples."""
    proto_rng = np.random.Generator(
        np.random.Philox(key=hash((num_classes, *shape)) & 0xFFFFFFFF))
    protos = proto_rng.normal(0.0, 1.0, size=(num_classes, *shape)).astype(
        np.float32)
    rng = np.random.Generator(np.random.Philox(key=seed))
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    noise = rng.normal(0.0, 1.0, size=(n, *shape)).astype(np.float32)
    images = 0.6 * protos[labels] + 0.8 * noise
    return ArrayDataset(images.astype(np.float32), labels, name=name)


def synthetic_lm(n: int, seq_len: int, vocab: int, seed: int = 0,
                 name: str = "synthetic-lm") -> ArrayDataset:
    """Token sequences from a deterministic order-1 Markov chain
    (reference ``:306-323``); inputs and targets both hold the full
    sequence, the model shifts."""
    rng = np.random.Generator(np.random.Philox(key=seed))
    trans = rng.dirichlet(np.full(vocab, 0.05), size=vocab).astype(np.float64)
    trans /= trans.sum(-1, keepdims=True)
    toks = np.empty((n, seq_len), np.int32)
    state = rng.integers(0, vocab, size=n)
    cum = np.cumsum(trans, axis=-1)
    for t in range(seq_len):
        toks[:, t] = state
        u = rng.random(n)
        state = (cum[state] < u[:, None]).sum(-1)
    return ArrayDataset(toks, toks, name=name)


def _warn_synthetic(name: str, data_dir: str) -> None:
    """A run that claims '<name>' metrics must not silently train on
    blobs (reference ``:26-34``)."""
    warnings.warn(
        f"{name}: real data not found under {data_dir!r}; substituting a "
        f"DETERMINISTIC SYNTHETIC dataset. Reported metrics are NOT {name} "
        f"metrics. Place the raw files under {data_dir!r}.",
        stacklevel=3)


def _read_idx(path: str) -> np.ndarray:
    """Decode one idx-ubyte file, optionally gzipped (reference
    ``:73-84``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    zeros, dtype_code, ndim = struct.unpack(">HBB", data[:4])
    if zeros != 0:
        raise ValueError(f"{path}: bad idx magic")
    dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
              0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
    shape = struct.unpack(f">{ndim}I", data[4:4 + 4 * ndim])
    return np.frombuffer(data, dtypes[dtype_code],
                         offset=4 + 4 * ndim).reshape(shape)


def _find_idx(data_dir: str, stem: str) -> str | None:
    """An idx file under ``data_dir`` in the common layouts (flat,
    ``MNIST/raw/``, ``raw/``, gzipped), reference ``:192-206``."""
    for c in (stem, stem + ".gz", os.path.join("MNIST", "raw", stem),
              os.path.join("MNIST", "raw", stem + ".gz"),
              os.path.join("raw", stem), os.path.join("raw", stem + ".gz")):
        p = os.path.join(data_dir, c)
        if os.path.exists(p):
            return p
    return None


def load_mnist(data_dir: str = "./data", split: str = "train"
               ) -> ArrayDataset:
    """MNIST with the reference's normalisation (reference ``:208-242``):
    images ``[N, 28, 28, 1]`` f32 as ``(x/255 - 0.1307) / 0.3081``, labels
    ``[N]`` int32. Without the idx files: :func:`synthetic_images` at
    60,000 (train, seed 0) or 10,000 (test, seed 1) images of the same
    shape, with a warning."""
    prefix = "train" if split == "train" else "t10k"
    img_path = _find_idx(data_dir, f"{prefix}-images-idx3-ubyte")
    lbl_path = _find_idx(data_dir, f"{prefix}-labels-idx1-ubyte")
    if img_path and lbl_path:
        raw = _read_idx(img_path)
        images = (raw.astype(np.float32) / 255.0 - MNIST_MEAN) / MNIST_STD
        labels = _read_idx(lbl_path).astype(np.int32)
        return ArrayDataset(images[..., None], labels, name=f"mnist-{split}")
    _warn_synthetic("mnist", data_dir)
    n = 60_000 if split == "train" else 10_000
    return synthetic_images(n, (28, 28, 1), 10,
                            seed=0 if split == "train" else 1,
                            name=f"mnist-{split}-synthetic")


def load_dataset(name: str, split: str = "train", data_dir: str = "./data",
                 **kw) -> ArrayDataset:
    """The MNIST and synthetic entries of the reference registry
    (``:399-445``), with its sizes: ``mnist`` (:func:`load_mnist`, from
    ``data_dir``); ``synthetic-images`` 4096 x 28 x 28 x 1, 10 classes;
    ``synthetic-lm`` 2048 x 128 tokens, vocab 256; the test split is seed
    1, the train split seed 0."""
    seed = 0 if split == "train" else 1
    if name == "mnist":
        return load_mnist(data_dir, split)
    if name == "synthetic-images":
        return synthetic_images(kw.pop("n", 4096), kw.pop("shape", (28, 28, 1)),
                                kw.pop("num_classes", 10), seed=seed)
    if name == "synthetic-lm":
        return synthetic_lm(kw.pop("n", 2048), kw.pop("seq_len", 128),
                            kw.pop("vocab", 256), seed=seed)
    raise ValueError(f"dataset {name!r} is not ported yet (mnist, "
                     f"synthetic-images, synthetic-lm)")
