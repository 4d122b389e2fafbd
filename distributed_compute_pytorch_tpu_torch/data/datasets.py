"""Dataset readers — the synthetic part of
``distributed_compute_pytorch_tpu/data/datasets.py``, copied (jax-free;
the port imports nothing of the JAX package) so one seed gives the port
and the reference the same arrays.

Only the deterministic synthetic datasets are ported: nothing here reads
or downloads real data. MNIST, CIFAR-10, text corpora and sharded
datasets come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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


def load_dataset(name: str, split: str = "train", **kw) -> ArrayDataset:
    """The synthetic entries of the reference registry (``:399-445``),
    with its sizes: ``synthetic-images`` 4096 x 28 x 28 x 1, 10 classes;
    ``synthetic-lm`` 2048 x 128 tokens, vocab 256; the test split is seed
    1, the train split seed 0."""
    seed = 0 if split == "train" else 1
    if name == "synthetic-images":
        return synthetic_images(kw.pop("n", 4096), kw.pop("shape", (28, 28, 1)),
                                kw.pop("num_classes", 10), seed=seed)
    if name == "synthetic-lm":
        return synthetic_lm(kw.pop("n", 2048), kw.pop("seq_len", 128),
                            kw.pop("vocab", 256), seed=seed)
    raise ValueError(f"dataset {name!r} is not ported yet (synthetic-lm, "
                     f"synthetic-images)")
