"""JAX <-> PyTorch weight interop for the port.

- :func:`gpt2_params_from_jax`: the JAX package's GPT-2 params pytree (as
  numpy arrays) -> this package's ``GPT2`` state dict. Dense kernels
  ``[in, out]`` become ``nn.Linear``-style weights ``[out, in]``; the
  stacked ``[num_layers, ...]`` block leaves are unstacked into
  ``blocks.{i}.*``; LayerNorm ``scale`` becomes ``weight``.
- :func:`gpt2_params_to_jax`: the inverse, for writing checkpoints in the
  JAX layout (``train/checkpoint.py``) and for the parity tests.
- :func:`read_checkpoint`: a numpy + zlib reader for the v1 ``.npz``
  checkpoint the JAX trainer and the port's ``train/checkpoint.py`` write:
  leaves flattened with ``"::"``-joined keys, the params under
  ``.params::``, and a ``__manifest__`` JSON holding a CRC-32 per leaf.
  Every leaf it returns is verified against its CRC; a mismatch raises
  :class:`CheckpointCorruptError`. :func:`load_jax_checkpoint` returns the
  params subtree of such a file.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib

import numpy as np
import torch

_SEP = "::"
_PARAMS = ".params"
_DENSE = ("qkv", "attn_out", "mlp_in", "mlp_out")
_NORMS = ("ln1", "ln2")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint leaf failed its CRC-32 integrity check."""


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))   # a writable copy


def gpt2_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX GPT-2 params (``{"wte", "wpe", "blocks", "ln_f"}``, numpy
    leaves, blocks stacked ``[L, ...]``) -> a ``GPT2`` state dict of f32
    CPU tensors."""
    sd = {"wte.weight": _t(tree["wte"]["embedding"]),
          "wpe.weight": _t(tree["wpe"]["embedding"]),
          "ln_f.weight": _t(tree["ln_f"]["scale"]),
          "ln_f.bias": _t(tree["ln_f"]["bias"])}
    blocks = tree["blocks"]
    n_layers = np.asarray(blocks["qkv"]["kernel"]).shape[0]
    for i in range(n_layers):
        pre = f"blocks.{i}."
        for name in _NORMS:
            sd[pre + name + ".weight"] = _t(np.asarray(blocks[name]["scale"])[i])
            sd[pre + name + ".bias"] = _t(np.asarray(blocks[name]["bias"])[i])
        for name in _DENSE:
            sd[pre + name + ".weight"] = _t(
                np.asarray(blocks[name]["kernel"])[i].T)
            sd[pre + name + ".bias"] = _t(np.asarray(blocks[name]["bias"])[i])
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def gpt2_params_to_jax(state_dict) -> dict:
    """A ``GPT2`` state dict (any device/dtype) -> the JAX package's GPT-2
    params tree of f32 numpy arrays: weights ``[out, in]`` back to kernels
    ``[in, out]``, ``blocks.{i}.*`` re-stacked into ``[num_layers, ...]``
    leaves, LayerNorm ``weight`` back to ``scale``."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("blocks."))

    def stack(name, fn=lambda a: a):
        return np.stack([fn(sd[f"blocks.{i}.{name}"])
                         for i in range(n_layers)])

    blocks = {}
    for name in _NORMS:
        blocks[name] = {"scale": stack(name + ".weight"),
                        "bias": stack(name + ".bias")}
    for name in _DENSE:
        blocks[name] = {"kernel": stack(name + ".weight",
                                        lambda a: np.ascontiguousarray(a.T)),
                        "bias": stack(name + ".bias")}
    return {"wte": {"embedding": sd["wte.weight"]},
            "wpe": {"embedding": sd["wpe.weight"]},
            "blocks": blocks,
            "ln_f": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]}}


def load_gpt2_params(model, tree):
    """Copy converted JAX params into ``model`` (any device/dtype). Raises
    ``ValueError`` naming the first leaf whose shape differs — the model
    configuration does not match the one that was saved."""
    sd = gpt2_params_from_jax(tree)
    own = model.state_dict()
    if set(sd) != set(own):
        raise ValueError(f"JAX params do not match the model: missing "
                         f"{sorted(set(own) - set(sd))[:4]}, unexpected "
                         f"{sorted(set(sd) - set(own))[:4]}")
    for key, val in sd.items():
        if tuple(val.shape) != tuple(own[key].shape):
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(val.shape)} but "
                f"the model wants {tuple(own[key].shape)} — model "
                f"configuration changed since the save")
    model.load_state_dict(sd)
    return model


def read_checkpoint(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Every leaf of the v1 file at ``path`` (``"::"``-joined keys), each
    verified against the manifest's CRC-32, and the manifest. Raises
    :class:`CheckpointCorruptError` on a mismatch, a leaf without a CRC or
    an unreadable file, ``ValueError`` on a sharded (v2) directory or
    another format."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a sharded (v2) checkpoint directory; "
                         f"only the v1 single-file format is read here")
    try:
        z = np.load(path, allow_pickle=False)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise CheckpointCorruptError(
            f"{path}: unreadable checkpoint file ({e})") from e
    with z:
        try:
            manifest = json.loads(str(z["__manifest__"]))
        except (KeyError, ValueError, zipfile.BadZipFile) as e:
            raise CheckpointCorruptError(
                f"{path}: unreadable manifest ({e})") from e
        if manifest.get("format") != 1:
            raise ValueError(f"{path}: checkpoint format "
                             f"{manifest.get('format')!r}, expected 1")
        sums = manifest.get("checksums", {})
        flat = {}
        for key in z.files:
            if key == "__manifest__":
                continue
            try:
                arr = z[key]
            except (OSError, ValueError, zipfile.BadZipFile) as e:
                raise CheckpointCorruptError(
                    f"{path}: leaf {key!r} unreadable ({e})") from e
            if key not in sums:
                raise CheckpointCorruptError(
                    f"{path}: leaf {key!r} has no CRC-32 in the manifest")
            if _crc(arr) != sums[key]:
                raise CheckpointCorruptError(
                    f"{path}: leaf {key!r} failed its CRC-32 integrity "
                    f"check (corrupted checkpoint)")
            flat[key] = arr
    return flat, manifest


def unflatten(flat: dict, prefix: str) -> dict:
    """The subtree of ``flat`` under ``prefix`` (e.g. ``".params"``) as
    nested dicts."""
    tree: dict = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + _SEP):
            continue
        node = tree
        *parents, leaf = key[len(prefix) + len(_SEP):].split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def load_jax_checkpoint(path: str) -> dict:
    """The params subtree of a JAX v1 checkpoint file as nested dicts of
    numpy arrays, every leaf verified against the manifest's CRC-32."""
    tree = unflatten(read_checkpoint(path)[0], _PARAMS)
    if not tree:
        raise ValueError(f"{path}: no '.params' leaves in the checkpoint")
    return tree
