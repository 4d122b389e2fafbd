"""JAX -> PyTorch weight interop for the port.

- :func:`gpt2_params_from_jax`: the JAX package's GPT-2 params pytree (as
  numpy arrays) -> this package's ``GPT2`` state dict. Dense kernels
  ``[in, out]`` become ``nn.Linear``-style weights ``[out, in]``; the
  stacked ``[num_layers, ...]`` block leaves are unstacked into
  ``blocks.{i}.*``; LayerNorm ``scale`` becomes ``weight``.
- :func:`load_jax_checkpoint`: a numpy + zlib reader for the v1 ``.npz``
  checkpoint the JAX trainer writes (``train/checkpoint.py``): leaves
  flattened with ``"::"``-joined keys, the params under ``.params::``, and
  a ``__manifest__`` JSON holding a CRC-32 per leaf. Every leaf it returns
  is verified against its CRC; a mismatch raises
  :class:`CheckpointCorruptError`.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np
import torch

_SEP = "::"
_PARAMS = ".params" + _SEP
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


def load_jax_checkpoint(path: str) -> dict:
    """The params subtree of a JAX v1 checkpoint file as nested dicts of
    numpy arrays, each leaf verified against the manifest's CRC-32."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a sharded (v2) checkpoint directory; "
                         f"only the v1 single-file format is read here")
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        if manifest.get("format") != 1:
            raise ValueError(f"{path}: checkpoint format "
                             f"{manifest.get('format')!r}, expected 1")
        checksums = manifest.get("checksums", {})
        tree: dict = {}
        for key in z.files:
            if not key.startswith(_PARAMS):
                continue
            arr = z[key]
            if key not in checksums:
                raise CheckpointCorruptError(
                    f"{path}: leaf {key!r} has no CRC-32 in the manifest")
            if _crc(arr) != checksums[key]:
                raise CheckpointCorruptError(
                    f"{path}: leaf {key!r} failed its CRC-32 integrity "
                    f"check (corrupted checkpoint)")
            node = tree
            *parents, leaf = key[len(_PARAMS):].split(_SEP)
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    if not tree:
        raise ValueError(f"{path}: no '.params' leaves in the checkpoint")
    return tree
