"""JAX <-> PyTorch weight interop for the port.

- :func:`gpt2_params_from_jax`: the JAX package's GPT-2 params pytree (as
  numpy arrays) -> this package's ``GPT2`` state dict. Dense kernels
  ``[in, out]`` become ``nn.Linear``-style weights ``[out, in]``; the
  stacked ``[num_layers, ...]`` block leaves are unstacked into
  ``blocks.{i}.*``; LayerNorm ``scale`` becomes ``weight``.
- :func:`gpt2_params_to_jax`: the inverse, for writing checkpoints in the
  JAX layout (``train/checkpoint.py``) and for the parity tests.
- :func:`convnet_params_from_jax` / :func:`convnet_params_to_jax`: the
  JAX ConvNet's ``(params, state)`` <-> this package's ``ConvNet`` state
  dict, which is the reference trainer's ``mnist.pt`` schema: conv
  kernels HWIO <-> OIHW, dense ``[in, out]`` <-> ``[out, in]``, BatchNorm
  ``scale`` <-> ``weight`` and the running stats ``mean``/``var`` <->
  ``running_mean``/``running_var``, and fc1's input features permuted
  between the JAX NHWC ``(h, w, c)`` flatten and the NCHW ``(c, h, w)``
  one (without it the logits come out wrong with no error).
  :func:`load_reference_state_dict` loads a reference ``mnist.pt`` (plain
  or ``module.`` keys, :func:`strip_ddp_prefix`) into a ``ConvNet``.
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


def strip_ddp_prefix(state_dict) -> dict:
    """Drop the ``module.`` prefix of a DDP-wrapped save (reference
    ``interop.py:51-54``)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def _fc1_grid(features: int, image_size) -> tuple[int, int]:
    """fc1's ``(h, w)`` feature grid (64 channels each): from
    ``image_size`` (two valid 3x3 convs, then a 2x2 pool), or square."""
    if image_size is not None:
        h, w = image_size
        return (h - 4) // 2, (w - 4) // 2
    side = int(round((features // 64) ** 0.5))
    if side * side * 64 != features:
        raise ValueError(f"fc1 has {features} input features, not a square "
                         f"grid of 64 channels: pass image_size")
    return side, side


def convnet_params_from_jax(params, state, image_size=None
                            ) -> dict[str, torch.Tensor]:
    """The JAX ConvNet's ``(params, state)`` (numpy leaves) -> a
    ``ConvNet`` state dict of f32 CPU tensors (reference
    ``convnet_to_torch_state_dict``, ``:119-158``, without the
    ``num_batches_tracked`` counter the port does not keep)."""
    def conv(tree):                         # HWIO -> OIHW
        return _t(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))

    fc1 = np.asarray(params["fc1"]["kernel"], np.float32).T   # [128, hwc]
    fh, fw = _fc1_grid(fc1.shape[1], image_size)
    fc1 = (fc1.reshape(-1, fh, fw, 64).transpose(0, 3, 1, 2)
           .reshape(fc1.shape[0], -1))                         # [128, chw]
    bn = state["batchnorm"]
    return {"conv1.weight": conv(params["conv1"]),
            "conv1.bias": _t(params["conv1"]["bias"]),
            "conv2.weight": conv(params["conv2"]),
            "conv2.bias": _t(params["conv2"]["bias"]),
            "fc1.weight": _t(fc1), "fc1.bias": _t(params["fc1"]["bias"]),
            "batchnorm.weight": _t(params["batchnorm"]["scale"]),
            "batchnorm.bias": _t(params["batchnorm"]["bias"]),
            "batchnorm.running_mean": _t(bn["mean"]),
            "batchnorm.running_var": _t(bn["var"]),
            "fc2.weight": _t(np.asarray(params["fc2"]["kernel"]).T),
            "fc2.bias": _t(params["fc2"]["bias"])}


def convnet_params_to_jax(state_dict, image_size=None) -> tuple[dict, dict]:
    """A ``ConvNet`` state dict (or a reference ``mnist.pt``'s, any
    device, plain or ``module.`` keys) -> the JAX ConvNet's ``(params,
    state)`` of f32 numpy arrays (reference
    ``convnet_from_torch_state_dict``, ``:57-108``)."""
    sd = {k: np.array(_np(v)) for k, v in strip_ddp_prefix(state_dict).items()
          if not k.endswith("num_batches_tracked")}   # copies, not views

    def conv(name):                         # OIHW -> HWIO
        return {"kernel": np.ascontiguousarray(
                    sd[f"{name}.weight"].transpose(2, 3, 1, 0)),
                "bias": sd[f"{name}.bias"]}

    fc1 = sd["fc1.weight"]                                     # [128, chw]
    fh, fw = _fc1_grid(fc1.shape[1], image_size)
    fc1 = (fc1.reshape(-1, 64, fh, fw).transpose(0, 2, 3, 1)
           .reshape(fc1.shape[0], -1))                         # [128, hwc]
    params = {"conv1": conv("conv1"), "conv2": conv("conv2"),
              "fc1": {"kernel": np.ascontiguousarray(fc1.T),
                      "bias": sd["fc1.bias"]},
              "batchnorm": {"scale": sd["batchnorm.weight"],
                            "bias": sd["batchnorm.bias"]},
              "fc2": {"kernel": np.ascontiguousarray(sd["fc2.weight"].T),
                      "bias": sd["fc2.bias"]}}
    state = {"batchnorm": {"mean": sd["batchnorm.running_mean"],
                           "var": sd["batchnorm.running_var"]}}
    return params, state


def is_convnet(names) -> bool:
    """Whether a state dict's (or a JAX params tree's) keys are the
    ConvNet's."""
    return "conv1.weight" in names or "conv1" in names


def params_to_jax(state_dict, image_size=None) -> tuple[dict, dict]:
    """A port model's parameters and buffers -> the JAX package's
    ``(params, model_state)`` trees: the ConvNet's, or GPT-2's (no model
    state)."""
    if is_convnet(state_dict):
        return convnet_params_to_jax(state_dict, image_size)
    return gpt2_params_to_jax(state_dict), {}


def params_from_jax(params, model_state, image_size=None
                    ) -> dict[str, torch.Tensor]:
    """The inverse of :func:`params_to_jax`: one state dict, parameters
    and buffers."""
    if is_convnet(params):
        return convnet_params_from_jax(params, model_state, image_size)
    return gpt2_params_from_jax(params)


def load_reference_state_dict(model, state_dict):
    """Load a reference ``mnist.pt`` state dict (plain or ``module.``
    keys; tensors or arrays) into a ``ConvNet``, copying in place (the
    reference's ``num_batches_tracked`` is not kept). Raises
    ``KeyError`` naming the keys that do not match."""
    sd = {k: v.detach().cpu() if isinstance(v, torch.Tensor)
          else torch.from_numpy(np.asarray(v))
          for k, v in strip_ddp_prefix(state_dict).items()
          if not k.endswith("num_batches_tracked")}
    own = model.state_dict()
    if set(sd) != set(own):
        raise KeyError(f"state dict does not match the ConvNet: missing "
                       f"{sorted(set(own) - set(sd))}, unexpected "
                       f"{sorted(set(sd) - set(own))}")
    model.load_state_dict(sd)
    return model


def load_reference_checkpoint(model, path: str):
    """Load the reference trainer's ``mnist.pt`` (``torch.save`` of its
    model's state dict) from ``path`` into a ``ConvNet`` (the JAX
    trainer's ``--import_torch``)."""
    return load_reference_state_dict(
        model, torch.load(path, map_location="cpu", weights_only=True))


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
