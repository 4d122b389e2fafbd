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
- :func:`resnet_params_from_jax` / :func:`resnet_params_to_jax`: the JAX
  ResNet's ``(params, state)`` <-> a ``ResNet`` state dict: conv kernels
  HWIO <-> OIHW, the head ``[in, out]`` <-> ``[out, in]``, each
  BatchNorm's ``scale``/``bias`` and ``mean``/``var`` <-> ``weight``/
  ``bias`` and ``running_mean``/``running_var``, the JAX ``block{i}`` <->
  the port's ``blocks.{i}``.
- :func:`bert_params_from_jax` / :func:`bert_params_to_jax`: BERT's
  params, its stacked blocks unstacked as GPT-2's are.
- :func:`llama_params_from_jax` / :func:`llama_params_to_jax`: Llama's
  params, the stacked blocks unstacked, kernels ``[in, out]`` <-> weights
  ``[out, in]``, RMSNorm ``scale`` <-> ``weight``.
  :func:`llama_to_hf_state_dict` / :func:`llama_from_hf_state_dict`: the
  port's Llama state dict <-> the HF ``LlamaForCausalLM`` schema (numpy
  arrays), the reference's converters (``interop.py:161-256``) over the
  port's names.
- :func:`params_to_jax` / :func:`params_from_jax` pick the converter by
  the keys (:func:`model_kind`); the checkpoints use them.
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


def _blocks_from_jax(blocks, sd: dict) -> None:
    """Stacked ``[L, ...]`` transformer block leaves -> ``blocks.{i}.*``
    entries of ``sd`` (GPT-2's and BERT's blocks alike)."""
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


def _norm_from_jax(tree) -> tuple[torch.Tensor, torch.Tensor]:
    return _t(tree["scale"]), _t(tree["bias"])


def gpt2_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX GPT-2 params (``{"wte", "wpe", "blocks", "ln_f"}``, numpy
    leaves, blocks stacked ``[L, ...]``) -> a ``GPT2`` state dict of f32
    CPU tensors."""
    sd = {"wte.weight": _t(tree["wte"]["embedding"]),
          "wpe.weight": _t(tree["wpe"]["embedding"])}
    sd["ln_f.weight"], sd["ln_f.bias"] = _norm_from_jax(tree["ln_f"])
    _blocks_from_jax(tree["blocks"], sd)
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _blocks_to_jax(sd: dict) -> dict:
    """``blocks.{i}.*`` entries of ``sd`` (numpy) re-stacked into the
    reference's ``[num_layers, ...]`` block leaves."""
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
    return blocks


def _norm_to_jax(sd: dict, name: str) -> dict:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def gpt2_params_to_jax(state_dict) -> dict:
    """A ``GPT2`` state dict (any device/dtype) -> the JAX package's GPT-2
    params tree of f32 numpy arrays: weights ``[out, in]`` back to kernels
    ``[in, out]``, ``blocks.{i}.*`` re-stacked into ``[num_layers, ...]``
    leaves, LayerNorm ``weight`` back to ``scale``."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    return {"wte": {"embedding": sd["wte.weight"]},
            "wpe": {"embedding": sd["wpe.weight"]},
            "blocks": _blocks_to_jax(sd),
            "ln_f": _norm_to_jax(sd, "ln_f")}


def bert_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX BERT params (``{"wte", "wpe", "emb_ln", "blocks", "mlm_dense",
    "mlm_ln"}``, blocks stacked ``[L, ...]``) -> a ``BertMLM`` state dict
    of f32 CPU tensors."""
    sd = {"wte.weight": _t(tree["wte"]["embedding"]),
          "wpe.weight": _t(tree["wpe"]["embedding"]),
          "mlm_dense.weight": _t(np.asarray(tree["mlm_dense"]["kernel"]).T),
          "mlm_dense.bias": _t(tree["mlm_dense"]["bias"])}
    for name in ("emb_ln", "mlm_ln"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _norm_from_jax(tree[name])
    _blocks_from_jax(tree["blocks"], sd)
    return sd


def bert_params_to_jax(state_dict) -> dict:
    """The inverse of :func:`bert_params_from_jax`: f32 numpy leaves in the
    JAX layout, blocks re-stacked."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    return {"wte": {"embedding": sd["wte.weight"]},
            "wpe": {"embedding": sd["wpe.weight"]},
            "emb_ln": _norm_to_jax(sd, "emb_ln"),
            "blocks": _blocks_to_jax(sd),
            "mlm_dense": {"kernel": np.ascontiguousarray(
                              sd["mlm_dense.weight"].T),
                          "bias": sd["mlm_dense.bias"]},
            "mlm_ln": _norm_to_jax(sd, "mlm_ln")}


# Llama's block leaves: the dense kernels (transposed) and the RMSNorm
# scales, by the JAX package's and the port's shared names
_LLAMA_DENSE = ("q", "k", "v", "o", "gate", "up", "down")
_LLAMA_NORMS = ("attn_norm", "mlp_norm")


def llama_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX Llama params (``{"wte", "blocks", "norm_f", "lm_head"}``, numpy
    leaves, blocks stacked ``[L, ...]``) -> a ``LlamaLM`` state dict of f32
    CPU tensors."""
    sd = {"wte.weight": _t(tree["wte"]["embedding"]),
          "norm_f.weight": _t(tree["norm_f"]["scale"]),
          "lm_head.weight": _t(np.asarray(tree["lm_head"]["kernel"]).T)}
    blocks = tree["blocks"]
    for i in range(np.asarray(blocks["q"]["kernel"]).shape[0]):
        for name in _LLAMA_NORMS:
            sd[f"blocks.{i}.{name}.weight"] = _t(
                np.asarray(blocks[name]["scale"])[i])
        for name in _LLAMA_DENSE:
            sd[f"blocks.{i}.{name}.weight"] = _t(
                np.asarray(blocks[name]["kernel"])[i].T)
    return sd


def llama_params_to_jax(state_dict) -> dict:
    """The inverse of :func:`llama_params_from_jax`: f32 numpy leaves in the
    JAX layout, blocks re-stacked."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("blocks."))

    def stack(name, fn=lambda a: a):
        return np.stack([fn(sd[f"blocks.{i}.{name}.weight"])
                         for i in range(n_layers)])
    blocks = {name: {"scale": stack(name)} for name in _LLAMA_NORMS}
    blocks.update({name: {"kernel": stack(
        name, lambda a: np.ascontiguousarray(a.T))} for name in _LLAMA_DENSE})
    return {"wte": {"embedding": sd["wte.weight"]}, "blocks": blocks,
            "norm_f": {"scale": sd["norm_f.weight"]},
            "lm_head": {"kernel": np.ascontiguousarray(
                sd["lm_head.weight"].T)}}


# the port's Llama block leaves <-> HF LlamaForCausalLM's (the reference's
# ``_LLAMA_BLOCK_MAP``, ``interop.py:163-174``); both store [out, in]
_LLAMA_HF = (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
             ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
             ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
             ("down", "mlp.down_proj"), ("attn_norm", "input_layernorm"),
             ("mlp_norm", "post_attention_layernorm"))


def llama_to_hf_state_dict(state_dict) -> dict[str, np.ndarray]:
    """A ``LlamaLM`` state dict (any device/dtype) -> HF
    ``LlamaForCausalLM`` state-dict arrays (f32 numpy; reference
    ``llama_to_hf_state_dict``). Wrap them in ``torch.from_numpy`` and
    ``load_state_dict(..., strict=False)``: HF registers rotary
    ``inv_freq`` buffers that carry no learned state."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("blocks."))
    out = {"model.embed_tokens.weight": sd["wte.weight"],
           "model.norm.weight": sd["norm_f.weight"],
           "lm_head.weight": sd["lm_head.weight"]}
    for i in range(n_layers):
        for ours, hf in _LLAMA_HF:
            out[f"model.layers.{i}.{hf}.weight"] = \
                sd[f"blocks.{i}.{ours}.weight"]
    return out


def llama_from_hf_state_dict(state_dict, config) -> dict[str, torch.Tensor]:
    """HF ``LlamaForCausalLM`` state-dict values (torch tensors or numpy
    arrays) -> a ``LlamaLM`` state dict of f32 CPU tensors for ``config``
    (a ``models.llama.LlamaConfig`` of the checkpoint's geometry;
    reference ``llama_from_hf_state_dict``). A checkpoint without
    ``lm_head.weight`` (tied embeddings) gets the embedding as its head;
    a missing key raises ``KeyError``, layers beyond
    ``config.num_layers`` raise ``ValueError``."""
    sd = {k: v.detach().to("cpu", torch.float32).numpy()
          if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)
          for k, v in state_dict.items()}
    missing = [k for k in ("model.embed_tokens.weight", "model.norm.weight")
               if k not in sd]
    if missing:
        raise KeyError(f"state_dict missing Llama keys {missing}")
    extra = f"model.layers.{config.num_layers}."
    if any(k.startswith(extra) for k in sd):
        raise ValueError(f"state_dict has layers beyond config.num_layers="
                         f"{config.num_layers} (found {extra}* keys) — the "
                         f"config does not match the checkpoint")
    out = {"wte.weight": _t(sd["model.embed_tokens.weight"]),
           "norm_f.weight": _t(sd["model.norm.weight"]),
           "lm_head.weight": _t(sd.get("lm_head.weight",
                                       sd["model.embed_tokens.weight"]))}
    for i in range(config.num_layers):
        for ours, hf in _LLAMA_HF:
            key = f"model.layers.{i}.{hf}.weight"
            if key not in sd:
                raise KeyError(f"state_dict missing {key!r}")
            out[f"blocks.{i}.{ours}.weight"] = _t(sd[key])
    return out


def _resnet_names(sd_or_tree) -> list[tuple[str, str]]:
    """``(port prefix, JAX key path)`` of every convolution and BatchNorm
    of a ResNet, from a port state dict's or a JAX params tree's keys:
    ``stem``, ``blocks.{i}.conv{j}`` <-> ``block{i}/conv{j}`` and the
    BatchNorms and projections alike."""
    if "stem.weight" in sd_or_tree:
        blocks = sorted({int(k.split(".")[1]) for k in sd_or_tree
                         if k.startswith("blocks.")})
        inner = {i: sorted({k.split(".")[2] for k in sd_or_tree
                            if k.startswith(f"blocks.{i}.")})
                 for i in blocks}
    else:
        blocks = sorted(int(k[len("block"):]) for k in sd_or_tree
                        if k.startswith("block"))
        inner = {i: sorted(sd_or_tree[f"block{i}"]) for i in blocks}
    names = [("stem", "stem"), ("stem_bn", "stem_bn")]
    for i in blocks:
        names += [(f"blocks.{i}.{m}", f"block{i}/{m}") for m in inner[i]]
    return names


def _get(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def resnet_params_from_jax(params, state) -> dict[str, torch.Tensor]:
    """The JAX ResNet's ``(params, state)`` (numpy leaves) -> a ``ResNet``
    state dict of f32 CPU tensors: conv kernels HWIO -> OIHW, the head's
    ``[in, out]`` -> ``[out, in]``, BatchNorm ``scale``/``bias`` ->
    ``weight``/``bias`` and its state ``mean``/``var`` ->
    ``running_mean``/``running_var``."""
    sd = {"head.weight": _t(np.asarray(params["head"]["kernel"]).T),
          "head.bias": _t(params["head"]["bias"])}
    for port, path in _resnet_names(params):
        p = _get(params, path)
        if "kernel" in p:
            sd[f"{port}.weight"] = _t(np.asarray(p["kernel"]).transpose(
                3, 2, 0, 1))
            continue
        sd[f"{port}.weight"], sd[f"{port}.bias"] = _norm_from_jax(p)
        st = _get(state, path)
        sd[f"{port}.running_mean"] = _t(st["mean"])
        sd[f"{port}.running_var"] = _t(st["var"])
    return sd


def resnet_params_to_jax(state_dict) -> tuple[dict, dict]:
    """A ``ResNet`` state dict (any device/dtype) -> the JAX ResNet's
    ``(params, state)`` of f32 numpy arrays."""
    sd = {k: np.array(_np(v)) for k, v in state_dict.items()}
    params = {"head": {"kernel": np.ascontiguousarray(sd["head.weight"].T),
                       "bias": sd["head.bias"]}}
    state: dict = {}
    for port, path in _resnet_names(sd):
        *parents, leaf = path.split("/")
        p, st = params, state
        for part in parents:
            p, st = p.setdefault(part, {}), st.setdefault(part, {})
        if f"{port}.running_mean" not in sd:
            p[leaf] = {"kernel": np.ascontiguousarray(
                sd[f"{port}.weight"].transpose(2, 3, 1, 0))}
            continue
        p[leaf] = _norm_to_jax(sd, port)
        st[leaf] = {"mean": sd[f"{port}.running_mean"],
                    "var": sd[f"{port}.running_var"]}
    return params, state


def load_gpt2_params(model, tree):
    """Copy converted JAX GPT-2 params into ``model`` (any device/dtype)
    (:func:`load_lm_params`'s checks)."""
    return _load_checked(model, gpt2_params_from_jax(tree))


def load_lm_params(model, tree):
    """Copy a JAX causal LM's params, GPT-2's or Llama's (told apart by
    their keys, :func:`model_kind`), into ``model`` (any device/dtype).
    Raises ``ValueError`` when the keys do not match the model or naming
    the first leaf whose shape differs — the model configuration does not
    match the one that was saved."""
    return _load_checked(model, params_from_jax(tree, {}))


def _load_checked(model, sd):
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


def model_kind(names) -> str:
    """``convnet``, ``resnet``, ``bert``, ``llama`` or ``gpt2``: the model
    whose parameters a state dict's (or a JAX params tree's) keys name."""
    if is_convnet(names):
        return "convnet"
    if "stem.weight" in names or "stem" in names:
        return "resnet"
    if "mlm_ln.weight" in names or "mlm_ln" in names:
        return "bert"
    if "lm_head.weight" in names or "lm_head" in names:
        return "llama"
    return "gpt2"


def params_to_jax(state_dict, image_size=None) -> tuple[dict, dict]:
    """A port model's parameters and buffers -> the JAX package's
    ``(params, model_state)`` trees: the ConvNet's, a ResNet's, BERT's,
    Llama's or GPT-2's (the transformers have no model state)."""
    kind = model_kind(state_dict)
    if kind == "convnet":
        return convnet_params_to_jax(state_dict, image_size)
    if kind == "resnet":
        return resnet_params_to_jax(state_dict)
    if kind == "bert":
        return bert_params_to_jax(state_dict), {}
    if kind == "llama":
        return llama_params_to_jax(state_dict), {}
    return gpt2_params_to_jax(state_dict), {}


def params_from_jax(params, model_state, image_size=None
                    ) -> dict[str, torch.Tensor]:
    """The inverse of :func:`params_to_jax`: one state dict, parameters
    and buffers."""
    kind = model_kind(params)
    if kind == "convnet":
        return convnet_params_from_jax(params, model_state, image_size)
    if kind == "resnet":
        return resnet_params_from_jax(params, model_state)
    if kind == "bert":
        return bert_params_from_jax(params)
    if kind == "llama":
        return llama_params_from_jax(params)
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
