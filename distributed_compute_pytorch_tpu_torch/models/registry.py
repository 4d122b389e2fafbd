"""Model registry — port of
``distributed_compute_pytorch_tpu/models/registry.py``: the ConvNet,
ResNet-18/50, BERT, GPT-2 and Llama; MoE follows in a later slice
(ROADMAP queue 1, item 8)."""

from __future__ import annotations

import dataclasses

import torch


def _config(cfg_cls, default, preset, overrides):
    """A transformer config from its preset (reference
    ``_transformer_config``, ``:13-24``: ``None``/``"full"``/``"base"``/
    ``"small"`` the default size, ``"tiny"`` the test size) and the
    overrides that are not ``None``."""
    if preset in (None, "full", "base", "small"):
        cfg = default
    elif preset == "tiny":
        cfg = cfg_cls.tiny()
    else:
        raise ValueError(f"unknown {cfg_cls.__name__} preset {preset!r}; "
                         f"expected 'tiny' or None")
    return dataclasses.replace(
        cfg, **{k: v for k, v in overrides.items() if v is not None})


def build_model(name: str, *, preset: str | None = None, device=None,
                dtype=torch.float32, **overrides):
    """Build ``name`` on ``device`` (CUDA unless ``"cpu"``). ``convnet``
    takes ``num_classes``, ``in_channels`` and ``image_size``;
    ``resnet18``/``resnet50`` ``num_classes``, ``in_channels``,
    ``small_input`` and ``width`` (the trainer sizes the classes and
    channels from the dataset); ``gpt2``, ``llama`` and ``bert`` a
    ``preset`` and config ``overrides`` (``vocab_size``, ``max_seq_len``,
    ...). ``moe`` raises, naming its ROADMAP item."""
    if name in ("convnet", "resnet18", "resnet50") and preset is not None:
        raise ValueError(f"the {name} has no presets")
    if name == "convnet":
        from distributed_compute_pytorch_tpu_torch.models.convnet import (
            ConvNet)
        return ConvNet(**overrides, device=device, dtype=dtype)
    if name in ("resnet18", "resnet50"):
        from distributed_compute_pytorch_tpu_torch.models.resnet import ResNet
        return ResNet.build(name, **overrides, device=device, dtype=dtype)
    if name == "bert":
        from distributed_compute_pytorch_tpu_torch.models.bert import (
            BertConfig, BertMLM)
        return BertMLM(_config(BertConfig, BertConfig(), preset, overrides),
                       device=device, dtype=dtype)
    if name == "llama":
        from distributed_compute_pytorch_tpu_torch.models.llama import (
            LlamaConfig, LlamaLM)
        return LlamaLM(_config(LlamaConfig, LlamaConfig(), preset, overrides),
                       device=device, dtype=dtype)
    if name == "moe":
        raise ValueError("model 'moe' is not ported yet (ROADMAP.md queue 1, "
                         "item 8: models/moe.py)")
    if name != "gpt2":
        raise ValueError(f"unknown model {name!r}")
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
        GPT2, GPT2Config)
    return GPT2(_config(GPT2Config, GPT2Config.small(), preset, overrides),
                device=device, dtype=dtype)
