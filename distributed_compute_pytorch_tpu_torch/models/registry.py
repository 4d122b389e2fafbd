"""Model registry — port of
``distributed_compute_pytorch_tpu/models/registry.py``. GPT-2 only for
now; the rest of the zoo follows in later slices."""

from __future__ import annotations

import dataclasses

import torch


def build_model(name: str, *, preset: str | None = None, device=None,
                dtype=torch.float32, **overrides):
    """Build ``name`` at ``preset`` (``None``/``"small"`` or ``"tiny"``)
    with config ``overrides`` (``vocab_size``, ``max_seq_len``, ...) on
    ``device`` (CUDA unless ``"cpu"``)."""
    if name != "gpt2":
        raise ValueError(f"unknown or not yet ported model {name!r}")
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
        GPT2, GPT2Config)
    if preset in (None, "full", "base", "small"):
        cfg = GPT2Config.small()
    elif preset == "tiny":
        cfg = GPT2Config.tiny()
    else:
        raise ValueError(f"unknown GPT2Config preset {preset!r}; expected "
                         f"'tiny' or 'small'")
    cfg = dataclasses.replace(
        cfg, **{k: v for k, v in overrides.items() if v is not None})
    return GPT2(cfg, device=device, dtype=dtype)
