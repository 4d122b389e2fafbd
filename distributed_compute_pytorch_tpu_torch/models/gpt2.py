"""GPT-2 — port of ``distributed_compute_pytorch_tpu/models/gpt2.py``.

Learned token + position embeddings, pre-LN causal blocks with fused QKV,
a final LayerNorm and the weight-tied readout through the token table.
Sizes default to GPT-2-small (12 layers, 12 heads of 64, d_model 768,
d_ff 3072, vocab 50257, 1024 positions); ``tiny()`` is the test size.

The blocks are an ``nn.ModuleList`` (the reference stacks them into
``[num_layers, ...]`` leaves for ``lax.scan``; ``interop.py`` unstacks).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from distributed_compute_pytorch_tpu_torch.device import resolve_device
from distributed_compute_pytorch_tpu_torch.models import layers as L
from distributed_compute_pytorch_tpu_torch.models.transformer import (
    TransformerBlock)


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072

    @classmethod
    def small(cls) -> "GPT2Config":
        return cls()

    @classmethod
    def tiny(cls) -> "GPT2Config":
        """The reference's test size (``gpt2.py:67-72``)."""
        return cls(vocab_size=256, max_seq_len=64, num_layers=2,
                   num_heads=4, d_model=64, d_ff=128)


class GPT2(nn.Module):
    """Decoder-only causal LM. Built on CUDA unless ``device="cpu"``
    (``RuntimeError`` when CUDA is absent and the CPU was not asked for);
    parameters start at zero until :meth:`init` or a weight load."""

    def __init__(self, config: GPT2Config = GPT2Config(), *, device=None,
                 dtype=torch.float32):
        super().__init__()
        c = self.config = config
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.wte = L.Embedding(c.vocab_size, c.d_model, **kw)
        self.wpe = L.Embedding(c.max_seq_len, c.d_model, init_std=0.01, **kw)
        self.blocks = nn.ModuleList(
            TransformerBlock(c.d_model, c.num_heads, c.d_ff, causal=True,
                             **kw)
            for _ in range(c.num_layers))
        self.ln_f = L.LayerNorm(c.d_model, **kw)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.wte.weight.dtype

    def init(self, generator: torch.Generator) -> "GPT2":
        """Random weights from ``generator`` (a CPU ``torch.Generator``)
        with the reference's distributions; returns ``self``."""
        self.wte.init(generator)
        self.wpe.init(generator)
        for block in self.blocks:
            block.init(generator)
        self.ln_f.init(generator)
        return self

    def embed(self, tokens, positions=None):
        """Token + learned-position embeddings; ``positions`` defaults to
        ``arange(T)``. Positions clamp to the table, as the reference's
        gather does: a parked serving row's counter runs past it, and its
        output is discarded."""
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        positions = positions.clamp(max=self.config.max_seq_len - 1)
        return self.wte(tokens) + self.wpe(positions)

    def readout(self, x):
        """Final LayerNorm + weight-tied readout."""
        return self.wte.attend(self.ln_f(x))

    def kv_cache_spec(self) -> tuple[int, int]:
        """(num_kv_heads, head_dim) a decode cache must hold per layer."""
        c = self.config
        return c.num_heads, c.d_model // c.num_heads

    def forward(self, tokens):
        """``tokens [B, T]`` -> logits ``[B, T, vocab]``."""
        x = self.embed(tokens)
        for block in self.blocks:
            x = block(x)
        return self.readout(x)
