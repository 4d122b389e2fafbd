"""GPT-2 — port of ``distributed_compute_pytorch_tpu/models/gpt2.py``.

Learned token + position embeddings, pre-LN causal blocks with fused QKV,
a final LayerNorm and the weight-tied readout through the token table.
Sizes default to GPT-2-small (12 layers, 12 heads of 64, d_model 768,
d_ff 3072, vocab 50257, 1024 positions, dropout 0.1); ``tiny()`` is the
test size (no dropout). Training uses ``forward(train=True, generator=)``
and the loss protocol (``loss_fn``, ``loss_sum``, ``eval_metrics``).

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
    dropout_rate: float = 0.1

    @classmethod
    def small(cls) -> "GPT2Config":
        return cls()

    @classmethod
    def tiny(cls) -> "GPT2Config":
        """The reference's test size (``gpt2.py:67-72``)."""
        return cls(vocab_size=256, max_seq_len=64, num_layers=2,
                   num_heads=4, d_model=64, d_ff=128, dropout_rate=0.0)


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
            TransformerBlock(c.d_model, c.num_heads, c.d_ff,
                             dropout_rate=c.dropout_rate, causal=True, **kw)
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
        """Token + learned-position embeddings; ``positions`` (``[T]``, or
        per-row ``[B, T]``: left-padded prompts) defaults to ``arange(T)``.
        Positions clamp to the table, as the reference's
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

    def forward(self, tokens, *, train: bool = False, generator=None):
        """``tokens [B, T]`` -> logits ``[B, T, vocab]``. ``train`` with a
        ``generator`` (a ``torch.Generator`` on the model's device) applies
        dropout to the embeddings and inside every block (reference
        ``apply``, ``:134-154``); eval mode, or no generator, drops
        nothing."""
        x = self.embed(tokens)
        train = train and generator is not None
        x = L.dropout(x, self.config.dropout_rate, generator, train)
        for block in self.blocks:
            x = block(x, train=train, generator=generator)
        return self.readout(x)

    # --- loss protocol (next-token prediction: shift inside) ---

    def loss_fn(self, logits, tokens):
        """Mean next-token cross-entropy (reference ``:158-160``)."""
        return L.cross_entropy_with_logits(logits[:, :-1], tokens[:, 1:],
                                           "mean")

    def loss_sum(self, logits, tokens):
        return L.cross_entropy_with_logits(logits[:, :-1], tokens[:, 1:],
                                           "sum")

    def eval_metrics(self, logits, tokens, valid=None):
        """Token-level eval sums (reference ``:166-174``): ``loss_sum``,
        ``correct`` and ``count`` over the shifted targets, rows weighted
        by ``valid`` (float ``[B]``)."""
        pred = logits[:, :-1].argmax(-1)
        tgt = tokens[:, 1:]
        per_tok = L.cross_entropy_with_logits(logits[:, :-1], tgt, "none")
        return L.token_eval_metrics(per_tok, pred == tgt, valid)
