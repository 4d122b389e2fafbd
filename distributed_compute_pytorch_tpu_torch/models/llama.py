"""Llama — port of ``distributed_compute_pytorch_tpu/models/llama.py``.

The post-GPT-2 decoder recipe: pre-RMSNorm blocks with no biases anywhere,
rotary position embeddings in the blocks instead of a position table
(``ops/rotary.py``, half-split), a SwiGLU MLP ``down(silu(gate(h)) *
up(h))``, grouped-query attention (``num_kv_heads`` K/V heads shared by
``num_heads // num_kv_heads`` query heads each) and an untied ``lm_head``.
No dropout. Sizes default to the reference's ``LlamaConfig`` (12 layers,
d_model 768, 12 query heads over 4 kv heads of 64, d_ff 2048, vocab
32000, 2048 positions: 124.7 M parameters); ``tiny()`` is the test size.

The model follows the port's decoder protocol, so ``serve.py``,
``infer.py``, ``train/step.py`` and ``parallel/api.py::fsdp_units`` take
it as they take GPT-2: a ``blocks`` ``nn.ModuleList`` (the reference
stacks them into ``[num_layers, ...]`` leaves; ``interop.py`` unstacks),
``embed`` (token lookup only: RoPE lives in the blocks), ``readout`` (the
final RMSNorm and the head), ``kv_cache_spec``, ``forward`` and the loss
protocol. Each block's ``forward`` ropes its window at ``positions``
(default ``arange(T)``) and hands its post-rope K/V, at kv-head width, to
``kv_sink``, which is what the decode caches store; ``decode_step`` ropes
the query and the new key at the cache slot ``pos`` and writes and
attends through ``ops/attention.py::cache_write_and_attend`` (the fused
decode kernels on CUDA, at ``G = num_heads // num_kv_heads`` query heads
a kv head). Whole windows repeat K/V to the query heads inside
``ops/attention.py::attention`` (the flash kernels, forward and
backward).

Not ported: the reference's speculative ``verify_step`` (ROADMAP queue
3.6), the prefix cache's ``kv_prefix`` (queue 3.3), and the pipeline,
ring-attention, tensor-parallel and remat paths (queue 1, item 2).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from distributed_compute_pytorch_tpu_torch.device import resolve_device
from distributed_compute_pytorch_tpu_torch.models import layers as L
from distributed_compute_pytorch_tpu_torch.ops import attention as A
from distributed_compute_pytorch_tpu_torch.ops.rotary import (
    rope_cos_sin, rotate)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 2048
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 4          # GQA: K/V heads shared by query groups
    d_model: int = 768
    d_ff: int = 2048               # SwiGLU hidden width
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads={self.num_heads} must be a multiple "
                             f"of num_kv_heads={self.num_kv_heads}")
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model={self.d_model} must be a multiple of "
                             f"num_heads={self.num_heads}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """The reference's test size (``:70-76``): GQA 4:2, SwiGLU, RoPE."""
        return cls(vocab_size=256, max_seq_len=64, num_layers=2,
                   num_heads=4, num_kv_heads=2, d_model=64, d_ff=128)


class LlamaBlock(nn.Module):
    """Pre-RMSNorm grouped-query attention + SwiGLU MLP, bias-free."""

    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        c = self.config = config
        kw = {"device": device, "dtype": dtype}
        d, hd = c.d_model, c.head_dim
        self.attn_norm = L.RMSNorm(d, eps=c.rms_eps, **kw)
        self.q = L.Dense(d, c.num_heads * hd, use_bias=False, **kw)
        self.k = L.Dense(d, c.num_kv_heads * hd, use_bias=False, **kw)
        self.v = L.Dense(d, c.num_kv_heads * hd, use_bias=False, **kw)
        self.o = L.Dense(c.num_heads * hd, d, use_bias=False, **kw)
        self.mlp_norm = L.RMSNorm(d, eps=c.rms_eps, **kw)
        self.gate = L.Dense(d, c.d_ff, use_bias=False, **kw)
        self.up = L.Dense(d, c.d_ff, use_bias=False, **kw)
        self.down = L.Dense(c.d_ff, d, use_bias=False, **kw)

    def init(self, generator):
        for layer in (self.attn_norm, self.q, self.k, self.v, self.o,
                      self.mlp_norm, self.gate, self.up, self.down):
            layer.init(generator)

    def qkv(self, h, positions):
        """Projected and roped ``q [b, H, t, hd]`` and ``k``, ``v`` at
        kv-head width ``[b, Hk, t, hd]`` (reference ``_qkv``,
        ``:111-133``): q and k roped at ``positions`` (``[t]``, or ``[b,
        t]`` per row), from one pair of tables."""
        c = self.config
        q = A.split_heads(self.q(h), c.num_heads)
        k = A.split_heads(self.k(h), c.num_kv_heads)
        v = A.split_heads(self.v(h), c.num_kv_heads)
        cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
        return rotate(q, cos, sin), rotate(k, cos, sin), v

    def mlp(self, x):
        """The SwiGLU residual (reference ``_mlp``, ``:135-148``): ``x +
        down(silu(gate(h)) * up(h))`` with ``h = mlp_norm(x)``."""
        h = self.mlp_norm(x)
        return x + self.down(F.silu(self.gate(h)) * self.up(h))

    def forward(self, x, *, train: bool = False, generator=None,
                kv_mask=None, kv_sink: list | None = None, positions=None):
        """The reference's ``apply`` (``:161-204``) over a whole ``[b, t,
        d]`` window: ``x + o(attn(attn_norm(x)))``, causal, with the
        optional ``[b, t]`` key validity ``kv_mask``, then the MLP.
        ``positions`` (``[t]`` or ``[b, t]`` integer tensors on ``x``'s
        device) default to ``arange(t)``. ``kv_sink`` receives this
        window's post-rope ``(k, v)`` at kv-head width, what the decode
        caches store. ``train`` and ``generator`` are taken for the
        protocol and unused: no dropout."""
        del train, generator
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q, k, v = self.qkv(self.attn_norm(x), positions)
        if kv_sink is not None:
            kv_sink.append((k, v))
        o = A.attention(q, k, v, causal=True, kv_mask=kv_mask)
        return self.mlp(x + self.o(A.merge_heads(o)))

    def decode_step(self, x, cache, pos, slot_mask=None):
        """One decode tick (reference ``:206-237``): ``x [B, 1, d]`` at
        cache slot ``pos`` (a scalar, every row at one slot, or int32
        ``[B]``, each row at its own). The query and the new key rope at
        the slot (per row under a ``[B]`` pos); the cache keeps keys roped
        at their slots, so under left padding the slot differences RoPE
        sees are the logical ones. The K/V write and the read, at kv-head
        width, are ``cache_write_and_attend``'s (in place on the cache)."""
        pos_t = torch.as_tensor(pos, device=x.device)
        rope_pos = pos_t[:, None] if pos_t.ndim == 1 else pos_t.reshape(1)
        q, k, v = self.qkv(self.attn_norm(x), rope_pos)
        o, cache = A.cache_write_and_attend(q, k, v, cache, pos,
                                            slot_mask=slot_mask)
        return self.mlp(x + self.o(A.merge_heads(o))), cache


class LlamaLM(nn.Module):
    """Decoder-only causal LM. Built on CUDA unless ``device="cpu"``
    (``RuntimeError`` when CUDA is absent and the CPU was not asked for);
    parameters start at zero (the norms at one) until :meth:`init` or a
    weight load."""

    def __init__(self, config: LlamaConfig = LlamaConfig(), *, device=None,
                 dtype=torch.float32):
        super().__init__()
        c = self.config = config
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.wte = L.Embedding(c.vocab_size, c.d_model, **kw)
        self.blocks = nn.ModuleList(LlamaBlock(c, **kw)
                                    for _ in range(c.num_layers))
        self.norm_f = L.RMSNorm(c.d_model, eps=c.rms_eps, **kw)
        self.lm_head = L.Dense(c.d_model, c.vocab_size, use_bias=False, **kw)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.wte.weight.dtype

    def init(self, generator: torch.Generator) -> "LlamaLM":
        """Random weights from ``generator`` (a CPU ``torch.Generator``)
        with the reference's distributions; returns ``self``."""
        self.wte.init(generator)
        for block in self.blocks:
            block.init(generator)
        self.norm_f.init(generator)
        self.lm_head.init(generator)
        return self

    def embed(self, tokens, positions=None):
        """Token embeddings. ``positions`` is taken for the decoder
        protocol and unused: RoPE lives in the blocks."""
        del positions
        return self.wte(tokens)

    def readout(self, x):
        """Final RMSNorm + the untied head: ``[.., d] -> [.., vocab]``."""
        return self.lm_head(self.norm_f(x))

    def kv_cache_spec(self) -> tuple[int, int]:
        """(num_kv_heads, head_dim) a decode cache must hold per layer."""
        return self.config.num_kv_heads, self.config.head_dim

    def forward(self, tokens, *, train: bool = False, generator=None,
                kv_mask=None):
        """``tokens [B, T]`` -> logits ``[B, T, vocab]``. ``kv_mask``:
        optional ``[B, T]`` key validity (nonzero = attend), what a padded
        batch's blocks take. ``train`` and ``generator`` are taken for the
        protocol and unused: Llama has no dropout (the train step draws
        nothing for it)."""
        del train, generator
        x = self.embed(tokens)
        for block in self.blocks:
            x = block(x, kv_mask=kv_mask)
        return self.readout(x)

    # --- loss protocol (next-token prediction: shift inside) ---

    def loss_fn(self, logits, tokens):
        """Mean next-token cross-entropy (reference ``:284-286``)."""
        return L.cross_entropy_with_logits(logits[:, :-1], tokens[:, 1:],
                                           "mean")

    def loss_sum(self, logits, tokens):
        return L.cross_entropy_with_logits(logits[:, :-1], tokens[:, 1:],
                                           "sum")

    def eval_metrics(self, logits, tokens, valid=None):
        """Token-level eval sums (reference ``:292-296``), as GPT-2's."""
        pred = logits[:, :-1].argmax(-1)
        tgt = tokens[:, 1:]
        per_tok = L.cross_entropy_with_logits(logits[:, :-1], tgt, "none")
        return L.token_eval_metrics(per_tok, pred == tgt, valid)
