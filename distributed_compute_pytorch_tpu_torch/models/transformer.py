"""Transformer block — port of
``distributed_compute_pytorch_tpu/models/transformer.py``: the pre-LN
causal block of GPT-2 and the post-LN bidirectional block of BERT.

Fused QKV projection, multi-head attention through the dispatcher
(``ops/attention.py::attention``: the flash kernels on CUDA, forward and
backward), tanh-GELU MLP. Two entry points, as in the reference:
``forward`` (the reference's ``apply``, pre-LN branch) for a whole window
— a training step (``train=True``: dropout after ``attn_out`` and after
``mlp_out``, as the reference places it; never on the attention
probabilities) or the admission prefill, which captures each layer's K/V
through ``kv_sink`` — and ``decode_step`` for one decode tick against the
paged pool (serving) or the dense pair cache (generation); a
non-causal or post-LN block has no decode.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from distributed_compute_pytorch_tpu_torch.models import layers as L
from distributed_compute_pytorch_tpu_torch.ops import attention as A


def _qkv_heads(block, h, num_heads: int):
    qkv = block.qkv(h)
    q, k, v = qkv.split(h.shape[-1], dim=-1)
    return (A.split_heads(q, num_heads), A.split_heads(k, num_heads),
            A.split_heads(v, num_heads))


def attention_sublayer(block, x, *, num_heads: int, causal: bool = False,
                       dropout_rate: float = 0.0, generator=None,
                       train: bool = False, kv_mask=None,
                       kv_sink: list | None = None):
    """Fused-QKV multi-head attention + output projection + dropout
    (reference ``:67-125``). ``kv_mask``: optional ``[b, t]`` key validity
    (nonzero = attend). ``kv_sink``: when given, this window's split-head
    ``(k, v)`` ``[b, h, t, hd]`` are appended to it (the prefill
    capture)."""
    q, k, v = _qkv_heads(block, x, num_heads)
    if kv_sink is not None:
        kv_sink.append((k, v))
    o = A.attention(q, k, v, causal=causal, kv_mask=kv_mask)
    return L.dropout(block.attn_out(A.merge_heads(o)), dropout_rate,
                     generator, train)


def attention_decode_tick(block, x, cache, pos, *, num_heads: int,
                          slot_mask=None):
    """The attention half of one decode tick (reference ``:142-163``):
    ln1 -> fused QKV -> the cache write + attention
    (``ops/attention.py::cache_write_and_attend``, in place on the cache)
    -> attn_out residual. ``cache``: ``{"kv"}`` (dense) or ``{"kv",
    "table"}`` (paged), with a ``"scale"`` leaf beside an int8 ``"kv"``;
    every leaf passes through to the write and the read as it is. ``pos``:
    a scalar (lockstep) or int32 ``[B]`` per-row slots; ``slot_mask``:
    optional ``[B, T]`` slot validity of a dense cache. Returns ``(x +
    attn_residual, cache)``."""
    q, k, v = _qkv_heads(block, block.ln1(x), num_heads)
    o, cache = A.cache_write_and_attend(q, k, v, cache, pos,
                                        slot_mask=slot_mask)
    return x + block.attn_out(A.merge_heads(o)), cache


class TransformerBlock(nn.Module):
    """Pre-LN (GPT-2) or post-LN (``pre_ln=False``, BERT) transformer
    block with fused-QKV MHA and a tanh-GELU MLP."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, *,
                 dropout_rate: float = 0.0, causal: bool = True,
                 pre_ln: bool = True, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.d_model, self.num_heads, self.causal = d_model, num_heads, causal
        self.pre_ln = pre_ln
        self.dropout_rate = dropout_rate
        self.ln1 = L.LayerNorm(d_model, **kw)
        self.qkv = L.Dense(d_model, 3 * d_model, **kw)
        self.attn_out = L.Dense(d_model, d_model, **kw)
        self.ln2 = L.LayerNorm(d_model, **kw)
        self.mlp_in = L.Dense(d_model, d_ff, **kw)
        self.mlp_out = L.Dense(d_ff, d_model, **kw)

    def init(self, generator):
        for layer in (self.ln1, self.qkv, self.attn_out, self.ln2,
                      self.mlp_in, self.mlp_out):
            layer.init(generator)

    def _mlp(self, x, generator=None, train: bool = False):
        # jax.nn.gelu defaults to the tanh approximation (reference :236)
        h = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
        return L.dropout(h, self.dropout_rate, generator, train)

    def forward(self, x, *, train: bool = False, generator=None,
                kv_mask=None, kv_sink: list | None = None):
        """The reference's ``apply`` (``:251-271``) over a whole ``[b, t,
        d]`` window: pre-LN ``x + attn(ln1(x))``, then ``+ mlp(ln2(x))``;
        post-LN ``ln1(x + attn(x))``, then ``ln2(x + mlp(x))``. ``train``
        with a ``generator`` (a ``torch.Generator`` on ``x``'s device)
        applies dropout; without a generator nothing is dropped, as the
        reference skips dropout without an rng. ``kv_mask``: optional
        ``[b, t]`` key validity (nonzero = attend)."""
        train = train and generator is not None
        kw = {"num_heads": self.num_heads, "causal": self.causal,
              "dropout_rate": self.dropout_rate, "generator": generator,
              "train": train, "kv_mask": kv_mask, "kv_sink": kv_sink}
        if not self.pre_ln:
            x = self.ln1(x + attention_sublayer(self, x, **kw))
            return self.ln2(x + self._mlp(x, generator, train))
        x = x + attention_sublayer(self, self.ln1(x), **kw)
        return x + self._mlp(self.ln2(x), generator, train)

    def decode_step(self, x, cache, pos, slot_mask=None):
        """One decode tick (reference ``:273-292``): ``x [B, 1, d]`` at
        slot ``pos`` (a scalar, or per-row ``[B]``); writes this step's K/V
        into ``cache["kv"]`` (the paged pool or the dense pair cache; int8
        with its ``cache["scale"]``) in place and attends slots ``0..pos``
        minus those ``slot_mask`` (optional ``[B, T]``, dense cache only)
        refuses."""
        if not (self.causal and self.pre_ln):
            raise ValueError("decode needs a causal pre-LN block")
        x, cache = attention_decode_tick(self, x, cache, pos,
                                         num_heads=self.num_heads,
                                         slot_mask=slot_mask)
        return x + self._mlp(self.ln2(x)), cache
