"""Layers — port of ``distributed_compute_pytorch_tpu/models/layers.py``
(the parts the GPT-2 serving and training paths use).

Each layer is an ``nn.Module`` whose parameters are allocated on the
module's device (zeros until :meth:`init` or a weight load fills them).
``init(generator)`` draws from a CPU ``torch.Generator`` and copies to
the device, so one seed gives the same weights on every device, with the
JAX package's distributions (PyTorch's ``nn.Linear`` defaults for Dense,
N(0, std) embeddings, unit LayerNorm) — not its values: ``jax.random`` and
``torch.Generator`` draw different numbers from one seed, so parity tests
convert weights (``interop.py``) instead.

Parameter layouts are PyTorch's: a Dense weight is ``[out, in]`` where the
JAX kernel is ``[in, out]``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _fill(param: nn.Parameter, sample: torch.Tensor) -> None:
    with torch.no_grad():
        param.copy_(sample.to(param.dtype))


class Dense(nn.Module):
    """Affine layer ``y = x W^T + b`` (reference ``Dense``, ``:43-75``),
    computed in the activation dtype."""

    def __init__(self, in_features: int, out_features: int, *,
                 use_bias: bool = True, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.zeros(out_features, in_features,
                                               device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if use_bias else None)

    def init(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.in_features)
        _fill(self.weight, torch.empty(self.weight.shape).uniform_(
            -bound, bound, generator=generator))
        if self.bias is not None:
            _fill(self.bias, torch.empty(self.bias.shape).uniform_(
                -bound, bound, generator=generator))

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.Module):
    """Layer normalisation over the last axis, eps 1e-5, computed in the
    ACTIVATION dtype as the reference does (``:235-252``) — not
    ``F.layer_norm``, which would compute bf16 inputs in f32."""

    def __init__(self, num_features: int, *, eps: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device,
                                             dtype=dtype))

    def init(self, generator: torch.Generator):
        del generator
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class Embedding(nn.Module):
    """Token/position table (reference ``:275-331``): ``forward`` looks
    ids up, ``attend`` is the tied-softmax readout ``x E^T``."""

    def __init__(self, num_embeddings: int, features: int, *,
                 init_std: float = 0.02, device=None, dtype=torch.float32):
        super().__init__()
        self.init_std = init_std
        self.weight = nn.Parameter(torch.zeros(num_embeddings, features,
                                               device=device, dtype=dtype))

    def init(self, generator: torch.Generator):
        _fill(self.weight, self.init_std * torch.randn(
            self.weight.shape, generator=generator))

    def forward(self, ids):
        return F.embedding(ids, self.weight)

    def attend(self, x):
        return torch.matmul(x, self.weight.to(x.dtype).t())


def dropout(x, rate: float, generator, train: bool):
    """``nn.Dropout`` (reference ``:143-158``): the identity when not
    training or ``rate == 0``; otherwise inverted scaling with a keep mask
    drawn from ``generator``, a ``torch.Generator`` on ``x``'s device."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def nll_loss(log_probs, targets, reduction: str = "mean"):
    """``F.nll_loss`` on log-probabilities (reference ``:339-347``), in
    their dtype."""
    picked = log_probs.gather(-1, targets[..., None].long())[..., 0]
    if reduction == "mean":
        return -picked.mean()
    if reduction == "sum":
        return -picked.sum()
    return -picked


def cross_entropy_with_logits(logits, targets, reduction: str = "mean"):
    """log-softmax + NLL (reference ``:350-352``), in the logits' dtype."""
    return nll_loss(torch.log_softmax(logits, dim=-1), targets, reduction)


def token_eval_metrics(per_tok_loss, correct, valid=None):
    """Token-level eval sums (reference ``:355-379``, without the
    per-token mask): ``per_tok_loss``/``correct`` ``[B, T']``; ``valid``
    an optional float ``[B]`` sequence weight (0.0 for the feeder's
    wraparound-padded rows). Returns ``loss_sum`` (f32), ``correct`` and
    ``count`` (int32) device scalars."""
    per_tok_loss = per_tok_loss.float()
    w = (torch.ones_like(per_tok_loss) if valid is None
         else valid.float()[:, None].expand_as(per_tok_loss))
    return {"loss_sum": (per_tok_loss * w).sum(),
            "correct": (correct.float() * w).sum().to(torch.int32),
            "count": w.sum().to(torch.int32)}
