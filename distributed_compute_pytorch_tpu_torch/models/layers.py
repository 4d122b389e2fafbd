"""Layers — port of ``distributed_compute_pytorch_tpu/models/layers.py``
(the parts the GPT-2, Llama, ConvNet, ResNet and BERT paths use).

Each layer is an ``nn.Module`` whose parameters are allocated on the
module's device (zeros until :meth:`init` or a weight load fills them).
``init(generator)`` draws from a CPU ``torch.Generator`` and copies to
the device, so one seed gives the same weights on every device, with the
JAX package's distributions (PyTorch's ``nn.Linear`` defaults for Dense,
N(0, std) embeddings, unit LayerNorm and RMSNorm) — not its values:
``jax.random`` and ``torch.Generator`` draw different numbers from one
seed, so parity tests convert weights (``interop.py``) instead.

Parameter layouts are PyTorch's: a Dense weight is ``[out, in]`` where the
JAX kernel is ``[in, out]``, a Conv2d weight OIHW where the JAX kernel is
HWIO, and images are NCHW where the JAX package's are NHWC.

Data parallelism (``core/mesh.py``): under a process group, dropout draws
the mask of the global batch and keeps this rank's rows, and BatchNorm's
training statistics are those of the global batch (sync-BN), so N ranks
compute what one process computes on the whole batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from distributed_compute_pytorch_tpu_torch.core import mesh


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


class RMSNorm(nn.Module):
    """Root-mean-square norm over the last axis (reference ``:256-272``),
    the Llama family's: no mean subtraction, no bias, eps 1e-6. The
    statistics and the scale product are in f32 whatever the activation
    dtype (bf16 squares underflow), then cast back. The reference names
    the scale ``scale``; here it is ``weight`` (``interop.py`` maps it)."""

    def __init__(self, num_features: int, *, eps: float = 1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device,
                                              dtype=dtype))

    def init(self, generator: torch.Generator):
        del generator
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        x32 = x.to(torch.float32)
        y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.to(torch.float32)).to(x.dtype)


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


class Conv2d(nn.Module):
    """2-D convolution ``nn.Conv2d`` (reference ``:79-119``) on NCHW maps
    with an OIHW weight, computed in the activation dtype: ``padding``
    pixels on each side of H and W (0 is the reference's VALID, the
    ConvNet's; a ResNet's ``(k - 1) // 2`` pads symmetrically as its
    explicit padding does), a bias unless ``use_bias=False``; init
    U(+-1/sqrt(fan_in)) for weight and bias, torch's defaults."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, *, padding: int = 0,
                 use_bias: bool = True, device=None, dtype=torch.float32):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.fan_in = in_channels * kernel_size * kernel_size
        self.weight = nn.Parameter(torch.zeros(
            out_channels, in_channels, kernel_size, kernel_size,
            device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device,
                                              dtype=dtype))
                     if use_bias else None)

    def init(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.fan_in)
        for p in (self.weight, self.bias):
            if p is not None:
                _fill(p, torch.empty(p.shape).uniform_(-bound, bound,
                                                       generator=generator))

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias,
                        stride=self.stride, padding=self.padding)


def max_pool2d(x, window: int = 2, stride: int | None = None,
               padding: int = 0):
    """``F.max_pool2d`` (reference ``:121-131``) on NCHW maps; ``padding``
    pads with -inf, as the reference's ``reduce_window`` does."""
    return F.max_pool2d(x, window, stride or window, padding)


class BatchNorm(nn.Module):
    """``nn.BatchNorm1d``/``nn.BatchNorm2d`` (reference ``:162-234``) over
    every axis but ``channel_axis``: the last (the reference's own axis:
    the ConvNet's ``[rows, features]``) or 1 (a ResNet's NCHW map, where
    the reference's NHWC map has its channels last); momentum 0.1, eps
    1e-5, f32 running stats (the buffers ``running_mean`` and
    ``running_var``, torch's names).

    ``forward(x, train)`` returns ``(y, new_stats)``: in training the
    statistics of the batch, with the new running stats in ``new_stats``
    (the running variance unbiased by ``n / (n - 1)``), and the layer's
    buffers untouched — the train step writes them (``train/step.py``);
    in eval the running stats, and ``new_stats`` is ``None``.

    The batch statistics come from the f64 sums of ``x`` and ``x**2`` and
    the row count, all-reduced over the process group when there is one
    (``mesh.all_reduce_sum``, which carries the gradient back to every
    rank's rows): sync-BN over the global batch, as the reference's SPMD
    program computes it, so ``n`` is the global row count (pixels
    included, for a map)."""

    def __init__(self, num_features: int, *, channel_axis: int = -1,
                 momentum: float = 0.1, eps: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.channel_axis = channel_axis
        self.weight = nn.Parameter(torch.ones(num_features, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device,
                                             dtype=dtype))
        self.register_buffer("running_mean", torch.zeros(
            num_features, device=device, dtype=torch.float32))
        self.register_buffer("running_var", torch.ones(
            num_features, device=device, dtype=torch.float32))

    def init(self, generator: torch.Generator):
        del generator
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x, train: bool = False):
        ax = self.channel_axis % x.ndim
        dims = tuple(d for d in range(x.ndim) if d != ax)
        shape = [1] * x.ndim
        shape[ax] = x.shape[ax]
        new_stats = None
        if train:
            # f64 sums: E[x^2] - E[x]^2 in f32 would cancel away a
            # feature whose mean is large against its spread
            xf = x.double()
            count = torch.full((1,), x.numel() // x.shape[ax],
                               dtype=torch.float64, device=x.device)
            sums = torch.cat([xf.sum(dims), xf.square().sum(dims), count])
            if mesh.distributed():
                sums = mesh.all_reduce_sum(sums)
            f = x.shape[ax]
            n = sums[-1]
            mean = sums[:f] / n
            var = (sums[f:2 * f] / n - mean.square()).clamp(min=0.0)
            unbiased = (var * (n / (n - 1.0).clamp(min=1.0))).float()
            mean, var = mean.float(), var.float()
            m = self.momentum
            new_stats = {
                "running_mean": (1 - m) * self.running_mean
                                + m * mean.detach(),
                "running_var": (1 - m) * self.running_var
                               + m * unbiased.detach()}
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var.to(x.dtype) + self.eps).view(shape)
        y = (x - mean.to(x.dtype).view(shape)) * inv
        return (y * self.weight.to(x.dtype).view(shape)
                + self.bias.to(x.dtype).view(shape), new_stats)


def dropout(x, rate: float, generator, train: bool,
            broadcast_dims: tuple[int, ...] = ()):
    """``nn.Dropout`` (reference ``:143-159``): the identity when not
    training or ``rate == 0``; otherwise inverted scaling with a keep mask
    drawn from ``generator``, a ``torch.Generator`` on ``x``'s device.
    ``broadcast_dims`` are axes the mask is shared across (``(2, 3)`` of
    an NCHW map: ``nn.Dropout2d``'s whole channels, a ``[B, C, 1, 1]``
    mask). Under a process group the mask is drawn for the global batch
    (this rank's rows are ``rank * B`` on) and this rank's rows are kept,
    so the ranks together draw what one process draws for the whole
    batch. Each rank thus draws ``world`` times its own mask: nothing for
    the ConvNet's ``[B, 64]`` and ``[B, 128]``; for GPT-2, ``world``
    times its ``[B, T, 768]`` at every site (``ddp_probe.py --model gpt2``
    measures what that costs a step)."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    rank, world = mesh.process_index(), mesh.process_count()
    shape = [1 if d in broadcast_dims else s for d, s in enumerate(x.shape)]
    rows = shape[0]
    shape[0] *= world
    u = torch.rand(shape, generator=generator, device=x.device)
    mask = u[rank * rows:(rank + 1) * rows] < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def log_softmax(x, dim: int = -1):
    """``F.log_softmax`` (reference ``:334``)."""
    return torch.log_softmax(x, dim=dim)


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


def token_eval_metrics(per_tok_loss, correct, valid=None, token_mask=None):
    """Token-level eval sums (reference ``:355-379``): ``per_tok_loss``/
    ``correct`` ``[B, T']``; ``valid`` an optional float ``[B]`` sequence
    weight (0.0 for the feeder's wraparound-padded rows); ``token_mask``
    an optional ``[B, T]`` per-token weight (1 = a real token), cropped to
    its last ``T'`` columns: a shifted causal loss's column j scores token
    j + 1, an unshifted one (BERT's) uses it as it is. Returns
    ``loss_sum`` (f32), ``correct`` and ``count`` (int32) device
    scalars."""
    per_tok_loss = per_tok_loss.float()
    w = (torch.ones_like(per_tok_loss) if valid is None
         else valid.float()[:, None].expand_as(per_tok_loss))
    if token_mask is not None:
        shift = token_mask.shape[1] - per_tok_loss.shape[1]
        w = w * token_mask[:, shift:].float()
    return {"loss_sum": (per_tok_loss * w).sum(),
            "correct": (correct.float() * w).sum().to(torch.int32),
            "count": w.sum().to(torch.int32)}
