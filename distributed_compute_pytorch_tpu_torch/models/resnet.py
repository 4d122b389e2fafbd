"""ResNet-18/50 — port of ``distributed_compute_pytorch_tpu/models/resnet.py``
(BASELINE's rungs 1 and 2: CIFAR-10 and ImageNet).

torchvision's topology: BasicBlock for ResNet-18, Bottleneck (the stride
on its 3x3 conv) for ResNet-50, a projection shortcut (1x1 conv +
BatchNorm) wherever a block changes stride or width; convolutions without
bias, each followed by a BatchNorm over the channels. ``small_input``
picks the CIFAR stem (3x3 stride 1, no pool; ResNet-18's default) or the
ImageNet stem (7x7 stride 2 and a 3x3 stride-2 max pool; ResNet-50's).
Then a global average pool and the ``head`` Dense.

The module names follow the reference's params tree (``stem``,
``stem_bn``, ``blocks.{i}.conv{j}`` / ``bn{j}`` / ``proj`` / ``proj_bn``
for its ``block{i}``, ``head``), so ``interop.py`` maps one onto the other
by name. Batches arrive NHWC, as the datasets and the JAX package hold
them, and are permuted to NCHW: a view in channels-last memory, the
layout cuDNN's tensor-core convolutions take, which every convolution,
BatchNorm and residual add keeps. ``blocks`` is an ``nn.ModuleList``, so
FSDP makes each block a unit (``parallel/api.py::fsdp_units``).
"""

from __future__ import annotations

import torch
from torch import nn

from distributed_compute_pytorch_tpu_torch.device import resolve_device
from distributed_compute_pytorch_tpu_torch.models import layers as L


def _conv(cin, cout, k, stride, kw):
    return L.Conv2d(cin, cout, k, stride, padding=(k - 1) // 2,
                    use_bias=False, **kw)


def _bn(c, kw):
    return L.BatchNorm(c, channel_axis=1, **kw)


def _norm(bn, x, train: bool, name: str, stats: dict):
    """``bn`` on ``x``; its new running stats go into ``stats`` under
    ``name``."""
    y, new = bn(x, train)
    if new is not None:
        stats.update({f"{name}.{k}": v for k, v in new.items()})
    return y


class Block(nn.Module):
    """BasicBlock (``bottleneck=False``, expansion 1) or Bottleneck
    (expansion 4), reference ``_Block`` (``:31-104``)."""

    def __init__(self, cin: int, cmid: int, stride: int, bottleneck: bool,
                 kw: dict):
        super().__init__()
        self.cout = cmid * (4 if bottleneck else 1)
        if bottleneck:
            convs = [(cin, cmid, 1, 1), (cmid, cmid, 3, stride),
                     (cmid, self.cout, 1, 1)]
        else:
            convs = [(cin, cmid, 3, stride), (cmid, self.cout, 3, 1)]
        self.depth = len(convs)
        for i, (a, b, k, s) in enumerate(convs):
            setattr(self, f"conv{i}", _conv(a, b, k, s, kw))
            setattr(self, f"bn{i}", _bn(b, kw))
        self.has_proj = stride != 1 or cin != self.cout
        if self.has_proj:
            self.proj = _conv(cin, self.cout, 1, stride, kw)
            self.proj_bn = _bn(self.cout, kw)

    def init(self, generator: torch.Generator):
        for m in self.children():
            m.init(generator)

    def forward(self, x, train: bool, stats: dict, prefix: str):
        y = x
        for i in range(self.depth):
            y = getattr(self, f"conv{i}")(y)
            y = _norm(getattr(self, f"bn{i}"), y, train, f"{prefix}bn{i}",
                      stats)
            if i < self.depth - 1:
                y = torch.relu(y)
        sc = x
        if self.has_proj:
            sc = _norm(self.proj_bn, self.proj(x), train,
                       f"{prefix}proj_bn", stats)
        return torch.relu(y + sc)


class ResNet(nn.Module):
    """Built on CUDA unless ``device="cpu"`` (``RuntimeError`` when CUDA
    is absent and the CPU was not asked for); parameters start at zero
    until :meth:`init` or a weight load; construct by :meth:`build`.

    ``forward(x, train, generator) -> (logits, new_stats)``: ``new_stats``
    are the BatchNorm running stats after a training batch, keyed by
    buffer name, and empty in eval; the buffers themselves are left for
    the train step to write. No dropout: ``generator`` is unused."""

    def __init__(self, depths: tuple[int, ...], bottleneck: bool, *,
                 num_classes: int = 10, in_channels: int = 3,
                 small_input: bool = True, width: int = 64, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.small_input = small_input
        stem_k, stem_s = (3, 1) if small_input else (7, 2)
        self.stem = _conv(in_channels, width, stem_k, stem_s, kw)
        self.stem_bn = _bn(width, kw)
        blocks, cin = [], width
        for stage, depth in enumerate(depths):
            cmid = width * 2 ** stage
            for i in range(depth):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(Block(cin, cmid, stride, bottleneck, kw))
                cin = blocks[-1].cout
        self.blocks = nn.ModuleList(blocks)
        self.head = L.Dense(cin, num_classes, **kw)

    @classmethod
    def build(cls, name: str, **kw) -> "ResNet":
        """``resnet18`` (2-2-2-2 BasicBlocks, CIFAR stem) or ``resnet50``
        (3-4-6-3 Bottlenecks, ImageNet stem), reference ``:119-127``."""
        if name == "resnet18":
            return cls((2, 2, 2, 2), False, **kw)
        if name == "resnet50":
            kw.setdefault("small_input", False)
            return cls((3, 4, 6, 3), True, **kw)
        raise ValueError(f"unknown resnet variant {name!r}")

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def init(self, generator: torch.Generator) -> "ResNet":
        """Draw every weight from ``generator`` (a CPU generator) with the
        reference's distributions; BatchNorm to unit scale and fresh
        running stats. Returns ``self``."""
        self.stem.init(generator)
        self.stem_bn.init(generator)
        for block in self.blocks:
            block.init(generator)
        self.head.init(generator)
        return self

    def forward(self, x, *, train: bool = False, generator=None):
        """``x`` ``[B, H, W, C]`` (NHWC) -> ``(logits [B, classes],
        new_stats)`` (reference ``apply``, ``:145-170``)."""
        del generator   # no dropout in a ResNet
        stats: dict = {}
        y = self.stem(x.permute(0, 3, 1, 2))
        y = torch.relu(_norm(self.stem_bn, y, train, "stem_bn", stats))
        if not self.small_input:
            y = L.max_pool2d(y, 3, 2, padding=1)
        for i, block in enumerate(self.blocks):
            y = block(y, train, stats, f"blocks.{i}.")
        return self.head(y.mean((2, 3))), stats

    def loss_fn(self, logits, targets):
        """Mean cross-entropy (reference ``:172-173``)."""
        return L.cross_entropy_with_logits(logits, targets, "mean")

    def eval_metrics(self, logits, targets, valid=None):
        """Classifier eval sums (the reference step's generic path,
        ``train/step.py:741-760``): ``loss_sum`` (f32), ``correct`` and
        ``count`` (int32); ``valid`` (float ``[B]``) weights out the
        feeder's padded rows."""
        hit = logits.argmax(-1) == targets
        if valid is None:
            n = targets.shape[0]
            return {"loss_sum": L.cross_entropy_with_logits(
                        logits, targets, "sum").float(),
                    "correct": hit.sum().to(torch.int32),
                    "count": torch.full((), n, dtype=torch.int32,
                                        device=targets.device)}
        per_ex = L.cross_entropy_with_logits(logits.float(), targets, "none")
        return {"loss_sum": (per_ex * valid).sum(),
                "correct": (hit.float() * valid).sum().to(torch.int32),
                "count": valid.sum().to(torch.int32)}
