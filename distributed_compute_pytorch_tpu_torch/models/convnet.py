"""The reference MNIST ConvNet — port of
``distributed_compute_pytorch_tpu/models/convnet.py``.

conv(1->32, 3x3, valid) -> relu -> conv(32->64, 3x3) -> relu ->
maxpool(2) -> channel dropout(0.25) -> flatten -> fc1(9216->128) ->
BatchNorm1d(128) -> relu -> dropout(0.5) -> fc2(128->10) -> log_softmax.

The module names and layouts are the reference trainer's (``conv1``,
``conv2``, ``fc1``, ``batchnorm``, ``fc2``; OIHW convs, ``[out, in]``
dense weights, fc1 reading the NCHW ``(c, h, w)`` flatten), so a reference
``mnist.pt`` loads into :meth:`ConvNet.load_state_dict`
(``interop.load_reference_state_dict``). Batches arrive NHWC, as the
datasets and the JAX package hold them, and are permuted to NCHW: a view,
in channels-last memory, cuDNN's preferred form for convolutions. The
JAX package flattens NHWC ``(h, w, c)`` before fc1, so fc1's input
features are permuted between the two (``interop.convnet_params_*``).
"""

from __future__ import annotations

import torch
from torch import nn

from distributed_compute_pytorch_tpu_torch.device import resolve_device
from distributed_compute_pytorch_tpu_torch.models import layers as L


class ConvNet(nn.Module):
    """Built on CUDA unless ``device="cpu"`` (``RuntimeError`` when CUDA
    is absent and the CPU was not asked for); parameters start at zero
    until :meth:`init` or a weight load.

    ``forward(x, train, generator) -> (log_probs, new_stats)``:
    ``new_stats`` are the BatchNorm running stats after a training batch,
    keyed by buffer name (``"batchnorm.running_mean"``, ...), and empty in
    eval; the module's buffers are left for the train step to write."""

    def __init__(self, num_classes: int = 10, in_channels: int = 1,
                 image_size: tuple[int, int] = (28, 28), *, device=None,
                 dtype=torch.float32):
        super().__init__()
        h, w = image_size
        self.image_size = (h, w)
        # two valid 3x3 convs shave 4 px, then the pool halves: 9216 at
        # the reference's 28 x 28
        flat = ((h - 4) // 2) * ((w - 4) // 2) * 64
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.conv1 = L.Conv2d(in_channels, 32, 3, 1, **kw)
        self.conv2 = L.Conv2d(32, 64, 3, 1, **kw)
        self.fc1 = L.Dense(flat, 128, **kw)
        self.batchnorm = L.BatchNorm(128, **kw)
        self.fc2 = L.Dense(128, num_classes, **kw)

    @property
    def device(self) -> torch.device:
        return self.fc2.weight.device

    def init(self, generator: torch.Generator) -> "ConvNet":
        """Draw every weight from ``generator`` (a CPU generator) with the
        reference's distributions; BatchNorm to unit scale and fresh
        running stats. Returns ``self``."""
        for layer in (self.conv1, self.conv2, self.fc1, self.batchnorm,
                      self.fc2):
            layer.init(generator)
        return self

    def forward(self, x, *, train: bool = False, generator=None):
        """``x`` ``[B, H, W, C]`` (NHWC) -> ``(log_probs [B, classes],
        new_stats)`` (reference ``apply``, ``:59-86``); ``train`` needs a
        ``generator`` for the two dropouts."""
        if train and generator is None:
            raise ValueError("train=True requires a generator for dropout")
        x = x.permute(0, 3, 1, 2)
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        x = L.max_pool2d(x, 2)
        # nn.Dropout2d(0.25): whole channels, a [B, C, 1, 1] mask
        x = L.dropout(x, 0.25, generator, train, broadcast_dims=(2, 3))
        x = self.fc1(x.flatten(1))
        x, stats = self.batchnorm(x, train)
        x = torch.relu(x)
        x = L.dropout(x, 0.5, generator, train)
        log_probs = L.log_softmax(self.fc2(x), -1)
        new_stats = ({f"batchnorm.{k}": v for k, v in stats.items()}
                     if stats is not None else {})
        return log_probs, new_stats

    def loss_fn(self, log_probs, targets):
        """Mean NLL (reference ``:87-89``)."""
        return L.nll_loss(log_probs, targets, "mean")

    def eval_metrics(self, log_probs, targets, valid=None):
        """Classifier eval sums (reference ``train/step.py:717-760``):
        ``loss_sum`` (f32), ``correct`` and ``count`` (int32); ``valid``
        (float ``[B]``) weights out the feeder's padded rows."""
        pred = log_probs.argmax(-1)
        hit = pred == targets
        if valid is None:
            n = targets.shape[0]
            return {"loss_sum": (self.loss_fn(log_probs, targets)
                                 * n).float(),
                    "correct": hit.sum().to(torch.int32),
                    "count": torch.full((), n, dtype=torch.int32,
                                        device=targets.device)}
        per_ex = L.nll_loss(torch.log_softmax(log_probs.float(), -1),
                            targets, "none")
        return {"loss_sum": (per_ex * valid).sum(),
                "correct": (hit.float() * valid).sum().to(torch.int32),
                "count": valid.sum().to(torch.int32)}
