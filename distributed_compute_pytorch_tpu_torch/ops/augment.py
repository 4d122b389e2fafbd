"""Device-side image augmentation — port of
``distributed_compute_pytorch_tpu/ops/augment.py``: it runs inside the
train step (and so inside its CUDA graph), never on the host.

- ``flip``: a per-example horizontal mirror with p = 0.5;
- ``flip-crop``: the flip, then a per-example shift: the image padded by
  ``pad`` pixels with its edge pixels replicated (not zeros: the images
  are already normalised, where a zero border would be a value no image
  holds) and cropped back at an offset drawn uniformly from ``[0,
  2 * pad]`` on each axis.

Each transform is a pure function of its decisions (:func:`flip`: the
flips ``[B]``; :func:`crop`: the offsets ``oy``, ``ox`` ``[B]``) and a
draw of them from the step's ``torch.Generator`` (:func:`draw_flips`,
:func:`draw_offsets`), so the tests feed the JAX package's decisions to
the pure half. Under a process group the draw is the global batch's and
this rank keeps its rows (as ``models/layers.py::dropout`` does), so N
ranks augment as one process does. The crop reads its rows and columns
through index tensors built on the device from the offsets: no host
sync, and the padded image is never materialised.

Images are NHWC ``[B, H, W, C]``, as the datasets hold them.
"""

from __future__ import annotations

import torch

from distributed_compute_pytorch_tpu_torch.core import mesh


def _rank_rows(draw: torch.Tensor, rows: int) -> torch.Tensor:
    r = mesh.process_index()
    return draw[r * rows:(r + 1) * rows]


def draw_flips(batch: int, generator, device) -> torch.Tensor:
    """This rank's ``[batch]`` bool flips of the global batch's draw."""
    u = torch.rand(batch * mesh.process_count(), generator=generator,
                   device=device)
    return _rank_rows(u < 0.5, batch)


def draw_offsets(batch: int, generator, device, pad: int = 4):
    """This rank's ``(oy, ox)`` int64 ``[batch]`` crop offsets in ``[0, 2 *
    pad]`` of the global batch's draw (``oy`` drawn first)."""
    n = batch * mesh.process_count()
    oy, ox = (torch.randint(0, 2 * pad + 1, (n,), generator=generator,
                            device=device) for _ in range(2))
    return _rank_rows(oy, batch), _rank_rows(ox, batch)


def flip(x, flips):
    """``x [B, H, W, C]`` with the rows where ``flips`` is true mirrored
    left to right (reference ``random_flip``, ``:26-29``)."""
    return torch.where(flips[:, None, None, None], x.flip(2), x)


def crop(x, oy, ox, pad: int = 4):
    """``x [B, H, W, C]`` padded by ``pad`` with its edges replicated and
    cropped back to ``H x W`` at the per-example offsets ``oy``, ``ox``
    (reference ``random_crop``, ``:32-53``): output pixel ``(i, j)`` of
    example ``b`` is input pixel ``(clamp(oy[b] + i - pad), clamp(ox[b] + j
    - pad))``, the edge replication the padding would give."""
    b, h, w, _ = x.shape
    rows = (oy[:, None] + torch.arange(h, device=x.device) - pad).clamp(
        0, h - 1)
    cols = (ox[:, None] + torch.arange(w, device=x.device) - pad).clamp(
        0, w - 1)
    idx = torch.arange(b, device=x.device)
    return x[idx[:, None, None], rows[:, :, None], cols[:, None, :]]


def build_augment(spec: str | None, pad: int = 4):
    """``spec`` -> ``augment(x, generator) -> x``, or ``None`` for
    ``none`` (reference ``build_augment``, ``:56-68``). ``flip-crop``
    draws the flips, then the offsets."""
    if spec in (None, "", "none"):
        return None
    if spec == "flip":
        def flip_only(x, generator):
            return flip(x, draw_flips(x.shape[0], generator, x.device))
        return flip_only
    if spec == "flip-crop":
        def flip_crop(x, generator):
            x = flip(x, draw_flips(x.shape[0], generator, x.device))
            oy, ox = draw_offsets(x.shape[0], generator, x.device, pad)
            return crop(x, oy, ox, pad)
        return flip_crop
    raise ValueError(f"unknown augment spec {spec!r}; expected none | flip "
                     f"| flip-crop")
