"""Fused AdamW — the port of
``distributed_compute_pytorch_tpu/ops/pallas/fused_adamw.py`` (its update
kernel ``_adamw_kernel``) as the hand-written CUDA kernel
``csrc/fused_adamw.cu``.

:func:`fused_adamw` returns the transformation, whose state mirrors the
reference's ``FusedAdamWState`` (``count``, ``mu``, ``nu``) and whose
``fused_apply(grads, state, params, ok)`` updates the params in place
where the device flag ``ok`` holds. Where the reference launches the
kernel once per leaf (148 launches for GPT-2-small), ``init`` lays params,
grads, ``mu`` and ``nu`` out as one flat f32 buffer each
(``train/flat.py``, the layout of every optimizer of the port), with
every parameter and its ``.grad`` a view into them, so one launch updates
every leaf; under ZeRO-1 one launch updates this rank's shard, and the
moments exist at the shard's size only. Autograd accumulates
into an existing ``.grad`` in place but replaces one that is ``None``: so
the grads are zeroed in place, never set to ``None``, and ``fused_apply``
raises when a parameter or its gradient no longer lies in its buffer.

As in the reference, the count is a device ``int32`` and the step's
scalars ``[lr, wd, c1, c2]`` are computed from it on the device in f32
(:meth:`FusedAdamW.scalars`, the reference's ``_scalars``) and read by
the kernel from device memory (its ``sc_ref`` block): nothing is passed
by value that changes from step to step, so a captured CUDA graph of the
train step replays each step with its own values. The device bool flag
``ok`` is the non-finite guard (``train/step.py``; a constant true one
where the step has no guard): when it is false the update writes nothing
and the count does not advance.

:func:`fused_adamw_update` is the wrapper: CUDA tensors launch the kernel
(or raise), CPU tensors run :func:`fused_adamw_plain`, the kernel's
arithmetic on tensors. ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Callable

import torch

from distributed_compute_pytorch_tpu_torch.ops import _build
from distributed_compute_pytorch_tpu_torch.train.flat import (
    FlatOptimizer, FlatState, device_count)

NAME = "fused_adamw"
REPLACES = "distributed_compute_pytorch_tpu/ops/pallas/fused_adamw.py:59"
launches = 0


def fused_adamw_plain(g, p, mu, nu, sc, ok, *, b1, b2, eps):
    """The kernel's plain PyTorch version (reference ``_adamw_kernel``),
    in f32: returns the new ``(p, mu, nu)``. ``sc`` is the step's f32
    ``[lr, wd, c1, c2]`` (``c1 = 1/(1 - b1^t)``, ``c2 = 1/(1 - b2^t)``);
    where the bool scalar ``ok`` is false the old values come back."""
    g, p, mu, nu = (x.float() for x in (g, p, mu, nu))
    lr, wd, c1, c2 = sc.float().unbind()
    new_mu = b1 * mu + (1.0 - b1) * g
    new_nu = b2 * nu + (1.0 - b2) * g * g
    update = new_mu * c1 / (torch.sqrt(new_nu * c2) + eps) + wd * p
    new = (p - lr * update, new_mu, new_nu)
    return tuple(torch.where(ok, a, b) for a, b in zip(new, (p, mu, nu)))


def _ptr(x, dev, dtype, numel, what):
    """``x``'s device address, after checking it is ``numel`` contiguous
    elements of ``dtype`` on ``dev``."""
    if (x.device != dev or x.dtype != dtype or x.numel() != numel
            or not x.is_contiguous()):
        raise ValueError(f"fused_adamw: {what} must be {numel} contiguous "
                         f"{dtype} on {dev}, got {x.numel()} {x.dtype} on "
                         f"{x.device}")
    return x.data_ptr()


def fused_adamw_cuda(g, p, mu, nu, sc, count, ok, *, b1, b2, eps):
    """Launch the kernel over flat buffers, updating ``p``, ``mu``, ``nu``
    in place (nothing where the device flag ``ok`` is false) and advancing
    the device ``int32`` ``count`` by ``ok``. Raises on anything it does
    not take: non-CUDA or mixed devices, non-f32, non-contiguous, unequal
    sizes, unaligned storage, a scalar block, flag or count of another
    size, type or device."""
    global launches
    bufs = (g, p, mu, nu)
    dev = p.device
    if dev.type != "cuda" or any(x.device != dev for x in bufs):
        raise ValueError(f"fused_adamw needs CUDA tensors on one device, "
                         f"got {[str(x.device) for x in bufs]}")
    if any(x.dtype != torch.float32 or not x.is_contiguous()
           or x.numel() != p.numel() or x.data_ptr() % 16 for x in bufs):
        raise ValueError("fused_adamw takes four contiguous, 16-byte "
                         "aligned f32 buffers of one size")
    sc_ptr = _ptr(sc, dev, torch.float32, 4, "the scalars")
    count_ptr = _ptr(count, dev, torch.int32, 1, "count")
    ok_ptr = _ptr(ok, dev, torch.bool, 1, "ok")
    lib, fn = _build.bind(NAME, "pppplpppfffffp")
    rc = fn(g.data_ptr(), p.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            p.numel(), sc_ptr, count_ptr, ok_ptr, b1, 1.0 - b1, b2, 1.0 - b2,
            eps, _build.stream_ptr(dev))
    _build.check(lib, NAME, rc)
    launches += 1


def fused_adamw_update(g, p, mu, nu, sc, count, ok, **hyper):
    """One AdamW step over flat f32 buffers, in place, where ``ok`` (a
    device bool scalar) holds; the device ``int32`` scalar ``count``
    advances by ``ok``. The kernel on CUDA tensors,
    :func:`fused_adamw_plain` on CPU tensors."""
    if p.device.type != "cpu":
        fused_adamw_cuda(g, p, mu, nu, sc, count, ok, **hyper)
        return
    new = fused_adamw_plain(g, p, mu, nu, sc, ok, **hyper)
    for dst, src in zip((p, mu, nu), new):
        dst.copy_(src)
    count.add_(ok.to(count.dtype))


def device_scalars(learning_rate, weight_decay: float, b1: float, b2: float,
                   count: torch.Tensor) -> torch.Tensor:
    """The reference's ``_scalars(count)``: f32 ``[lr, wd, c1, c2]`` on
    ``count``'s device from the ``int32`` update count, with ``t = count +
    1``, ``lr`` the schedule at ``count`` (its tensor form, evaluated on
    the device) and the bias corrections ``c = 1 / (1 - b^t)`` in f32. No
    value is read back or passed by value from the host."""
    dev = count.device

    def const(v):
        return torch.full((), v, dtype=torch.float32, device=dev)
    t = count.float() + 1.0
    lr = (learning_rate(count) if callable(learning_rate)
          else const(learning_rate))
    return torch.stack([lr.float(), const(weight_decay),
                        1.0 / (1.0 - const(b1) ** t),
                        1.0 / (1.0 - const(b2) ** t)])


class FusedAdamW(FlatOptimizer):
    """The transformation (reference ``fused_adamw``) over the flat layout
    every optimizer of the port keeps (``train/flat.py``): ``init(params,
    layout)`` builds the flat buffers, re-pointing each tensor of
    ``params`` (a ``{name: tensor}`` dict, f32, one device) and its
    ``.grad`` at its slice; :meth:`update` is one kernel launch over the
    update's buffers: the whole model, or under ZeRO-1 this rank's shard
    (16-byte aligned: the layout pads every unit to ``world x 4``
    elements, and the kernel raises on an unaligned view);
    ``fused_apply(grads, state, params, ok)`` checks that every tensor
    still lies in the buffers, then updates."""

    kinds = ("mu", "nu")

    def __init__(self, learning_rate: float | Callable[[torch.Tensor],
                                                       torch.Tensor],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    @property
    def hyper(self) -> dict:
        """The constant hyper-parameters the kernel takes by value."""
        return {"b1": self.b1, "b2": self.b2, "eps": self.eps}

    def scalars(self, count: torch.Tensor) -> torch.Tensor:
        """The step's f32 ``[lr, wd, c1, c2]`` from the device count
        (:func:`device_scalars`)."""
        return device_scalars(self.learning_rate, self.weight_decay,
                              self.b1, self.b2, count)

    def update(self, state: FlatState, ok: torch.Tensor | None = None,
               gn2: torch.Tensor | None = None) -> None:
        """One kernel launch (on CUDA) over ``state.upd_p`` from
        ``state.upd_g``, where the device bool scalar ``ok`` holds; the
        count advances by ``ok``."""
        del gn2
        if ok is None:
            raise ValueError("fused_adamw takes a device bool flag ok")
        fused_adamw_update(state.upd_g, state.upd_p, state.slots["mu"],
                           state.slots["nu"], self.scalars(state.count),
                           state.count, ok, **self.hyper)

    def fused_apply(self, grads: dict, state: FlatState,
                    params: dict, ok: torch.Tensor) -> None:
        """One update of every leaf, in place (one kernel launch on CUDA),
        where the device bool scalar ``ok`` holds; the count advances by
        ``ok``."""
        if set(params) != set(state.layout.names) or set(grads) != set(
                params):
            raise ValueError("fused_apply: params/grads do not match the "
                             "leaves init laid out")
        self.check(state, grads)
        self.update(state, ok)


def fused_adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.0) -> FusedAdamW:
    """AdamW with the single-pass update kernel (reference
    ``fused_adamw``): same recurrence, bias correction and decoupled
    weight decay as ``optax.adamw`` without a decay mask."""
    return FusedAdamW(learning_rate, b1, b2, eps, weight_decay)
