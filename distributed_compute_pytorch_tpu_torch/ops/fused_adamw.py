"""Fused AdamW — the port of
``distributed_compute_pytorch_tpu/ops/pallas/fused_adamw.py`` (its update
kernel ``_adamw_kernel``) as the hand-written CUDA kernel
``csrc/fused_adamw.cu``.

:func:`fused_adamw` returns the transformation, whose state mirrors the
reference's ``FusedAdamWState`` (``count``, ``mu``, ``nu``) and whose
``fused_apply(grads, state, params)`` updates the params in place. Where
the reference launches the kernel once per leaf (148 launches for
GPT-2-small), ``init`` lays params, grads, ``mu`` and ``nu`` out as one
flat f32 buffer each, with every parameter and its ``.grad`` a view into
them, so one launch updates every leaf. Autograd accumulates into an
existing ``.grad`` in place but replaces one that is ``None``: so the
grads are zeroed in place, never set to ``None``, and ``fused_apply``
raises when a parameter or its gradient no longer lies in its buffer.

:func:`fused_adamw_update` is the wrapper: CUDA tensors launch the kernel
(or raise), CPU tensors run :func:`fused_adamw_plain`, the kernel's
arithmetic on tensors. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from distributed_compute_pytorch_tpu_torch.ops import _build

NAME = "fused_adamw"
REPLACES = "distributed_compute_pytorch_tpu/ops/pallas/fused_adamw.py:59"
launches = 0


def fused_adamw_plain(g, p, mu, nu, *, lr, wd, c1, c2, b1, b2, eps):
    """The kernel's plain PyTorch version (reference ``_adamw_kernel``),
    in f32: returns the new ``(p, mu, nu)``. ``lr, wd, c1, c2`` are the
    step's scalars, ``c1 = 1/(1 - b1^t)`` and ``c2 = 1/(1 - b2^t)``."""
    g, p, mu, nu = (x.float() for x in (g, p, mu, nu))
    mu = b1 * mu + (1.0 - b1) * g
    nu = b2 * nu + (1.0 - b2) * g * g
    update = mu * c1 / (torch.sqrt(nu * c2) + eps) + wd * p
    return p - lr * update, mu, nu


def fused_adamw_cuda(g, p, mu, nu, *, lr, wd, c1, c2, b1, b2, eps):
    """Launch the kernel over flat buffers, updating ``p``, ``mu``, ``nu``
    in place. Raises on anything it does not take: non-CUDA or mixed
    devices, non-f32, non-contiguous, unequal sizes, unaligned storage."""
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
    lib, fn = _build.bind(NAME, "pppplfffffffffp")
    rc = fn(g.data_ptr(), p.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            p.numel(), lr, wd, c1, c2, b1, 1.0 - b1, b2, 1.0 - b2, eps,
            _build.stream_ptr(dev))
    _build.check(lib, NAME, rc)
    launches += 1


def fused_adamw_update(g, p, mu, nu, **scalars) -> None:
    """One AdamW step over flat f32 buffers, in place: the kernel on CUDA
    tensors, :func:`fused_adamw_plain` on CPU tensors."""
    if p.device.type == "cpu":
        new = fused_adamw_plain(g, p, mu, nu, **scalars)
        for dst, src in zip((p, mu, nu), new):
            dst.copy_(src)
        return
    fused_adamw_cuda(g, p, mu, nu, **scalars)


@dataclass
class FusedAdamWState:
    """``count`` (host int: the step's scalars need no device read) and
    the flat f32 buffers; ``layout`` maps each leaf name to its
    ``(offset, shape)`` in them."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor
    params: torch.Tensor
    grads: torch.Tensor
    layout: dict

    def view(self, flat, name):
        off, shape = self.layout[name]
        return flat[off:off + math.prod(shape)].view(shape)

    def moments(self) -> dict:
        """``{"mu": {name: view}, "nu": {...}}`` (checkpointing)."""
        return {k: {n: self.view(getattr(self, k), n) for n in self.layout}
                for k in ("mu", "nu")}


class FusedAdamW:
    """The transformation (reference ``fused_adamw``): ``init(params)``
    builds the flat buffers, re-pointing each tensor of ``params`` (a
    ``{name: tensor}`` dict, f32, one device) and its ``.grad`` at its
    slice; ``fused_apply(grads, state, params)`` checks that every tensor
    still lies there, then runs one update over all leaves."""

    def __init__(self, learning_rate: float | Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def scalars(self, count: int) -> dict:
        """The step's scalars from the host-side ``count`` (reference
        ``_scalars``: ``t = count + 1``, lr from the schedule at
        ``count``), with the constant hyper-parameters."""
        t = count + 1
        lr = (self.learning_rate(count) if callable(self.learning_rate)
              else self.learning_rate)
        return {"lr": float(lr), "wd": float(self.weight_decay),
                "c1": 1.0 / (1.0 - self.b1 ** t),
                "c2": 1.0 / (1.0 - self.b2 ** t),
                "b1": self.b1, "b2": self.b2, "eps": self.eps}

    def init(self, params: dict) -> FusedAdamWState:
        ps = list(params.values())
        if not ps:
            raise ValueError("fused_adamw: no parameters")
        dev = ps[0].device
        if any(p.dtype != torch.float32 or p.device != dev for p in ps):
            raise ValueError("fused_adamw keeps f32 master parameters on "
                             "one device")
        layout, off = {}, 0
        for name, p in params.items():
            layout[name] = (off, tuple(p.shape))
            off += p.numel()
        flat_p = torch.empty(off, dtype=torch.float32, device=dev)
        flat_g = torch.zeros(off, dtype=torch.float32, device=dev)
        state = FusedAdamWState(
            count=0, mu=torch.zeros_like(flat_p), nu=torch.zeros_like(flat_p),
            params=flat_p, grads=flat_g, layout=layout)
        with torch.no_grad():
            for name, p in params.items():
                view = state.view(flat_p, name)
                view.copy_(p)
                p.data = view
                p.grad = state.view(flat_g, name)
        return state

    def _check(self, grads, state, params):
        if set(params) != set(state.layout) or set(grads) != set(params):
            raise ValueError("fused_apply: params/grads do not match the "
                             "leaves init laid out")
        for name in state.layout:
            for flat, x, what in ((state.params, params[name], "parameter"),
                                  (state.grads, grads[name], "gradient")):
                view = state.view(flat, name)
                if (x is None or x.data_ptr() != view.data_ptr()
                        or x.shape != view.shape):
                    raise RuntimeError(
                        f"fused_apply: the {what} of {name!r} no longer "
                        f"lies in the optimizer's flat buffer (zero grads "
                        f"in place, never set them to None)")

    def fused_apply(self, grads: dict, state: FusedAdamWState,
                    params: dict) -> None:
        """One update of every leaf, in place (one kernel launch on CUDA),
        then ``count += 1``."""
        self._check(grads, state, params)
        fused_adamw_update(state.grads, state.params, state.mu, state.nu,
                           **self.scalars(state.count))
        state.count += 1


def fused_adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.0) -> FusedAdamW:
    """AdamW with the single-pass update kernel (reference
    ``fused_adamw``): same recurrence, bias correction and decoupled
    weight decay as ``optax.adamw`` without a decay mask."""
    return FusedAdamW(learning_rate, b1, b2, eps, weight_decay)
