"""Optimizers and LR schedules — port of
``distributed_compute_pytorch_tpu/train/optim.py``: the reference's
Adadelta + StepLR stack, SGD with momentum, and the AdamW rungs.

A transformation here is what an ``optax.GradientTransformation`` is in
the reference, with PyTorch's in-place update over one flat layout
(``train/flat.py``, the same for every optimizer): ``init(params,
layout)`` lays a ``{name: tensor}`` dict of f32 master parameters, their
gradients and the optimizer's slots out as flat f32 buffers, whole or
sharded over ranks (ZeRO-1, FSDP), and ``update(state, ok)`` updates the
flat masters in place (``apply(grads, state, params)`` from a dict of
gradients; ``fused_apply`` for the fused kernel, ``ops/fused_adamw.py``).
The learning
rate is a schedule indexed by the update count *before* the increment,
as optax's ``scale_by_learning_rate`` indexes it, so the warmup-cosine
schedule gives lr 0 to the first update.

The count is a device ``int32``, as optax keeps it: the schedule and the
bias corrections are evaluated from it on the device in f32, as optax
evaluates them inside the jitted step, so a step reads nothing back and
passes nothing by value that changes from step to step (a captured CUDA
graph replays each step with its own lr). Every update takes a device
bool flag ``ok``, the non-finite guard of ``train/step.py`` (optional
except for the fused kernel; the unguarded update runs in place): where
it is false, params and moments keep their bits and the count does not
advance (the reference's ``where`` against the incoming state).

``adadelta`` is ``optax.chain(scale_by_adadelta(rho, eps),
scale_by_schedule(-steplr))`` and ``sgd`` ``optax.chain(trace(0.9),
scale_by_schedule(-steplr))``, with the StepLR rate ``lr * gamma **
(count // steps_per_epoch)`` from the device count before the increment,
so a captured step replays the right rate after an epoch boundary.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from distributed_compute_pytorch_tpu_torch.ops.fused_adamw import fused_adamw
from distributed_compute_pytorch_tpu_torch.train.flat import (
    FlatOptimizer, FlatState)


def warmup_cosine_decay(lr: float, warmup_steps: int, decay_steps: int):
    """``optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=lr,
    warmup_steps, decay_steps)`` (end value 0): linear from 0 to ``lr``
    over ``warmup_steps`` updates, then a cosine to 0 over the remaining
    ``decay_steps - warmup_steps``. The schedule takes a host int (a
    Python float back) or an ``int32`` count tensor: then it is evaluated
    on the count's device in f32 with ``torch.where`` / ``torch.cos``, as
    optax's ``join_schedules`` of a linear and a cosine schedule is inside
    the jitted step, and gives an f32 scalar tensor. The warm-up's
    ``-lr * frac + lr`` is taken as ``lr * (1 - frac)``, the one rounding
    that XLA's fused multiply-add makes of it."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed "
                         f"warmup_steps ({warmup_steps})")
    span = decay_steps - warmup_steps

    def on_device(count: torch.Tensor) -> torch.Tensor:
        frac = 1.0 - count.clamp(0, warmup_steps).float() / warmup_steps
        warm = lr * (1.0 - frac)
        c = (count - warmup_steps).clamp(max=span).float()
        cosine = lr * (0.5 * (1.0 + torch.cos(math.pi * c / span)))
        return torch.where(count < warmup_steps, warm, cosine)

    def schedule(count):
        if isinstance(count, torch.Tensor):
            return on_device(count)
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return -lr * frac + lr
        c = min(count - warmup_steps, span)
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / span))
    return schedule


def steplr(lr: float, gamma: float, steps_per_epoch: int):
    """``StepLR(step_size=1, gamma)`` indexed by update count (reference
    ``:25-36``): ``lr * gamma ** (count // steps_per_epoch)``. A host int
    gives a Python float; an ``int32`` count tensor gives an f32 scalar
    evaluated on its device, as the jitted step evaluates it."""
    if steps_per_epoch < 1:
        raise ValueError(f"steps_per_epoch must be >= 1, got "
                         f"{steps_per_epoch}")

    def schedule(count):
        if isinstance(count, torch.Tensor):
            epoch = torch.div(count, steps_per_epoch,
                              rounding_mode="floor").float()
            return lr * torch.full((), gamma, device=count.device) ** epoch
        return lr * gamma ** (count // steps_per_epoch)
    return schedule


class _Scheduled(FlatOptimizer):
    """An elementwise update ``p <- p - lr(count) * u`` with slot state, in
    place over the flat buffers (``train/flat.py``); subclasses give the
    slot kinds and :meth:`_step`, the new slots and ``u`` from a gradient
    and the old slots."""

    def __init__(self, learning_rate):
        self.learning_rate = learning_rate

    def _step(self, g, slots: tuple) -> tuple:
        raise NotImplementedError

    @torch.no_grad()
    def update(self, state: FlatState, ok: torch.Tensor | None = None,
               gn2: torch.Tensor | None = None) -> None:
        del gn2
        lr = self.learning_rate(state.count)
        p = state.upd_p
        old = tuple(state.slots[k] for k in self.kinds)
        *new, u = self._step(state.upd_g, old)
        for dst, val in zip((p, *old), (p - lr * u, *new)):
            if ok is None:
                dst.copy_(val)
            else:
                torch.where(ok, val, dst, out=dst)
        state.count.add_(1 if ok is None else ok.to(state.count.dtype))


class Adadelta(_Scheduled):
    """``optax.scale_by_adadelta(rho, eps)`` (torch's recurrence) then
    ``scale_by_schedule(-lr)``: ``e_g <- rho e_g + (1-rho) g^2``, ``u =
    sqrt(e_x + eps) / sqrt(e_g + eps) * g``, ``e_x <- rho e_x + (1-rho)
    u^2``, ``p <- p - lr u``."""

    kinds = ("e_g", "e_x")

    def __init__(self, learning_rate, rho: float = 0.9, eps: float = 1e-6):
        super().__init__(learning_rate)
        self.rho, self.eps = rho, eps

    def _step(self, g, slots):
        e_g, e_x = slots
        rho, eps = self.rho, self.eps
        new_e_g = (1 - rho) * g.square() + rho * e_g
        u = torch.sqrt(e_x + eps) / torch.sqrt(new_e_g + eps) * g
        new_e_x = (1 - rho) * u.square() + rho * e_x
        return new_e_g, new_e_x, u


class SGD(_Scheduled):
    """``optax.trace(decay=momentum)`` (no dampening, no Nesterov) then
    ``scale_by_schedule(-lr)``: ``t <- g + momentum t``, ``p <- p - lr
    t``."""

    kinds = ("trace",)

    def __init__(self, learning_rate, momentum: float = 0.9):
        super().__init__(learning_rate)
        self.momentum = momentum

    def _step(self, g, slots):
        t = g + self.momentum * slots[0]
        return t, t


def decay_mask(params: dict) -> dict:
    """Standard AdamW decay exclusion by leaf (reference ``:48-67``): the
    JAX package's ``kernel`` and ``embedding`` leaves decay, its ``bias``
    and norm ``scale`` leaves do not. In the port's names those are the
    ``weight`` of a Dense or an Embedding (decay) against every ``bias``
    and the ``weight`` of a LayerNorm, whose modules are named ``ln*``."""
    def decays(name: str) -> bool:
        *owner, leaf = name.split(".")
        return leaf == "weight" and not (owner and owner[-1].startswith("ln"))
    return {name: decays(name) for name in params}


class AdamW(FlatOptimizer):
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(schedule,
    weight_decay=..., mask=...))`` in plain PyTorch over the flat buffers
    (``train/flat.py``), in place; the decay mask is one 0/1 per element
    (``FlatState.decay``), and the global norm is compared on the device,
    so no step reads a value back. With a clip the update is not
    elementwise: a shard cannot run it alone."""

    kinds = ("mu", "nu")

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 mask: Callable[[dict], dict] | None = None,
                 clip_norm: float = 0.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.mask, self.clip_norm = (weight_decay, mask,
                                                        clip_norm)
        self.elementwise = clip_norm <= 0

    def decay_leaves(self, params: dict) -> dict | None:
        if not self.weight_decay or self.mask is None:
            return None
        return self.mask(params)

    @torch.no_grad()
    def update(self, state: FlatState, ok: torch.Tensor | None = None,
               gn2: torch.Tensor | None = None) -> None:
        """One update, in place. With a device bool ``ok`` it applies
        where ``ok`` holds: a select against the old moments and params
        written straight back, not a host branch, and the count advances
        by ``ok``. ``None``: no guard, the in-place update alone. The clip
        reads ``gn2`` (the step's global sum of squares) where given."""
        g, p = state.upd_g, state.upd_p
        mu, nu = state.slots["mu"], state.slots["nu"]
        if self.clip_norm > 0:
            norm = torch.sqrt(torch.dot(g, g) if gn2 is None else gn2)
            g = torch.where(norm < self.clip_norm, g,
                            g / norm * self.clip_norm)
        dev = state.count.device
        t = state.count.float() + 1.0
        bc1 = 1.0 - torch.full((), self.b1, device=dev) ** t
        bc2 = 1.0 - torch.full((), self.b2, device=dev) ** t
        lr = (self.learning_rate(state.count)
              if callable(self.learning_rate) else self.learning_rate)
        if ok is None:
            new_mu = mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            new_nu = nu.mul_(self.b2).add_((1.0 - self.b2) * g.square())
        else:
            new_mu = self.b1 * mu + (1.0 - self.b1) * g
            new_nu = self.b2 * nu + (1.0 - self.b2) * g.square()
        u = (new_mu / bc1) / (torch.sqrt(new_nu / bc2) + self.eps)
        if self.weight_decay:
            wd = self.weight_decay * p
            u = u + (wd if state.decay is None else wd * state.decay)
        if ok is None:
            p.sub_(lr * u)
        else:
            for dst, new in ((p, p - lr * u), (mu, new_mu), (nu, new_nu)):
                torch.where(ok, new, dst, out=dst)
        state.count.add_(1 if ok is None else ok.to(state.count.dtype))


def build_optimizer(name: str, lr: float, gamma: float = 0.7,
                    steps_per_epoch: int = 1, weight_decay: float = 0.0,
                    warmup_steps: int = 0, clip_norm: float = 0.0,
                    grad_accum: int = 1, total_steps: int | None = None,
                    **kw):
    """The reference registry (``:78-180``): ``adadelta`` and ``sgd``
    (``momentum``, default 0.9) with StepLR(``gamma``) over
    ``steps_per_epoch``; the AdamW rungs with the reference's schedule
    sizing (``decay_steps = max(total, warmup + 1)``, warmup at least 1)
    and its refusal of ``adamw_fused`` with ``clip_norm``,
    ``weight_decay`` or the legacy ``grad_accum`` (step-level
    accumulation, ``make_step_fns(accum_steps=N)``, composes with
    every optimizer). ``clip_norm`` and ``weight_decay`` belong to
    ``adamw`` here."""
    total = steps_per_epoch * 10 if total_steps is None else total_steps
    if name == "adamw_fused" and (clip_norm > 0 or grad_accum > 1
                                  or weight_decay > 0):
        raise ValueError(
            "adamw_fused has no decay-mask path (weight_decay would hit "
            "biases and norm scales too) and no clip; use --optimizer "
            "adamw with --clip_norm/--weight_decay. For gradient "
            "accumulation use the step-level path (--grad_accum via the "
            "trainer / make_step_fns accum_steps), which composes with "
            "adamw_fused")
    if grad_accum > 1:
        raise ValueError("build_optimizer(grad_accum>1), the reference's "
                         "legacy optax.MultiSteps path, is not ported: use "
                         "step-level accumulation (make_step_fns "
                         "accum_steps)")
    if name in ("adadelta", "sgd"):
        if clip_norm > 0 or weight_decay > 0:
            raise ValueError(f"{name}: --clip_norm and --weight_decay are "
                             f"ported for adamw only")
        sched = steplr(lr, gamma, steps_per_epoch)
        if name == "adadelta":
            return Adadelta(sched, **kw)
        return SGD(sched, momentum=kw.pop("momentum", 0.9), **kw)
    if name not in ("adamw", "adamw_fused"):
        raise ValueError(f"optimizer {name!r} is not ported yet (adadelta, "
                         f"sgd, adamw, adamw_fused)")
    eff_warmup = max(warmup_steps, 1)
    sched = warmup_cosine_decay(lr, eff_warmup, max(total, eff_warmup + 1))
    if name == "adamw_fused":
        return fused_adamw(sched, weight_decay=weight_decay, **kw)
    return AdamW(sched, weight_decay=weight_decay,
                 mask=decay_mask if weight_decay else None,
                 clip_norm=clip_norm, **kw)
