"""Optimizers and LR schedules — port of
``distributed_compute_pytorch_tpu/train/optim.py`` (the AdamW rungs).

A transformation here is what an ``optax.GradientTransformation`` is in
the reference, with PyTorch's in-place update: ``init(params)`` returns
the optimizer state for a ``{name: tensor}`` dict of f32 master
parameters, and ``apply(grads, state, params)`` (plain AdamW) or
``fused_apply(grads, state, params)`` (the fused kernel,
``ops/fused_adamw.py``) updates params and state in place. The learning
rate is a schedule indexed by the update count *before* the increment,
as optax's ``scale_by_learning_rate`` indexes it, so the warmup-cosine
schedule gives lr 0 to the first update.

The Adadelta/StepLR reference stack and SGD wait for the ConvNet slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from distributed_compute_pytorch_tpu_torch.ops.fused_adamw import fused_adamw


def warmup_cosine_decay(lr: float, warmup_steps: int,
                        decay_steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=lr,
    warmup_steps, decay_steps)`` (end value 0): linear from 0 to ``lr``
    over ``warmup_steps`` updates, then a cosine to 0 over the remaining
    ``decay_steps - warmup_steps``."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed "
                         f"warmup_steps ({warmup_steps})")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return -lr * frac + lr
        span = decay_steps - warmup_steps
        c = min(count - warmup_steps, span)
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / span))
    return schedule


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


@dataclass
class AdamWState:
    """``optax.adamw``'s state: the update ``count`` (a host int) and the
    f32 first and second moments by leaf name."""
    count: int
    mu: dict
    nu: dict

    def moments(self) -> dict:
        return {"mu": self.mu, "nu": self.nu}


class AdamW:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(schedule,
    weight_decay=..., mask=...))`` in plain PyTorch, in place; the global
    norm is compared on the device, so no step reads a value back."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 mask: Callable[[dict], dict] | None = None,
                 clip_norm: float = 0.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.mask, self.clip_norm = (weight_decay, mask,
                                                        clip_norm)

    def init(self, params: dict) -> AdamWState:
        return AdamWState(
            count=0, mu={n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()})

    @torch.no_grad()
    def apply(self, grads: dict, state: AdamWState, params: dict) -> None:
        gs = {n: grads[n].float() for n in params}
        if self.clip_norm > 0:
            norm = torch.sqrt(sum(g.square().sum() for g in gs.values()))
            keep = norm < self.clip_norm
            gs = {n: torch.where(keep, g, g / norm * self.clip_norm)
                  for n, g in gs.items()}
        t = state.count + 1
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        lr = (self.learning_rate(state.count)
              if callable(self.learning_rate) else self.learning_rate)
        decays = (self.mask(params) if self.mask is not None
                  else dict.fromkeys(params, True))
        for n, p in params.items():
            g, mu, nu = gs[n], state.mu[n], state.nu[n]
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * g.square())
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay and decays[n]:
                u = u + self.weight_decay * p
            p.sub_(lr * u)
        state.count += 1


def build_optimizer(name: str, lr: float, gamma: float = 0.7,
                    steps_per_epoch: int = 1, weight_decay: float = 0.0,
                    warmup_steps: int = 0, clip_norm: float = 0.0,
                    grad_accum: int = 1, total_steps: int | None = None,
                    **kw):
    """The AdamW rungs of the reference registry (``:78-180``), with its
    schedule sizing (``decay_steps = max(total, warmup + 1)``, warmup at
    least 1) and its refusal of ``adamw_fused`` with ``clip_norm``,
    ``weight_decay`` or the legacy ``grad_accum`` (step-level
    accumulation, ``make_step_fns(accum_steps=N)``, composes with both).
    ``gamma`` belongs to the Adadelta/SGD rungs, not ported yet."""
    del gamma
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
    if name not in ("adamw", "adamw_fused"):
        raise ValueError(f"optimizer {name!r} is not ported yet (adamw, "
                         f"adamw_fused)")
    eff_warmup = max(warmup_steps, 1)
    sched = warmup_cosine_decay(lr, eff_warmup, max(total, eff_warmup + 1))
    if name == "adamw_fused":
        return fused_adamw(sched, weight_decay=weight_decay, **kw)
    return AdamW(sched, weight_decay=weight_decay,
                 mask=decay_mask if weight_decay else None,
                 clip_norm=clip_norm, **kw)
