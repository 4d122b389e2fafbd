"""The train and eval steps — port of
``distributed_compute_pytorch_tpu/train/step.py`` for one device.

``make_step_fns(model, tx, ...) -> (init_fn, train_step, eval_step)`` keeps
the reference's signature minus the mesh, the parallel strategy and the
multi-device knobs. PyTorch runs eagerly, so nothing is compiled and the
step updates the state in place where the reference donates it.

- Mixed precision as the reference's ``_cast_params``: the f32 master
  parameters are cast to ``compute_dtype`` inside the loss closure
  (``torch.func.functional_call``), so the forward, LayerNorm and the loss
  all run in that dtype and the casts' backward lands f32 gradients on
  the masters. (``torch.autocast`` would keep LayerNorm and the loss in
  f32; the reference does not.)
- ``accum_steps``: step-level accumulation (reference
  ``_accum_auto_step``): the batch splits into equal microbatches whose
  gradients sum in the f32 ``.grad`` of the masters, then divide by
  ``accum_steps``; the loss is the mean of the microbatch losses.
- Dropout draws from a ``torch.Generator`` on the model's device, seeded
  from ``(state.seed, state.step)``, so a run is repeatable step for step
  and a resumed run draws what the uninterrupted one would have drawn.
- The loss comes back as a device scalar, read only at the caller's log
  cadence; ``nonfinite_policy="raise"`` is the only policy (the trainer
  aborts at that read).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.func import functional_call

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


@dataclass
class TrainState:
    """Everything that evolves during training: the update count ``step``
    (which also indexes the dropout stream), the master ``params`` (the
    model's own parameters, ``{name: tensor}``), the optimizer state and
    the dropout ``seed``."""
    step: int
    params: dict
    opt_state: Any
    seed: int


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of update ``step``: a pure function of
    ``(seed, step)``, on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    return g


def make_step_fns(model, tx, *, compute_dtype=None, accum_steps: int = 1,
                  accum_dtype=None, nonfinite_policy: str = "raise"):
    """Build ``(init_fn, train_step, eval_step)`` for ``model`` (on its own
    device) and the optimizer transformation ``tx``
    (``train/optim.py::build_optimizer``)."""
    if nonfinite_policy != "raise":
        raise ValueError(f"nonfinite_policy {nonfinite_policy!r} is not "
                         f"ported: only 'raise' (abort at the log-cadence "
                         f"loss read)")
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype!r}")
    dtype = _DTYPES[compute_dtype]
    accum_steps = int(accum_steps or 1)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_dtype not in (None, "float32"):
        raise ValueError("only f32 gradient accumulation is ported")

    def _cast(params):
        if dtype is None:
            return params
        return {n: p.to(dtype) for n, p in params.items()}

    def init_fn(seed: int | None) -> TrainState:
        """A fresh state: the model's weights drawn from ``seed`` (``None``
        keeps the weights it has, e.g. loaded ones), the optimizer state
        from ``tx.init``; dropout seeded from ``seed`` (0 for ``None``)."""
        if seed is not None:
            model.init(torch.Generator().manual_seed(seed))
        params = dict(model.named_parameters())
        return TrainState(step=0, params=params,
                          opt_state=tx.init(params),
                          seed=0 if seed is None else seed)

    def _loss(state, x, y, gen):
        logits = functional_call(model, _cast(state.params), (x,),
                                 {"train": True, "generator": gen})
        return model.loss_fn(logits, y)

    def train_step(state: TrainState, x, y):
        """One optimizer update on the batch ``(x, y)``; returns ``(state,
        {"loss": device scalar})`` with ``state`` updated in place."""
        if x.shape[0] % accum_steps:
            raise ValueError(
                f"grad accumulation needs the batch ({x.shape[0]}) "
                f"divisible by accum_steps ({accum_steps})")
        for p in state.params.values():
            if p.grad is not None:
                p.grad.zero_()       # in place: fused_adamw's buffer stays
        gen = step_generator(state.seed, state.step, x.device)
        if accum_steps == 1:
            loss = _loss(state, x, y, gen)
            loss.backward()
            loss = loss.detach().float()
        else:
            losses = []
            for xm, ym in zip(x.chunk(accum_steps), y.chunk(accum_steps)):
                lm = _loss(state, xm, ym, gen)
                lm.backward()
                losses.append(lm.detach().float())
            with torch.no_grad():
                for p in state.params.values():
                    p.grad.div_(accum_steps)
            loss = torch.stack(losses).mean()
        grads = {n: p.grad for n, p in state.params.items()}
        if hasattr(tx, "fused_apply"):
            tx.fused_apply(grads, state.opt_state, state.params)
        else:
            tx.apply(grads, state.opt_state, state.params)
        state.step += 1
        return state, {"loss": loss}

    @torch.no_grad()
    def eval_step(state: TrainState, x, y, acc=None, valid=None):
        """Eval-batch sums (reference ``eval_step``): ``loss_sum``,
        ``correct`` and ``count`` as device scalars, added to ``acc`` when
        given; ``valid`` (float ``[B]``) weights out padded rows."""
        logits = functional_call(model, _cast(state.params), (x,))
        metrics = model.eval_metrics(logits, y, valid=valid)
        if acc is not None:
            metrics = {k: metrics[k] + acc[k] for k in metrics}
        return metrics

    return init_fn, train_step, eval_step
