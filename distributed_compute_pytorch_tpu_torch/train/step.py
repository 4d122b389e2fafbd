"""The train and eval steps — port of
``distributed_compute_pytorch_tpu/train/step.py`` for one device.

``make_step_fns(model, tx, ...) -> (init_fn, train_step, eval_step)`` keeps
the reference's signature minus the mesh, the parallel strategy and the
multi-device knobs. The step updates the state in place where the
reference donates it.

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
- Dropout draws from one persistent ``torch.Generator`` on the model's
  device, re-seeded before every update from ``(state.seed, state.step)``
  (:func:`step_seed`), so a run is repeatable step for step and a resumed
  run draws what the uninterrupted one would have drawn.
- ``nonfinite_policy``: ``"raise"`` adds nothing to the step (the trainer
  aborts when its log-cadence loss read is not finite). ``"skip"`` puts
  the reference's guard (``_guarded``) into the step: ``ok = isfinite(loss)
  & isfinite(grad_sumsq)``, a device flag the optimizer applies the update
  under (``train/optim.py``), so on a bad batch params and optimizer state
  keep their bits and the device count does not advance, with no host
  branch; ``state.step`` still advances (the dropout stream moves on) and
  ``metrics["skipped"]`` is ``1.0``. ``sentinel=True`` reports
  ``metrics["grad_sumsq"]``, the f32 sum of squares of every gradient (one
  reduction over the flat gradient buffer under ``adamw_fused``).
- Every metric is a device scalar, read only at the caller's log cadence.

**The captured step.** The reference's step is one compiled program
(``jax.jit``); on a CUDA model the port's is one CUDA graph. A batch
shape's first update runs eagerly (kernels loaded, cuBLAS set up, every
``.grad`` allocated) and then returns the blocks its activations left in
PyTorch's cache to the device (``torch.cuda.empty_cache``): the graph
allocates from a private pool of its own and would never reuse them, so
without that the captured step would reserve its activations twice. The
second update captures the whole update (zeroing, forward, backward,
guard, optimizer) on a side stream (``utils/graphs.py::capture``) over
static input buffers, and every update from then on copies the batch into
those buffers in stream order and replays the graph. The dropout generator is registered with the graph
and re-seeded before each replay, so the captured and the eager update
draw the same bits. The metrics come back as fresh tensors copied from
the graph's outputs after each replay. The graph holds the state's
tensors by address, so restoring a checkpoint copies into them in place
(``train/checkpoint.py``) and a state other than the one it captured is
refused. Nothing falls back: a capture or replay that fails raises. The
eager step stays as the private reference (``_eager=True``); a CPU model
always runs it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.func import functional_call

from distributed_compute_pytorch_tpu_torch.utils import graphs

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}
POLICIES = ("raise", "skip")


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


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed for update ``step``: a pure function
    of ``(seed, step)``."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def grad_sumsq(grads, flat=None) -> torch.Tensor:
    """The f32 sum of squares of every gradient (reference
    ``_grad_sumsq``): one reduction over ``flat`` (the optimizer's flat
    gradient buffer) where given, else one a leaf, summed."""
    if flat is not None:
        return torch.dot(flat, flat)
    return torch.stack([torch.dot(g.reshape(-1).float(),
                                  g.reshape(-1).float())
                        for g in grads]).sum()


def make_step_fns(model, tx, *, compute_dtype=None, accum_steps: int = 1,
                  accum_dtype=None, nonfinite_policy: str = "raise",
                  sentinel: bool = False, _eager: bool = False):
    """Build ``(init_fn, train_step, eval_step)`` for ``model`` (on its own
    device) and the optimizer transformation ``tx``
    (``train/optim.py::build_optimizer``). On a CUDA model ``train_step``
    is the captured step (module docstring); ``_eager`` keeps it eager."""
    if nonfinite_policy not in POLICIES:
        raise ValueError(f"nonfinite_policy must be 'raise' or 'skip', got "
                         f"{nonfinite_policy!r}")
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype!r}")
    dtype = _DTYPES[compute_dtype]
    accum_steps = int(accum_steps or 1)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_dtype not in (None, "float32"):
        raise ValueError("only f32 gradient accumulation is ported")
    skip_guard = nonfinite_policy == "skip"
    fused = hasattr(tx, "fused_apply")
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    # the fused kernel's flag where the step has no guard
    always = torch.ones((), dtype=torch.bool, device=device)

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

    def _loss(state, x, y):
        logits = functional_call(model, _cast(state.params), (x,),
                                 {"train": True, "generator": gen})
        return model.loss_fn(logits, y)

    def _update(state: TrainState, x, y) -> dict:
        """One update's device work, from zeroing the gradients to the
        optimizer: what a capture records. Returns the metrics."""
        if fused:
            state.opt_state.grads.zero_()   # in place: every .grad a view
        else:
            for p in state.params.values():
                if p.grad is not None:
                    p.grad.zero_()
        if accum_steps == 1:
            loss = _loss(state, x, y)
            loss.backward()
            loss = loss.detach().float()
        else:
            losses = []
            for xm, ym in zip(x.chunk(accum_steps), y.chunk(accum_steps)):
                lm = _loss(state, xm, ym)
                lm.backward()
                losses.append(lm.detach().float())
            with torch.no_grad():
                for p in state.params.values():
                    p.grad.div_(accum_steps)
            loss = torch.stack(losses).mean()
        grads = {n: p.grad for n, p in state.params.items()}
        metrics = {"loss": loss}
        ok = None
        if skip_guard or sentinel:
            gn2 = grad_sumsq(grads.values(), state.opt_state.grads
                             if fused else None)
            if sentinel:
                metrics["grad_sumsq"] = gn2
        if skip_guard:
            ok = torch.isfinite(loss) & torch.isfinite(gn2)
            metrics["skipped"] = (~ok).float()
        if fused:
            tx.fused_apply(grads, state.opt_state, state.params,
                           always if ok is None else ok)
        else:
            tx.apply(grads, state.opt_state, state.params, ok)
        return metrics

    def _check_batch(x):
        if x.shape[0] % accum_steps:
            raise ValueError(
                f"grad accumulation needs the batch ({x.shape[0]}) "
                f"divisible by accum_steps ({accum_steps})")

    def eager_step(state: TrainState, x, y):
        """One optimizer update on the batch ``(x, y)``; returns ``(state,
        metrics)`` with ``state`` updated in place and every metric a
        device scalar: ``loss``, and ``skipped`` (policy ``skip``) and
        ``grad_sumsq`` (``sentinel``)."""
        _check_batch(x)
        gen.manual_seed(step_seed(state.seed, state.step))
        metrics = _update(state, x, y)
        state.step += 1
        return state, metrics

    if _eager or not _captures(device):
        train_step = eager_step
    else:
        train_step = CapturedStep(eager_step, _update, gen, _check_batch)

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


def _captures(device) -> bool:
    """Whether a model on ``device`` gets the captured step: CUDA only."""
    return device.type == "cuda"


class _Captured:
    """One batch shape's graph: its static inputs and outputs and the
    optimizer state it updates."""

    def __init__(self, program, x, y, outputs: dict, opt_state):
        self.program, self.x, self.y = program, x, y
        self.outputs, self.opt_state = outputs, opt_state


class CapturedStep:
    """The train step of a CUDA model as a CUDA graph (module docstring):
    called as ``train_step(state, x, y) -> (state, metrics)``, like the
    eager step. ``stats``: eager updates, captures, replays and each
    capture's ms; ``programs``: the captured graph of each batch shape,
    keyed by the shapes and dtypes of ``x`` and ``y``."""

    def __init__(self, eager_step, update, generator, check_batch):
        self._eager_step, self._update = eager_step, update
        self._gen, self._check_batch = generator, check_batch
        self._seen: set = set()
        self.programs: dict = {}
        self.stats = {"eager_steps": 0, "graph_captures": 0,
                      "graph_replays": 0, "capture_ms": []}

    def __call__(self, state: TrainState, x, y):
        key = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype)
        cap = self.programs.get(key)
        if cap is None and key not in self._seen:
            # the warm-up: kernels loaded, cuBLAS set up, every .grad made;
            # its cached activations go back before the graph's pool forms
            self._seen.add(key)
            self.stats["eager_steps"] += 1
            out = self._eager_step(state, x, y)
            torch.cuda.empty_cache()
            return out
        if cap is None:
            cap = self.programs[key] = self._capture(state, x, y)
        elif state.opt_state is not cap.opt_state:
            raise ValueError("the captured train step updates the state it "
                             "captured: build new step functions for "
                             "another TrainState")
        cap.x.copy_(x)
        cap.y.copy_(y)
        self._gen.manual_seed(step_seed(state.seed, state.step))
        cap.program.replay()
        self.stats["graph_replays"] += 1
        state.step += 1
        return state, {k: v.clone() for k, v in cap.outputs.items()}

    def _capture(self, state: TrainState, x, y) -> _Captured:
        self._check_batch(x)
        sx, sy = torch.empty_like(x), torch.empty_like(y)
        outputs: dict = {}
        program = graphs.capture(
            lambda: outputs.update(self._update(state, sx, sy)),
            generators=(self._gen,))
        self.stats["graph_captures"] += 1
        self.stats["capture_ms"].append(program.capture_ms)
        return _Captured(program, sx, sy, outputs, state.opt_state)
