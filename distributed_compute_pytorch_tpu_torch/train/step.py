"""The train and eval steps — port of
``distributed_compute_pytorch_tpu/train/step.py``: one device a process,
data-parallel and sharded over a process group.

``make_step_fns(model, tx, mesh, strategy=..., shard_update=..., ...) ->
(init_fn, train_step, eval_step)`` keeps the reference's signature minus
the knobs of the unported axes, quantized collectives and bucketing. The
step updates the state in place where the reference donates it.

- Model state (the reference's ``model_state``: BatchNorm running stats).
  A model whose forward returns ``(out, new_stats)`` (the ConvNet) keeps
  its buffers in ``TrainState.model_state``; the step writes the new
  stats into them in place, where the update is applied (under ``skip``
  a skipped update leaves them bit-untouched, a select as the
  reference's ``_guarded``), and eval reads them.
- The optimizer's flat layout (``train/flat.py``): every master
  parameter, gradient and optimizer slot is a view of one flat f32
  buffer per unit, zeroed in place before each update.
- Data parallelism and sharding over the mesh (``core/mesh.py``,
  ``parallel/api.py``): in a process group the step is the reference's
  one SPMD program split over the ranks, each on its rows of the global
  batch; between the backward and the optimizer the gradients become the
  global batch's mean, in one of three ways:

  - replicated (DataParallel, ``shard_update`` off, a clip, or one rank
    under ``auto``): one all-reduce of the flat gradient buffer, whose
    extra slot carries the loss, then the whole update on every rank;
  - ZeRO-1 (DataParallel at a data-parallel size above 1 under ``auto``,
    or ``shard_update=True``; reference ``_zero1_update``): one
    reduce-scatter of the flat gradient into this rank's shard, the
    update of that shard (``adamw_fused``: one kernel launch on it; the
    moments exist at its size only), and one all-gather of the shard
    back into the flat masters, in place; the loss takes its own
    one-element all-reduce;
  - FSDP (``strategy=FSDP()``): only this rank's shard of each unit's
    masters and slots exists. :class:`_GatherUnit` gathers a unit in the
    compute dtype for the forward and reduce-scatters its f32 gradient
    in the backward; under ``data=D,fsdp=F`` the shard's gradient is then
    all-reduced over ``data``. Autograd saves the gathered weights for
    the backward, so they live for the whole step and nothing is gathered
    twice; the masters, moments and gradient shards are ``1/F`` a card.

  The skip guard's and the sentinel's ``grad_sumsq`` is the global sum:
  this rank's update gradients, all-reduced over the ranks that hold
  distinct shards. BatchNorm and dropout take the global batch's
  statistics and mask (``models/layers.py``). No
  ``DistributedDataParallel`` or FSDP wrapper: their hooks are built for
  eager steps. Every collective is issued by the eager warm-up before
  the capture, so every group's communicator exists when the graph
  records it.

- Mixed precision as the reference's ``_cast_params``: the f32 master
  parameters are cast to ``compute_dtype`` inside the loss closure
  (``torch.func.functional_call``), so the forward, LayerNorm and the loss
  all run in that dtype and the casts' backward lands f32 gradients on
  the masters. (``torch.autocast`` would keep LayerNorm and the loss in
  f32; the reference does not.)
- ``accum_steps``: step-level accumulation (reference
  ``_accum_auto_step``): the batch splits into equal microbatches whose
  gradients sum in the flat f32 gradient buffer, then divide by
  ``accum_steps``; the loss is the mean of the microbatch losses. The
  replicated and ZeRO-1 updates reduce once, at the boundary (the
  reference's manual path); under FSDP each microbatch's backward
  reduce-scatters into the shard's gradient, which accumulates.
- The loss: a model with a ``train_loss`` owns its objective (BERT's MLM
  masking draws before its forward; reference ``:452-453``), called as
  ``model.train_loss(x, y, generator=...) -> (loss, new_stats)``; any
  other model's forward output goes to ``model.loss_fn(out, y)``.
  Floating inputs are cast to ``compute_dtype`` first, in the train and
  the eval step, as the reference's ``_cast`` does.
- ``augment`` (``ops/augment.py::build_augment``): a ``(x, generator) ->
  x`` transform of the cast train inputs, inside the step (and so inside
  its CUDA graph), never in eval (reference ``:449-451``, ``:657-660``).
- Every random draw of an update (the augment decisions, the MLM masks,
  dropout) comes from one persistent ``torch.Generator`` on the model's
  device, in that order, re-seeded before every update from
  ``(state.seed, state.step)`` (:func:`step_seed`), so a run is
  repeatable step for step and a resumed run draws what the
  uninterrupted one would have drawn; under ``accum_steps`` each
  microbatch draws its own from the stream in turn.
- ``nonfinite_policy``: ``"raise"`` adds nothing to the step (the trainer
  aborts when its log-cadence loss read is not finite). ``"skip"`` puts
  the reference's guard (``_guarded``) into the step: ``ok = isfinite(loss)
  & isfinite(grad_sumsq)``, a device flag the optimizer applies the update
  under (``train/optim.py``), so on a bad batch params and optimizer state
  keep their bits and the device count does not advance, with no host
  branch; ``state.step`` still advances (the dropout stream moves on) and
  ``metrics["skipped"]`` is ``1.0``. ``sentinel=True`` reports
  ``metrics["grad_sumsq"]``, the f32 sum of squares of every gradient
  (one reduction over the flat gradient buffer).
- Every metric is a device scalar, read only at the caller's log cadence.
- Precision: the train and eval steps run cuDNN in full f32 with its
  deterministic algorithms (:func:`cudnn_f32`), set for the step's
  forward and backward and restored after: PyTorch's default lets
  cuDNN's convolutions run in TF32, and its default weight-gradient
  algorithm accumulates with atomics, whose last bits vary run to run.
  So every caller (the trainer, the CLI, a benchmark) runs the ConvNet
  at the precision the f32 compute dtype states, and a run repeats bit
  for bit.

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

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from distributed_compute_pytorch_tpu_torch.core import mesh as mesh_lib
from distributed_compute_pytorch_tpu_torch.parallel import collectives as coll
from distributed_compute_pytorch_tpu_torch.parallel.api import (
    FSDP, DataParallel, fsdp_units)
from distributed_compute_pytorch_tpu_torch.train.flat import FlatLayout
from distributed_compute_pytorch_tpu_torch.utils import graphs

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}
POLICIES = ("raise", "skip")


@dataclass
class TrainState:
    """Everything that evolves during training: the update count ``step``
    (which also indexes the dropout stream), the master ``params`` (the
    model's own parameters, ``{name: tensor}``; under FSDP this rank's
    unit shards, ``{unit: tensor}``: ``opt_state.param_leaves()`` gathers
    the logical ones), the optimizer state, the dropout ``seed``, the
    ``model_state`` (the model's own buffers, e.g. BatchNorm running
    stats; empty for GPT-2) and, in a process group, ``flat_grads``: the
    f32 buffer every ``.grad`` is a view of."""
    step: int
    params: dict
    opt_state: Any
    seed: int
    model_state: dict = field(default_factory=dict)
    flat_grads: torch.Tensor | None = None


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed for update ``step``: a pure function
    of ``(seed, step)``."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


@contextlib.contextmanager
def cudnn_f32():
    """cuDNN in full f32 (no TF32) with its deterministic algorithms for
    the block, the flags restored after. Autograd's device threads read
    the same process-wide flags, so a ``backward()`` inside the block
    runs under them too."""
    c = torch.backends.cudnn
    before = (c.allow_tf32, c.deterministic)
    c.allow_tf32, c.deterministic = False, True
    try:
        yield
    finally:
        c.allow_tf32, c.deterministic = before


class _TrainLoss(nn.Module):
    """``model.train_loss`` as a module's forward, so ``functional_call``
    runs it over the step's parameters (keys under ``model.``)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x, y, generator):
        return self.model.train_loss(x, y, generator=generator)


def _split(out):
    """A forward's ``(out, new_stats)``, or ``(out, {})`` for a model
    without state."""
    return out if isinstance(out, tuple) else (out, {})


class _GatherUnit(torch.autograd.Function):
    """One FSDP unit's compute weights: forward casts this rank's f32
    shard to the compute dtype and all-gathers the whole unit over the
    ``fsdp`` group; backward converts the unit's gradient to f32 and
    reduce-scatters it into the shard's gradient, divided by the group's
    size (the mean over its ranks' rows)."""

    @staticmethod
    def forward(ctx, shard, unit, layout, dtype):
        ctx.unit, ctx.layout = unit, layout
        src = shard if dtype is None else shard.to(dtype)
        full = torch.empty(unit.padded, dtype=src.dtype, device=src.device)
        coll.all_gather(full, src, layout.group)
        return full

    @staticmethod
    def backward(ctx, grad):
        unit, layout = ctx.unit, ctx.layout
        out = torch.empty(unit.shard, dtype=torch.float32,
                          device=grad.device)
        coll.reduce_scatter(out, grad.float().contiguous(), layout.group)
        return out.div_(layout.world), None, None, None


def gather_units(opt_state, dtype=None) -> dict:
    """``{name: tensor}`` of every parameter in ``dtype`` (``None``: f32)
    from an FSDP state's unit shards: one :class:`_GatherUnit` a unit,
    split into views (whose backward is one concatenation a unit)."""
    layout, out = opt_state.layout, {}
    for u in layout.units:
        full = _GatherUnit.apply(opt_state.leaves[u.name], u, layout, dtype)
        sizes = [math.prod(shape) for _, shape, _ in u.leaves]
        pieces = full.split_with_sizes(sizes + [u.padded - sum(sizes)])
        for (name, shape, _), piece in zip(u.leaves, pieces):
            out[name] = piece.view(shape)
    return out


def make_step_fns(model, tx, mesh=None, *, strategy=None,
                  shard_update: bool | None = None, compute_dtype=None,
                  accum_steps: int = 1, accum_dtype=None,
                  nonfinite_policy: str = "raise", sentinel: bool = False,
                  augment=None, _eager: bool = False):
    """Build ``(init_fn, train_step, eval_step)`` for ``model`` (on its own
    device) and the optimizer transformation ``tx``
    (``train/optim.py::build_optimizer``) over ``mesh``
    (``core/mesh.py::make_mesh``; default ``data=-1`` over this process's
    world) with ``strategy`` (``parallel/api.py``; default DataParallel).
    ``shard_update`` (the reference's tri-state): ``None`` shards the
    update ZeRO-1 style under DataParallel at a data-parallel size above
    1 when ``tx`` is elementwise; ``True`` forces it (a non-elementwise
    chain or FSDP raises; in a process group of one rank it runs the
    sharded dataflow over that rank, where the reference turns it off);
    ``False`` keeps the replicated update. On a CUDA model ``train_step``
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
    mesh = mesh if mesh is not None else mesh_lib.make_mesh("data=-1")
    strategy = strategy if strategy is not None else DataParallel()
    grouped = mesh_lib.distributed()
    fsdp = isinstance(strategy, FSDP)
    elementwise = getattr(tx, "elementwise", True)
    if fsdp and fused:
        raise ValueError(
            "fused optimizers (adamw_fused) support replicated parameters "
            "(DataParallel) only; use --optimizer adamw with sharded "
            "parameter layouts")
    if shard_update is None:
        zero1 = not fsdp and coll.dp_size(mesh) > 1 and elementwise
    else:
        zero1 = bool(shard_update)
        if zero1 and not elementwise:
            raise ValueError(
                "shard_update cannot run a non-elementwise optimizer chain "
                "(global-norm clip) on shards; drop --clip_norm or "
                "--shard_update")
        if zero1 and fsdp:
            raise ValueError(
                "shard_update applies to the DataParallel strategy only "
                "(FSDP already shards the optimizer state with the "
                "params)")
        zero1 = zero1 and grouped
    if fsdp and not grouped:
        raise ValueError("FSDP shards over a process group: join one "
                         "first (core/mesh.py::initialize_distributed)")
    world = mesh_lib.dp_world_size(mesh)
    dp_group = mesh.group(*mesh_lib.BATCH_AXES)
    fsdp_group = mesh.group(strategy.axis) if fsdp else None
    data_group = (mesh.group("data") if fsdp and mesh.size("data") > 1
                  else None)
    clip = getattr(tx, "clip_norm", 0.0) > 0
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    # the fused kernel's flag where the step has no guard
    always = torch.ones((), dtype=torch.bool, device=device)

    def _layout(params):
        if fsdp:
            return FlatLayout.of(
                params, fsdp_units(model), mode="fsdp",
                world=dist.get_world_size(fsdp_group),
                rank=dist.get_rank(fsdp_group), group=fsdp_group)
        if zero1:
            return FlatLayout.of(params, mode="zero1",
                                 world=dist.get_world_size(dp_group),
                                 rank=dist.get_rank(dp_group),
                                 group=dp_group)
        # a replicated world's gradient buffer carries the loss
        return FlatLayout.of(params, extra=1 if grouped else 0)

    def _cast(params):
        if dtype is None:
            return params
        return {n: p.to(dtype) for n, p in params.items()}

    def _cast_input(x):
        if dtype is None or not x.is_floating_point():
            return x
        return x.to(dtype)

    owner = _TrainLoss(model) if hasattr(model, "train_loss") else None

    def _compute_params(state):
        """The forward's parameters in the compute dtype: the masters
        cast, or FSDP's units gathered."""
        if fsdp:
            return gather_units(state.opt_state, dtype)
        return _cast(state.params)

    def init_fn(seed: int | None) -> TrainState:
        """A fresh state: the model's weights drawn from ``seed`` (``None``
        keeps the weights it has, e.g. loaded ones), the optimizer state
        from ``tx.init`` in the strategy's flat layout; dropout seeded
        from ``seed`` (0 for ``None``). Under FSDP the model's own
        parameters are freed: call it once a model."""
        if seed is not None:
            model.init(torch.Generator().manual_seed(seed))
        params = dict(model.named_parameters())
        opt_state = tx.init(params, _layout(params))
        return TrainState(step=0, params=opt_state.leaves,
                          opt_state=opt_state,
                          seed=0 if seed is None else seed,
                          model_state=dict(model.named_buffers()),
                          flat_grads=opt_state.grads if grouped else None)

    def _loss(state, stats, x, y):
        """The microbatch's loss and new model state, the forward reading
        the model state ``stats``: the inputs cast and augmented, then
        the model's own ``train_loss`` or ``loss_fn`` of its forward."""
        x = _cast_input(x)
        if augment is not None:
            x = augment(x, gen)
        weights = {**_compute_params(state), **stats}
        if owner is not None:
            loss, new_stats = functional_call(
                owner, {f"model.{k}": v for k, v in weights.items()},
                (x, y, gen))
            return loss, {**stats, **new_stats}
        out, new_stats = _split(functional_call(
            model, weights, (x,), {"train": True, "generator": gen}))
        return model.loss_fn(out, y), {**stats, **new_stats}

    def _mean_over_ranks(loss):
        buf = loss.reshape(1).clone()
        dist.all_reduce(buf, group=dp_group)
        return buf[0] / world

    def _reduce(opt, loss):
        """The gradients summed over the ranks and divided by the world
        size (the global batch's mean), where the strategy puts them: the
        whole flat buffer (replicated, one all-reduce that also carries
        the loss), this rank's shard (ZeRO-1, one reduce-scatter), or the
        FSDP shard, already reduce-scattered by the backward, all-reduced
        over ``data``. Returns the global mean loss."""
        if fsdp:
            if data_group is not None:
                dist.all_reduce(opt.grads, group=data_group)
                opt.grads.div_(mesh.size("data"))
            return _mean_over_ranks(loss)
        if zero1:
            coll.reduce_scatter(opt.shard_grads, opt.grads, dp_group)
            opt.shard_grads.div_(world)
            return _mean_over_ranks(loss)
        flat = opt.grads
        flat[-1].copy_(loss)
        dist.all_reduce(flat, group=dp_group)
        loss = flat[-1].clone()
        flat.div_(world)
        return loss / world

    def _sumsq(opt):
        """The global gradient sum of squares: this rank's update
        gradients, summed over the ranks that hold distinct shards."""
        gn2 = torch.dot(opt.upd_g, opt.upd_g)
        if zero1 or fsdp:
            gn2 = gn2.reshape(1)
            dist.all_reduce(gn2, group=dp_group if zero1 else fsdp_group)
            gn2 = gn2[0]
        return gn2

    @cudnn_f32()
    def _update(state: TrainState, x, y) -> dict:
        """One update's device work, from zeroing the gradients to the
        optimizer: what a capture records. Returns the metrics."""
        opt = state.opt_state
        tx.check(opt)
        opt.grads.zero_()           # in place: every .grad a view
        stats = state.model_state
        if accum_steps == 1:
            loss, stats = _loss(state, stats, x, y)
            loss.backward()
            loss = loss.detach().float()
        else:
            losses = []
            for xm, ym in zip(x.chunk(accum_steps), y.chunk(accum_steps)):
                lm, stats = _loss(state, stats, xm, ym)
                lm.backward()
                losses.append(lm.detach().float())
            with torch.no_grad():
                opt.grads.div_(accum_steps)
            loss = torch.stack(losses).mean()
        with torch.no_grad():
            if grouped:
                loss = _reduce(opt, loss)
            metrics = {"loss": loss}
            ok = gn2 = None
            if skip_guard or sentinel or clip:
                gn2 = _sumsq(opt)
                if sentinel:
                    metrics["grad_sumsq"] = gn2
            if skip_guard:
                ok = torch.isfinite(loss) & torch.isfinite(gn2)
                metrics["skipped"] = (~ok).float()
            tx.update(opt, always if fused and ok is None else ok, gn2)
            if zero1:
                coll.all_gather(opt.params, opt.upd_p, dp_group)
            for name, buf in state.model_state.items():
                if ok is None:
                    buf.copy_(stats[name])
                else:
                    torch.where(ok, stats[name], buf, out=buf)
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
    @cudnn_f32()
    def eval_step(state: TrainState, x, y, acc=None, valid=None):
        """Eval-batch sums (reference ``eval_step``): ``loss_sum``,
        ``correct`` and ``count`` as device scalars, added to ``acc`` when
        given; ``valid`` (float ``[B]``) weights out padded rows. The
        forward reads the state's model state in eval mode (under FSDP
        every rank gathers the units, so every rank calls it). Under data
        parallelism the sums are this rank's: the caller all-reduces them
        once a pass."""
        out, _ = _split(functional_call(
            model, {**_compute_params(state), **state.model_state},
            (_cast_input(x),)))
        metrics = model.eval_metrics(out, y, valid=valid)
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
