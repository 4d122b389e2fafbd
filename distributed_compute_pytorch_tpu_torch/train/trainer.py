"""The trainer loop — port of ``distributed_compute_pytorch_tpu/train/trainer.py``,
one device a process, data-parallel over a process group.

Epoch loop -> train steps -> eval -> epoch timing -> checkpoint, with the
reference's observable contract: its flags (``core/config.py``), its line
formats (``utils/logging.py``), its dataset-derived model sizing, its
epoch-keyed data order, the loss read only at the log cadence,
divergence containment (``--nonfinite_policy``: ``raise`` aborts on a
non-finite loss at that read; ``skip`` queues each step's ``skipped``
device scalar and drains the queue at that read, :meth:`_poll_nonfinite`),
per-epoch and ``--checkpoint_every`` saves in the v1 format the JAX
package reads, and a ``--resume`` that lands on the exact next batch
(falling back past a corrupted newest file with ``--keep_last``), and
``--import_torch`` of a reference ``mnist.pt``. On the card the step is
the captured one (``train/step.py``).

Data parallelism: with ``--coordinator``/``--num_processes``/
``--process_id`` (or torchrun's environment) the trainer joins the
process group first (``core/mesh.py``); each rank feeds its rows of every
global batch (``--batch_size`` is the global batch), the step sums the
gradients over the ranks, the logged train loss is the global mean (the
reference logs a world-size-scaled sum, SURVEY §A.4), the eval sums are
all-reduced once at the end of the pass, and rank 0 alone logs and
writes the checkpoint (§A.6). Only the ConvNet trains over more than one
rank: every rank draws the global batch's dropout masks, which costs the
ConvNet nothing and GPT-2 world times its activation-sized draws.

Not in this slice: meshes and sharded strategies, heartbeats, preemption and
supervision, tracing, the flight recorder (the reference's
``flight.record`` / ``dump_on_fault`` calls around a skip or an abort
wait for the telemetry slice), the divergence sentinel and sharded
checkpoints.
"""

from __future__ import annotations

import math
import os
import time

import torch
import torch.distributed as dist

from distributed_compute_pytorch_tpu_torch import interop
from distributed_compute_pytorch_tpu_torch.core import mesh
from distributed_compute_pytorch_tpu_torch.core.config import Config
from distributed_compute_pytorch_tpu_torch.data.datasets import load_dataset
from distributed_compute_pytorch_tpu_torch.data.loader import DeviceFeeder
from distributed_compute_pytorch_tpu_torch.device import resolve_device
from distributed_compute_pytorch_tpu_torch.models.registry import build_model
from distributed_compute_pytorch_tpu_torch.train import checkpoint
from distributed_compute_pytorch_tpu_torch.train.optim import build_optimizer
from distributed_compute_pytorch_tpu_torch.train.step import make_step_fns
from distributed_compute_pytorch_tpu_torch.utils.logging import (
    MetricLogger, log0)

# nonfinite_policy=skip: abort after this many CONSECUTIVE skipped
# updates (reference NONFINITE_SKIP_LIMIT) — scattered skips are
# survivable (params stay untouched), an unbroken run means the run has
# diverged
NONFINITE_SKIP_LIMIT = 10


class Trainer:
    """End-to-end training run from a :class:`Config`, on CUDA unless the
    config asks for the CPU."""

    def __init__(self, config: Config, model=None, train_data=None,
                 eval_data=None):
        self.config = config
        cpu = config.device_name == "cpu"
        mesh.initialize_distributed(config.coordinator, config.num_processes,
                                    config.process_id,
                                    "cpu" if cpu else "cuda")
        self.device = resolve_device(config.device_name)
        rank, world = mesh.process_index(), mesh.process_count()
        if world > 1 and config.model != "convnet":
            # every rank draws the global batch's dropout masks: the
            # ConvNet's [B, 64] and [B, 128] cost nothing, GPT-2's [B, T,
            # 768] a site would cost each rank world times the draw
            raise NotImplementedError(
                f"data parallelism is ported for the ConvNet; {config.model}"
                f" over {world} ranks would draw every rank the whole "
                f"global batch's dropout masks (unmeasured)")
        self.train_data = (train_data if train_data is not None
                           else self._load("train"))
        self.eval_data = eval_data if eval_data is not None else (
            self.train_data if config.eval_on_train else self._load("test"))
        # step-level accumulation: the feeder delivers the effective batch
        # (micro x accum), steps count updates (reference :98-115)
        self.accum = max(1, int(config.grad_accum))
        self.train_feed = DeviceFeeder(self.train_data,
                                       config.batch_size * self.accum,
                                       self.device, shuffle=True,
                                       seed=config.seed, rank=rank,
                                       world=world)
        self.eval_feed = DeviceFeeder(self.eval_data, config.batch_size,
                                      self.device, shuffle=False,
                                      seed=config.seed, rank=rank,
                                      world=world)
        self.model = model if model is not None else build_model(
            config.model, device=self.device, **self._model_kwargs())
        steps = self.train_feed.steps_per_epoch
        self.tx = build_optimizer(
            config.optimizer, config.lr, gamma=config.gamma,
            steps_per_epoch=steps,
            total_steps=steps * config.epochs,
            weight_decay=config.weight_decay, clip_norm=config.clip_norm,
            warmup_steps=config.warmup_steps)
        self.init_fn, self.train_step, self.eval_step = make_step_fns(
            self.model, self.tx, compute_dtype=config.compute_dtype,
            accum_steps=self.accum,
            nonfinite_policy=config.nonfinite_policy)
        self.state = self.init_fn(config.seed)
        self.logger = MetricLogger()
        # nonfinite_policy=skip: the per-step skip flags (device scalars)
        # queued unread until the log cadence, and the running counts
        self._skip_hist: list = []
        self._skips_total = 0
        self._skips_consec = 0
        self.start_epoch = 0
        self.start_step = 0
        resumed = config.resume and os.path.isfile(config.ckpt_path)
        if resumed:
            manifest = checkpoint.restore_with_fallback(config.ckpt_path,
                                                        self.state)
            epoch = int(manifest["epoch"])
            step_in_epoch = int(manifest.get("extra", {})
                                .get("step_in_epoch", -1))
            if 0 <= step_in_epoch < steps:
                # a --checkpoint_every save: the exact next batch of the
                # deterministic epoch order
                self.start_epoch, self.start_step = epoch, step_in_epoch
                log0(f"resumed from {config.ckpt_path} at epoch {epoch} "
                     f"step {step_in_epoch}")
            else:
                self.start_epoch = epoch + 1
                log0(f"resumed from {config.ckpt_path} at epoch "
                     f"{self.start_epoch}")
        if config.import_torch and resumed:
            log0(f"resume checkpoint found; skipping --import_torch "
                 f"{config.import_torch}")
        elif config.import_torch:
            # the reference user's migration path: start from mnist.pt
            if config.model != "convnet":
                raise ValueError("--import_torch supports the reference "
                                 "ConvNet checkpoint schema (model=convnet)")
            interop.load_reference_checkpoint(self.model, config.import_torch)
            log0(f"imported torch checkpoint {config.import_torch}")
        group = f" ({dist.get_backend()})" if mesh.distributed() else ""
        log0(f"device: {self.device} | world: {world}{group} | model: "
             f"{config.model} | dataset: {self.train_data.name} | "
             f"optimizer: {config.optimizer} | compute_dtype: "
             f"{config.compute_dtype}")

    def _load(self, split: str):
        cfg = self.config
        return load_dataset(cfg.dataset, split, data_dir=cfg.data_dir)

    def _model_kwargs(self) -> dict:
        """Dataset-derived model sizing (reference ``_model_kwargs``,
        ``:356-372``): the ConvNet's classes, channels and image size;
        synthetic and tiny GPT-2 runs take the vocab and the window from
        the data."""
        cfg = self.config
        inputs = self.train_data.inputs
        if cfg.model == "convnet":
            return {"num_classes": self.train_data.num_classes,
                    "in_channels": int(inputs.shape[-1]),
                    "image_size": tuple(int(d) for d in inputs.shape[1:3])}
        kw: dict = {"preset": cfg.model_preset}
        if cfg.model_preset == "tiny" or cfg.dataset.startswith("synthetic"):
            kw["vocab_size"] = max(self.train_data.num_classes, 4)
            kw["max_seq_len"] = int(self.train_data.inputs.shape[1])
        if cfg.num_layers is not None:
            kw["num_layers"] = cfg.num_layers
        return kw

    def _save_ckpt(self, epoch: int, extra: dict | None = None) -> None:
        if not mesh.is_coordinator():
            return
        checkpoint.save(self.config.ckpt_path, self.state, epoch=epoch,
                        extra=extra, keep_last=self.config.keep_last)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_epoch(self, epoch: int, skip: int = 0) -> float:
        """One epoch from batch ``skip``; returns samples/s."""
        cfg = self.config
        t0 = time.perf_counter()
        steps = self.train_feed.steps_per_epoch
        metrics = None
        for b, (x, y) in enumerate(self.train_feed.epoch(epoch, skip=skip),
                                   start=skip):
            self.state, metrics = self.train_step(self.state, x, y)
            if "skipped" in metrics:
                self._skip_hist.append(metrics["skipped"])
            if b % cfg.log_every == 0:
                loss = float(metrics["loss"])   # the log-cadence read
                self._poll_nonfinite(loss, epoch, b)
                self.logger.train_line(epoch, b, steps, loss)
            if (cfg.checkpoint_every and (b + 1) % cfg.checkpoint_every == 0
                    and b + 1 < steps):
                self._save_ckpt(epoch, extra={"step_in_epoch": b + 1})
        if metrics is not None:
            # drain the skip flags queued since the last log line, so an
            # epoch cannot end with unexamined non-finite skips
            self._poll_nonfinite(float(metrics["loss"]), epoch, steps - 1)
        self._sync()
        secs = time.perf_counter() - t0
        return (steps - skip) * cfg.batch_size * self.accum / secs

    def _poll_nonfinite(self, loss: float, epoch: int, b: int) -> None:
        """Log-cadence divergence containment (reference
        ``_poll_nonfinite``). ``skip``: drain the queued per-step skip
        flags (settled long ago: reading them stalls nothing), log the
        running count, and give up after :data:`NONFINITE_SKIP_LIMIT`
        CONSECUTIVE skips; params are bit-untouched throughout, so the
        delayed detection is harmless. ``raise``: a non-finite loss
        aborts (the params are already poisoned)."""
        if self.config.nonfinite_policy == "skip":
            new_skips = 0
            for s in self._skip_hist:
                if float(s) > 0.0:
                    self._skips_total += 1
                    self._skips_consec += 1
                    new_skips += 1
                else:
                    self._skips_consec = 0
            self._skip_hist.clear()
            if new_skips:
                log0(f"nonfinite_policy=skip: skipped {new_skips} "
                     f"non-finite update(s) near epoch {epoch} step {b} "
                     f"(total {self._skips_total}, consecutive "
                     f"{self._skips_consec})")
            if self._skips_consec >= NONFINITE_SKIP_LIMIT:
                raise RuntimeError(
                    f"{self._skips_consec} consecutive non-finite updates "
                    f"skipped (epoch {epoch} step {b}): the run has "
                    f"diverged — params are still the last finite state; "
                    f"lower the lr or clip gradients")
        elif not math.isfinite(loss):
            raise RuntimeError(
                f"non-finite loss {loss} at epoch {epoch} step {b} "
                f"(nonfinite_policy=raise); use --nonfinite_policy skip to "
                f"drop bad updates instead of aborting")

    def evaluate(self, epoch: int) -> dict:
        """Full eval pass: sums accumulate on the device, all-reduced over
        the ranks once at the end (the reference's SUM), one read;
        padded rows weigh nothing."""
        total = None
        for x, y, valid in self.eval_feed.epoch(0, with_valid=True):
            total = self.eval_step(self.state, x, y, total, valid)
        sums = torch.zeros(3, dtype=torch.float64, device=self.device)
        if total:
            sums = torch.stack([total[k].double() for k in
                                ("loss_sum", "correct", "count")])
        if mesh.distributed():
            dist.all_reduce(sums)
        loss_sum, correct, count = sums.tolist()
        correct, count = int(correct), int(count)
        loss = loss_sum / max(count, 1)
        self.logger.eval_line(epoch, loss, correct, count)
        return {"loss": loss, "accuracy": correct / max(count, 1),
                "loss_sum": loss_sum, "correct": correct, "count": count}

    def fit(self) -> dict:
        """The epoch loop: train -> eval -> timing line -> checkpoint."""
        last_eval: dict = {}
        for epoch in range(self.start_epoch, self.config.epochs):
            skip = self.start_step if epoch == self.start_epoch else 0
            t0 = time.perf_counter()
            throughput = self.train_epoch(epoch, skip=skip)
            last_eval = self.evaluate(epoch)
            self.logger.epoch_time(epoch, time.perf_counter() - t0,
                                   throughput)
            self._save_ckpt(epoch, extra={"eval_done": True})
        return last_eval
