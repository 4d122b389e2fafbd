"""The trainer loop — port of ``distributed_compute_pytorch_tpu/train/trainer.py``
for one device.

Epoch loop -> train steps -> eval -> epoch timing -> checkpoint, with the
reference's observable contract: its flags (``core/config.py``), its line
formats (``utils/logging.py``), its dataset-derived model sizing, its
epoch-keyed data order, the loss read only at the log cadence (a
non-finite loss there aborts: ``nonfinite_policy=raise``), per-epoch and
``--checkpoint_every`` saves in the v1 format the JAX package reads, and a
``--resume`` that lands on the exact next batch (falling back past a
corrupted newest file with ``--keep_last``).

Not in this slice: meshes and strategies, heartbeats, preemption and
supervision, tracing, the flight recorder, the divergence sentinel and
sharded checkpoints.
"""

from __future__ import annotations

import math
import os
import time

import torch

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


class Trainer:
    """End-to-end training run from a :class:`Config`, on CUDA unless the
    config asks for the CPU."""

    def __init__(self, config: Config, model=None, train_data=None,
                 eval_data=None):
        self.config = config
        self.device = resolve_device(config.device_name)
        self.train_data = (train_data if train_data is not None
                           else load_dataset(config.dataset, "train"))
        self.eval_data = eval_data if eval_data is not None else (
            self.train_data if config.eval_on_train
            else load_dataset(config.dataset, "test"))
        # step-level accumulation: the feeder delivers the effective batch
        # (micro x accum), steps count updates (reference :98-115)
        self.accum = max(1, int(config.grad_accum))
        self.train_feed = DeviceFeeder(self.train_data,
                                       config.batch_size * self.accum,
                                       self.device, shuffle=True,
                                       seed=config.seed)
        self.eval_feed = DeviceFeeder(self.eval_data, config.batch_size,
                                      self.device, shuffle=False,
                                      seed=config.seed)
        self.model = model if model is not None else build_model(
            config.model, device=self.device, **self._model_kwargs())
        steps = self.train_feed.steps_per_epoch
        self.tx = build_optimizer(
            config.optimizer, config.lr, steps_per_epoch=steps,
            total_steps=steps * config.epochs,
            weight_decay=config.weight_decay, clip_norm=config.clip_norm,
            warmup_steps=config.warmup_steps)
        self.init_fn, self.train_step, self.eval_step = make_step_fns(
            self.model, self.tx, compute_dtype=config.compute_dtype,
            accum_steps=self.accum,
            nonfinite_policy=config.nonfinite_policy)
        self.state = self.init_fn(config.seed)
        self.logger = MetricLogger()
        self.start_epoch = 0
        self.start_step = 0
        if config.resume and os.path.isfile(config.ckpt_path):
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
        log0(f"device: {self.device} | model: {config.model} | dataset: "
             f"{self.train_data.name} | optimizer: {config.optimizer} | "
             f"compute_dtype: {config.compute_dtype}")

    def _model_kwargs(self) -> dict:
        """Dataset-derived model sizing (reference ``_model_kwargs``):
        synthetic and tiny runs take the vocab and the window from the
        data."""
        cfg = self.config
        kw: dict = {"preset": cfg.model_preset}
        if cfg.model_preset == "tiny" or cfg.dataset.startswith("synthetic"):
            kw["vocab_size"] = max(self.train_data.num_classes, 4)
            kw["max_seq_len"] = int(self.train_data.inputs.shape[1])
        if cfg.num_layers is not None:
            kw["num_layers"] = cfg.num_layers
        return kw

    def _save_ckpt(self, epoch: int, extra: dict | None = None) -> None:
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
            if b % cfg.log_every == 0:
                loss = float(metrics["loss"])   # the log-cadence read
                self._check_finite(loss, epoch, b)
                self.logger.train_line(epoch, b, steps, loss)
            if (cfg.checkpoint_every and (b + 1) % cfg.checkpoint_every == 0
                    and b + 1 < steps):
                self._save_ckpt(epoch, extra={"step_in_epoch": b + 1})
        if metrics is not None:
            self._check_finite(float(metrics["loss"]), epoch, steps - 1)
        self._sync()
        secs = time.perf_counter() - t0
        return (steps - skip) * cfg.batch_size * self.accum / secs

    @staticmethod
    def _check_finite(loss: float, epoch: int, b: int) -> None:
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss} at epoch {epoch} "
                               f"step {b} (nonfinite_policy=raise)")

    def evaluate(self, epoch: int) -> dict:
        """Full eval pass: sums accumulate on the device, one read at the
        end; padded rows weigh nothing."""
        total = None
        for x, y, valid in self.eval_feed.epoch(0, with_valid=True):
            total = self.eval_step(self.state, x, y, total, valid)
        loss_sum = float(total["loss_sum"]) if total else 0.0
        correct = int(total["correct"]) if total else 0
        count = int(total["count"]) if total else 0
        loss = loss_sum / max(count, 1)
        self.logger.eval_line(epoch, loss, correct, count)
        return {"loss": loss, "accuracy": correct / max(count, 1)}

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
