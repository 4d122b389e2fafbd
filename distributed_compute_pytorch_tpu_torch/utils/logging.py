"""Structured logging — port of
``distributed_compute_pytorch_tpu/utils/logging.py`` for one process: the
reference-format stdout lines (the JSONL sink and the metrics registry
wait for the telemetry slice)."""

from __future__ import annotations

import sys


def log0(*args, **kw) -> None:
    """``print`` and flush (one process: it is the coordinator)."""
    print(*args, **kw)
    sys.stdout.flush()


class MetricLogger:
    """The reference's stdout lines, in its format."""

    def train_line(self, epoch: int, step: int, steps_per_epoch: int,
                   loss: float) -> None:
        pct = 100.0 * step / steps_per_epoch
        log0(f"epoch: {epoch} [{step}/{steps_per_epoch} ({pct:.0f}%)]\t "
             f"Loss:{loss:.6f}")

    def eval_line(self, epoch: int, loss: float, correct: int,
                  total: int) -> None:
        del epoch
        acc = 100.0 * correct / max(total, 1)
        log0(f"\nTest set: Average loss: {loss:.4f}, "
             f"Accuracy: {correct}/{total} ({acc:.0f}%)\n")

    def epoch_time(self, epoch: int, seconds: float,
                   samples_per_sec: float) -> None:
        del epoch
        log0(f"time to complete this epoch: {seconds} seconds "
             f"({samples_per_sec:.1f} samples/s)")
