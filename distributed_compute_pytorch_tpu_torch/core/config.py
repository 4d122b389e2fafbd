"""Run configuration — the subset of
``distributed_compute_pytorch_tpu/core/config.py`` the port's trainer
takes, under the reference's flag names.

Defaults differ where the reference's do not run here yet: the model is
``gpt2``, the dataset ``synthetic-lm`` and the optimizer ``adamw``.
``--device`` (``cuda`` or ``cpu``) is new; ``--force-cpu`` keeps its
reference meaning. A flag of the reference that the port does not take
yet ends the run with a one-line error naming it: none is ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


@dataclass
class Config:
    """All knobs of a port training run."""

    batch_size: int = 128
    lr: float = 1e-3
    epochs: int = 20
    force_cpu: bool = False
    device: str | None = None       # None = cuda (raises without a card)

    model: str = "gpt2"
    model_preset: str | None = None
    num_layers: int | None = None
    dataset: str = "synthetic-lm"
    optimizer: str = "adamw"

    log_every: int = 10
    seed: int = 0

    ckpt_path: str = "checkpoint.npz"
    resume: bool = False
    keep_last: int = 1
    checkpoint_every: int = 0
    nonfinite_policy: str = "raise"

    compute_dtype: str = "float32"
    weight_decay: float = 0.0
    clip_norm: float = 0.0
    grad_accum: int = 1
    warmup_steps: int = 0

    eval_on_train: bool = False

    @property
    def device_name(self) -> str | None:
        return "cpu" if self.force_cpu else self.device

    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(
            description="single-GPU trainer of the PyTorch/CUDA port "
                        "(the dcp-train subset)", allow_abbrev=False)
        p.add_argument("--batch_size", type=int, default=cls.batch_size)
        p.add_argument("--lr", type=float, default=cls.lr)
        p.add_argument("--epochs", type=int, default=cls.epochs)
        p.add_argument("--force-cpu", action="store_true", dest="force_cpu",
                       help="run on the CPU (same as --device cpu)")
        p.add_argument("--device", type=str, default=None,
                       choices=("cuda", "cpu"),
                       help="cuda (default; raises without a card) or cpu")
        p.add_argument("--model", type=str, default=cls.model,
                       choices=("gpt2",))
        p.add_argument("--model_preset", type=str, default=None,
                       choices=("tiny", "small"))
        p.add_argument("--num_layers", type=int, default=None)
        p.add_argument("--dataset", type=str, default=cls.dataset,
                       choices=("synthetic-lm",))
        p.add_argument("--optimizer", type=str, default=cls.optimizer,
                       choices=("adamw", "adamw_fused"))
        p.add_argument("--log_every", type=int, default=cls.log_every)
        p.add_argument("--seed", type=int, default=cls.seed)
        p.add_argument("--ckpt_path", type=str, default=cls.ckpt_path)
        p.add_argument("--resume", action="store_true")
        p.add_argument("--keep_last", type=int, default=cls.keep_last)
        p.add_argument("--checkpoint_every", type=int,
                       default=cls.checkpoint_every)
        p.add_argument("--nonfinite_policy", type=str,
                       default=cls.nonfinite_policy,
                       choices=("raise", "skip"))
        p.add_argument("--compute_dtype", type=str,
                       default=cls.compute_dtype,
                       choices=("float32", "bfloat16"))
        p.add_argument("--weight_decay", type=float,
                       default=cls.weight_decay)
        p.add_argument("--clip_norm", type=float, default=cls.clip_norm)
        p.add_argument("--grad_accum", type=int, default=cls.grad_accum)
        p.add_argument("--warmup_steps", type=int, default=cls.warmup_steps)
        p.add_argument("--eval_on_train", action="store_true")
        return p

    @classmethod
    def from_argv(cls, argv: list[str] | None = None) -> "Config":
        ns, rest = cls.parser().parse_known_args(argv)
        if rest:
            flag = next((a for a in rest if a.startswith("-")), rest[0])
            raise SystemExit(f"dcp-train (port): {flag.split('=')[0]} is "
                             f"not supported by the port yet")
        return cls(**{f.name: getattr(ns, f.name)
                      for f in dataclasses.fields(cls)})
