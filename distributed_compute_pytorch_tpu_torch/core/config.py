"""Run configuration — the subset of
``distributed_compute_pytorch_tpu/core/config.py`` the port's trainer
takes, under the reference's flag names.

The defaults are the reference's workload: the ``convnet`` on ``mnist``
(its synthetic stand-in when the idx files are not under ``--data_dir``)
with ``adadelta`` and StepLR ``--gamma 0.7``; ``--model gpt2 --dataset
synthetic-lm --optimizer adamw`` selects the transformer rung, ``--model
resnet18 --dataset cifar10 --augment flip-crop --optimizer sgd`` and
``--model resnet50`` the ResNet rungs, ``--model bert --dataset
synthetic-lm`` the MLM rung, ``--model llama --dataset synthetic-lm`` the
Llama decoder.
``--device`` (``cuda`` or ``cpu``) is new; ``--force-cpu`` keeps its
reference meaning. ``--coordinator host:port --num_processes N
--process_id R`` (or torchrun's environment) makes the run rank R of a
data-parallel world of N (``core/mesh.py``). A flag of the reference that
the port does not take yet ends the run with a one-line error naming it:
none is ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass

# reference flags of the sharded trainer the port refuses, by their
# ROADMAP queue item
QUEUED = {
    "--quant_collectives": "ROADMAP queue 1, item 2 (quantized "
                           "collectives, parallel/collectives.py:159)",
    "--accum_bucket_mb": "ROADMAP queue 1, item 2 (bucketed accumulation, "
                         "bucketize/bucketed_update)",
    "--ckpt_sharded": "ROADMAP queue 1, item 2 (the v2 sharded "
                      "checkpoint, train/checkpoint.py:207 save_sharded)",
}


def queued(flag: str) -> str:
    """The one-line refusal of a queued reference flag."""
    return f"{flag} is not ported yet: {QUEUED[flag]}"


@dataclass
class Config:
    """All knobs of a port training run."""

    batch_size: int = 128           # the global batch, over every rank
    lr: float = 1e-3
    epochs: int = 20
    force_cpu: bool = False
    device: str | None = None       # None = cuda (raises without a card)
    gamma: float = 0.7              # StepLR decay per epoch

    model: str = "convnet"
    model_preset: str | None = None
    num_layers: int | None = None
    dataset: str = "mnist"
    optimizer: str = "adadelta"

    log_every: int = 10
    seed: int = 0

    data_dir: str = "./data"
    ckpt_path: str = "checkpoint.npz"
    resume: bool = False
    import_torch: str | None = None
    keep_last: int = 1
    checkpoint_every: int = 0
    nonfinite_policy: str = "raise"
    augment: str = "none"           # none | flip | flip-crop (images)

    compute_dtype: str = "float32"
    weight_decay: float = 0.0
    clip_norm: float = 0.0
    grad_accum: int = 1
    warmup_steps: int = 0

    eval_on_train: bool = False

    coordinator: str | None = None  # host:port of rank 0's rendezvous
    num_processes: int | None = None
    process_id: int | None = None
    mesh: str = "data=-1"
    shard_update: str = "auto"

    @property
    def device_name(self) -> str | None:
        return "cpu" if self.force_cpu else self.device

    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(
            description="trainer of the PyTorch/CUDA port (the dcp-train "
                        "subset)", allow_abbrev=False)
        p.add_argument("--batch_size", type=int, default=cls.batch_size)
        p.add_argument("--lr", type=float, default=cls.lr)
        p.add_argument("--epochs", type=int, default=cls.epochs)
        p.add_argument("--gamma", type=float, default=cls.gamma)
        p.add_argument("--force-cpu", action="store_true", dest="force_cpu",
                       help="run on the CPU (same as --device cpu)")
        p.add_argument("--device", type=str, default=None,
                       choices=("cuda", "cpu"),
                       help="cuda (default; raises without a card) or cpu")
        p.add_argument("--model", type=str, default=cls.model,
                       choices=("convnet", "resnet18", "resnet50", "bert",
                                "gpt2", "llama", "moe"))
        p.add_argument("--model_preset", type=str, default=None,
                       choices=("tiny", "small", "base"))
        p.add_argument("--num_layers", type=int, default=None)
        p.add_argument("--dataset", type=str, default=cls.dataset,
                       choices=("mnist", "cifar10", "synthetic-images",
                                "synthetic-lm"))
        p.add_argument("--optimizer", type=str, default=cls.optimizer,
                       choices=("adadelta", "sgd", "adamw", "adamw_fused"))
        p.add_argument("--log_every", type=int, default=cls.log_every)
        p.add_argument("--seed", type=int, default=cls.seed)
        p.add_argument("--data_dir", type=str, default=cls.data_dir)
        p.add_argument("--ckpt_path", type=str, default=cls.ckpt_path)
        p.add_argument("--resume", action="store_true")
        p.add_argument("--import_torch", type=str, default=None,
                       help="start from a reference mnist.pt (convnet)")
        p.add_argument("--keep_last", type=int, default=cls.keep_last)
        p.add_argument("--checkpoint_every", type=int,
                       default=cls.checkpoint_every)
        p.add_argument("--nonfinite_policy", type=str,
                       default=cls.nonfinite_policy,
                       choices=("raise", "skip"))
        p.add_argument("--augment", type=str, default=cls.augment,
                       choices=("none", "flip", "flip-crop"),
                       help="device-side augmentation of image batches "
                            "inside the train step")
        p.add_argument("--compute_dtype", type=str,
                       default=cls.compute_dtype,
                       choices=("float32", "bfloat16"))
        p.add_argument("--weight_decay", type=float,
                       default=cls.weight_decay)
        p.add_argument("--clip_norm", type=float, default=cls.clip_norm)
        p.add_argument("--grad_accum", type=int, default=cls.grad_accum)
        p.add_argument("--warmup_steps", type=int, default=cls.warmup_steps)
        p.add_argument("--eval_on_train", action="store_true")
        p.add_argument("--coordinator", type=str, default=None,
                       help="host:port of rank 0 (with --num_processes "
                            "and --process_id)")
        p.add_argument("--num_processes", type=int, default=None)
        p.add_argument("--process_id", type=int, default=None)
        p.add_argument("--mesh", type=str, default=cls.mesh,
                       help="axes over the ranks: data=N, fsdp=N or "
                            "data=D,fsdp=F (one -1 fills the world)")
        p.add_argument("--shard_update", type=str, default=cls.shard_update,
                       choices=("auto", "on", "off"),
                       help="ZeRO-1 update sharding: reduce-scatter the "
                            "gradients, update this rank's shard, "
                            "all-gather the params; auto = on under "
                            "DataParallel at a data-parallel size above 1")
        return p

    @classmethod
    def from_argv(cls, argv: list[str] | None = None) -> "Config":
        ns, rest = cls.parser().parse_known_args(argv)
        if rest:
            flag = next((a for a in rest if a.startswith("-")), rest[0])
            flag = flag.split("=")[0]
            if flag in QUEUED:
                raise SystemExit(f"dcp-train (port): {queued(flag)}")
            raise SystemExit(f"dcp-train (port): {flag} is not supported "
                             f"by the port yet")
        if ns.model == "moe":
            raise SystemExit("dcp-train (port): --model moe is not ported "
                             "yet: ROADMAP queue 1, item 8 (models/moe.py)")
        return cls(**{f.name: getattr(ns, f.name)
                      for f in dataclasses.fields(cls)})
