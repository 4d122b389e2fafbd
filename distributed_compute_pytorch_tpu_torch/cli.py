"""``dcp-train`` for the port — the subset of
``distributed_compute_pytorch_tpu/cli.py`` it takes.

    python -m distributed_compute_pytorch_tpu_torch.cli --epochs 1

trains the reference's workload (the ConvNet on MNIST, or its synthetic
stand-in, with Adadelta and StepLR); ``--model gpt2 --dataset synthetic-lm
--optimizer adamw_fused --compute_dtype bfloat16`` the transformer rung;
``--model resnet18 --dataset cifar10 --augment flip-crop --optimizer sgd``
(CIFAR-10, or its synthetic stand-in), ``--model resnet50`` and ``--model
bert --dataset synthetic-lm --optimizer adamw`` the other BASELINE rungs,
``--model llama --dataset synthetic-lm --optimizer adamw`` Llama.
A data-parallel world of N runs one process a rank, launched N times
with ``--coordinator host:port --num_processes N --process_id R`` (or
under ``torchrun --nproc_per_node N``), ``nccl`` on CUDA and ``gloo`` with
``--device cpu``.

Runs on CUDA unless ``--device cpu`` (or ``--force-cpu``); without a card
and without that request it raises. Prints the reference's lines
(``epoch: E [b/N (p%)]  Loss:...``, ``Test set: ...``, ``time to complete
this epoch: ...``) on rank 0 and writes a v1 checkpoint the JAX package
reads.
"""

from __future__ import annotations

import sys

from distributed_compute_pytorch_tpu_torch.core import mesh
from distributed_compute_pytorch_tpu_torch.core.config import Config


def main(argv=None) -> int:
    config = Config.from_argv(argv)
    from distributed_compute_pytorch_tpu_torch.train.trainer import Trainer
    try:
        Trainer(config).fit()
    finally:
        mesh.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
