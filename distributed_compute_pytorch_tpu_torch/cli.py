"""``dcp-train`` for the port — the single-GPU subset of
``distributed_compute_pytorch_tpu/cli.py``.

    python -m distributed_compute_pytorch_tpu_torch.cli --model gpt2 \\
        --dataset synthetic-lm --optimizer adamw_fused \\
        --compute_dtype bfloat16 --epochs 1 --batch_size 32

Runs on CUDA unless ``--device cpu`` (or ``--force-cpu``); without a card
and without that request it raises. Prints the reference's lines
(``epoch: E [b/N (p%)]  Loss:...``, ``Test set: ...``, ``time to complete
this epoch: ...``) and writes a v1 checkpoint the JAX package reads.
"""

from __future__ import annotations

import sys

from distributed_compute_pytorch_tpu_torch.core.config import Config


def main(argv=None) -> int:
    config = Config.from_argv(argv)
    from distributed_compute_pytorch_tpu_torch.train.trainer import Trainer
    Trainer(config).fit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
