"""One rank of the port's data-parallel trainer on the CPU, for
``tests/test_torch_ddp.py``.

    python tests/torch_ddp_worker.py OUT RANK WORLD PORT

trains the ConvNet (Adadelta, lr 1.0, StepLR 0.7) for two epochs of a
64-image ``synthetic_images`` set at a global batch of 16 (4 steps an
epoch; dropout on), evaluating on 40 images (the last batch padded by
8 rows), as rank RANK of a gloo world of WORLD joined at
``127.0.0.1:PORT``; WORLD 1 runs alone, without a process group. Writes
every step's loss, the final parameters and BatchNorm stats and the last
eval's sums to the ``.npz`` OUT.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributed_compute_pytorch_tpu_torch.core import mesh  # noqa: E402
from distributed_compute_pytorch_tpu_torch.core.config import (  # noqa: E402
    Config)
from distributed_compute_pytorch_tpu_torch.data.datasets import (  # noqa: E402
    synthetic_images)
from distributed_compute_pytorch_tpu_torch.train.trainer import (  # noqa: E402
    Trainer)


def main(out: str, rank: int, world: int, port: int) -> None:
    group = ({"coordinator": f"127.0.0.1:{port}", "num_processes": world,
              "process_id": rank} if world > 1 else {})
    cfg = Config(device="cpu", model="convnet", optimizer="adadelta",
                 lr=1.0, gamma=0.7, batch_size=16, epochs=2, log_every=1,
                 ckpt_path=f"{out}.ck.npz", **group)
    tr = Trainer(cfg, train_data=synthetic_images(64, (28, 28, 1), 10, 0),
                 eval_data=synthetic_images(40, (28, 28, 1), 10, 1))
    step, losses = tr.train_step, []

    def recording_step(state, x, y):
        state, metrics = step(state, x, y)
        losses.append(float(metrics["loss"]))
        return state, metrics
    tr.train_step = recording_step
    ev = tr.fit()
    state = {k: v.detach().numpy().copy()
             for k, v in {**tr.state.params, **tr.state.model_state}.items()}
    np.savez(out, losses=np.asarray(losses),
             eval=np.asarray([ev["loss_sum"], ev["correct"], ev["count"]]),
             **state)
    mesh.shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1], *map(int, sys.argv[2:5]))
