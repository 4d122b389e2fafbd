"""One rank of the port's trainer on a BASELINE ladder model on the CPU,
for ``tests/test_torch_resnet.py``, ``tests/test_torch_bert.py`` and
``tests/test_torch_llama.py``.

    python tests/torch_ladder_worker.py OUT RANK WORLD PORT MODEL MESH

joins a gloo world of WORLD at ``127.0.0.1:PORT`` as rank RANK (WORLD 1
runs alone, without a process group), lays it out over ``--mesh MESH``
and trains through the port's ``Trainer`` from seed 0:

- ``resnet``: ResNet-18 at width 8 on 32 8 x 8 x 3 ``synthetic_images``
  at a global batch of 16 (one epoch: two updates; further updates of
  this deep BatchNorm net at small batch drift apart by more than 1e-5
  under a mere change of the CPU's thread count), SGD (lr 0.05,
  momentum), ``--augment flip-crop``: sync-BN over the NCHW maps and the
  global batch's augment draw;
- ``bert``: BERT-tiny at T = 32 (``pad_token_id`` 0, dropout 0.1) on 64
  ragged sequences of 8-32 real tokens padded with 0, at a global batch of
  16 for two epochs, AdamW (ZeRO-1 at WORLD 2 under ``--shard_update
  auto``): the global batch's MLM mask and dropout draws;
- ``llama``: Llama-tiny (GQA 4:2) at T = 32 on 64 ``synthetic_lm``
  sequences, at a global batch of 16 for two epochs, AdamW (ZeRO-1 under
  ``--mesh data=2``, FSDP under ``fsdp=2``).

Both evaluate on 40 examples (the last batch padded by 8 rows). Writes
every step's loss, the final parameters and BatchNorm stats (gathered)
and the last eval's sums to the ``.npz`` OUT. :func:`run_world`, which
the tests import, starts every rank of a world and loads what each wrote.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributed_compute_pytorch_tpu_torch.core import mesh  # noqa: E402
from distributed_compute_pytorch_tpu_torch.core.config import (  # noqa: E402
    Config)
from distributed_compute_pytorch_tpu_torch.data.datasets import (  # noqa: E402
    ArrayDataset, synthetic_images, synthetic_lm)
from distributed_compute_pytorch_tpu_torch.models.bert import (  # noqa: E402
    BertConfig, BertMLM)
from distributed_compute_pytorch_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig, LlamaLM)
from distributed_compute_pytorch_tpu_torch.models.resnet import (  # noqa: E402
    ResNet)
from distributed_compute_pytorch_tpu_torch.train.trainer import (  # noqa: E402
    Trainer)

T = 32
BERT = dataclasses.replace(BertConfig.tiny(), max_seq_len=T, pad_token_id=0,
                           dropout_rate=0.1)
LLAMA = dataclasses.replace(LlamaConfig.tiny(), max_seq_len=T)


def ragged_tokens(n: int, seed: int) -> ArrayDataset:
    """``n`` sequences of 8-``T`` tokens in ``[2, vocab)``, padded with 0
    to ``T``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, BERT.vocab_size, (n, T)).astype(np.int32)
    lengths = rng.integers(8, T + 1, n)
    toks[np.arange(T)[None] >= lengths[:, None]] = 0
    return ArrayDataset(toks, toks, name="ragged-lm",
                        num_classes_override=BERT.vocab_size)


def run_world(tmp_path, kind: str, world: int, mesh_spec: str) -> list:
    """Every rank of a world of this worker, each under a 120 s timeout
    (one intra-op thread pair a rank); the ``.npz`` each wrote, loaded."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    outs = [str(tmp_path / f"{kind}-{mesh_spec}-w{world}r{r}.npz")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), out, str(r), str(world),
         str(port), kind, mesh_spec], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for r, out in enumerate(outs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{log[-3000:]}"
    return [dict(np.load(out)) for out in outs]


def main(out: str, rank: int, world: int, port: int, kind: str,
         mesh_spec: str) -> None:
    group = ({"coordinator": f"127.0.0.1:{port}", "num_processes": world,
              "process_id": rank} if world > 1 else {})
    common = {"device": "cpu", "batch_size": 16, "log_every": 1,
              "seed": 0, "mesh": mesh_spec, "ckpt_path": f"{out}.ck.npz",
              **group}
    if kind == "resnet":
        cfg = Config(model="resnet18", optimizer="sgd", lr=0.05,
                     augment="flip-crop", epochs=1, **common)
        model = ResNet.build("resnet18", width=8, device="cpu")
        train = synthetic_images(32, (8, 8, 3), 10, 0)
        test = synthetic_images(40, (8, 8, 3), 10, 1)
    elif kind == "llama":
        cfg = Config(model="llama", optimizer="adamw", lr=1e-3, epochs=2,
                     **common)
        model = LlamaLM(LLAMA, device="cpu").init(
            torch.Generator().manual_seed(0))
        train = synthetic_lm(64, T, LLAMA.vocab_size, seed=0)
        test = synthetic_lm(40, T, LLAMA.vocab_size, seed=1)
    else:
        cfg = Config(model="bert", optimizer="adamw", lr=1e-3, epochs=2,
                     **common)
        model = BertMLM(BERT, device="cpu")
        train, test = ragged_tokens(64, 0), ragged_tokens(40, 1)
    tr = Trainer(cfg, model=model, train_data=train, eval_data=test)
    step, losses = tr.train_step, []

    def recording_step(state, x, y):
        state, metrics = step(state, x, y)
        losses.append(float(metrics["loss"]))
        return state, metrics
    tr.train_step = recording_step
    ev = tr.fit()
    leaves = {**tr.state.opt_state.param_leaves(), **tr.state.model_state}
    state = {k: v.detach().numpy().copy() for k, v in leaves.items()}
    np.savez(out, losses=np.asarray(losses),
             eval=np.asarray([ev["loss_sum"], ev["correct"], ev["count"]]),
             strategy=np.asarray(type(tr.strategy).__name__), **state)
    mesh.shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1], *map(int, sys.argv[2:5]), sys.argv[5], sys.argv[6])
