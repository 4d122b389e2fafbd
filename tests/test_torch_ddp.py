"""The port's data parallelism on the CPU: two gloo ranks, each on half of
every global batch, against one process on the whole batch.

Each run is ``tests/torch_ddp_worker.py``: the ConvNet through the port's
``Trainer`` (Adadelta, dropout on, sync-BN), two epochs of 4 steps and an
eval whose last batch is padded. The JAX package's data parallelism is one
SPMD program over the global batch, so N ranks must train as one device
on the whole batch: the losses (the logged global mean), the parameters,
the BatchNorm running stats and the eval sums agree to 1e-5 (f32; only
the order of the sums differs). A rank that summed the BatchNorm
statistics without carrying their gradient back to the other ranks'
rows, or that drew only its own rows' dropout mask, would not.

Each process runs under its own 120 s timeout, so a hang fails fast.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(__file__), "torch_ddp_worker.py")
TOL = 1e-5
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(tmp_path, world: int) -> list:
    """Start every rank of a world, wait for each under the timeout, and
    load what each wrote."""
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    outs = [str(tmp_path / f"w{world}r{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, out, str(r), str(world), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r, out in enumerate(outs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{log[-3000:]}"
    return [dict(np.load(out)) for out in outs], logs


def test_two_gloo_ranks_train_as_one_process(tmp_path):
    (one,), (log1,) = _run(tmp_path, 1)
    ranks, logs = _run(tmp_path, 2)
    assert len(one["losses"]) == 8
    assert set(one) == set(ranks[0]) == set(ranks[1])
    for r, got in enumerate(ranks):
        for key, want in one.items():
            np.testing.assert_allclose(got[key], want, atol=TOL, rtol=TOL,
                                       err_msg=f"rank {r}: {key}")
    # eval: 40 images, padded rows weighted out, summed over the ranks
    assert ranks[0]["eval"][2] == one["eval"][2] == 40
    # rank 0 alone logs
    assert "Test set:" in logs[0] and "Test set:" in log1
    assert "epoch:" not in logs[1] and "Test set:" not in logs[1]


def test_trainer_runs_only_the_convnet_over_ranks(monkeypatch):
    """Every model trains over ranks now (GPT-2 included: every rank draws
    the global batch's dropout masks, measured on four cards): the
    trainer takes GPT-2 in a world of 2 on to its data. What it still
    refuses over ranks, before any data loads, are the mesh axes the port
    lacks, naming their queue item."""
    from distributed_compute_pytorch_tpu_torch.core import mesh
    from distributed_compute_pytorch_tpu_torch.core.config import Config
    from distributed_compute_pytorch_tpu_torch.train import trainer

    class Loaded(Exception):
        pass

    def load(*a, **k):
        raise Loaded
    monkeypatch.setattr(mesh, "initialize_distributed", lambda *a: True)
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    monkeypatch.setattr(trainer, "load_dataset", load)
    with pytest.raises(Loaded):
        trainer.Trainer(Config(device="cpu", model="gpt2",
                               dataset="synthetic-lm", optimizer="adamw"))
    with pytest.raises(NotImplementedError, match="queue 1, item 2"):
        trainer.Trainer(Config(device="cpu", model="gpt2",
                               dataset="synthetic-lm", optimizer="adamw",
                               mesh="data=1,tensor=2"))


@pytest.mark.parametrize("omp", [None, "3"])
def test_a_world_of_ranks_takes_one_thread_a_rank(monkeypatch, omp):
    """Joining a world of more than one process sets one intra-op thread,
    as torchrun does, unless ``OMP_NUM_THREADS`` says otherwise: ranks of
    one host would otherwise each spin a pool as wide as the host."""
    import torch
    import torch.distributed as dist

    from distributed_compute_pytorch_tpu_torch.core import mesh
    if omp is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", omp)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: None)
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert mesh.initialize_distributed("127.0.0.1:1", 2, 1, "cpu")
        assert torch.get_num_threads() == (1 if omp is None else 2)
    finally:
        torch.set_num_threads(before)
