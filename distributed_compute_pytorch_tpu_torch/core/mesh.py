"""Process group — the process-group half of
``distributed_compute_pytorch_tpu/core/mesh.py``, over ``torch.distributed``.

The reference's data parallelism is one SPMD program over the global
batch. The port runs one process a rank (one GPU each on CUDA) and keeps
that contract: each rank feeds its contiguous ``global_batch / world``
rows of every global batch (``data/loader.py``), the train step sums the
gradients over the ranks once a step (``train/step.py``), BatchNorm takes
the global batch's statistics and dropout draws the global batch's mask
(``models/layers.py``). So N ranks train as one process on the whole
batch.

:func:`initialize_distributed` is the reference's rendezvous
(``:50-73``): ``nccl`` for CUDA and ``gloo`` for the CPU, never one for the
other. Mesh axes, ``DeviceMesh`` and ``--mesh`` are not ported.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def distributed() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device_type: str = "cuda") -> bool:
    """Join the process group (reference ``initialize_distributed``): all
    ranks block until the whole world has joined. ``coordinator`` is
    ``host:port`` of rank 0's rendezvous; without it, torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` are used when
    set. No coordinator and no torchrun environment: a single process, no
    group (returns ``False``). ``device_type`` picks the backend: ``nccl``
    on ``cuda`` (the rank's card is ``LOCAL_RANK``, else ``process_id``
    modulo the cards), ``gloo`` on ``cpu``. A world of more than one
    process takes one intra-op thread a rank unless ``OMP_NUM_THREADS``
    is set, as torchrun does. Joining twice is a no-op."""
    if distributed():
        return True
    env = os.environ
    if coordinator is None and num_processes is None:
        if "WORLD_SIZE" not in env or "MASTER_ADDR" not in env:
            return False
        port = env.get("MASTER_PORT", "29500")
        coordinator = f"{env['MASTER_ADDR']}:{port}"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env.get("RANK", "0"))
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs --coordinator, "
                         "--num_processes and --process_id together")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is outside a world of "
                         f"{num_processes}")
    if device_type == "cuda":
        backend = "nccl"
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device type "
                         f"{device_type!r}")
    if num_processes > 1 and "OMP_NUM_THREADS" not in env:
        # one intra-op thread a rank, as torchrun sets: the ranks of a
        # host share its cores, and their OpenMP pools, each as wide as
        # the host, spin against one another on every batch's copy
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if this process is in one."""
    if distributed():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if distributed() else 1


def process_index() -> int:
    return dist.get_rank() if distributed() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def dp_world_size() -> int:
    """Data-parallel ranks (the reference's ``world_size``): one a
    process."""
    return process_count()


def local_batch_size(global_batch: int, world: int | None = None) -> int:
    """A rank's rows of ``global_batch`` over ``world`` ranks (this
    process's world by default); raises when they do not divide."""
    ws = dp_world_size() if world is None else world
    if global_batch % ws:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel world size {ws}")
    return global_batch // ws


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks whose backward is the SUM of the output's
    gradients, as ``torch.distributed.nn.functional.all_reduce`` (which
    warns on every call as deprecated): every rank's input then gets the
    gradient of the loss summed over the ranks."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the process group, differentiably (a new
    tensor; ``x`` is left as it is)."""
    return _AllReduceSum.apply(x)
