"""Process group and mesh — ``distributed_compute_pytorch_tpu/core/mesh.py``
over ``torch.distributed``.

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
other.

The mesh (``--mesh``, reference ``MeshSpec`` and ``make_mesh``) names axes
over the processes, one card a rank: ``data`` (batch sharding) and
``fsdp`` (batch sharding with the parameters sharded over it,
``parallel/api.py::FSDP``). :func:`make_mesh` lays the ranks out row-major
over the axes, as the reference reshapes its devices, through
``torch.distributed.device_mesh.init_device_mesh``, so each axis has a
process group of its own; rank ``r`` holds rows ``r * B`` on of every
global batch, the reference's batch sharding over ``("data", "fsdp")``.
The ``tensor``, ``seq``, ``pipe`` and ``expert`` axes are not ported: a
size above 1 raises, naming :data:`AXES_QUEUE`.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

# axes the global batch is sharded over (reference :44)
BATCH_AXES = ("data", "fsdp")
ALL_AXES = ("data", "fsdp", "tensor", "seq", "pipe", "expert")
AXES_QUEUE = "ROADMAP queue 1, item 2 (the tensor, pipe, seq and expert axes)"


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


def dp_world_size(mesh: "Mesh | None" = None) -> int:
    """Data-parallel ranks (the reference's ``world_size``): the product
    of ``mesh``'s batch axes, which cover every process
    (:func:`make_mesh` refuses the model axes and undersubscription);
    without a mesh, one a process."""
    if mesh is None:
        return process_count()
    return math.prod(mesh.size(a) for a in BATCH_AXES)


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


@dataclass(frozen=True)
class MeshSpec:
    """An ordered mapping of axis name -> size; at most one size may be -1
    (inferred from the world) — the reference's ``MeshSpec``
    (``:92-145``)."""

    axes: tuple[tuple[str, int], ...]

    @classmethod
    def parse(cls, spec: "str | dict[str, int]") -> "MeshSpec":
        if isinstance(spec, str):
            d: dict[str, int] = {}
            for part in spec.split(","):
                part = part.strip()
                if not part:
                    continue
                name, _, size = part.partition("=")
                d[name.strip()] = int(size) if size else -1
            spec = d or {"data": -1}
        for name in spec:
            if name not in ALL_AXES:
                raise ValueError(
                    f"unknown mesh axis {name!r}; known axes: {ALL_AXES}")
        return cls(axes=tuple(spec.items()))

    def resolve(self, n_ranks: int) -> "MeshSpec":
        """Fill in a single -1 so the axis sizes multiply to ``n_ranks``."""
        sizes = dict(self.axes)
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {unknown}")
        known = math.prod(v for v in sizes.values() if v != -1)
        if unknown:
            if n_ranks % known:
                raise ValueError(
                    f"{n_ranks} ranks not divisible by fixed axes {sizes}")
            sizes[unknown[0]] = n_ranks // known
        elif known > n_ranks:
            raise ValueError(
                f"mesh {sizes} wants {known} ranks, the world has "
                f"{n_ranks}")
        return MeshSpec(axes=tuple(sizes.items()))

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(k for k, _ in self.axes)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(v for _, v in self.axes)

    def size(self, name: str) -> int:
        return dict(self.axes).get(name, 1)


class Mesh:
    """The named axes over the ranks of the process group (or one process
    without a group, every axis of size 1): ``size(axis)``, ``shape``
    and ``group(*axes)``, the process group of the ranks that differ
    only along ``axes``."""

    def __init__(self, spec: MeshSpec, device_mesh=None):
        self.spec, self.device_mesh = spec, device_mesh

    def size(self, name: str) -> int:
        return self.spec.size(name)

    @property
    def shape(self) -> dict:
        return dict(self.spec.axes)

    def group(self, *axes: str):
        """The process group of ``axes``: one axis's own group, the whole
        world where ``axes`` cover every axis of size above 1, ``None``
        without a process group."""
        if self.device_mesh is None:
            return None
        big = {a for a, n in self.spec.axes if n > 1}
        if big <= set(axes):
            return dist.group.WORLD
        (axis,) = axes
        return self.device_mesh.get_group(axis)


def make_mesh(spec: "str | dict[str, int] | MeshSpec" = "data=-1") -> Mesh:
    """The mesh over this process's world (reference ``make_mesh``,
    ``:147-185``): ``spec`` resolved against the ranks, each axis a
    process group (``init_device_mesh`` with ``mesh_dim_names``). Raises
    for a ``tensor``/``pipe``/``seq``/``expert`` axis above 1 and for a
    mesh smaller than a multi-process world (the reference's
    undersubscription is single-process only, and here one process is one
    rank). Without a process group the mesh is the single process: every
    size must be 1."""
    if not isinstance(spec, MeshSpec):
        spec = MeshSpec.parse(spec)
    world = process_count()
    model_axes = {a: n for a, n in spec.axes
                  if a not in BATCH_AXES and n != 1}
    if model_axes:
        raise NotImplementedError(
            f"mesh axes {model_axes} are not ported yet: {AXES_QUEUE}")
    spec = spec.resolve(world)
    total = math.prod(spec.shape)
    if total < world:
        raise ValueError(
            f"mesh spec {dict(spec.axes)} uses {total} of {world} ranks; "
            f"undersubscription is single-process only — relaunch with "
            f"fewer processes")
    if not distributed():
        return Mesh(spec)
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(spec, init_device_mesh(device_type, spec.shape,
                                       mesh_dim_names=spec.names))
