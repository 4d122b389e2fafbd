"""One rank of the port's sharded GPT-2 training on the CPU, for
``tests/test_torch_shard.py``.

    python tests/torch_shard_worker.py OUT RANK WORLD PORT JOB

joins a gloo world of WORLD at ``127.0.0.1:PORT`` as rank RANK, lays it
out over the mesh ``JOB["mesh"]`` (``data=2``, ``fsdp=2``,
``data=2,fsdp=2``) with the strategy it implies, and runs, for GPT-2-tiny
at T = 32 in f32:

- ``steps``: ten updates of ``make_step_fns`` from the converted weights
  ``JOB["weights"]`` on this rank's rows of the global batch
  ``JOB["tokens"]``, dropout 0, with ``adamw`` (and ``adamw_fused`` when
  ``JOB["fused"]``): the losses, the gathered parameters, and this rank's
  bytes of masters, moments and gradients;
- ``skip`` (``JOB["skip"]``): under ``nonfinite_policy="skip"``, a step
  with one master element set to ``inf`` must be skipped and leave this
  rank's masters, moments and count bit-untouched;
- ``trainer`` (``JOB["trainer"]``): the ``Trainer`` (``--mesh``,
  ``--shard_update auto``) on 64 sequences at a global batch of 16,
  dropout 0.1, from seed 0: one epoch (the losses and the gathered
  leaves of the state it saved to ``JOB["ckpt"]``), then ``--resume`` to
  a second epoch from that checkpoint and from ``JOB["resume_from"]`` (a
  replicated run's).

Writes everything to the ``.npz`` OUT.
"""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from distributed_compute_pytorch_tpu_torch.core import mesh as M  # noqa: E402
from distributed_compute_pytorch_tpu_torch.core.config import (  # noqa: E402
    Config)
from distributed_compute_pytorch_tpu_torch.data.datasets import (  # noqa: E402
    synthetic_lm)
from distributed_compute_pytorch_tpu_torch.models.gpt2 import (  # noqa: E402
    GPT2, GPT2Config)
from distributed_compute_pytorch_tpu_torch.parallel.api import (  # noqa: E402
    pick_strategy)
from distributed_compute_pytorch_tpu_torch.train.optim import (  # noqa: E402
    build_optimizer)
from distributed_compute_pytorch_tpu_torch.train.step import (  # noqa: E402
    make_step_fns)
from distributed_compute_pytorch_tpu_torch.train.trainer import (  # noqa: E402
    Trainer)

T = 32
STEPS = 10
OPT = {"lr": 1e-3, "gamma": 0.7, "steps_per_epoch": STEPS,
       "warmup_steps": 2, "total_steps": STEPS}
CFG = dataclasses.replace(GPT2Config.tiny(), max_seq_len=T)
POISON = ("wte.weight", 3 * CFG.d_model + 5)
TRAIN_SEQS, EVAL_SEQS, TRAIN_BATCH = 64, 24, 16


def trainer_data():
    return (synthetic_lm(TRAIN_SEQS, T, CFG.vocab_size, seed=0),
            synthetic_lm(EVAL_SEQS, T, CFG.vocab_size, seed=1))


def trainer_config(mesh: str, ckpt: str, epochs: int, resume: bool,
                   **kw) -> Config:
    return Config(device="cpu", model="gpt2", optimizer="adamw", lr=1e-3,
                  warmup_steps=2, batch_size=TRAIN_BATCH, epochs=epochs,
                  log_every=1, seed=0, mesh=mesh, ckpt_path=ckpt,
                  resume=resume, **kw)


def run_trainer(cfg: Config) -> tuple[list, object]:
    """``Trainer.fit`` of GPT-2-tiny with dropout 0.1; returns every
    step's loss and the trainer."""
    model = GPT2(dataclasses.replace(CFG, dropout_rate=0.1), device="cpu")
    train, evals = trainer_data()
    tr = Trainer(cfg, model=model, train_data=train, eval_data=evals)
    step, losses = tr.train_step, []

    def recording_step(state, x, y):
        state, metrics = step(state, x, y)
        losses.append(float(metrics["loss"]))
        return state, metrics
    tr.train_step = recording_step
    tr.fit()
    return losses, tr


def logical(state) -> dict:
    """The state's gathered leaves: every rank calls it."""
    opt = state.opt_state
    out = {f"param/{n}": t.detach().numpy().copy()
           for n, t in opt.param_leaves().items()}
    for kind, leaves in opt.moments().items():
        out.update({f"{kind}/{n}": t.numpy().copy()
                    for n, t in leaves.items()})
    out["count"] = np.asarray(int(opt.count))
    return out


def build(job, mesh, optimizer, **kw):
    model = GPT2(CFG, device="cpu")
    weights = np.load(job["weights"])
    model.load_state_dict({k: torch.from_numpy(weights[k]) for k in weights})
    init_fn, train_step, _ = make_step_fns(
        model, build_optimizer(optimizer, **OPT), mesh,
        strategy=pick_strategy(mesh), **kw)
    return init_fn(None), train_step


def rows(job, rank: int, world: int) -> torch.Tensor:
    tokens = np.load(job["tokens"])["tokens"]
    b = tokens.shape[0] // world
    return torch.from_numpy(tokens[rank * b:(rank + 1) * b]).long()


def steps_run(job, mesh, optimizer, x) -> dict:
    state, train_step = build(job, mesh, optimizer)
    losses = [float(train_step(state, x, x)[1]["loss"])
              for _ in range(STEPS)]
    out = {f"{optimizer}/{k}": v for k, v in logical(state).items()}
    out[f"{optimizer}/losses"] = np.asarray(losses)
    for k, v in state.opt_state.nbytes().items():
        out[f"{optimizer}/bytes/{k}"] = np.asarray(v)
    return out


def poison(opt, value: float) -> float:
    """Set the master element :data:`POISON` to ``value`` on the rank
    that holds it (every rank, where the masters are whole); returns the
    old value (``nan`` on a rank that does not hold it)."""
    name, i = POISON
    layout = opt.layout
    idx = layout.offsets[name][0] + i
    if layout.mode != "fsdp":
        old = float(opt.params[idx])
        opt.params[idx] = value
        return old
    unit = next(u for u in layout.units
                if u.offset <= idx < u.offset + u.padded)
    within = idx - unit.offset
    if within // unit.shard != layout.rank:
        return float("nan")
    local = unit.shard_offset + within % unit.shard
    old = float(opt.params[local])
    opt.params[local] = value
    return old


def skip_run(job, mesh, x) -> dict:
    state, train_step = build(job, mesh, "adamw",
                              nonfinite_policy="skip")
    opt = state.opt_state
    flags = [float(train_step(state, x, x)[1]["skipped"]) for _ in range(2)]

    def bits():
        return [opt.params.clone(), opt.count.clone(),
                *(s.clone() for s in opt.slots.values())]
    before = bits()
    with torch.no_grad():
        old = poison(opt, float("inf"))
    flags.append(float(train_step(state, x, x)[1]["skipped"]))
    with torch.no_grad():
        if not np.isnan(old):
            poison(opt, old)
    kept = all(torch.equal(a, b) for a, b in zip(bits(), before))
    flags.append(float(train_step(state, x, x)[1]["skipped"]))
    return {"skip/flags": np.asarray(flags), "skip/kept": np.asarray(kept),
            "skip/count": np.asarray(int(opt.count))}


def trainer_runs(job, spec: str, out: str) -> dict:
    ck = job["ckpt"]            # rank 0 writes it
    res = {}
    losses, tr = run_trainer(trainer_config(spec, ck, 1, False))
    res["trainer/losses"] = np.asarray(losses)
    res.update({f"trainer/{k}": v for k, v in logical(tr.state).items()})
    dist.barrier()              # rank 0 has written the checkpoint
    for tag, src in (("own", ck), ("from_replicated", job["resume_from"])):
        # a rank's own copy: the resumed run writes over its checkpoint
        mine = f"{out}.resume_{tag}.npz"
        shutil.copyfile(src, mine)
        _, tr = run_trainer(trainer_config(spec, mine, 2, True))
        res.update({f"resume_{tag}/{k}": v
                    for k, v in logical(tr.state).items()})
    return res


def main(out: str, rank: int, world: int, port: int, job_path: str) -> None:
    with open(job_path) as f:
        job = json.load(f)
    M.initialize_distributed(f"127.0.0.1:{port}", world, rank, "cpu")
    mesh = M.make_mesh(job["mesh"])
    x = rows(job, rank, world)
    res = steps_run(job, mesh, "adamw", x)
    if job.get("fused"):
        res.update(steps_run(job, mesh, "adamw_fused", x))
    if job.get("skip"):
        res.update(skip_run(job, mesh, x))
    if job.get("trainer"):
        res.update(trainer_runs(job, job["mesh"], out))
    np.savez(out, **res)
    M.shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1], *map(int, sys.argv[2:5]), sys.argv[5])
