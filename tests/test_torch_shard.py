"""The port's sharded GPT-2 training on the CPU: ZeRO-1 (``--mesh data=2``,
the default ``--shard_update auto``), FSDP (``--mesh fsdp=2``) and both
(``--mesh data=2,fsdp=2``, four ranks), each a gloo world of
``tests/torch_shard_worker.py`` processes, against the JAX package's
``make_step_fns`` on the same faked CPU mesh and against one port
process.

GPT-2-tiny (2 layers, d_model 64) at T = 32, f32. Tolerances:

- against the JAX package (dropout 0, converted weights, ten steps of a
  global batch of 8): losses 1e-4 relative, parameters 1e-4 absolute, the
  key third of ``qkv.bias`` left out (``test_torch_train.py`` says why).
  ``adamw_fused`` under ZeRO-1 is held to the JAX single-device fused step
  on the whole batch: the reference's own sharded fused test fails
  (``test_zero1.py::test_fused_adamw_sharded_update_matches_replicated``);
- N ranks against one process (the ``Trainer``, dropout 0.1 drawn for
  the global batch on every rank, one epoch of four updates): 1e-5, only
  the order of the sums differs; the key third of ``qkv.bias`` and of
  its moments is left out here too (its gradient is rounding noise,
  which each order rounds its own way and Adam scales to about lr);
- a sharded checkpoint is logical: loaded into a replicated one-process
  state it gives the sharded run's gathered leaves bit for bit; resumed
  in another layout, a second epoch agrees with the run resumed in the
  saving layout to 1e-6 (the key bias left out as above).

Each process runs under its own 120 s timeout; the three worlds run
together, while the JAX references run in this process.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.core.mesh import batch_sharding, make_mesh
from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.parallel.api import FSDP as JaxFSDP
from distributed_compute_pytorch_tpu.train.optim import (
    build_optimizer as jax_build_optimizer)
from distributed_compute_pytorch_tpu.train.step import (
    make_step_fns as jax_make_step_fns)
from distributed_compute_pytorch_tpu_torch import cli
from distributed_compute_pytorch_tpu_torch.core import config as port_config
from distributed_compute_pytorch_tpu_torch.core import mesh as port_mesh
from distributed_compute_pytorch_tpu_torch.data.datasets import synthetic_lm
from distributed_compute_pytorch_tpu_torch.interop import (
    gpt2_params_from_jax, read_checkpoint)
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2
from distributed_compute_pytorch_tpu_torch.parallel.api import FSDP
from distributed_compute_pytorch_tpu_torch.train import checkpoint
from distributed_compute_pytorch_tpu_torch.train.optim import build_optimizer
from distributed_compute_pytorch_tpu_torch.train.step import make_step_fns

import torch_shard_worker as W

WORKER = os.path.join(os.path.dirname(__file__), "torch_shard_worker.py")
TIMEOUT = 120
B = 8
JAX_TOL, RANKS_TOL, RESUME_TOL = 1e-4, 1e-5, 1e-6
MESHES = ("data=2", "fsdp=2", "data=2,fsdp=2")
JOBS = {"data=2": {"fused": True, "skip": True, "trainer": True},
        "fsdp=2": {"skip": True, "trainer": True},
        "data=2,fsdp=2": {"trainer": True}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(spec: str) -> int:
    return int(np.prod([int(a.split("=")[1]) for a in spec.split(",")]))


def _tag(spec: str) -> str:
    return spec.replace("=", "").replace(",", "_")


def _launch(tmp, spec: str, job: dict) -> tuple[list, list]:
    """Start every rank of ``spec``'s world; returns the processes and the
    files they will write."""
    world, port = _world(spec), _free_port()
    job_path = str(tmp / f"{_tag(spec)}.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    outs = [str(tmp / f"{_tag(spec)}_r{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, out, str(r), str(world), str(port),
         job_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r, out in enumerate(outs)]
    return procs, outs


def _wait(procs) -> list:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def _jax_run(params, tokens, optimizer, spec, n_dev, strategy=None):
    cfg = dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=W.T)
    mesh = make_mesh(spec, devices=jax.devices()[:n_dev])
    tx = jax_build_optimizer(optimizer, **W.OPT)
    init_fn, train_step, _ = jax_make_step_fns(
        JaxGPT2(cfg), tx, mesh, strategy=strategy, donate=False)
    state = init_fn(jax.random.key(0))
    state = state.replace(params=params, opt_state=tx.init(params))
    x = jax.device_put(jnp.asarray(tokens), batch_sharding(mesh, 2))
    losses = []
    for _ in range(W.STEPS):
        state, m = train_step(state, x, x)
        losses.append(float(m["loss"]))
    return np.asarray(losses), gpt2_params_from_jax(
        jax.tree.map(np.asarray, state.params))


def _logical(prefix: str, got: dict) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in got.items()
            if k.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three worlds, the one-process trainer runs and the JAX
    references."""
    tmp = tmp_path_factory.mktemp("shard")
    cfg = dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=W.T)
    jparams, _ = JaxGPT2(cfg).init(jax.random.key(0))
    weights = gpt2_params_from_jax(jax.tree.map(np.asarray, jparams))
    np.savez(tmp / "weights.npz", **{k: v.numpy() for k, v in
                                     weights.items()})
    tokens = synthetic_lm(B, W.T, W.CFG.vocab_size, seed=3).inputs
    np.savez(tmp / "tokens.npz", tokens=tokens)
    # one process, replicated: the trainer's epoch and its continuation
    ck_rep = str(tmp / "replicated.ck.npz")
    one = {}
    losses, tr = W.run_trainer(W.trainer_config("data=-1", ck_rep, 1, False))
    one["losses"], one["leaves"] = np.asarray(losses), W.logical(tr.state)
    shutil.copyfile(ck_rep, tmp / "replicated.resume.npz")
    _, tr = W.run_trainer(W.trainer_config(
        "data=-1", str(tmp / "replicated.resume.npz"), 2, True))
    one["resumed"] = W.logical(tr.state)
    state, _ = W.build({"weights": str(tmp / "weights.npz")},
                       port_mesh.make_mesh(), "adamw")
    one["bytes"] = state.opt_state.nbytes()
    launched = {}
    for spec in MESHES:
        job = {"mesh": spec, "weights": str(tmp / "weights.npz"),
               "tokens": str(tmp / "tokens.npz"), "resume_from": ck_rep,
               "ckpt": str(tmp / f"{_tag(spec)}.ck.npz"), **JOBS[spec]}
        launched[spec] = _launch(tmp, spec, job)
    jax_ref = {spec: _jax_run(jparams, tokens, "adamw", spec, _world(spec),
                              JaxFSDP() if "fsdp" in spec else None)
               for spec in MESHES}
    jax_ref["fused"] = _jax_run(jparams, tokens, "adamw_fused", "data=1", 1)
    worlds = {}
    for spec, (procs, outs) in launched.items():
        logs = _wait(procs)
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"{spec} rank {r}:\n{log[-3000:]}"
        worlds[spec] = [dict(np.load(o)) for o in outs]
        worlds[spec][0]["ckpt"] = str(tmp / f"{_tag(spec)}.ck.npz")
    return {"tmp": tmp, "one": one, "jax": jax_ref, "worlds": worlds,
            "weights": weights}


def _without_key_bias(name, a):
    if not name.endswith("qkv.bias"):
        return a
    d = W.CFG.d_model
    return np.concatenate([a[:d], a[2 * d:]])


def _assert_leaves_close(got, want, tol, what):
    """Every leaf of ``want`` (``{"kind/name": array}``) in ``got``
    within ``tol``, the key bias left out."""
    for key, w in want.items():
        name = key.split("/")[-1]
        np.testing.assert_allclose(_without_key_bias(name, got[key]),
                                   _without_key_bias(name, w), atol=tol,
                                   rtol=tol, err_msg=f"{what}: {key}")


def _assert_params_match_jax(got: dict, want: dict, what: str):
    for name, w in want.items():
        np.testing.assert_allclose(
            _without_key_bias(name, got[name]),
            _without_key_bias(name, w.numpy()), atol=JAX_TOL, rtol=0,
            err_msg=f"{what}: {name}")


@pytest.mark.parametrize("spec", MESHES)
def test_sharded_steps_match_jax(runs, spec):
    j_losses, j_params = runs["jax"][spec]
    for r, got in enumerate(runs["worlds"][spec]):
        np.testing.assert_allclose(got["adamw/losses"], j_losses,
                                   rtol=JAX_TOL, err_msg=f"rank {r}")
        _assert_params_match_jax(_logical("adamw/param", got), j_params,
                                 f"{spec} rank {r}")
        assert int(got["adamw/count"]) == W.STEPS


def test_fused_adamw_under_zero1_matches_jax_single_device(runs):
    j_losses, j_params = runs["jax"]["fused"]
    for r, got in enumerate(runs["worlds"]["data=2"]):
        np.testing.assert_allclose(got["adamw_fused/losses"], j_losses,
                                   rtol=JAX_TOL, err_msg=f"rank {r}")
        _assert_params_match_jax(_logical("adamw_fused/param", got),
                                 j_params, f"fused rank {r}")


@pytest.mark.parametrize("spec", MESHES)
def test_ranks_train_as_one_process_with_dropout(runs, spec):
    one = runs["one"]
    assert len(one["losses"]) == W.TRAIN_SEQS // W.TRAIN_BATCH
    for r, got in enumerate(runs["worlds"][spec]):
        np.testing.assert_allclose(got["trainer/losses"], one["losses"],
                                   atol=RANKS_TOL, rtol=RANKS_TOL,
                                   err_msg=f"{spec} rank {r}")
        _assert_leaves_close(_logical("trainer", got), one["leaves"],
                             RANKS_TOL, f"{spec} rank {r}")


@pytest.mark.parametrize("spec", ["data=2", "fsdp=2"])
def test_skip_guard_keeps_every_shard(runs, spec):
    for r, got in enumerate(runs["worlds"][spec]):
        assert got["skip/flags"].tolist() == [0.0, 0.0, 1.0, 0.0], r
        assert bool(got["skip/kept"]), f"{spec} rank {r}: bits changed"
        assert int(got["skip/count"]) == 3


def test_per_rank_state_bytes_drop_by_the_world(runs):
    """ZeRO-1 at 2 ranks: each rank's moments are half the replicated
    ones (the masters stay whole); FSDP at 2: masters and moments both
    halve (up to the pads). As ``test_zero1.py:122`` asserts for the JAX
    package's born-sharded moments."""
    rep = runs["one"]["bytes"]
    for spec, halved in (("data=2", ("moments",)),
                         ("fsdp=2", ("moments", "masters"))):
        for got in runs["worlds"][spec]:
            for kind in ("moments", "masters"):
                ratio = rep[kind] / int(got[f"adamw/bytes/{kind}"])
                want = 2.0 if kind in halved else 1.0
                assert ratio == pytest.approx(want, rel=1e-2), (spec, kind)
    # data=2,fsdp=2: the masters and moments split over fsdp only
    got = runs["worlds"]["data=2,fsdp=2"][0]
    assert rep["moments"] / int(got["adamw/bytes/moments"]) == \
        pytest.approx(2.0, rel=1e-2)


def _replicated_state():
    model = GPT2(W.CFG, device="cpu")
    init_fn, _, _ = make_step_fns(model, build_optimizer("adamw", **W.OPT))
    return init_fn(0)


@pytest.mark.parametrize("spec", ["data=2", "fsdp=2"])
def test_sharded_checkpoint_is_logical(runs, spec):
    """The sharded run's v1 file loads into a replicated one-process state
    whose leaves are the run's gathered leaves, bit for bit."""
    got = runs["worlds"][spec][0]
    state = _replicated_state()
    flat, manifest = read_checkpoint(got["ckpt"])
    assert manifest["format"] == 1
    checkpoint.load_into(state, flat)
    have = W.logical(state)
    for key, want in _logical("trainer", got).items():
        if key == "losses":
            continue
        np.testing.assert_array_equal(have[key], want, err_msg=key)


@pytest.mark.parametrize("spec", ["data=2", "fsdp=2"])
def test_resume_across_layouts(runs, spec):
    """A sharded checkpoint resumed by one process continues as the
    sharded run resumed in its own layout; a replicated checkpoint resumed
    sharded continues as the replicated run resumed."""
    got = runs["worlds"][spec][0]
    tmp = runs["tmp"]
    mine = str(tmp / f"{_tag(spec)}.resumed_replicated.npz")
    shutil.copyfile(got["ckpt"], mine)
    _, tr = W.run_trainer(W.trainer_config("data=-1", mine, 2, True))
    have = W.logical(tr.state)
    _assert_leaves_close(have, _logical("resume_own", got), RESUME_TOL,
                         f"{spec} checkpoint resumed replicated")
    _assert_leaves_close(_logical("resume_from_replicated", got),
                         runs["one"]["resumed"], RESUME_TOL,
                         f"replicated checkpoint resumed {spec}")
    assert int(have["count"]) == 2 * W.TRAIN_SEQS // W.TRAIN_BATCH


@pytest.mark.parametrize("flag", sorted(port_config.QUEUED))
def test_queued_flags_exit_naming_their_queue_item(flag):
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", flag])
    msg = str(e.value)
    assert flag in msg and "queue 1, item 2" in msg and "\n" not in msg
    if flag == "--ckpt_sharded":
        with pytest.raises(NotImplementedError) as e2:
            checkpoint.save_sharded("ck", None)
        assert str(e2.value) in msg


@pytest.mark.parametrize("spec", ["tensor=2", "data=1,pipe=2", "seq=2",
                                  "expert=2"])
def test_model_axes_are_refused_naming_their_queue_item(spec):
    with pytest.raises(NotImplementedError, match="queue 1, item 2"):
        port_mesh.make_mesh(spec)


def test_sharded_strategies_refuse_what_the_reference_refuses():
    """``adamw_fused`` under FSDP, a forced ZeRO-1 update under FSDP or
    with a clip, and FSDP without a process group raise; the trainer's
    ``--shard_update`` follows the reference's rules."""
    model = GPT2(W.CFG, device="cpu")
    one = port_mesh.make_mesh()
    with pytest.raises(ValueError, match="adamw_fused"):
        make_step_fns(model, build_optimizer("adamw_fused", **W.OPT), one,
                      strategy=FSDP())
    with pytest.raises(ValueError, match="process group"):
        make_step_fns(model, build_optimizer("adamw", **W.OPT), one,
                      strategy=FSDP())
    with pytest.raises(ValueError, match="DataParallel strategy only"):
        make_step_fns(model, build_optimizer("adamw", **W.OPT), one,
                      strategy=FSDP(), shard_update=True)
    with pytest.raises(ValueError, match="elementwise"):
        make_step_fns(model, build_optimizer("adamw", clip_norm=1.0,
                                             **W.OPT), one,
                      shard_update=True)
