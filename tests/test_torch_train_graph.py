"""The captured train step's bookkeeping on the CPU, where no CUDA graph
exists: ``train/step.py::CapturedStep`` forced onto a CPU model, with
``utils/graphs.capture`` replaced by a stand-in whose replay runs the
captured update again over the same static buffers (as a graph replays
its kernels, and nothing else of the Python state).

GPT-2-tiny with dropout 0.1 (T 32, batch 8), f32, ``adamw`` and
``adamw_fused``, six updates: the first runs eagerly, the second
captures and replays, the rest replay; losses, parameters, moments and
count bit-identical to the eager step's (the dropout generator re-seeded
before each replay draws the eager step's bits); every metric a tensor of
its own; a poisoned replay under ``nonfinite_policy="skip"`` leaves the
state's bits; a batch of another shape warms up and captures on its own;
another state is refused; a CPU model's step never touches CUDA graphs.
The card tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` hold
the real graph to the eager step.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.train import step as step_mod
from distributed_compute_pytorch_tpu_torch.train.optim import build_optimizer
from distributed_compute_pytorch_tpu_torch.utils import graphs

CFG = dataclasses.replace(GPT2Config.tiny(), max_seq_len=32,
                          dropout_rate=0.1)
OPT = {"lr": 1e-2, "steps_per_epoch": 6, "warmup_steps": 2,
       "total_steps": 6}


class _Replayer:
    """A stand-in for a captured graph: a replay runs the captured
    function again over the same buffers."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _stand_in_capture(fn, generators=()):
    assert len(generators) == 1     # the dropout generator, registered
    return graphs.record(_Replayer(fn), contextlib.nullcontext(),
                         lambda: None)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(step_mod, "_captures", lambda device: True)
    monkeypatch.setattr(graphs, "capture", _stand_in_capture)


def _setup(optimizer, *, captured, **kw):
    model = GPT2(CFG, device="cpu")
    init_fn, train_step, _ = step_mod.make_step_fns(
        model, build_optimizer(optimizer, **OPT), _eager=not captured, **kw)
    state = init_fn(0)
    x = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (8, 32)))
    return train_step, state, x


def _bits(state):
    opt = state.opt_state
    return ([p.detach().clone() for p in state.params.values()]
            + [t.clone() for v in opt.moments().values() for t in v.values()]
            + [opt.count.clone()])


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_fused"])
def test_captured_schedule_matches_eager_bits(stand_in, optimizer):
    runs = {}
    for captured in (False, True):
        train_step, state, x = _setup(optimizer, captured=captured)
        metrics = [train_step(state, x, x)[1] for _ in range(6)]
        runs[captured] = ([m["loss"] for m in metrics], _bits(state))
        assert state.step == 6 and int(state.opt_state.count) == 6
    assert isinstance(train_step, step_mod.CapturedStep)
    assert (train_step.stats["eager_steps"], train_step.stats[
        "graph_captures"], train_step.stats["graph_replays"]) == (1, 1, 5)
    (l_e, b_e), (l_g, b_g) = runs[False], runs[True]
    assert len({id(v) for v in l_g}) == 6      # a fresh tensor a step
    assert [v.item() for v in l_g] == [v.item() for v in l_e]
    assert len(set(v.item() for v in l_g)) == 6
    assert _same(b_g, b_e)


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_fused"])
def test_captured_skip_keeps_the_bits(stand_in, optimizer):
    train_step, state, x = _setup(optimizer, captured=True,
                                  nonfinite_policy="skip", sentinel=True)
    for _ in range(3):
        assert train_step(state, x, x)[1]["skipped"].item() == 0.0
    wte = state.params["wte.weight"].detach()
    clean = wte[3, 5].item()
    wte[3, 5] = float("inf")
    before = _bits(state)
    _, m = train_step(state, x, x)
    assert m["skipped"].item() == 1.0
    assert not torch.isfinite(m["grad_sumsq"]).item()
    assert _same(_bits(state), before)
    wte[3, 5] = clean
    _, m = train_step(state, x, x)
    assert m["skipped"].item() == 0.0
    assert int(state.opt_state.count) == 4 and state.step == 5
    assert train_step.stats["graph_replays"] == 4


def test_each_batch_shape_warms_up_and_captures_once(stand_in):
    train_step, state, x = _setup("adamw_fused", captured=True)
    half = x[:4].clone()
    for batch in (x, half, x, half, x, half):
        train_step(state, batch, batch)
    assert len(train_step.programs) == 2
    assert (train_step.stats["eager_steps"], train_step.stats[
        "graph_captures"], train_step.stats["graph_replays"]) == (2, 2, 4)


def test_another_state_is_refused(stand_in):
    model = GPT2(CFG, device="cpu")
    init_fn, train_step, _ = step_mod.make_step_fns(
        model, build_optimizer("adamw_fused", **OPT))
    state = init_fn(0)
    x = torch.zeros(8, 32, dtype=torch.long)
    for _ in range(2):
        train_step(state, x, x)
    with pytest.raises(ValueError, match="captured"):
        train_step(init_fn(0), x, x)


def test_cpu_model_never_touches_cuda_graphs(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU model's step touched CUDA graphs")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(graphs, "capture", refuse)
    train_step, state, x = _setup("adamw_fused", captured=True)
    assert not isinstance(train_step, step_mod.CapturedStep)
    for _ in range(3):
        train_step(state, x, x)
    assert state.step == 3
