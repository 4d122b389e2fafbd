"""The port's device-side optimizer count and ``nonfinite_policy="skip"``
against the JAX package, on the CPU.

- The step scalars ``[lr, wd, c1, c2]`` the port computes from its device
  ``int32`` count against the reference's ``_scalars`` (the closure of the
  JAX ``fused_adamw``'s ``fused_apply``) at counts 0-20: within one f32
  ulp. The warmup-cosine schedule's tensor form against its float form
  (f32 against f64: 1e-6 relative) and against optax's jitted schedule
  (1e-6 of the peak learning rate: not in ulps, as XLA's fused cosine and
  PyTorch's differ by an ulp, which ``1 + cos`` near the end of the decay
  turns into tens of ulps of a learning rate near 0).
- GPT-2-tiny (2 layers, d_model 64, T 32, batch 8 on a ``data=1`` mesh,
  as ``tests/test_torch_train.py``), the port's ``make_step_fns(
  nonfinite_policy="skip", sentinel=True)`` against the JAX one, for
  ``adamw`` and ``adamw_fused``: a clean step (``skipped`` 0, loss and
  ``grad_sumsq`` within 1e-4 relative); a step with one ``wte`` element
  set to ``inf`` on both sides (``skipped`` 1, params and optimizer state,
  the count included, bit-identical to before on both sides, ``step``
  advanced); then, the element restored, three steps whose losses (1e-4
  relative) and parameters (1e-4 absolute, the key bias left out as in
  ``tests/test_torch_train.py``) match the JAX steps', so the count did
  not move on the skip (the bias corrections at counts 1 and 2 differ by
  a factor 1.4).
- A bad policy string raises at build time.
- The trainer, its steps poisoned through the real guard: ten or more
  consecutive skips abort with the reference's message; scattered skips
  are logged and the run goes on; under ``raise`` a poisoned step aborts
  at the log read with the reference's message. ``--nonfinite_policy
  skip`` through the CLI.
- A checkpoint round trip restores the device count into the same tensor.
"""

import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.core.mesh import batch_sharding, make_mesh
from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.train.optim import (
    build_optimizer as jax_build_optimizer)
from distributed_compute_pytorch_tpu.train.step import (
    make_step_fns as jax_make_step_fns)
from distributed_compute_pytorch_tpu_torch import cli
from distributed_compute_pytorch_tpu_torch.core.config import Config
from distributed_compute_pytorch_tpu_torch.data.datasets import synthetic_lm
from distributed_compute_pytorch_tpu_torch.interop import (
    gpt2_params_from_jax, load_gpt2_params)
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.train import checkpoint
from distributed_compute_pytorch_tpu_torch.train.optim import (
    build_optimizer, warmup_cosine_decay)
from distributed_compute_pytorch_tpu_torch.train.step import make_step_fns
from distributed_compute_pytorch_tpu_torch.train.trainer import Trainer

B, T = 8, 32
TOL = 1e-4
OPT = {"lr": 1e-3, "gamma": 0.7, "steps_per_epoch": 10, "warmup_steps": 2,
       "total_steps": 10}
CFG = dataclasses.replace(GPT2Config.tiny(), max_seq_len=T)
POISON = (3, 5)          # the wte element set to inf


def _ulps(a, b) -> int:
    a, b = (np.asarray(v, np.float32).reshape(-1) for v in (a, b))
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _ref_scalars(jtx):
    """The JAX ``fused_adamw``'s ``_scalars``, from its ``fused_apply``'s
    closure."""
    fn = jtx.fused_apply
    return dict(zip(fn.__code__.co_freevars,
                    fn.__closure__))["_scalars"].cell_contents


def test_device_scalars_match_the_reference():
    jtx = jax_build_optimizer("adamw_fused", 3e-3, 0.7, 20,
                              warmup_steps=4, total_steps=20)
    ref = jax.jit(_ref_scalars(jtx))
    tx = build_optimizer("adamw_fused", 3e-3, 0.7, 20, warmup_steps=4,
                         total_steps=20)
    worst = 0
    for c in range(21):
        got = tx.scalars(torch.tensor(c, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == (4,)
        worst = max(worst, _ulps(got.numpy(), ref(jnp.int32(c))))
    assert worst <= 1


def test_tensor_schedule_matches_float_and_optax():
    import optax
    ours = warmup_cosine_decay(3e-3, 4, 17)
    ref = jax.jit(optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-3, warmup_steps=4, decay_steps=17))
    counts = range(22)
    got = [ours(torch.tensor(c, dtype=torch.int32)) for c in counts]
    assert all(g.dtype == torch.float32 and g.ndim == 0 for g in got)
    got = [float(g) for g in got]
    assert got[0] == 0.0 and got[4] == pytest.approx(3e-3, rel=1e-7)
    np.testing.assert_allclose(got, [ours(c) for c in counts], rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(got, [float(ref(jnp.int32(c)))
                                     for c in counts], rtol=0, atol=3e-9)


@pytest.fixture(scope="module")
def tokens():
    return synthetic_lm(B, T, 256, seed=3).inputs


@pytest.fixture(scope="module")
def jax_params():
    cfg = dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=T)
    params, _ = JaxGPT2(cfg).init(jax.random.key(0))
    return params


def _set_wte(tree, value):
    emb = tree["wte"]["embedding"]
    return {**tree, "wte": {**tree["wte"],
                            "embedding": emb.at[POISON].set(value)}}


def _jax_guarded(params, tokens, optimizer):
    """One clean step, one with ``wte[POISON] = inf``, the element
    restored and three more: ``(metrics, states)`` per step, as numpy."""
    cfg = dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=T)
    mesh = make_mesh("data=1", devices=jax.devices()[:1])
    tx = jax_build_optimizer(optimizer, **OPT)
    init_fn, train_step, _ = jax_make_step_fns(
        JaxGPT2(cfg), tx, mesh, donate=False, nonfinite_policy="skip",
        sentinel=True)
    state = init_fn(jax.random.key(0))
    state = state.replace(params=params, opt_state=tx.init(params))
    x = jax.device_put(jnp.asarray(tokens), batch_sharding(mesh, 2))
    clean = params["wte"]["embedding"][POISON]
    out = []
    for k in range(5):
        if k == 1:
            state = state.replace(params=_set_wte(state.params, jnp.inf))
        if k == 2:
            state = state.replace(params=_set_wte(state.params, clean))
        before = jax.tree.map(np.asarray, (state.params, state.opt_state))
        state, m = train_step(state, x, x)
        out.append(({k_: float(v) for k_, v in m.items()}, before,
                    jax.tree.map(np.asarray,
                                 (state.params, state.opt_state)),
                    int(state.step)))
    return out


def _port_snapshot(state):
    opt = state.opt_state
    return ({n: p.detach().clone() for n, p in state.params.items()},
            {k: {n: t.clone() for n, t in v.items()}
             for k, v in opt.moments().items()}, opt.count.clone())


def _assert_same_bits(a, b):
    pa, ma, ca = a
    pb, mb, cb = b
    assert torch.equal(ca, cb)
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    for kind in ma:
        for n in ma[kind]:
            assert torch.equal(ma[kind][n], mb[kind][n]), (kind, n)


def _without_key_bias(name, t):
    if not name.endswith("qkv.bias"):
        return t
    d = CFG.d_model
    return torch.cat([t[:d], t[2 * d:]])


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_fused"])
def test_skip_guard_matches_jax(tokens, jax_params, optimizer):
    ref = _jax_guarded(jax_params, tokens, optimizer)
    model = load_gpt2_params(GPT2(CFG, device="cpu"),
                             jax.tree.map(np.asarray, jax_params))
    init_fn, train_step, _ = make_step_fns(
        model, build_optimizer(optimizer, **OPT), nonfinite_policy="skip",
        sentinel=True)
    state = init_fn(None)
    wte = state.params["wte.weight"].detach()
    clean = float(wte[POISON])
    x = torch.from_numpy(tokens).long()
    for k, (jm, jbefore, jafter, jstep) in enumerate(ref):
        if k == 1:
            wte[POISON] = float("inf")
        if k == 2:
            wte[POISON] = clean
        before = _port_snapshot(state)
        state, m = train_step(state, x, x)
        assert set(m) == {"loss", "skipped", "grad_sumsq"}
        assert state.step == jstep == k + 1
        assert float(m["skipped"]) == jm["skipped"] == float(k == 1)
        if k == 1:
            _assert_same_bits(_port_snapshot(state), before)
            assert int(state.opt_state.count) == 1
            for a, b in zip(jax.tree_util.tree_leaves(jbefore),
                            jax.tree_util.tree_leaves(jafter)):
                np.testing.assert_array_equal(a, b)
            continue
        assert float(m["loss"]) == pytest.approx(jm["loss"], rel=TOL)
        assert float(m["grad_sumsq"]) == pytest.approx(jm["grad_sumsq"],
                                                       rel=TOL)
    assert int(state.opt_state.count) == 4
    for name, want in gpt2_params_from_jax(ref[-1][2][0]).items():
        got = state.params[name].detach()
        np.testing.assert_allclose(_without_key_bias(name, got).numpy(),
                                   _without_key_bias(name, want).numpy(),
                                   atol=TOL, rtol=0, err_msg=name)


def test_bad_policy_raises_at_build_time():
    model = GPT2(CFG, device="cpu")
    with pytest.raises(ValueError, match="nonfinite_policy"):
        make_step_fns(model, build_optimizer("adamw", **OPT),
                      nonfinite_policy="ignore")


def _poisoning_trainer(tmp_path, poisoned, policy="skip"):
    """A GPT-2-tiny ``synthetic-lm`` trainer (16 steps an epoch) whose
    step ``b`` runs with ``wte[POISON] = inf`` when ``poisoned(b)``: the
    real guard skips it; the element is restored after the step."""
    cfg = Config(device="cpu", model_preset="tiny", batch_size=128,
                 epochs=1, log_every=4, nonfinite_policy=policy,
                 ckpt_path=str(tmp_path / "ck.npz"))
    tr = Trainer(cfg)
    step, calls = tr.train_step, []

    def poisoning_step(state, x, y):
        wte = state.params["wte.weight"].detach()
        clean = float(wte[POISON])
        bad = poisoned(len(calls))
        calls.append(bad)
        if bad:
            wte[POISON] = float("inf")
        state, metrics = step(state, x, y)
        wte[POISON] = clean
        return state, metrics
    tr.train_step = poisoning_step
    return tr, calls


def test_trainer_aborts_after_ten_consecutive_skips(tmp_path):
    tr, calls = _poisoning_trainer(tmp_path, lambda b: b >= 2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(
            RuntimeError, match=r"^11 consecutive non-finite updates "
                                r"skipped \(epoch 0 step 12\): the run has "
                                r"diverged — params are still the last "
                                r"finite state; lower the lr or clip "
                                r"gradients$"):
        tr.fit()
    assert len(calls) == 13
    assert "nonfinite_policy=skip: skipped 4 non-finite update(s) near " \
           "epoch 0 step 8 (total 7, consecutive 7)" in buf.getvalue()


def test_trainer_raise_aborts_at_the_log_read(tmp_path):
    """``raise``: the step has no guard; the log-cadence read of a
    non-finite loss aborts with the reference's message."""
    tr, calls = _poisoning_trainer(tmp_path, lambda b: b == 4, "raise")
    with contextlib.redirect_stdout(io.StringIO()), pytest.raises(
            RuntimeError, match=r"^non-finite loss nan at epoch 0 step 4 "
                                r"\(nonfinite_policy=raise\); use "
                                r"--nonfinite_policy skip to drop bad "
                                r"updates instead of aborting$"):
        tr.fit()
    assert len(calls) == 5 and tr._skip_hist == []


def test_trainer_goes_on_through_scattered_skips(tmp_path):
    tr, calls = _poisoning_trainer(tmp_path, lambda b: b % 2 == 1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tr.fit()
    out = buf.getvalue()
    assert len(calls) == 16 and tr._skips_total == 8
    assert tr._skips_consec == 1
    assert re.search(r"skipped 2 non-finite update\(s\) near epoch 0 step 4 "
                     r"\(total 2, consecutive 0\)", out)
    assert "Test set:" in out
    assert int(tr.state.opt_state.count) == 8
    assert all(bool(torch.isfinite(p).all())
               for p in tr.state.params.values())


def test_cli_takes_nonfinite_policy_skip(tmp_path, capsys):
    assert cli.main(["--device", "cpu", "--model_preset", "tiny",
                     "--optimizer", "adamw_fused", "--batch_size", "256",
                     "--epochs", "1", "--log_every", "4",
                     "--nonfinite_policy", "skip",
                     "--ckpt_path", str(tmp_path / "ck.npz")]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^epoch: 0 \[4/8 \(50%\)\]\t Loss:[\d.]+$", out, re.M)
    assert "skipped" not in out


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_fused"])
def test_checkpoint_restores_the_count_in_place(tmp_path, tokens,
                                                optimizer):
    """Three steps saved, restored into a fresh state: the count lands in
    the fresh state's own tensor (same object, same address), as every
    other leaf does."""
    x = torch.from_numpy(tokens).long()
    states = []
    for steps in (3, 0):
        init_fn, train_step, _ = make_step_fns(
            GPT2(CFG, device="cpu"), build_optimizer(optimizer, **OPT))
        states.append(init_fn(0))
        for _ in range(steps):
            train_step(states[-1], x, x)
    src, dst = states
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, src)
    count = dst.opt_state.count
    ptr = count.data_ptr()
    checkpoint.restore_with_fallback(path, dst)
    assert dst.opt_state.count is count and count.data_ptr() == ptr
    assert count.dtype == torch.int32 and int(count) == 3
    assert dst.step == 3
    _assert_same_bits(_port_snapshot(dst), _port_snapshot(src))
