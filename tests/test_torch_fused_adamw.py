"""The port's AdamW against the JAX package, on the CPU.

- ``FusedAdamW`` (its plain version on CPU tensors, the arithmetic the
  CUDA kernel is held to on the card) against the JAX ``fused_adamw``'s
  ``fused_apply``, whose Pallas kernel runs in interpret mode here, over
  three steps of the warmup-cosine schedule (lr 0 at step 0). Tolerance
  1e-6: the same f32 elementwise ops, with the step's scalars computed
  from the device count in f32 on both sides.
- ``build_optimizer("adamw", weight_decay=0.01, clip_norm=1.0)`` against
  the JAX ``build_optimizer`` (``optax``) on GPT-2-tiny's params tree,
  decay mask included. Tolerance 1e-6.
- The refusals of ``adamw_fused`` with ``weight_decay``, ``clip_norm`` and
  the legacy ``grad_accum``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.ops.pallas.fused_adamw import (
    fused_adamw as jax_fused_adamw)
from distributed_compute_pytorch_tpu.train.optim import (
    build_optimizer as jax_build_optimizer)
from distributed_compute_pytorch_tpu_torch.interop import gpt2_params_from_jax
from distributed_compute_pytorch_tpu_torch.ops import fused_adamw as FA
from distributed_compute_pytorch_tpu_torch.train.optim import (
    build_optimizer, decay_mask, warmup_cosine_decay)

TOL = 1e-6
STEPS = 3


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": rng.standard_normal((5, 7)),
                      "bias": rng.standard_normal(7)},
            "table": {"embedding": rng.standard_normal((9, 4))}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = np.asarray(v, np.float32)
    return out


def test_schedule_matches_optax():
    ours = warmup_cosine_decay(3e-3, 4, 17)
    ref = optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=3e-3,
                                             warmup_steps=4, decay_steps=17)
    got = [ours(c) for c in range(20)]
    want = [float(ref(c)) for c in range(20)]
    assert got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_fused_adamw_matches_jax_fused_apply():
    sched = (0.0, 1e-2, 1, STEPS + 2)   # init, peak, warmup, decay steps
    params = _tree(0)
    grads = [_tree(10 + s) for s in range(STEPS)]

    jtx = jax_fused_adamw(optax.warmup_cosine_decay_schedule(*sched))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    jstate = jtx.init(jp)
    for g in grads:
        jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), g)
        jp, jstate = jtx.fused_apply(jg, jstate, jp)

    tx = FA.fused_adamw(warmup_cosine_decay(sched[1], sched[2], sched[3]))
    tp = {n: torch.nn.Parameter(torch.from_numpy(a))
          for n, a in _flat(params).items()}
    before = {n: p.detach().clone() for n, p in tp.items()}
    state = tx.init(tp)
    launches = FA.launches
    for step, g in enumerate(grads):
        for n, a in _flat(g).items():
            tp[n].grad.copy_(torch.from_numpy(a))
        tx.fused_apply({n: p.grad for n, p in tp.items()}, state, tp,
                       torch.tensor(True))
        if step == 0:      # lr 0 at count 0: moments move, params do not
            for n, p in tp.items():
                assert torch.equal(p.detach(), before[n]), n
    assert FA.launches == launches and state.count == STEPS
    for kind, want in (("params", jp), ("mu", jstate.mu), ("nu", jstate.nu)):
        got = (tp if kind == "params" else state.moments()[kind])
        for n, w in _flat(jax.tree.map(np.asarray, want)).items():
            np.testing.assert_allclose(got[n].detach().numpy(), w, rtol=TOL,
                                       atol=TOL, err_msg=f"{kind} {n}")


def test_fused_apply_refuses_grads_outside_its_buffer():
    tx = FA.fused_adamw(1e-3)
    tp = {"w": torch.nn.Parameter(torch.ones(3, 2))}
    state = tx.init(tp)
    assert tp["w"].grad.data_ptr() == state.grads.data_ptr()
    tp["w"].grad = torch.zeros(3, 2)          # replaced, as set_to_none does
    with pytest.raises(RuntimeError, match="flat buffer"):
        tx.fused_apply({"w": tp["w"].grad}, state, tp, torch.tensor(True))


def test_adamw_with_clip_and_masked_decay_matches_optax():
    """GPT-2-tiny's params: the port's names decay exactly where the JAX
    package's ``kernel``/``embedding`` leaves do; gradients large enough
    that the global-norm clip engages."""
    params, _ = JaxGPT2(JaxGPT2Config.tiny()).init(jax.random.key(0))
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape) * 0.05, jnp.float32), params)
        for _ in range(STEPS)]
    kw = {"weight_decay": 0.01, "clip_norm": 1.0, "warmup_steps": 1,
          "total_steps": 10}
    jtx = jax_build_optimizer("adamw", 1e-2, 0.7, 5, **kw)
    jp, jstate = params, jtx.init(params)
    for g in grads:
        upd, jstate = jtx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)

    tp = gpt2_params_from_jax(jax.tree.map(np.asarray, params))
    mask = decay_mask(tp)
    assert [n for n, m in mask.items() if not m] == [
        n for n in tp if n.endswith(".bias") or ".ln" in n
        or n.startswith("ln_f")]
    tx = build_optimizer("adamw", 1e-2, 0.7, 5, **kw)
    state = tx.init(tp)
    norms = []
    for g in grads:
        tg = gpt2_params_from_jax(jax.tree.map(np.asarray, g))
        norms.append(float(torch.sqrt(sum(v.square().sum()
                                          for v in tg.values()))))
        tx.apply(tg, state, tp)
    assert max(norms) > 1.0          # the clip engaged
    want = gpt2_params_from_jax(jax.tree.map(np.asarray, jp))
    for n, w in want.items():
        np.testing.assert_allclose(tp[n].numpy(), w.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=n)


@pytest.mark.parametrize("kw", [{"weight_decay": 0.01}, {"clip_norm": 1.0},
                                {"grad_accum": 2}],
                         ids=["weight_decay", "clip_norm", "grad_accum"])
def test_adamw_fused_refuses_what_it_cannot_do(kw):
    with pytest.raises(ValueError, match="adamw_fused"):
        jax_build_optimizer("adamw_fused", 1e-3, 0.7, 5, **kw)
    with pytest.raises(ValueError, match="adamw_fused"):
        build_optimizer("adamw_fused", 1e-3, 0.7, 5, **kw)
