"""The port's BERT (masked LM) against the JAX package's, on the CPU.

BERT-tiny (2 post-LN layers, d_model 64, 4 heads, vocab 256) at T = 32,
the JAX ``init`` converted by ``interop.bert_params_from_jax``, a batch of
8 sequences of 8-32 real tokens padded with ``pad_token_id`` 0, from a
numpy seed. Tolerances (f32; the frameworks sum in different orders):

- the logits, with the pad mask (``pad_token_id`` 0, the flash kernels'
  plain versions non-causal under ``kv_mask`` here) and without it, in
  eval: 1e-5;
- ``mask_inputs`` on the JAX ``_mask_inputs`` decisions (recomputed from
  the same key splits): exact; ``mlm_loss`` on the JAX draw against the
  JAX ``train_loss`` on the same key (dropout 0): 1e-5;
- the draws, held to invariants (``jax.random`` bits cannot be drawn by a
  ``torch.Generator``): one seed gives one draw, no pad position is
  selected, the 15 % rate and the 80/10/10 split hold within 5-sigma
  binomial margins, the ranks of a world of 2 draw the global batch's;
- ten AdamW steps against the JAX ``make_step_fns`` with one fixed JAX
  mask draw patched into both packages: losses 1e-4 relative,
  parameters 1e-4 (absolute and relative; the key third of ``qkv.bias``
  left out, its exact gradient is zero: ``tests/test_torch_train.py``);
- two gloo ranks (ZeRO-1 under ``--shard_update auto``, dropout 0.1)
  against one process (``tests/torch_ladder_worker.py``): 1e-5;
- the converters round-trip exactly, a checkpoint resumes bit for bit and
  the JAX ``restore_params`` reads it, the CLI trains the tiny preset on
  ``synthetic-lm`` (ignoring ``--augment`` with a warning) and resumes,
  accumulation draws each microbatch's masks, and a post-LN block
  refuses to decode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.core.mesh import batch_sharding, make_mesh
from distributed_compute_pytorch_tpu.models.bert import (
    BertConfig as JaxBertConfig, BertMLM as JaxBert)
from distributed_compute_pytorch_tpu.train import checkpoint as jax_checkpoint
from distributed_compute_pytorch_tpu.train.optim import (
    build_optimizer as jax_build_optimizer)
from distributed_compute_pytorch_tpu.train.step import (
    make_step_fns as jax_make_step_fns)
from distributed_compute_pytorch_tpu_torch import cli, interop
from distributed_compute_pytorch_tpu_torch.core import mesh
from distributed_compute_pytorch_tpu_torch.core.config import Config
from distributed_compute_pytorch_tpu_torch.models.bert import (
    BertConfig, BertMLM)
from distributed_compute_pytorch_tpu_torch.models.registry import build_model
from distributed_compute_pytorch_tpu_torch.models.transformer import (
    TransformerBlock)
from distributed_compute_pytorch_tpu_torch.train import checkpoint
from distributed_compute_pytorch_tpu_torch.train import (
    trainer as trainer_module)
from distributed_compute_pytorch_tpu_torch.train.optim import build_optimizer
from distributed_compute_pytorch_tpu_torch.train.step import make_step_fns

from torch_ladder_worker import run_world
from torch_threads import one_thread  # noqa: F401 (autouse)

B, T, STEPS = 8, 32, 10
FWD_TOL, LOSS_TOL, PARAM_TOL, DDP_TOL = 1e-5, 1e-4, 1e-4, 1e-5
CFG = dataclasses.replace(BertConfig.tiny(), max_seq_len=T, pad_token_id=0)
JCFG = dataclasses.replace(JaxBertConfig.tiny(), max_seq_len=T,
                           pad_token_id=0)
OPT = {"lr": 1e-3, "gamma": 0.7, "steps_per_epoch": STEPS,
       "warmup_steps": 2, "total_steps": STEPS}


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(0)
    toks = rng.integers(2, CFG.vocab_size, (B, T)).astype(np.int32)
    lengths = rng.integers(8, T + 1, B)
    lengths[0] = T
    toks[np.arange(T)[None] >= lengths[:, None]] = 0
    return toks


@pytest.fixture(scope="module")
def jax_params():
    params, _ = JaxBert(JCFG).init(jax.random.key(0))
    return params


def _port(params, cfg=CFG):
    model = BertMLM(cfg, device="cpu")
    model.load_state_dict(interop.bert_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return model


@pytest.mark.parametrize("padded", [True, False], ids=["pad_mask", "no_mask"])
def test_logits_match_jax(tokens, jax_params, padded):
    jcfg = JCFG if padded else dataclasses.replace(JCFG, pad_token_id=None)
    cfg = CFG if padded else dataclasses.replace(CFG, pad_token_id=None)
    want, _ = JaxBert(jcfg).apply(jax_params, {}, jnp.asarray(tokens))
    model = _port(jax_params, cfg)
    got = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=FWD_TOL)
    if padded:
        # the pad keys are refused: the unmasked forward differs
        free = model(torch.from_numpy(tokens).long(),
                     kv_mask=torch.ones(B, T))
        assert (free - got).abs().max() > 1e-3


def _jax_draw(key, tokens):
    """The JAX ``train_loss`` draw of ``key`` and its raw decisions."""
    r_mask, _ = jax.random.split(key)
    r_sel, r_kind, r_rand = jax.random.split(r_mask, 3)
    shape = tokens.shape
    raw = (np.array(jax.random.bernoulli(r_sel, JCFG.mask_rate, shape)),
           np.array(jax.random.uniform(r_kind, shape)),
           np.array(jax.random.randint(r_rand, shape, 0, JCFG.vocab_size)))
    jm = JaxBert(JCFG)
    inputs, selected = jm._mask_inputs(jnp.asarray(tokens), r_mask,
                                       jm.padding_mask(jnp.asarray(tokens)))
    return raw, np.array(inputs), np.array(selected)


def test_mlm_loss_on_the_jax_draw_matches_jax(tokens, jax_params):
    key = jax.random.key(5)
    (sel, kind, rand), j_inputs, j_selected = _jax_draw(key, tokens)
    model = _port(jax_params)
    tok = torch.from_numpy(tokens).long()
    inputs, selected = model.mask_inputs(
        tok, torch.from_numpy(sel), torch.from_numpy(kind),
        torch.from_numpy(rand).long())
    np.testing.assert_array_equal(inputs.numpy(), j_inputs)
    np.testing.assert_array_equal(selected.numpy(), j_selected)
    want, _ = JaxBert(JCFG).train_loss(jax_params, {}, jnp.asarray(tokens),
                                       None, key)
    got = model.mlm_loss(inputs, selected, tok, model.padding_mask(tok))
    assert float(got) == pytest.approx(float(want), rel=FWD_TOL)


def test_draw_invariants():
    n, t = 256, 64
    cfg = dataclasses.replace(CFG, max_seq_len=t)
    model = BertMLM(cfg, device="cpu")
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(2, cfg.vocab_size, (n, t))).long()
    tok[:, t // 2:] = 0                        # half of every row is pad
    a = model.draw_masks(tok, torch.Generator().manual_seed(3))
    b = model.draw_masks(tok, torch.Generator().manual_seed(3))
    c = model.draw_masks(tok, torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    inputs, selected = a
    real = tok != 0
    assert not selected[~real].any()
    assert torch.equal(inputs[~selected], tok[~selected])

    def within(count, trials, p):
        return abs(count - trials * p) < 5 * (trials * p * (1 - p)) ** 0.5
    n_real, n_sel = int(real.sum()), int(selected.sum())
    assert within(n_sel, n_real, cfg.mask_rate)
    masked = int((inputs[selected] == cfg.mask_token_id).sum())
    kept = int((inputs[selected] == tok[selected]).sum())
    assert within(masked, n_sel, 0.8)
    # a random token equal to the original counts as kept: p 0.1 + 0.1/V
    assert within(kept, n_sel, 0.1 + 0.1 / cfg.vocab_size)
    assert within(n_sel - masked - kept, n_sel, 0.1 - 0.1 / cfg.vocab_size)


def test_ranks_draw_the_global_batch(monkeypatch, tokens):
    model = BertMLM(CFG, device="cpu")
    tok = torch.from_numpy(tokens).long()
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    ranks = []
    for r in range(2):
        monkeypatch.setattr(mesh, "process_index", lambda r=r: r)
        ranks.append(model.draw_masks(tok[r * 4:(r + 1) * 4],
                                      torch.Generator().manual_seed(7)))
    monkeypatch.setattr(mesh, "process_count", lambda: 1)
    monkeypatch.setattr(mesh, "process_index", lambda: 0)
    whole = model.draw_masks(tok, torch.Generator().manual_seed(7))
    for i in range(2):
        assert torch.equal(torch.cat([ranks[0][i], ranks[1][i]]), whole[i])


@pytest.fixture(scope="module")
def runs(tokens, jax_params):
    """Ten AdamW steps of each package, one fixed JAX mask draw in both."""
    _, inputs, selected = _jax_draw(jax.random.key(9), tokens)
    mp = pytest.MonkeyPatch()
    mp.setattr(JaxBert, "_mask_inputs", lambda self, t, r, p=None: (
        jnp.asarray(inputs), jnp.asarray(selected)))
    mp.setattr(BertMLM, "draw_masks", lambda self, t, g: (
        torch.from_numpy(inputs).long(), torch.from_numpy(selected)))
    try:
        mesh_ = make_mesh("data=1", devices=jax.devices()[:1])
        tx = jax_build_optimizer("adamw", **OPT)
        init_fn, train_step, eval_step = jax_make_step_fns(
            JaxBert(JCFG), tx, mesh_, donate=False)
        js = init_fn(jax.random.key(0)).replace(params=jax_params,
                                                opt_state=tx.init(jax_params))
        x = jax.device_put(jnp.asarray(tokens), batch_sharding(mesh_, 2))
        jl = []
        for _ in range(STEPS):
            js, m = train_step(js, x, x)
            jl.append(float(m["loss"]))
        jev = {k: float(v) for k, v in eval_step(js, x, x).items()}
        init, step, ev = make_step_fns(_port(jax_params),
                                       build_optimizer("adamw", **OPT))
        ps = init(None)
        xt = torch.from_numpy(tokens).long()
        pl = [float(step(ps, xt, xt)[1]["loss"]) for _ in range(STEPS)]
        pev = {k: float(v) for k, v in ev(ps, xt, xt).items()}
    finally:
        mp.undo()
    return (jl, jax.tree.map(np.asarray, js.params), jev), (pl, ps, pev)


def _without_key_bias(name, t):
    if not name.endswith("qkv.bias"):
        return t
    d = CFG.d_model
    return torch.cat([t[:d], t[2 * d:]])


def test_adamw_steps_match_jax(runs, tokens):
    (jl, jp, jev), (pl, ps, pev) = runs
    np.testing.assert_allclose(pl, jl, rtol=LOSS_TOL)
    assert pl[-1] < pl[0]
    for name, want in interop.bert_params_from_jax(jp).items():
        got = ps.params[name].detach()
        np.testing.assert_allclose(_without_key_bias(name, got).numpy(),
                                   _without_key_bias(name, want).numpy(),
                                   atol=PARAM_TOL, rtol=PARAM_TOL,
                                   err_msg=name)
    assert pev["count"] == jev["count"] == int((tokens != 0).sum())
    assert pev["correct"] == jev["correct"]
    assert pev["loss_sum"] == pytest.approx(jev["loss_sum"], rel=LOSS_TOL)


def test_converters_round_trip(jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    sd = interop.bert_params_from_jax(tree)
    assert set(sd) == set(BertMLM(CFG, device="cpu").state_dict())
    back, state = interop.params_to_jax(sd)
    assert state == {} and interop.model_kind(sd) == "bert"
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    again = interop.params_from_jax(back, {})
    assert all(torch.equal(again[k], sd[k]) for k in sd)


def test_accumulation_draws_each_microbatch_its_masks(tokens, jax_params):
    draws = []
    real = BertMLM.draw_masks

    def spy(self, t, g):
        out = real(self, t, g)
        draws.append(out[1].clone())
        return out
    model = _port(jax_params)
    init, step, _ = make_step_fns(model, build_optimizer("adamw", **OPT),
                                  accum_steps=2)
    state = init(None)
    xt = torch.from_numpy(tokens).long()
    try:
        BertMLM.draw_masks = spy
        step(state, xt, xt)
    finally:
        BertMLM.draw_masks = real
    assert len(draws) == 2 and draws[0].shape == (B // 2, T)
    assert not torch.equal(draws[0], draws[1])


def test_checkpoint_round_trip_and_jax_reads(tokens, tmp_path):
    xt = torch.from_numpy(tokens).long()
    tx = build_optimizer("adamw", **OPT)
    model = BertMLM(CFG, device="cpu")
    init, step, _ = make_step_fns(model, tx)
    state = init(2)
    for _ in range(3):
        state, _ = step(state, xt, xt)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, state, epoch=0)
    other = BertMLM(CFG, device="cpu")
    init2, step2, _ = make_step_fns(other, tx)
    restored = init2(8)
    checkpoint.restore_with_fallback(path, restored)
    assert restored.step == 3
    for name, t in state.params.items():
        assert torch.equal(t, restored.params[name]), name
    _, m1 = step(state, xt, xt)
    _, m2 = step2(restored, xt, xt)
    assert float(m1["loss"]) == float(m2["loss"])
    jp = interop.bert_params_to_jax(restored.params)
    got = jax_checkpoint.restore_params(path, jax.tree.map(jnp.asarray, jp))
    assert jax.tree.structure(got) == jax.tree.structure(jp)


def test_cli_trains_bert_and_ignores_augment(tmp_path, capsys, monkeypatch):
    """The BERT CLI: ``--augment`` warned about and ignored, 4 steps an
    epoch (the ``synthetic-lm`` splits cut to 256 sequences of 32 tokens),
    the eval line, then a resume."""
    load = trainer_module.load_dataset
    monkeypatch.setattr(trainer_module, "load_dataset",
                        lambda name, split, **kw: load(name, split, n=256,
                                                       seq_len=T, **kw))
    ck = str(tmp_path / "ck.npz")
    base = ["--device", "cpu", "--model", "bert", "--model_preset", "tiny",
            "--dataset", "synthetic-lm", "--optimizer", "adamw",
            "--batch_size", "64", "--log_every", "2", "--ckpt_path", ck]
    assert cli.main(base + ["--epochs", "1", "--augment", "flip-crop"]) == 0
    out = capsys.readouterr().out
    assert "WARNING: --augment flip-crop needs image (rank-4) inputs" in out
    assert "model: bert" in out and "epoch: 0 [2/4 (50%)]" in out
    assert "Test set: Average loss:" in out
    assert cli.main(base + ["--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "at epoch 1" in out
    assert checkpoint.load_manifest(ck)["epoch"] == 1


@pytest.mark.parametrize("argv, ok", [
    (["--model", "bert", "--model_preset", "base"], True),
    (["--model", "resnet50", "--dataset", "cifar10", "--augment", "flip"],
     True),
    (["--model", "moe"], False),
    (["--augment", "rotate"], False),
    (["--dataset", "imagenet"], False),
])
def test_cli_refusals_and_accepts(argv, ok):
    if ok:
        cfg = Config.from_argv(argv)
        assert cfg.model == argv[1]
    else:
        with pytest.raises(SystemExit):
            Config.from_argv(argv)


def test_registry_presets_and_mask_token():
    assert build_model("bert", preset="tiny", device="cpu").config == \
        BertConfig.tiny()
    assert build_model("bert", device="cpu").config == BertConfig.base()
    with pytest.raises(ValueError, match="mask_token_id"):
        BertMLM(dataclasses.replace(BertConfig.tiny(), mask_token_id=256),
                device="cpu")


def test_post_ln_block_refuses_to_decode():
    block = TransformerBlock(16, 2, 32, causal=False, pre_ln=False,
                             device="cpu")
    with pytest.raises(ValueError, match="causal pre-LN"):
        block.decode_step(torch.zeros(1, 1, 16), {}, 0)


def test_two_gloo_ranks_train_as_one_process(tmp_path):
    (one,) = run_world(tmp_path, "bert", 1, "data=-1")
    ranks = run_world(tmp_path, "bert", 2, "data=2")
    assert len(one["losses"]) == 8
    assert str(one.pop("strategy")) == "DataParallel"
    for r, got in enumerate(ranks):
        got.pop("strategy")
        for key, want in one.items():
            np.testing.assert_allclose(got[key], want, atol=DDP_TOL,
                                       rtol=DDP_TOL,
                                       err_msg=f"rank {r}: {key}")
