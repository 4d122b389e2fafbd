"""The port's Llama against the JAX package's, on the CPU.

Llama-tiny (2 layers, d_model 64, 4 query heads over 2 kv heads, so each
kv head serves G = 2 query heads, where ``repeat`` and ``repeat_interleave``
differ; d_ff 128, vocab 256), f32, the JAX ``init`` converted by
``interop.llama_params_from_jax``; inputs from numpy seeds. Tolerances
(the frameworks sum in different orders):

- ``apply_rope`` with shared and per-row positions: 1e-6; ``RMSNorm`` in
  f32: 1e-6, in bf16: one bf16 ulp of the output (both compute in f32 and
  round once);
- one block's forward under a ragged pad mask, and the post-rope K/V its
  ``kv_sink`` captures at kv-head width: 1e-5; the GQA block against the
  same block with its K/V projections tiled to MHA by hand: 1e-5;
- ``LlamaLM`` logits against the JAX ``LlamaLM`` (with a ragged pad mask
  through the JAX blocks, and without): 1e-5; against HF
  ``LlamaForCausalLM`` on the port's ``llama_to_hf_state_dict``: 2e-4, as
  the JAX package's own HF test;
- the converters round-trip bit for bit, both ways;
- ten ``adamw`` and ten ``adamw_fused`` steps against the JAX
  ``make_step_fns`` on the same batch: losses 1e-4 relative, parameters
  1e-5 absolute;
- two gloo ranks (``tests/torch_ladder_worker.py``) under ``--mesh
  data=2`` (ZeRO-1) and ``fsdp=2`` against one process: 1e-5;
- the CLIs: ``dcp-train --model llama`` trains the tiny preset and
  resumes, the JAX ``restore_params`` reads its checkpoint to the same
  leaves, ``dcp-generate`` and ``dcp-serve --model llama`` on it print the
  JAX CLIs' lines, and ``--model moe`` is refused in one line naming its
  ROADMAP item.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.core.mesh import batch_sharding, make_mesh
from distributed_compute_pytorch_tpu.models import layers as JL
from distributed_compute_pytorch_tpu.models.llama import (
    LlamaBlock as JaxBlock, LlamaConfig as JaxConfig, LlamaLM as JaxLlama)
from distributed_compute_pytorch_tpu.ops import rotary as jax_rotary
from distributed_compute_pytorch_tpu.train import checkpoint as jax_checkpoint
from distributed_compute_pytorch_tpu.train.optim import (
    build_optimizer as jax_build_optimizer)
from distributed_compute_pytorch_tpu.train.step import (
    make_step_fns as jax_make_step_fns)
from distributed_compute_pytorch_tpu_torch import cli, interop
from distributed_compute_pytorch_tpu_torch.core.config import Config
from distributed_compute_pytorch_tpu_torch.data.datasets import synthetic_lm
from distributed_compute_pytorch_tpu_torch.models import layers as L
from distributed_compute_pytorch_tpu_torch.models.llama import (
    LlamaBlock, LlamaConfig, LlamaLM)
from distributed_compute_pytorch_tpu_torch.models.registry import build_model
from distributed_compute_pytorch_tpu_torch.ops.rotary import apply_rope
from distributed_compute_pytorch_tpu_torch.parallel.api import fsdp_units
from distributed_compute_pytorch_tpu_torch.train import checkpoint
from distributed_compute_pytorch_tpu_torch.train import (
    trainer as trainer_module)
from distributed_compute_pytorch_tpu_torch.train.optim import build_optimizer
from distributed_compute_pytorch_tpu_torch.train.step import make_step_fns

from torch_ladder_worker import run_world

B, T, STEPS = 4, 32, 10
FWD_TOL, LOSS_TOL, PARAM_TOL, DDP_TOL, HF_TOL = 1e-5, 1e-4, 1e-5, 1e-5, 2e-4
CFG = dataclasses.replace(LlamaConfig.tiny(), max_seq_len=T)
JCFG = dataclasses.replace(JaxConfig.tiny(), max_seq_len=T)
OPT = {"lr": 1e-3, "gamma": 0.7, "steps_per_epoch": STEPS,
       "warmup_steps": 2, "total_steps": STEPS}


@pytest.fixture(scope="module")
def jax_params():
    params, _ = JaxLlama(JCFG).init(jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _port(params, cfg=CFG):
    model = LlamaLM(cfg, device="cpu")
    model.load_state_dict(interop.llama_params_from_jax(params))
    return model


def _tokens(seed=0, b=B):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (b, T)).astype(np.int32)


def _ragged_mask(b=B):
    """Right-padded key validity: row 0 full, the others 9-31 real."""
    lengths = np.random.default_rng(5).integers(9, T, b)
    lengths[0] = T
    return (np.arange(T)[None] < lengths[:, None]).astype(np.int32)


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
def test_apply_rope_matches_jax(per_row):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4, 7, 16)).astype(np.float32)
    pos = (rng.integers(0, 2048, (3, 7)) if per_row
           else rng.integers(0, 2048, 7)).astype(np.int32)
    want = jax_rotary.apply_rope(jnp.asarray(x), jnp.asarray(pos))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = (3.0 * rng.normal(size=(4, 5, 64))).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    want = JL.RMSNorm(64).apply({"scale": jnp.asarray(scale)},
                                jnp.asarray(x).astype(dtype))
    norm = L.RMSNorm(64, device="cpu")
    norm.weight.data.copy_(torch.from_numpy(scale))
    got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def _block_params(params, i=0):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), params["blocks"])


def test_block_forward_and_kv_sink_match_jax(jax_params):
    x = np.random.default_rng(3).normal(size=(B, T, CFG.d_model)).astype(
        np.float32)
    mask = _ragged_mask()
    sink_j: list = []
    want = JaxBlock(JCFG).apply(_block_params(jax_params), jnp.asarray(x),
                                kv_mask=jnp.asarray(mask), kv_sink=sink_j)
    block = _port(jax_params).blocks[0]
    sink: list = []
    got = block(torch.from_numpy(x), kv_mask=torch.from_numpy(mask),
                kv_sink=sink)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=FWD_TOL)
    (k, v), = sink
    assert tuple(k.shape) == (B, CFG.num_kv_heads, T, CFG.head_dim)
    for ours, ref in zip((k, v), sink_j[0]):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                   atol=FWD_TOL, rtol=FWD_TOL)


def test_gqa_block_equals_tiled_mha(jax_params):
    """Query head h reads kv head h // G: the GQA block equals an MHA block
    whose K/V projections repeat each kv head's rows G times in a row
    (reference ``tests/test_llama.py:130``); tiled round-robin (h % hk)
    it does not."""
    gqa = _port(jax_params).blocks[0]
    mha_cfg = dataclasses.replace(CFG, num_kv_heads=CFG.num_heads)
    G, hd = CFG.num_heads // CFG.num_kv_heads, CFG.head_dim
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(B, T, CFG.d_model)).astype(np.float32))
    want = gqa(x)
    for interleave, same in ((True, True), (False, False)):
        mha = LlamaBlock(mha_cfg, device="cpu")
        sd = dict(gqa.state_dict())
        for name in ("k", "v"):
            w = sd[f"{name}.weight"].reshape(CFG.num_kv_heads, 1, hd, -1)
            w = (w.expand(-1, G, -1, -1) if interleave
                 else w.transpose(0, 1).expand(G, -1, -1, -1))
            sd[f"{name}.weight"] = w.reshape(CFG.num_heads * hd, -1)
        mha.load_state_dict(sd)
        close = torch.allclose(mha(x), want, atol=FWD_TOL, rtol=FWD_TOL)
        assert close == same, f"interleave={interleave}"


def _jax_logits(params, tokens, mask=None):
    """The JAX ``LlamaLM`` forward; with ``mask``, its blocks under that
    ``kv_mask`` (``LlamaLM.apply`` takes none)."""
    jm = JaxLlama(JCFG)
    if mask is None:
        return np.asarray(jm.apply(params, {}, jnp.asarray(tokens))[0])
    x = jm.embed(params, jnp.asarray(tokens))
    for i in range(JCFG.num_layers):
        x = JaxBlock(JCFG).apply(_block_params(params, i), x,
                                 kv_mask=jnp.asarray(mask))
    return np.asarray(jm.readout(params, x))


@pytest.mark.parametrize("padded", [True, False], ids=["pad_mask", "no_mask"])
def test_logits_match_jax(jax_params, padded):
    tokens = _tokens()
    mask = _ragged_mask() if padded else None
    want = _jax_logits(jax_params, tokens, mask)
    model = _port(jax_params)
    got = model(torch.from_numpy(tokens).long(),
                kv_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_TOL,
                               rtol=FWD_TOL)
    if padded:
        assert (model(torch.from_numpy(tokens).long()) - got).abs().max() \
            > 1e-3


def test_converters_round_trip(jax_params):
    sd = interop.llama_params_from_jax(jax_params)
    assert set(sd) == set(LlamaLM(CFG, device="cpu").state_dict())
    assert interop.model_kind(sd) == interop.model_kind(jax_params) == "llama"
    back, state = interop.params_to_jax(sd)
    assert state == {}
    assert jax.tree.structure(back) == jax.tree.structure(jax_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_params)):
        np.testing.assert_array_equal(a, b)
    again = interop.params_from_jax(back, {})
    assert set(again) == set(sd)
    assert all(torch.equal(again[k], sd[k]) for k in sd)


def test_hf_converters_round_trip(jax_params):
    sd = interop.llama_params_from_jax(jax_params)
    hf = interop.llama_to_hf_state_dict(sd)
    assert len(hf) == 3 + 9 * CFG.num_layers
    back = interop.llama_from_hf_state_dict(
        {k: torch.from_numpy(v) for k, v in hf.items()}, CFG)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    del hf["lm_head.weight"]          # a tied-embedding checkpoint
    tied = interop.llama_from_hf_state_dict(hf, CFG)
    assert torch.equal(tied["lm_head.weight"], sd["wte.weight"])
    with pytest.raises(KeyError, match="missing"):
        interop.llama_from_hf_state_dict({}, CFG)
    short = dataclasses.replace(CFG, num_layers=CFG.num_layers - 1)
    with pytest.raises(ValueError, match="beyond config.num_layers"):
        interop.llama_from_hf_state_dict(hf, short)


def test_logits_match_hf_transformers(jax_params, monkeypatch):
    # the PyTorch model alone: transformers would import TensorFlow too
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=CFG.vocab_size, hidden_size=CFG.d_model,
        intermediate_size=CFG.d_ff, num_hidden_layers=CFG.num_layers,
        num_attention_heads=CFG.num_heads,
        num_key_value_heads=CFG.num_kv_heads,
        max_position_embeddings=CFG.max_seq_len, rms_norm_eps=CFG.rms_eps,
        rope_theta=CFG.rope_theta, attention_bias=False, mlp_bias=False,
        tie_word_embeddings=False, attn_implementation="eager")
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    model = _port(jax_params)
    missing, unexpected = hf.load_state_dict(
        {k: torch.from_numpy(v) for k, v in
         interop.llama_to_hf_state_dict(model.state_dict()).items()},
        strict=False)
    assert not unexpected and all("inv_freq" in m for m in missing)
    tokens = torch.from_numpy(_tokens(6, 2)).long()
    with torch.no_grad():
        np.testing.assert_allclose(model(tokens).numpy(),
                                   hf(tokens).logits.numpy(), atol=HF_TOL,
                                   rtol=HF_TOL)


@pytest.fixture(scope="module")
def batch():
    return synthetic_lm(B, T, CFG.vocab_size, seed=3).inputs


def _jax_steps(params, tokens, optimizer):
    mesh = make_mesh("data=1", devices=jax.devices()[:1])
    tx = jax_build_optimizer(optimizer, **OPT)
    init_fn, train_step, eval_step = jax_make_step_fns(
        JaxLlama(JCFG), tx, mesh, donate=False)
    params = jax.tree.map(jnp.asarray, params)
    state = init_fn(jax.random.key(0)).replace(params=params,
                                               opt_state=tx.init(params))
    x = jax.device_put(jnp.asarray(tokens), batch_sharding(mesh, 2))
    losses = []
    for _ in range(STEPS):
        state, m = train_step(state, x, x)
        losses.append(float(m["loss"]))
    ev = {k: float(v) for k, v in eval_step(state, x, x).items()}
    return losses, jax.tree.map(np.asarray, state.params), ev


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_fused"])
def test_ten_steps_match_jax(batch, jax_params, optimizer):
    j_losses, j_params, j_ev = _jax_steps(jax_params, batch, optimizer)
    init, step, ev = make_step_fns(_port(jax_params),
                                   build_optimizer(optimizer, **OPT))
    state = init(None)
    x = torch.from_numpy(batch).long()
    losses = [float(step(state, x, x)[1]["loss"]) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_TOL)
    assert losses[-1] < losses[0]
    for name, want in interop.llama_params_from_jax(j_params).items():
        np.testing.assert_allclose(state.params[name].detach().numpy(),
                                   want.numpy(), atol=PARAM_TOL, rtol=0,
                                   err_msg=name)
    got = {k: float(v) for k, v in ev(state, x, x).items()}
    assert got["count"] == j_ev["count"] == B * (T - 1)
    assert got["correct"] == j_ev["correct"]
    assert got["loss_sum"] == pytest.approx(j_ev["loss_sum"], rel=LOSS_TOL)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    (one,) = run_world(tmp_path_factory.mktemp("llama_one"), "llama", 1,
                       "data=-1")
    return one


@pytest.mark.parametrize("spec", ["data=2", "fsdp=2"])
def test_two_gloo_ranks_train_as_one_process(tmp_path, one_process, spec):
    one = dict(one_process)
    ranks = run_world(tmp_path, "llama", 2, spec)
    assert len(one["losses"]) == 8
    assert str(one.pop("strategy")) == "DataParallel"
    want_strategy = "FSDP" if spec.startswith("fsdp") else "DataParallel"
    for r, got in enumerate(ranks):
        assert str(got.pop("strategy")) == want_strategy
        for key, want in one.items():
            np.testing.assert_allclose(got[key], want, atol=DDP_TOL,
                                       rtol=DDP_TOL,
                                       err_msg=f"{spec} rank {r}: {key}")


def test_fsdp_units_are_the_blocks():
    units = dict(fsdp_units(LlamaLM(CFG, device="cpu")))
    assert list(units) == ["rest"] + [f"blocks.{i}"
                                      for i in range(CFG.num_layers)]
    assert units["rest"] == ["wte.weight", "norm_f.weight", "lm_head.weight"]
    assert len(units["blocks.0"]) == 9


def test_registry_presets_and_moe_refusal():
    assert build_model("llama", preset="tiny", device="cpu").config == \
        LlamaConfig.tiny()
    full = build_model("llama", device="cpu")
    assert full.config == LlamaConfig()
    assert sum(p.numel() for p in full.parameters()) == 124_668_672
    with pytest.raises(ValueError, match="queue 1, item 8"):
        build_model("moe", device="cpu")
    with pytest.raises(ValueError, match="multiple of num_kv_heads"):
        LlamaConfig(num_heads=12, num_kv_heads=5)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``dcp-train --model llama`` on the tiny preset for one epoch, then
    ``--resume --epochs 2``; the checkpoint and both runs' output. The
    ``synthetic-lm`` splits are cut from 2048 sequences to 64 and 32 (the
    same generator at its own width: T 128, vocab 256, which size the
    model), so each epoch is two steps of 32 and the test takes seconds."""
    tmp = tmp_path_factory.mktemp("llama_cli")
    ck = str(tmp / "ck.npz")
    base = ["--device", "cpu", "--model", "llama", "--model_preset", "tiny",
            "--dataset", "synthetic-lm", "--optimizer", "adamw",
            "--batch_size", "32", "--log_every", "1", "--ckpt_path", ck]
    outs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_module, "load_dataset",
                   lambda name, split, data_dir: synthetic_lm(
                       64 if split == "train" else 32, 128, 256,
                       seed=0 if split == "train" else 1))
        for extra in (["--epochs", "1"], ["--epochs", "2", "--resume"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(base + extra) == 0
            outs.append(buf.getvalue())
    return ck, outs


def test_cli_trains_llama_and_resumes(trained):
    ck, (first, second) = trained
    assert "model: llama" in first and "epoch: 0 [1/2 (50%)]" in first
    assert "Test set: Average loss:" in first
    assert "resumed from" in second and "at epoch 1" in second
    assert checkpoint.load_manifest(ck)["epoch"] == 1


def test_cli_checkpoint_reads_in_jax(trained):
    ck, _ = trained
    cfg = dataclasses.replace(JaxConfig.tiny(), max_seq_len=128)
    template, _ = JaxLlama(cfg).init(jax.random.key(0))
    got = jax_checkpoint.restore_params(ck, template)
    model = LlamaLM(dataclasses.replace(CFG, max_seq_len=128), device="cpu")
    interop.load_lm_params(model, interop.load_jax_checkpoint(ck))
    want = interop.llama_params_to_jax(model.state_dict())
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_cli_generate_llama_matches_jax(trained, capsys):
    from distributed_compute_pytorch_tpu.cli_generate import main as jax_main
    from distributed_compute_pytorch_tpu_torch.cli_generate import (
        main as port_main)
    ck, _ = trained
    common = ["--ckpt_path", ck, "--model", "llama", "--model_preset",
              "tiny", "--max_seq_len", "128", "--prompt",
              "5, 9, 12; 7 3; 1 2 3 4 5 6 7", "--max_new_tokens", "6"]
    capsys.readouterr()
    assert jax_main(common + ["--force-cpu"]) == 0
    want = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert port_main(common + ["--device", "cpu"]) == 0
    got = [json.loads(ln) for ln in
           capsys.readouterr().out.strip().splitlines()]
    assert got == want and len(got) == 3


def test_cli_serve_llama_matches_jax(trained, tmp_path, capsys):
    from distributed_compute_pytorch_tpu.cli_serve import main as jax_main
    from distributed_compute_pytorch_tpu_torch.cli_serve import (
        main as port_main)
    ck, _ = trained
    reqfile = tmp_path / "reqs.txt"
    reqfile.write_text("5, 9, 12\n"
                       '{"tokens": [7], "max_new": 3}\n'
                       '{"tokens": [1, 2, 3, 4, 5, 6], "id": "six"}\n'
                       "40 41 42 43\n")
    common = ["--ckpt_path", ck, "--model", "llama", "--model_preset",
              "tiny", "--max_seq_len", "128", "--requests", str(reqfile),
              "--slots", "2", "--segment", "3", "--max_new_tokens", "5"]
    capsys.readouterr()
    assert jax_main(common + ["--heartbeat", "0"]) == 0
    want = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert port_main(common + ["--device", "cpu"]) == 0
    got = [json.loads(ln) for ln in
           capsys.readouterr().out.strip().splitlines()]
    assert got == want
    assert [len(ln["new"]) for ln in got] == [5, 3, 5, 5]


def test_cli_accepts_llama_and_refuses_moe():
    from distributed_compute_pytorch_tpu_torch.cli_generate import main
    from distributed_compute_pytorch_tpu_torch.cli_serve import (
        main as serve_main)
    assert Config.from_argv(["--model", "llama"]).model == "llama"
    for run, item in (
            (lambda: cli.main(["--device", "cpu", "--model", "moe"]),
             "queue 1, item 8"),
            (lambda: main(["--init_seed", "0", "--model_preset", "tiny",
                           "--prompt", "5", "--device", "cpu", "--model",
                           "moe"]), "queue 1.7.4"),
            (lambda: serve_main(["--init_seed", "0", "--requests", "-",
                                 "--device", "cpu", "--model", "moe"]),
             "queue 3.9")):
        with pytest.raises(SystemExit) as e:
            run()
        msg = str(e.value)
        assert "--model moe" in msg and item in msg and "\n" not in msg
    assert main(["--init_seed", "0", "--model", "llama", "--model_preset",
                 "tiny", "--prompt", "5 6; 7", "--max_new_tokens", "3",
                 "--device", "cpu"]) == 0
