"""The port's one-shot generation (``infer.py``, ``cli_generate.py``)
against the JAX package's, on the CPU in f32, with GPT-2-tiny weights
carried across by ``interop``.

Greedy decoding is held token for token to the JAX ``generate`` (a plain
batch, a left-padded batch, eos rows), ``prefill`` to 1e-5 (only the
summation order differs), and the top-k / nucleus truncation
(``_filter_logits``) to the reference's masking exactly. ``torch.Generator``
cannot draw ``jax.random``'s bits, so sampled streams are held to
invariants: the same generator seed gives the same tokens, and no draw
lands on a filtered logit. Every validation error is raised where the JAX
``generate`` raises it, with its message. The port's ``cli_generate
--device cpu`` prints the JAX ``cli_generate --force-cpu`` lines on one v1
checkpoint.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu import infer as jax_infer
from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu_torch import infer
from distributed_compute_pytorch_tpu_torch.interop import load_gpt2_params
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config

TOL = 1e-5   # f32, both sides: only the summation order differs
B, T0, N = 3, 7, 8


@pytest.fixture(scope="module")
def models():
    """The JAX tiny GPT-2 and the port's copy of its weights."""
    jm = JaxGPT2(JaxGPT2Config.tiny())
    params, _ = jm.init(jax.random.key(0))
    tm = load_gpt2_params(GPT2(GPT2Config.tiny(), device="cpu"),
                          jax.tree.map(np.asarray, params))
    return jm, params, tm


def _prompt(seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, T0)
                                                ).astype(np.int32)


def _left_pad_mask():
    """Row 0 full, row 1 with 3 pads, row 2 with a single real token."""
    mask = np.ones((B, T0), np.int32)
    mask[1, :3] = 0
    mask[2, :T0 - 1] = 0
    return mask


@pytest.mark.parametrize("masked", [False, True])
def test_prefill_matches_jax(models, masked):
    jm, params, tm = models
    prompt = _prompt()
    mask = _left_pad_mask() if masked else None
    t_max = T0 + 5
    want_logits, want_caches = jax_infer.prefill(
        jm, params, jnp.asarray(prompt), t_max,
        prompt_mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        logits, caches = infer.prefill(
            tm, torch.from_numpy(prompt).long(), t_max,
            prompt_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=TOL, rtol=TOL)
    assert len(caches) == len(want_caches) == 2
    for got, want in zip(caches, want_caches):
        assert tuple(got["kv"].shape) == (2, B, 4, t_max, 16)
        np.testing.assert_allclose(got["kv"].numpy(),
                                   np.asarray(want["kv"]), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_greedy_generate_matches_jax(models, masked):
    jm, params, tm = models
    prompt = _prompt()
    mask = _left_pad_mask() if masked else None
    want = jax_infer.generate(
        jm, params, jnp.asarray(prompt), N,
        prompt_mask=None if mask is None else jnp.asarray(mask))
    got = infer.generate(tm, prompt, N, prompt_mask=mask)
    assert got.shape == (B, T0 + N) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # each call fills fresh caches: a second call gives the same tokens
    np.testing.assert_array_equal(
        infer.generate(tm, prompt, N, prompt_mask=mask).numpy(),
        np.asarray(want))


def test_left_padded_row_equals_prompt_alone(models):
    _, _, tm = models
    prompt = _prompt()
    mask = _left_pad_mask()
    batch = infer.generate(tm, prompt, N, prompt_mask=mask)
    for row, pads in ((1, 3), (2, T0 - 1)):
        alone = infer.generate(tm, prompt[row:row + 1, pads:], N)
        np.testing.assert_array_equal(batch[row, pads:].numpy(),
                                      alone[0].numpy())


def test_eos_rows_match_jax(models):
    jm, params, tm = models
    prompt = _prompt(2)
    greedy = infer.generate(tm, prompt, N).numpy()
    eos = int(greedy[0, T0 + 1])      # row 0 emits it at its second step
    want = jax_infer.generate(jm, params, jnp.asarray(prompt), N, eos_id=eos)
    got = infer.generate(tm, prompt, N, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[0, T0 + 1:] == eos).all()


class _Keep:
    """Stands in for ``jax.random.categorical``'s result: hands back the
    logits it was given (``_sample`` casts the draw with ``astype``)."""

    def __init__(self, logits):
        self.logits = logits

    def astype(self, dtype):
        return self.logits


@pytest.mark.parametrize("top_k,top_p", [(5, None), (1, None), (None, 0.9),
                                         (None, 0.3), (None, 0.99), (10, 0.5),
                                         (256, 0.75)])
def test_filter_logits_matches_reference_masking(monkeypatch, top_k, top_p):
    """The reference's ``_sample`` masks, then draws: with the draw
    replaced by the identity, it returns the masked logits. (Not at
    ``top_p`` = 1.0: there both sides drop the tail tokens whose f32
    cumulative mass rounds to 1.0, a set that follows the summation
    order.)"""
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: _Keep(logits))
    logits = np.random.default_rng(3).standard_normal((4, 256)
                                                      ).astype(np.float32) * 3
    temperature = 0.7
    want = jax_infer._sample(jnp.asarray(logits), temperature,
                             jax.random.key(0), top_k, top_p)
    got = infer._filter_logits(torch.from_numpy(logits) / temperature, top_k,
                               top_p)
    np.testing.assert_array_equal(np.isinf(got.numpy()),
                                  np.isinf(np.asarray(want)))
    kept = ~np.isinf(got.numpy())
    np.testing.assert_allclose(got.numpy()[kept], np.asarray(want)[kept],
                               rtol=1e-6)


def test_sampling_is_seeded_and_never_draws_a_filtered_logit(models):
    _, _, tm = models
    prompt = _prompt()
    kw = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}

    def run(seed):
        return infer.generate(tm, prompt, N, generator=torch.Generator(
            ).manual_seed(seed), **kw).numpy()
    np.testing.assert_array_equal(run(1), run(1))
    assert not np.array_equal(run(1), run(2))
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 64)).astype(np.float32))
    allowed = ~torch.isinf(infer._filter_logits(logits, 4, 0.9))
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([infer._sample(logits, 1.0, gen, 4, 0.9)
                         for _ in range(400)])             # [400, 2]
    for row in range(2):
        drawn = set(draws[:, row].tolist())
        assert drawn == set(torch.nonzero(allowed[row])[:, 0].tolist())


_MASKS = {
    "shape": np.ones((B, T0 - 1), np.int32),
    "binary": np.full((B, T0), 2, np.int32),
    "LEFT-padded": np.ones((B, T0), np.int32) - np.eye(1, T0, 1, np.int32),
    "fully-padded": np.zeros((B, T0), np.int32),
}


@pytest.mark.parametrize("new,fn_kw,call_kw,match", [
    (-1, {}, {}, "max_new_tokens must be >= 0"),
    (N, {"temperature": 1.0, "top_k": 0}, {}, "top_k must be in"),
    (N, {"temperature": 1.0, "top_k": 257}, {}, "top_k must be in"),
    (N, {"temperature": 1.0, "top_p": 0.0}, {}, "top_p must be in"),
    (N, {"temperature": 1.0, "top_p": 1.5}, {}, "top_p must be in"),
    (N, {"temperature": -0.5}, {}, "temperature must be >= 0"),
    (N, {"top_k": 5}, {}, "require temperature > 0"),
    (N, {"top_p": 0.9}, {}, "require temperature > 0"),
    (N, {"t_max": T0 + N - 1}, {}, "can't hold prompt"),
    (64, {}, {}, "max_seq_len=64"),
    (N, {}, {"prompt_mask": "shape"}, "prompt_mask shape"),
    (N, {}, {"prompt_mask": "binary"}, "binary"),
    (N, {}, {"prompt_mask": "LEFT-padded"}, "LEFT-padded"),
    (N, {}, {"prompt_mask": "fully-padded"}, "fully-padded"),
])
def test_validation_errors_match_jax(models, new, fn_kw, call_kw, match):
    jm, params, tm = models
    prompt = _prompt()
    mask = _MASKS.get(call_kw.get("prompt_mask"))
    with pytest.raises(ValueError, match=match):
        jax_infer.generate(jm, params, jnp.asarray(prompt), new,
                           prompt_mask=None if mask is None
                           else jnp.asarray(mask), **fn_kw)
    with pytest.raises(ValueError, match=match):
        infer.generate(tm, prompt, new, prompt_mask=mask, **fn_kw)


def test_unported_modes_raise(models):
    """Sharded generation is still refused; the int8 KV cache
    (``kv_quant``) is ported and gives the JAX ``kv_quant`` tokens (held
    further in ``tests/test_torch_kv_quant.py``)."""
    jm, params, tm = models
    with pytest.raises(NotImplementedError, match="sharded"):
        infer.generate(tm, _prompt(), N, mesh=object())
    want = jax_infer.generate(jm, params, jnp.asarray(_prompt()), N,
                              kv_quant=True)
    np.testing.assert_array_equal(
        infer.generate(tm, _prompt(), N, kv_quant=True).numpy(),
        np.asarray(want))
    assert torch.equal(infer.generate(tm, _prompt(), 0),
                       torch.from_numpy(_prompt()).long())


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A v1 checkpoint of GPT-2-tiny random weights, written by the port's
    trainer (params in the JAX layout, which the JAX CLI restores)."""
    from distributed_compute_pytorch_tpu_torch.train import checkpoint as ck
    from distributed_compute_pytorch_tpu_torch.train.optim import (
        build_optimizer)
    from distributed_compute_pytorch_tpu_torch.train.step import make_step_fns
    model = GPT2(GPT2Config.tiny(), device="cpu").init(
        torch.Generator().manual_seed(7))
    init_fn, _, _ = make_step_fns(model, build_optimizer("adamw", 1e-3))
    path = str(tmp_path_factory.mktemp("gen") / "ck.npz")
    ck.save(path, init_fn(None))
    return path


@pytest.mark.parametrize("extra", [[], ["--eos_id", "7"]])
def test_cli_generate_matches_jax(checkpoint, capsys, extra):
    from distributed_compute_pytorch_tpu.cli_generate import main as jax_main
    from distributed_compute_pytorch_tpu_torch.cli_generate import (
        main as port_main)
    common = ["--ckpt_path", checkpoint, "--model", "gpt2", "--model_preset",
              "tiny", "--prompt", "5, 9, 12; 7 3; 1 2 3 4 5",
              "--max_new_tokens", "6", *extra]
    capsys.readouterr()
    assert jax_main(common + ["--force-cpu"]) == 0
    want = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert port_main(common + ["--device", "cpu"]) == 0
    got = [json.loads(ln) for ln in
           capsys.readouterr().out.strip().splitlines()]
    assert got == want
    assert [ln["prompt"] for ln in got] == [[5, 9, 12], [7, 3],
                                            [1, 2, 3, 4, 5]]


@pytest.mark.parametrize("flag", [["--mesh", "data=2"],
                                  ["--quantize", "int8"],
                                  ["--text_prompt", "hello"],
                                  ["--tokenizer", "byte"],
                                  ["--quantize", "int8-kv"],
                                  ["--model", "moe"]])
def test_cli_generate_refuses_unported_flags(flag):
    from distributed_compute_pytorch_tpu_torch.cli_generate import main
    with pytest.raises(SystemExit, match=f"{flag[0]} .*not ported"):
        main(["--init_seed", "0", "--model_preset", "tiny", "--prompt", "5",
              "--device", "cpu", *flag])
