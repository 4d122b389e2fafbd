"""The port's serving slice against the JAX package, on the CPU: the
port's ``ContinuousBatcher(device="cpu")`` and the JAX
``ContinuousBatcher`` serve the same staggered requests with the same
``slots``, ``segment`` and ``kv_block_tokens`` on the same (converted)
weights, and must give the same greedy tokens, token for token — with
eos, slot reuse and ``HorizonError`` — and leak no block. Then the CLI
end to end: the JAX trainer writes a v1 checkpoint, and the port's
``cli_serve --device cpu`` prints the JAX ``dcp-serve`` lines exactly.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.serve import (
    ContinuousBatcher as JaxBatcher, HorizonError as JaxHorizonError,
    Request as JaxRequest)
from distributed_compute_pytorch_tpu_torch.interop import load_gpt2_params
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.serve import (
    ContinuousBatcher, HorizonError, Request)

SLOTS, SEGMENT, BT, T_MAX, PROMPT_BUF = 2, 3, 8, 128, 10


@pytest.fixture(scope="module")
def models():
    """JAX tiny GPT-2 (positions lifted to 128 so the horizon fits) and
    the port's copy; plus the one JAX reference batcher of this module
    (later JAX batchers of the same shape borrow its compiled programs)."""
    cfg = dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=128)
    jm = JaxGPT2(cfg)
    params, _ = jm.init(jax.random.key(0))
    tm = load_gpt2_params(
        GPT2(dataclasses.replace(GPT2Config.tiny(), max_seq_len=128),
             device="cpu"), jax.tree.map(np.asarray, params))
    jcb = JaxBatcher(jm, params, slots=SLOTS, t_max=T_MAX,
                     prompt_buf=PROMPT_BUF, segment=SEGMENT,
                     kv_block_tokens=BT, decode_width_buckets=1)
    return jm, params, tm, jcb


def _requests(seed, n, min_new=3, max_new=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ln = int(rng.integers(1, PROMPT_BUF + 1))
        out.append(([int(t) for t in rng.integers(0, 256, size=ln)],
                    int(rng.integers(min_new, max_new + 1))))
    return out


def _port(tm, **kw):
    return ContinuousBatcher(tm, slots=SLOTS, t_max=T_MAX,
                             prompt_buf=PROMPT_BUF, segment=SEGMENT,
                             kv_block_tokens=BT, device="cpu", **kw)


def test_staggered_requests_token_identical_to_jax(models):
    """7 mixed-length requests (one-token prompts included) through 2
    slots: admissions stagger across segments and rows are reused; a
    second serve call on the same batcher reuses the freed pool."""
    _, _, tm, jcb = models
    reqs = _requests(3, 7)
    want = jcb.serve([JaxRequest(list(t), n) for t, n in reqs])
    cb = _port(tm)
    got = cb.serve([Request(list(t), n) for t, n in reqs])
    assert got == want
    assert [len(o) for o in got] == [n for _, n in reqs]
    assert cb.stats["prefill_calls"] > 1          # staggered admission
    assert cb.last_block_leaks == 0 and cb.last_slot_leaks == 0
    assert cb.stats["fetches_overlapped"] > 0     # dispatch N+1, fetch N
    again = cb.serve([Request(list(t), n) for t, n in reqs])
    assert again == want and cb.last_block_leaks == 0


def test_eos_frees_slot_early_like_jax(models):
    jm, params, tm, jcb = models
    reqs = _requests(5, 5, min_new=6, max_new=6)
    first = jcb.serve([JaxRequest(list(reqs[0][0]), 6)])[0]
    eos = first[1]                     # occurs early in request 0's stream
    jeos = JaxBatcher(jm, params, slots=SLOTS, t_max=T_MAX,
                      prompt_buf=PROMPT_BUF, segment=SEGMENT,
                      kv_block_tokens=BT, decode_width_buckets=1,
                      eos_id=eos)
    want = jeos.serve([JaxRequest(list(t), n) for t, n in reqs])
    cb = _port(tm, eos_id=eos)
    got = cb.serve([Request(list(t), n) for t, n in reqs])
    assert got == want
    assert got[0][-1] == eos and len(got[0]) == 2
    assert cb.last_block_leaks == 0


def test_horizon_error_carries_completed_outputs_like_jax(models):
    _, _, tm, jcb = models
    reqs = _requests(9, 3) + [([1, 2, 3], 200)]   # 10 + 201 > t_max
    with pytest.raises(JaxHorizonError) as jexc:
        jcb.serve([JaxRequest(list(t), n) for t, n in reqs])
    cb = _port(tm)
    with pytest.raises(HorizonError, match="horizon") as exc:
        cb.serve([Request(list(t), n) for t, n in reqs])
    assert exc.value.outputs == jexc.value.outputs
    assert exc.value.outputs[-1] == [] and all(exc.value.outputs[:-1])
    assert cb.last_block_leaks == 0


def test_block_pool_matches_jax_block_pool():
    """The port's copy of ``BlockPool`` hands out the same block ids as
    the JAX package's under one alloc/release sequence, refuses the same
    misuse, and counts leaks the same way."""
    from distributed_compute_pytorch_tpu.kv_pool import (
        BlockPool as JaxPool, PoolExhausted as JaxExhausted)
    from distributed_compute_pytorch_tpu_torch.kv_pool import (
        BlockPool, PoolExhausted)
    ours, ref = BlockPool(9), JaxPool(9)
    held_o, held_r = [], []
    # (blocks to take, index of a held allocation to free after, or None)
    for n, drop in ((3, None), (2, 0), (4, None), (1, 1), (2, None)):
        held_o.append(ours.alloc(n))
        held_r.append(ref.alloc(n))
        assert held_o[-1] == held_r[-1]
        if drop is not None:
            ours.release(held_o.pop(drop))
            ref.release(held_r.pop(drop))
    assert ours.leak_check() == ref.leak_check({}) > 0
    with pytest.raises(PoolExhausted):
        ours.alloc(9)
    with pytest.raises(JaxExhausted):
        ref.alloc(9)
    with pytest.raises(RuntimeError, match="refcount"):
        ours.release([BlockPool.TRASH])
    for blocks in held_o:
        ours.release(blocks)
    assert ours.leak_check() == 0


def test_invalid_requests_raise(models):
    _, _, tm, _ = models
    cb = _port(tm)
    with pytest.raises(ValueError, match="prompt_buf"):
        cb.serve([Request(list(range(PROMPT_BUF + 1)), 2)])
    with pytest.raises(ValueError, match="empty"):
        cb.serve([Request([], 2)])
    with pytest.raises(ValueError, match="sampling"):
        cb.serve([Request([1, 2], 2, temperature=0.7)])
    with pytest.raises(ValueError, match="vocab"):
        cb.serve([Request([1, 999], 2)])


def test_cli_serve_matches_jax_dcp_serve(tmp_path, capsys, devices8):
    """The JAX trainer writes a v1 checkpoint; the port's CLI serves it
    on the CPU and prints exactly the JAX ``dcp-serve`` lines."""
    from distributed_compute_pytorch_tpu.cli_serve import main as jax_main
    from distributed_compute_pytorch_tpu.core.config import Config
    from distributed_compute_pytorch_tpu.data.datasets import synthetic_lm
    from distributed_compute_pytorch_tpu.train.trainer import Trainer
    from distributed_compute_pytorch_tpu_torch.cli_serve import (
        main as port_main)

    ck = str(tmp_path / "ck.npz")
    data = synthetic_lm(64, seq_len=16, vocab=256, seed=9)
    Trainer(Config(batch_size=32, lr=1e-3, epochs=1, mesh="data=8",
                   model="gpt2", model_preset="tiny",
                   dataset="synthetic-lm", optimizer="adamw", ckpt_path=ck),
            train_data=data, eval_data=data).fit()
    reqfile = tmp_path / "reqs.txt"
    reqfile.write_text("5, 9, 12\n"
                       '{"tokens": [7], "max_new": 3}\n'
                       '{"tokens": [1, 2, 3, 4, 5], "id": "five"}\n')
    common = ["--ckpt_path", ck, "--model", "gpt2", "--model_preset", "tiny",
              "--max_seq_len", "16", "--requests", str(reqfile),
              "--slots", "2", "--segment", "3", "--max_new_tokens", "5"]
    capsys.readouterr()                      # drop the trainer's log lines
    assert jax_main(common + ["--heartbeat", "0"]) == 0
    want = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert port_main(common + ["--device", "cpu"]) == 0
    got = [json.loads(ln) for ln in
           capsys.readouterr().out.strip().splitlines()]
    assert got == want
    assert [ln["id"] for ln in got] == ["req-00000", "req-00001", "five"]
    assert [len(ln["new"]) for ln in got] == [5, 3, 5]
