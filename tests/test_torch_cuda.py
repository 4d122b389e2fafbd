"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; without a CUDA device every test skips (a skip
counts no pass). This file imports neither JAX nor the test conftest's
JAX set-up, so the card's machine runs it on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The shapes are small and ragged on purpose (odd lengths, head dims 32 to
128, GQA, parked rows, positions past the horizon): ``chip_smoke.py``
covers the serving shapes. Tolerances: f32 2e-5 (the kernel sums in
another order); bf16 3e-2 (the plain version rounds the softmax
probabilities to bf16 before the value product, the kernel keeps f32).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _randn(gen, *shape, dtype, dev):
    return torch.randn(*shape, generator=gen).to(dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,tk,d,causal,masked", [
    (2, 3, 17, 17, 64, True, True),
    (1, 2, 5, 70, 32, True, False),
    (2, 1, 1, 9, 128, True, True),
    (3, 2, 19, 33, 80, False, True),
    (1, 4, 40, 40, 64, False, False),
])
def test_flash_fwd_matches_plain(dev, dtype, b, h, t, tk, d, causal, masked):
    from distributed_compute_pytorch_tpu_torch.ops import flash_attention as F
    gen = torch.Generator().manual_seed(0)
    q = _randn(gen, b, h, t, d, dtype=dtype, dev=dev)
    k = _randn(gen, b, h, tk, d, dtype=dtype, dev=dev)
    v = _randn(gen, b, h, tk, d, dtype=dtype, dev=dev)
    mask = None
    if masked:
        lengths = torch.randint(1, tk + 1, (b,), generator=gen)
        mask = (torch.arange(tk)[None] < lengths[:, None]).float().to(dev)
    before = F.launches
    got, lse = F.flash_fwd(q, k, v, causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    assert F.launches == before + 1
    want = F.flash_attention_plain(q, k, v, causal=causal, kv_mask=mask)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.isfinite(lse).all()


def test_flash_fwd_takes_split_head_views(dev):
    """The prefill passes strided views of the fused QKV projection."""
    from distributed_compute_pytorch_tpu_torch.ops import attention as A
    from distributed_compute_pytorch_tpu_torch.ops import flash_attention as F
    gen = torch.Generator().manual_seed(1)
    qkv = _randn(gen, 2, 23, 3 * 96, dtype=torch.float32, dev=dev)
    q, k, v = (A.split_heads(x, 3) for x in qkv.split(96, dim=-1))
    got = F.flash_attention(q, k, v, causal=True)
    want = F.flash_attention_plain(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_pool_insert_matches_plain(dev, dtype):
    from distributed_compute_pytorch_tpu_torch.ops import cache_update as C
    gen = torch.Generator().manual_seed(2)
    P, H, bt, hd, n = 11, 3, 16, 64, 9
    pool = _randn(gen, 2, P, H, bt, hd, dtype=dtype, dev=dev)
    kv = _randn(gen, n, 2 * H * hd, dtype=dtype, dev=dev)
    k = kv[:, :H * hd].reshape(n, H, hd)          # strided views
    v = kv[:, H * hd:].reshape(n, H, hd)
    blocks = torch.randperm(P - 1, generator=gen)[:n].to(torch.int32) + 1
    blocks[[2, 5]] = P                            # dropped
    blocks[7] = -1                                # dropped
    offsets = torch.randint(0, bt, (n,), generator=gen, dtype=torch.int32)
    blocks, offsets = blocks.to(dev), offsets.to(dev)
    want = C.kv_pool_insert_plain(pool.clone(), k, v, blocks, offsets)
    got = pool.clone()
    C.kv_pool_insert_cuda(got, k, v, blocks, offsets)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hk,hd,bt", [(4, 4, 64, 16), (6, 2, 32, 8),
                                        (2, 2, 128, 4), (8, 1, 64, 16)])
def test_paged_decode_matches_plain(dev, dtype, H, hk, hd, bt):
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    gen = torch.Generator().manual_seed(3)
    B, P, nb = 5, 40, 7
    q = _randn(gen, B, H, 1, hd, dtype=dtype, dev=dev)
    pool = _randn(gen, 2, P, hk, bt, hd, dtype=dtype, dev=dev)
    table = torch.stack([torch.randperm(P - 1, generator=gen)[:nb] + 1
                         for _ in range(B)]).to(torch.int32)
    table[3] = 0                                  # parked: all trash
    pos = torch.tensor([0, 5 * bt + 3, nb * bt + 9, 2, 33 % (nb * bt)],
                       dtype=torch.int32)
    table, pos = table.to(dev), pos.to(dev)
    got = D.paged_decode_cuda(q, pool, table, pos)
    torch.cuda.synchronize()
    want = D.paged_decode_plain(q, pool, table, pos)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.isfinite(got).all()


def test_tiny_serve_on_card_matches_cpu(dev):
    """GPT-2-tiny served on the card (through all three kernels) gives the
    CPU's greedy tokens in f32, and each kernel's counter moved."""
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
        GPT2, GPT2Config)
    from distributed_compute_pytorch_tpu_torch.ops import (
        cache_update, decode_attention, flash_attention)
    from distributed_compute_pytorch_tpu_torch.serve import (
        ContinuousBatcher, Request)
    cfg = GPT2Config(vocab_size=256, max_seq_len=128, num_layers=2,
                     num_heads=4, d_model=64, d_ff=128)
    cpu = GPT2(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = GPT2(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(4)
    reqs = [([int(x) for x in rng.integers(0, 256, rng.integers(1, 11))],
             int(rng.integers(3, 10))) for _ in range(7)]
    outs = []
    for model, device in ((cpu, "cpu"), (gpu, dev)):
        cb = ContinuousBatcher(model, slots=2, t_max=128, prompt_buf=10,
                               segment=3, device=device)
        counts = (flash_attention.launches, cache_update.launches,
                  decode_attention.launches)
        outs.append(cb.serve([Request(list(t), n) for t, n in reqs]))
        assert cb.last_block_leaks == 0
    assert outs[0] == outs[1]
    moved = (flash_attention.launches - counts[0],
             cache_update.launches - counts[1],
             decode_attention.launches - counts[2])
    assert all(m > 0 for m in moved), moved
