"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; without a CUDA device every test skips (a skip
counts no pass). This file imports neither JAX nor the test conftest's
JAX set-up, so the card's machine runs it on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The shapes are small and ragged on purpose (odd lengths, head dims 32 to
128, GQA, parked rows, positions past the horizon): ``chip_smoke.py``
covers the serving and training shapes. Tolerances: f32 2e-5 (the kernel
sums in another order); bf16 3e-2: the decode kernels, and the flash
forward's CUDA-core kernel, keep the softmax probabilities in f32 where
the plain version rounds them to bf16 before the value product; the bf16
flash forward on the tensor cores rounds them too, but unnormalised, and
sums in another order; the bf16
backward runs on the tensor cores and rounds p and ds to bf16 before
their products, where the plain version keeps f32, and its outputs are
rounded to bf16 from f32 sums taken in another order, so its error is
taken relative to the output's largest magnitude where that exceeds 1.
The bf16 flash kernels are also held row by row, relative to each row's
own magnitude (``ROW_TOL``).
"""

import math

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


def _rel_err(got, want):
    """Max abs error over the larger of 1 and the reference's max abs."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


# the bf16 flash kernels, row by row (``_row_err``): the first causal rows
# set the output's largest magnitude, several times a late row's, so
# ``_rel_err`` alone would pass a fault confined to late rows or one tile;
# about four times a one-ulp disagreement at a row's largest element
ROW_TOL = 3e-2


def _row_err(got, want):
    """The largest, over rows (the last axis), of a row's max abs error
    over that row's max abs reference, the latter floored at 1e-2 of the
    reference's RMS (a row whose true value is 0, such as dq of a causal
    first row, holds only rounding noise)."""
    want = want.float()
    floor = 1e-2 * want.square().mean().sqrt().item()
    return ((got.float() - want).abs().amax(-1)
            / want.abs().amax(-1).clamp(min=floor)).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,tk,d,causal,masked,padded", [
    (2, 3, 17, 17, 64, True, True, False),
    (1, 2, 5, 70, 32, True, False, False),
    (2, 1, 1, 9, 128, True, True, False),
    (3, 2, 19, 33, 80, False, True, False),
    (1, 4, 40, 40, 64, False, False, False),
    (2, 2, 150, 150, 128, True, False, False),
    (2, 3, 100, 230, 64, True, True, False),
    (2, 3, 90, 130, 20, True, True, False),
    (2, 3, 45, 45, 64, True, True, True),
])
def test_flash_fwd_matches_plain(dev, dtype, b, h, t, tk, d, causal, masked,
                                 padded):
    """bf16 calls that meet the rule (head dim a multiple of 8, 16-byte
    aligned bases and strides) take the tensor-core kernel; f32, bf16 at
    d = 20 and, with ``padded`` (t == tk), split-head views of a fused QKV
    behind 4 elements of padding (base and row stride off 16 bytes) take
    the CUDA-core one: the counters say which. A second launch gives the
    same bits."""
    from distributed_compute_pytorch_tpu_torch.ops import attention as A
    from distributed_compute_pytorch_tpu_torch.ops import flash_attention as F
    gen = torch.Generator().manual_seed(0)
    if padded:
        qkv = _randn(gen, b, t, 4 + 3 * h * d, dtype=dtype, dev=dev)
        q, k, v = (A.split_heads(x, h)
                   for x in qkv[..., 4:].split(h * d, dim=-1))
    else:
        q = _randn(gen, b, h, t, d, dtype=dtype, dev=dev)
        k = _randn(gen, b, h, tk, d, dtype=dtype, dev=dev)
        v = _randn(gen, b, h, tk, d, dtype=dtype, dev=dev)
    mask = None
    if masked:
        lengths = torch.randint(1, tk + 1, (b,), generator=gen)
        mask = (torch.arange(tk)[None] < lengths[:, None]).float().to(dev)
    before = (F.launches, F.tc_launches)
    got, lse = F.flash_fwd(q, k, v, causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16 and d % 8 == 0 and not padded)
    assert (F.launches - before[0], F.tc_launches - before[1]) == (1, tc)
    want, lse_want = F.flash_fwd_plain(q, k, v, causal=causal, kv_mask=mask)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if dtype == torch.bfloat16:
        assert _row_err(got, want) <= ROW_TOL
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(lse, lse_want, atol=2e-5, rtol=2e-5)
    again, lse_again = F.flash_fwd(q, k, v, causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(lse, lse_again)


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
    """GPT-2-tiny served on the card gives the CPU's greedy tokens in f32,
    through the flash forward, the admission scatter (``kv_pool_insert``)
    and the fused tick (``paged_decode_write``): each of their counters
    moved, and the read-only ``paged_decode``'s did not."""
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
                  decode_attention.write_launches, decode_attention.launches)
        outs.append(cb.serve([Request(list(t), n) for t, n in reqs]))
        assert cb.last_block_leaks == 0
    assert outs[0] == outs[1]
    moved = (flash_attention.launches - counts[0],
             cache_update.launches - counts[1],
             decode_attention.write_launches - counts[2])
    assert all(m > 0 for m in moved), moved
    assert decode_attention.launches == counts[3]


# ---- slice 2: the flash backward, fused AdamW and a train step ----------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,tk,d,causal,masked,views", [
    (2, 3, 17, 17, 64, True, True, False),
    (1, 2, 5, 70, 32, True, False, False),
    (2, 1, 1, 9, 128, True, True, False),
    (3, 2, 19, 33, 80, False, True, False),
    (1, 4, 70, 70, 64, False, False, False),
    (2, 3, 90, 130, 20, True, True, False),
    (2, 3, 257, 257, 64, True, False, False),
    (1, 2, 100, 300, 64, True, True, False),
    (2, 2, 130, 130, 128, False, False, False),
    (1, 4, 64, 64, 16, True, False, False),
    (2, 4, 200, 200, 64, True, True, True),
])
def test_flash_bwd_kernels_match_plain(dev, dtype, b, h, t, tk, d, causal,
                                       masked, views):
    """Both backward kernels against the plain version; dO in the
    ``[b, t, h, d]`` order the model's backward hands over, and with
    ``views`` (t == tk) q, k and v split-head views of one fused QKV. bf16
    calls whose head dim is a multiple of 8 take the tensor-core kernels,
    the rest (f32, bf16 at d = 20) the CUDA-core ones: the counters say
    which. A second launch on the same inputs gives the same bits (no
    atomics)."""
    from distributed_compute_pytorch_tpu_torch.ops import attention as A
    from distributed_compute_pytorch_tpu_torch.ops import flash_attention as F
    gen = torch.Generator().manual_seed(5)
    if views:
        qkv = _randn(gen, b, t, 3 * h * d, dtype=dtype, dev=dev)
        q, k, v = (A.split_heads(x, h) for x in qkv.split(h * d, dim=-1))
        assert not q.is_contiguous()
    else:
        q = _randn(gen, b, h, t, d, dtype=dtype, dev=dev)
        k, v = (_randn(gen, b, h, tk, d, dtype=dtype, dev=dev)
                for _ in range(2))
    do = _randn(gen, b, t, h, d, dtype=dtype, dev=dev).transpose(1, 2)
    mask = None
    if masked:
        lengths = torch.randint(1, tk + 1, (b,), generator=gen)
        lengths[0] = tk
        mask = (torch.arange(tk)[None] < lengths[:, None]).float().to(dev)
    o, lse = F.flash_fwd(q, k, v, causal=causal, kv_mask=mask)
    delta = (do.float() * o.float()).sum(-1)
    args, kw = (q, k, v, do, lse, delta), {"causal": causal, "kv_mask": mask}
    counters = ("dq_launches", "dkv_launches", "dq_tc_launches",
                "dkv_tc_launches")
    before = [getattr(F, c) for c in counters]
    got = (F.flash_bwd_dq(*args, **kw), *F.flash_bwd_dkv(*args, **kw))
    torch.cuda.synchronize()
    moved = tuple(getattr(F, c) - n for c, n in zip(counters, before))
    tc = int(dtype == torch.bfloat16 and d % 8 == 0)
    assert moved == (1, 1, tc, tc), moved
    want = F.flash_bwd_plain(*args, **kw)
    again = (F.flash_bwd_dq(*args, **kw), *F.flash_bwd_dkv(*args, **kw))
    torch.cuda.synchronize()
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        assert g.dtype == dtype and torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= TOL[dtype], name
        if dtype == torch.bfloat16:
            assert _row_err(g, w) <= ROW_TOL, name
        assert torch.equal(g, g2), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,masked,scale", [(True, False, None),
                                                 (True, True, None),
                                                 (False, True, 0.3)])
def test_attention_grads_on_card_match_plain_autograd(dev, dtype, causal,
                                                      masked, scale):
    """The CUDA forward is differentiable: gradients of q, k and v (split-
    head views of one fused QKV, as the model makes them) through
    ``attention(...)`` on the card equal autograd through the plain
    version."""
    from distributed_compute_pytorch_tpu_torch.ops import attention as A
    from distributed_compute_pytorch_tpu_torch.ops import flash_attention as F
    gen = torch.Generator().manual_seed(6)
    b, t, h, d = 2, 45, 3, 64
    qkv0 = _randn(gen, b, t, 3 * h * d, dtype=dtype, dev=dev)
    g = _randn(gen, b, t, h * d, dtype=dtype, dev=dev)
    mask = None
    if masked:
        mask = (torch.arange(t)[None] < torch.tensor([[t], [t // 2]])
                ).float().to(dev)
    grads = []
    for fn in (A.attention, F.flash_attention_plain):
        qkv = qkv0.clone().requires_grad_()
        q, k, v = (A.split_heads(x, h) for x in qkv.split(h * d, dim=-1))
        o = fn(q, k, v, causal=causal, scale=scale, kv_mask=mask)
        A.merge_heads(o).backward(g)
        grads.append(qkv.grad)
    got, want = grads
    assert got is not None and torch.isfinite(got).all()
    for i, name in enumerate("qkv"):
        sl = slice(i * h * d, (i + 1) * h * d)
        assert _rel_err(got[..., sl], want[..., sl]) <= TOL[dtype], name
        if dtype == torch.bfloat16:
            assert _row_err(got[..., sl], want[..., sl]) <= ROW_TOL, name


@pytest.mark.parametrize("n", [1, 7, 4096, 1_000_003])
def test_fused_adamw_kernel_matches_plain(dev, n):
    """Four steps from the device count, the third with the flag ``ok``
    false: the kernel leaves p, mu and nu bit-untouched and the count
    where it was, and every step matches the plain version's."""
    from distributed_compute_pytorch_tpu_torch.ops import fused_adamw as FA
    gen = torch.Generator().manual_seed(7)
    p, mu = (torch.randn(n, generator=gen).to(dev) for _ in range(2))
    nu = torch.rand(n, generator=gen).to(dev)
    want = [p.clone(), mu.clone(), nu.clone()]
    tx = FA.fused_adamw(lambda c: 1e-3 * (c + 1), weight_decay=0.1)
    count = FA.device_count(dev)
    before = FA.launches
    for step in range(4):
        g = torch.randn(n, generator=gen).to(dev)
        ok = torch.tensor(step != 2, device=dev)
        sc = tx.scalars(count)
        want = list(FA.fused_adamw_plain(g, *want, sc, ok, **tx.hyper))
        kept = [x.clone() for x in (p, mu, nu)]
        FA.fused_adamw_update(g, p, mu, nu, sc, count, ok, **tx.hyper)
        if step == 2:
            assert all(torch.equal(a, b) for a, b in zip((p, mu, nu), kept))
    torch.cuda.synchronize()
    assert FA.launches == before + 4 and int(count) == 3
    for got, w in zip((p, mu, nu), want):
        torch.testing.assert_close(got, w, atol=1e-6, rtol=1e-6)


def test_tiny_train_on_card_matches_cpu(dev):
    """GPT-2-tiny, f32, three ``adamw_fused`` steps on the card (through the
    flash forward, both backward kernels and fused AdamW) against the same
    steps on the CPU: losses to 1e-4, parameters to 1e-4 (Adam's
    normalised step turns summation-order differences of small gradients
    into parameter differences of up to about lr x 1e-3)."""
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
        GPT2, GPT2Config)
    from distributed_compute_pytorch_tpu_torch.ops import flash_attention as F
    from distributed_compute_pytorch_tpu_torch.ops import fused_adamw as FA
    from distributed_compute_pytorch_tpu_torch.train.optim import (
        build_optimizer)
    from distributed_compute_pytorch_tpu_torch.train.step import make_step_fns
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPT2Config(vocab_size=256, max_seq_len=32, num_layers=2,
                     num_heads=4, d_model=64, d_ff=128, dropout_rate=0.0)
    tokens = np.random.default_rng(8).integers(0, 256, (8, 32))
    base = GPT2(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    runs = []
    for device in ("cpu", dev):
        model = GPT2(cfg, device=device)
        model.load_state_dict(base.state_dict())
        tx = build_optimizer("adamw_fused", 1e-3, steps_per_epoch=3,
                             total_steps=3, warmup_steps=1)
        init_fn, train_step, _ = make_step_fns(model, tx)
        state = init_fn(None)
        x = torch.from_numpy(tokens).to(device)
        counts = (F.launches, F.dq_launches, F.dkv_launches, FA.launches)
        losses = [float(train_step(state, x, x)[1]["loss"]) for _ in range(3)]
        moved = [a - b for a, b in zip(
            (F.launches, F.dq_launches, F.dkv_launches, FA.launches), counts)]
        runs.append((losses, {n: p.detach().cpu()
                              for n, p in state.params.items()}, moved))
    (l_cpu, p_cpu, m_cpu), (l_gpu, p_gpu, m_gpu) = runs
    assert m_cpu == [0, 0, 0, 0] and m_gpu == [6, 6, 6, 3]
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    d = cfg.d_model
    for name in p_cpu:
        got, want = p_gpu[name], p_cpu[name]
        if name.endswith("qkv.bias"):
            # the key bias has an exactly zero gradient (a constant added
            # to every key of a row leaves its softmax as it is), so each
            # side's Adam step is rounding noise normalised to about lr:
            # compare the query and value biases only
            got, want = (torch.cat([w[:d], w[2 * d:]]) for w in (got, want))
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4,
                                   msg=lambda m: f"{name}: {m}")


# ---- slice 3: the dense KV writes, the dense decode read, generation -----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_insert_kernels_match_plain(dev, dtype):
    """``cache_insert``, ``kv_insert`` (a 0-dim position, and a stride-0
    ``[B]`` view through ``kv_insert_rows``) and ``kv_insert_rows``
    (first, last, interior and out-of-range slots), the updates strided
    split-head views of one fused QKV: exact, each counter moved once."""
    from distributed_compute_pytorch_tpu_torch.ops import attention as A
    from distributed_compute_pytorch_tpu_torch.ops import cache_update as C
    gen = torch.Generator().manual_seed(9)
    B, hk, T, hd = 3, 4, 37, 64
    qkv = _randn(gen, B, 1, 3 * hk * hd, dtype=dtype, dev=dev)
    _, k, v = (A.split_heads(x, hk) for x in qkv.split(hk * hd, dim=-1))
    assert not k.is_contiguous()
    cache = _randn(gen, 2, B, hk, T, hd, dtype=dtype, dev=dev)
    slots = torch.arange(T, dtype=torch.int32, device=dev)
    cases = [
        ("kv_insert", lambda c: C.kv_insert_cuda(c, k, v, slots[17]),
         lambda c: C.kv_insert_plain(c, k, v, slots[17])),
        ("kv_insert_rows", lambda c: C.kv_insert_rows_cuda(
            c, k, v, slots[T - 1].reshape(1).expand(B)),
         lambda c: C.kv_insert_plain(c, k, v, slots[T - 1])),
        ("kv_insert_rows", lambda c: C.kv_insert_rows_cuda(
            c, k, v, torch.tensor([0, T - 1, T], dtype=torch.int32,
                                  device=dev)),
         lambda c: C.kv_insert_plain(c, k, v, torch.tensor(
             [0, T - 1, T], dtype=torch.int32, device=dev))),
        ("cache_insert", lambda c: C.cache_insert_cuda(c[1], v, slots[0]),
         lambda c: C.cache_insert_plain(c[1], v, slots[0])),
    ]
    for counter, kernel, plain in cases:
        before = getattr(C, f"{counter}_launches")
        got, want = cache.clone(), cache.clone()
        kernel(got)
        plain(want)
        torch.cuda.synchronize()
        assert getattr(C, f"{counter}_launches") == before + 1
        assert torch.equal(got, want), counter
    assert not torch.equal(got, cache)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hk,hd", [(4, 4, 64), (8, 2, 32), (2, 2, 128),
                                     (8, 1, 64)])
@pytest.mark.parametrize("lockstep", [True, False])
def test_dense_decode_matches_plain(dev, dtype, H, hk, hd, lockstep):
    """With and without a left-pad slot mask whose runs cover whole
    32-key chunks (row 1: 70 pads), MHA and GQA, a stride-0 lockstep
    position and per-row positions (one past the cache: clamped)."""
    from distributed_compute_pytorch_tpu_torch.ops import attention as A
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    gen = torch.Generator().manual_seed(10)
    B, T = 4, 150
    qx = _randn(gen, B, 1, 3 * H * hd, dtype=dtype, dev=dev)
    q = A.split_heads(qx[..., :H * hd], H)                # strided view
    cache = _randn(gen, 2, B, hk, T, hd, dtype=dtype, dev=dev)
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[1, :70] = False
    mask[2, :3] = False
    mask = mask.to(dev)
    if lockstep:
        pos = torch.arange(100, 102, dtype=torch.int32, device=dev)[0]
    else:
        pos = torch.tensor([0, 96, T, 41], dtype=torch.int32, device=dev)
    for slot_mask in (None, mask):
        before = D.dense_launches
        got = D.dense_decode_cuda(q, cache, pos, slot_mask=slot_mask)
        torch.cuda.synchronize()
        assert D.dense_launches == before + 1
        want = D.dense_decode_plain(q, cache, pos, slot_mask=slot_mask)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def test_dense_kernels_refuse_int8_and_bad_positions(dev):
    """The int8 forms take an int8 cache only with its scale plane, float
    updates of one dtype and a float query (the int8 kernels themselves
    are held to their plain versions below); bad positions are refused as
    before."""
    from distributed_compute_pytorch_tpu_torch.ops import cache_update as C
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    c8 = torch.zeros(2, 2, 2, 8, 16, dtype=torch.int8, device=dev)
    s8 = torch.zeros(2, 2, 2, 8, 1, device=dev)
    u8 = torch.zeros(2, 2, 1, 16, dtype=torch.int8, device=dev)
    uf = torch.zeros(2, 2, 1, 16, device=dev)
    with pytest.raises(ValueError, match="scale"):
        C.kv_insert_cuda(c8, uf, uf, 0)
    with pytest.raises(ValueError, match="float K/V"):
        C.kv_insert_cuda(c8, u8, u8, 0, scale=s8)
    with pytest.raises(ValueError, match="one dtype"):
        C.kv_insert_cuda(c8, uf, uf.bfloat16(), 0, scale=s8)
    with pytest.raises(ValueError, match="kv_scale"):
        D.dense_decode_cuda(uf, c8, 0)
    with pytest.raises(ValueError, match="query must be float"):
        D.dense_decode_cuda(u8, c8, 0, kv_scale=s8)
    c = torch.zeros(2, 2, 2, 8, 16, device=dev)
    u = torch.zeros(2, 2, 1, 16, device=dev)
    with pytest.raises(ValueError, match="int32"):
        C.kv_insert_rows_cuda(c, u, u, torch.zeros(2, dtype=torch.int64,
                                                   device=dev))
    with pytest.raises(ValueError, match="stride"):
        C.kv_insert_rows_cuda(c, u, u, torch.zeros(
            4, dtype=torch.int32, device=dev)[::2])


def test_tiny_generate_on_card_teacher_forced(dev):
    """GPT-2-tiny greedy generation of a left-padded batch on the card, in
    f32, through ``flash_fwd`` and the fused tick ``dense_decode_write``:
    the CPU's tokens, every token the teacher-forced row maximum of the
    model's own full forward (within 1e-4: f32 summation order), and the
    launch counts the schedule implies (no standalone ``kv_insert`` or
    read-only ``dense_decode``)."""
    from distributed_compute_pytorch_tpu_torch.infer import generate
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
        GPT2, GPT2Config)
    from distributed_compute_pytorch_tpu_torch.ops import cache_update as C
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    from distributed_compute_pytorch_tpu_torch.ops import flash_attention as F
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPT2Config(vocab_size=256, max_seq_len=128, num_layers=2,
                     num_heads=4, d_model=64, d_ff=128)
    cpu = GPT2(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = GPT2(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(11)
    lens = [9, 3, 40]
    T0, N = max(lens), 12
    prompt = np.zeros((3, T0), np.int64)
    mask = np.zeros((3, T0), np.int64)
    for i, n in enumerate(lens):
        prompt[i, T0 - n:] = rng.integers(0, 256, n)
        mask[i, T0 - n:] = 1
    want = generate(cpu, prompt, N, prompt_mask=mask)
    counts = (F.launches, D.dense_write_launches, C.kv_insert_launches,
              D.dense_launches)
    got = generate(gpu, prompt, N, prompt_mask=mask).cpu()
    moved = (F.launches - counts[0], D.dense_write_launches - counts[1],
             C.kv_insert_launches - counts[2], D.dense_launches - counts[3])
    assert moved == (2, 2 * (N - 1), 0, 0), moved
    assert torch.equal(got, want)
    with torch.no_grad():
        for i, n in enumerate(lens):
            seq = got[i, T0 - n:].to(dev)
            logits = gpu(seq[None, :-1])[0, n - 1:].float()
            chosen = logits.gather(1, seq[n:, None])[:, 0]
            assert (logits.max(dim=1).values - chosen).max() <= 1e-4


# ---- slice 6: the int8 KV cache (the quantizing writes, the int8 reads) --

def _q8_cache(gen, *shape, dev):
    """An int8 cache and its f32 scale plane: ``quantize_kv`` of normal
    floats, as the writes leave them."""
    from distributed_compute_pytorch_tpu_torch.utils.quantize import (
        quantize_kv)
    kv, scale = quantize_kv(torch.randn(*shape, generator=gen))
    return kv.to(dev), scale.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 40, 128])
def test_int8_pool_insert_matches_plain(dev, dtype, hd):
    """The quantizing pool write: float rows (strided views of a fused
    QKV), dropped rows, both leaves exact against quantize-then-write."""
    from distributed_compute_pytorch_tpu_torch.ops import cache_update as C
    gen = torch.Generator().manual_seed(20)
    P, H, bt, n = 11, 3, 16, 9
    pool, scale = _q8_cache(gen, 2, P, H, bt, hd, dev=dev)
    kv = _randn(gen, n, 2 * H * hd, dtype=dtype, dev=dev) * 3
    k = kv[:, :H * hd].reshape(n, H, hd)
    v = kv[:, H * hd:].reshape(n, H, hd)
    blocks = torch.randperm(P - 1, generator=gen)[:n].to(torch.int32) + 1
    blocks[[2, 5]] = P                            # dropped
    offsets = torch.randint(0, bt, (n,), generator=gen, dtype=torch.int32)
    offsets[7] = bt                               # dropped
    blocks, offsets = blocks.to(dev), offsets.to(dev)
    want = (pool.clone(), scale.clone())
    C.kv_pool_insert_plain(want[0], k, v, blocks, offsets, want[1])
    before = C.q8_launches
    C.kv_pool_insert_cuda(pool, k, v, blocks, offsets, scale=scale)
    torch.cuda.synchronize()
    assert C.q8_launches == before + 1
    assert torch.equal(pool, want[0]) and torch.equal(scale, want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_dense_insert_kernels_match_plain(dev, dtype):
    """``cache_insert``, ``kv_insert`` and ``kv_insert_rows`` in their int8
    forms (first, last, interior and out-of-range slots), the updates
    strided split-head views: both leaves exact, each int8 counter moved
    once and the float ones not at all."""
    from distributed_compute_pytorch_tpu_torch.ops import attention as A
    from distributed_compute_pytorch_tpu_torch.ops import cache_update as C
    gen = torch.Generator().manual_seed(21)
    B, hk, T, hd = 3, 4, 37, 64
    qkv = _randn(gen, B, 1, 3 * hk * hd, dtype=dtype, dev=dev)
    _, k, v = (A.split_heads(x, hk) for x in qkv.split(hk * hd, dim=-1))
    cache, scale = _q8_cache(gen, 2, B, hk, T, hd, dev=dev)
    slots = torch.arange(T, dtype=torch.int32, device=dev)
    rows = torch.tensor([0, T - 1, T], dtype=torch.int32, device=dev)
    cases = [
        ("kv_insert", lambda c, s: C.kv_insert_cuda(c, k, v, slots[17],
                                                    scale=s),
         lambda c, s: C.kv_insert_plain(c, k, v, slots[17], s)),
        ("kv_insert_rows", lambda c, s: C.kv_insert_rows_cuda(
            c, k, v, rows, scale=s),
         lambda c, s: C.kv_insert_plain(c, k, v, rows, s)),
        ("cache_insert", lambda c, s: C.cache_insert_cuda(
            c[1], v, slots[0], scale=s[1]),
         lambda c, s: C.cache_insert_plain(c[1], v, slots[0], s[1])),
    ]
    floats = (C.kv_insert_launches, C.kv_insert_rows_launches,
              C.cache_insert_launches)
    for counter, kernel, plain in cases:
        before = getattr(C, f"{counter}_q8_launches")
        got, want = (cache.clone(), scale.clone()), (cache.clone(),
                                                     scale.clone())
        kernel(*got)
        plain(*want)
        torch.cuda.synchronize()
        assert getattr(C, f"{counter}_q8_launches") == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert not torch.equal(got[0], cache), counter
    assert floats == (C.kv_insert_launches, C.kv_insert_rows_launches,
                      C.cache_insert_launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hk,hd,bt", [(4, 4, 64, 16), (6, 2, 32, 8),
                                        (2, 2, 128, 4), (8, 1, 64, 16),
                                        (4, 2, 40, 8)])
def test_int8_paged_decode_matches_plain(dev, dtype, H, hk, hd, bt):
    """The int8 paged read (hd 40 takes the 8-byte loads) with a parked
    row and a position past the table's horizon."""
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    gen = torch.Generator().manual_seed(22)
    B, P, nb = 5, 40, 7
    q = _randn(gen, B, H, 1, hd, dtype=dtype, dev=dev)
    pool, scale = _q8_cache(gen, 2, P, hk, bt, hd, dev=dev)
    table = torch.stack([torch.randperm(P - 1, generator=gen)[:nb] + 1
                         for _ in range(B)]).to(torch.int32)
    table[3] = 0                                  # parked: all trash
    pos = torch.tensor([0, 5 * bt + 3, nb * bt + 9, 2, 33 % (nb * bt)],
                       dtype=torch.int32)
    table, pos = table.to(dev), pos.to(dev)
    before = D.q8_launches
    got = D.paged_decode_cuda(q, pool, table, pos, kv_scale=scale)
    torch.cuda.synchronize()
    assert D.q8_launches == before + 1
    want = D.paged_decode_plain(q, pool, table, pos, kv_scale=scale)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hk,hd", [(4, 4, 64), (8, 2, 32), (2, 2, 128),
                                     (8, 1, 64), (4, 4, 24)])
@pytest.mark.parametrize("lockstep", [True, False])
def test_int8_dense_decode_matches_plain(dev, dtype, H, hk, hd, lockstep):
    """The int8 dense read with and without a left-pad slot mask whose runs
    cover whole 32-key chunks, MHA and GQA, a stride-0 lockstep position
    and per-row positions (one past the cache: clamped)."""
    from distributed_compute_pytorch_tpu_torch.ops import attention as A
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    gen = torch.Generator().manual_seed(23)
    B, T = 4, 150
    qx = _randn(gen, B, 1, 3 * H * hd, dtype=dtype, dev=dev)
    q = A.split_heads(qx[..., :H * hd], H)                # strided view
    cache, scale = _q8_cache(gen, 2, B, hk, T, hd, dev=dev)
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[1, :70] = False
    mask[2, :3] = False
    mask = mask.to(dev)
    if lockstep:
        pos = torch.arange(100, 102, dtype=torch.int32, device=dev)[0]
    else:
        pos = torch.tensor([0, 96, T, 41], dtype=torch.int32, device=dev)
    for slot_mask in (None, mask):
        before = D.dense_q8_launches
        got = D.dense_decode_cuda(q, cache, pos, slot_mask=slot_mask,
                                  kv_scale=scale)
        torch.cuda.synchronize()
        assert D.dense_q8_launches == before + 1
        want = D.dense_decode_plain(q, cache, pos, slot_mask=slot_mask,
                                    kv_scale=scale)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def test_tiny_int8_serve_and_generate_on_card_match_cpu(dev):
    """GPT-2-tiny in f32 with the int8 KV cache: served and generated
    greedy tokens on the card equal the CPU's, through the int8 kernels
    (the admission scatter's and the fused ticks' counters moved; the
    float forms', the read-only reads' and the standalone tick writes'
    did not), and the serve call
    runs under ``set_sync_debug_mode("error")``: no copy in it waits for
    the card."""
    from distributed_compute_pytorch_tpu_torch.infer import generate
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
        GPT2, GPT2Config)
    from distributed_compute_pytorch_tpu_torch.ops import cache_update as C
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    from distributed_compute_pytorch_tpu_torch.serve import (
        ContinuousBatcher, Request)
    torch.backends.cuda.matmul.allow_tf32 = False
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
                               segment=3, kv_dtype="int8", device=device)
        counts = (C.q8_launches, D.write_q8_launches, C.launches,
                  D.launches, D.write_launches, D.q8_launches)
        if device == "cpu":
            outs.append(cb.serve([Request(list(t), n) for t, n in reqs]))
        else:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                outs.append(cb.serve([Request(list(t), n) for t, n in reqs]))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert cb.last_block_leaks == 0
    assert outs[0] == outs[1]
    moved = (C.q8_launches - counts[0], D.write_q8_launches - counts[1],
             C.launches - counts[2], D.launches - counts[3],
             D.write_launches - counts[4], D.q8_launches - counts[5])
    assert moved[0] > 0 and moved[1] > 0 and moved[2:] == (0,) * 4, moved
    prompt = rng.integers(0, 256, (3, 12))
    mask = np.ones((3, 12), np.int64)
    mask[1, :5] = 0
    want = generate(cpu, prompt, 9, prompt_mask=mask, kv_quant=True)
    before = (D.dense_write_q8_launches, C.kv_insert_q8_launches,
              D.dense_q8_launches)
    got = generate(gpu, prompt, 9, prompt_mask=mask, kv_quant=True).cpu()
    assert (D.dense_write_q8_launches - before[0],
            C.kv_insert_q8_launches - before[1],
            D.dense_q8_launches - before[2]) == (2 * 8, 0, 0)
    assert torch.equal(got, want)


# ---- the split-key decode reads: the edges of a split ----------------------

def _decode_cache(gen, q8, dtype, dev, *shape):
    """A float cache of ``dtype``, or an int8 one and its scale plane."""
    if q8:
        return _q8_cache(gen, *shape, dev=dev)
    return _randn(gen, *shape, dtype=dtype, dev=dev), None


def _two_launches_match_plain(launch, plain, counter, dtype, zero_rows=()):
    """Two launches give the same bits and move ``counter()`` by 2; the
    output is finite and within TOL of the plain version (bf16 also row by
    row within ROW_TOL), except rows ``zero_rows``, which must be 0."""
    before = counter()
    got, again = launch(), launch()
    torch.cuda.synchronize()
    assert counter() == before + 2
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    want = plain().float()
    keep = [b for b in range(got.shape[0]) if b not in zero_rows]
    for b in zero_rows:
        assert not got[b].any(), b
    got, want = got[keep].float(), want[keep]
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    if dtype == torch.bfloat16:
        assert _row_err(got, want) <= ROW_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hk", [(4, 4), (8, 2)])
@pytest.mark.parametrize("q8", [False, True])
def test_paged_decode_split_edges(dev, dtype, H, hk, q8):
    """A capacity of 4 splits (nb * bt = 4 L): live lengths 1, L - 1, L,
    L + 1, 2 L + 5 and the full capacity in one batch, a parked all-trash
    row and a position past the horizon; then a batch where every row but
    one is a few keys long, so most splits are empty."""
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    gen = torch.Generator().manual_seed(40)
    L, hd, bt = D.SPLIT_KEYS, 64, 16
    nb = 4 * L // bt
    cap, B = nb * bt, 8
    P = B * nb + 1
    q = _randn(gen, B, H, 1, hd, dtype=dtype, dev=dev)
    pool, scale = _decode_cache(gen, q8, dtype, dev, 2, P, hk, bt, hd)
    table = (torch.randperm(P - 1, generator=gen)[:B * nb] + 1).reshape(
        B, nb).to(torch.int32)
    plan = D.split_plan(q, pool, table=table.to(dev), kv_scale=scale)
    assert (plan["S"], plan["L"]) == (4, L)
    table[5] = 0                                   # parked: all trash
    counter = (lambda: D.q8_launches) if q8 else (lambda: D.launches)
    for lengths in ([1, L - 1, L, L + 1, cap, 40, cap + 40, 2 * L + 5],
                    [1, 2, 3, 1, cap, 2, 1, 3]):
        pos = torch.tensor(lengths, dtype=torch.int32) - 1
        tab, pos = table.to(dev), pos.to(dev)
        _two_launches_match_plain(
            lambda: D.paged_decode_cuda(q, pool, tab, pos, kv_scale=scale),
            lambda: D.paged_decode_plain(q, pool, tab, pos, kv_scale=scale),
            counter, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hk", [(4, 4), (8, 2)])
@pytest.mark.parametrize("q8", [False, True])
def test_dense_decode_split_edges(dev, dtype, H, hk, q8):
    """A cache of 4 splits (T = 4 L), a strided query: live lengths 1,
    L - 1, L, L + 1 and T; with and without a slot mask that covers two
    whole splits of one row and every slot of another (that row writes
    zeros); then a stride-0 lockstep position that leaves the two-split
    row ten valid slots past its masked ones, in the last split."""
    from distributed_compute_pytorch_tpu_torch.ops import attention as A
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    gen = torch.Generator().manual_seed(41)
    L, hd = D.SPLIT_KEYS, 64
    T, B = 4 * L, 7
    qx = _randn(gen, B, 1, 3 * H * hd, dtype=dtype, dev=dev)
    q = A.split_heads(qx[..., :H * hd], H)                # strided view
    cache, scale = _decode_cache(gen, q8, dtype, dev, 2, B, hk, T, hd)
    plan = D.split_plan(q, cache, kv_scale=scale)
    assert (plan["S"], plan["L"]) == (4, L)
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[5, :2 * L] = False                        # two whole splits
    mask[6] = False                                # no valid slot: zeros
    mask = mask.to(dev)
    per_row = torch.tensor([1, L - 1, L, L + 1, T, T, T], dtype=torch.int32,
                           device=dev) - 1
    lockstep = torch.arange(T, dtype=torch.int32, device=dev)[2 * L + 9]
    counter = (lambda: D.dense_q8_launches) if q8 else (
        lambda: D.dense_launches)
    for pos in (per_row, lockstep):
        for m in (None, mask):
            _two_launches_match_plain(
                lambda: D.dense_decode_cuda(q, cache, pos, slot_mask=m,
                                            kv_scale=scale),
                lambda: D.dense_decode_plain(q, cache, pos, slot_mask=m,
                                             kv_scale=scale),
                counter, dtype, zero_rows=() if m is None else (6,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q8", [False, True])
def test_decode_reads_past_one_window(dev, dtype, q8):
    """A capacity over SMAX splits of 1,024 keys (the lookup window): each
    split walks two windows and, within them, the ring of tiles. The paged
    read over 1,100 blocks of 16 and the dense read over 17,408 slots (a
    slot mask with a masked run inside), GQA and MHA; full and short rows."""
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    gen = torch.Generator().manual_seed(42)
    hd, bt, nb, B = 64, 16, 1100, 2
    P = B * nb + 1
    for H, hk in ((4, 2), (2, 2)):
        q = _randn(gen, B, H, 1, hd, dtype=dtype, dev=dev)
        pool, scale = _decode_cache(gen, q8, dtype, dev, 2, P, hk, bt, hd)
        table = (torch.randperm(P - 1, generator=gen)[:B * nb] + 1).reshape(
            B, nb).to(dev, torch.int32)
        pos = torch.tensor([nb * bt - 1, 1500], dtype=torch.int32, device=dev)
        plan = D.split_plan(q, pool, table=table, kv_scale=scale)
        assert plan["S"] * 1024 < nb * bt and plan["stages"] > 1
        counter = (lambda: D.q8_launches) if q8 else (lambda: D.launches)
        _two_launches_match_plain(
            lambda: D.paged_decode_cuda(q, pool, table, pos, kv_scale=scale),
            lambda: D.paged_decode_plain(q, pool, table, pos, kv_scale=scale),
            counter, dtype)
    T = 17408
    cache, scale = _decode_cache(gen, q8, dtype, dev, 2, B, 2, T, hd)
    q = _randn(gen, B, 4, 1, hd, dtype=dtype, dev=dev)
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    mask[0, 3000:9000] = False
    pos = torch.tensor([T - 1, 2000], dtype=torch.int32, device=dev)
    assert D.split_plan(q, cache, kv_scale=scale)["S"] * 1024 < T
    counter = (lambda: D.dense_q8_launches) if q8 else (
        lambda: D.dense_launches)
    for m in (None, mask):
        _two_launches_match_plain(
            lambda: D.dense_decode_cuda(q, cache, pos, slot_mask=m,
                                        kv_scale=scale),
            lambda: D.dense_decode_plain(q, cache, pos, slot_mask=m,
                                         kv_scale=scale),
            counter, dtype)


@pytest.mark.parametrize("q8", [False, True])
def test_decode_reads_on_two_streams_at_once(dev, q8):
    """The paged and the dense read, each launched again and again on two
    streams with nothing between them, every launch of several splits a
    (row, kv head): each stream keeps its own merge scratch, so every
    output has the bits of one launch on the default stream (and that one
    is within TOL of the plain version)."""
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(43)
    hd, bt, nb, B, H, T = 64, 16, 64, 8, 4, 1024
    P = B * nb + 1
    q = _randn(gen, B, H, 1, hd, dtype=dtype, dev=dev)
    pool, pscale = _decode_cache(gen, q8, dtype, dev, 2, P, H, bt, hd)
    table = (torch.randperm(P - 1, generator=gen)[:B * nb] + 1).reshape(
        B, nb).to(dev, torch.int32)
    pos = torch.randint(0, nb * bt, (B,), generator=gen,
                        dtype=torch.int32).to(dev)
    cache, dscale = _decode_cache(gen, q8, dtype, dev, 2, B, H, T, hd)
    assert D.split_plan(q, pool, table=table, kv_scale=pscale)["S"] > 1
    assert D.split_plan(q, cache, kv_scale=dscale)["S"] > 1

    def paged():
        return D.paged_decode_cuda(q, pool, table, pos, kv_scale=pscale)

    def dense():
        return D.dense_decode_cuda(q, cache, pos, kv_scale=dscale)

    want = {"paged": paged(), "dense": dense()}
    torch.testing.assert_close(
        want["paged"].float(),
        D.paged_decode_plain(q, pool, table, pos, kv_scale=pscale).float(),
        atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(
        want["dense"].float(),
        D.dense_decode_plain(q, cache, pos, kv_scale=dscale).float(),
        atol=TOL[dtype], rtol=TOL[dtype])
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            torch.cuda._sleep(50_000_000)   # the launches below queue up
    got = []
    for _ in range(20):
        for s in streams:
            with torch.cuda.stream(s):
                got += [("paged", paged()), ("dense", dense())]
    for s in streams:
        torch.cuda.current_stream(dev).wait_stream(s)
    torch.cuda.synchronize()
    for name, out in got:
        assert torch.equal(out, want[name]), name


# ---- slice 8: the fused ticks (the slot write and the read in one launch) --

def _fresh_rows(gen, B, H, hk, hd, dtype, dev):
    """q, k, v ``[B, H(k), 1, hd]`` as the model hands them over:
    split-head views of one fused QKV projection (strided)."""
    from distributed_compute_pytorch_tpu_torch.ops import attention as A
    qkv = _randn(gen, B, 1, (H + 2 * hk) * hd, dtype=dtype, dev=dev)
    q, k, v = qkv.split([H * hd, hk * hd, hk * hd], dim=-1)
    return A.split_heads(q, H), A.split_heads(k, hk), A.split_heads(v, hk)


def _paged_pair(q, k, v, table, pos):
    """The unfused serving tick on the card: ``kv_pool_insert`` at the
    (block, offset) the table maps ``pos`` to, then ``paged_decode``."""
    from distributed_compute_pytorch_tpu_torch.ops import cache_update as C
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D

    def pair(pool, scale):
        bt, nb = pool.shape[3], table.shape[1]
        slot = torch.clamp(pos // bt, max=nb - 1).long()
        blk = table.gather(1, slot[:, None])[:, 0].contiguous()
        C.kv_pool_insert_cuda(pool, k[:, :, 0], v[:, :, 0], blk,
                              (pos % bt).contiguous(), scale=scale)
        return D.paged_decode_cuda(q, pool, table, pos, kv_scale=scale)
    return pair


def _dense_pair(q, k, v, pos, mask):
    """The unfused generation tick on the card: ``kv_insert`` (a 0-dim
    ``pos``) or ``kv_insert_rows`` at slot ``pos``, then
    ``dense_decode``."""
    from distributed_compute_pytorch_tpu_torch.ops import cache_update as C
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D

    def pair(cache, scale):
        write = C.kv_insert_rows_cuda if pos.ndim else C.kv_insert_cuda
        write(cache, k, v, pos, scale=scale)
        return D.dense_decode_cuda(q, cache, pos, slot_mask=mask,
                                   kv_scale=scale)
    return pair


def _split_start(n, S, gran):
    """The first keys of the S splits of a row of n live keys (the
    kernels' even share, rounded up to gran keys)."""
    per = -(-(-(-n // S)) // gran) * gran
    return [min(s * per, n) for s in range(S)]


def _fused_matches_pair(fused, pair, plain, cache, scale, live, counter,
                        dtype):
    """On four copies of one cache: the unfused kernel pair (the standalone
    write, then the read-only read), two fused launches and the plain
    version. The caches all bit-identical; every live row's output the
    pair's bits on both fused launches, finite, and within TOL of the plain
    version (bf16 also row by row within ROW_TOL); ``counter()`` moved by
    2."""
    copies = [(cache.clone(), None if scale is None else scale.clone())
              for _ in range(4)]
    before = counter()
    want = pair(*copies[0])
    got, again = fused(*copies[1]), fused(*copies[2])
    torch.cuda.synchronize()
    assert counter() == before + 2
    plain_out = plain(*copies[3])
    for c, s in copies[:1] + copies[2:]:
        assert torch.equal(c, copies[1][0])
        assert s is None or torch.equal(s, copies[1][1])
    assert not torch.equal(copies[1][0], cache)        # it wrote
    assert torch.equal(got[live], want[live])
    assert torch.equal(got[live], again[live])
    g, w = got[live].float(), plain_out[live].float()
    assert torch.isfinite(g).all()
    torch.testing.assert_close(g, w, atol=TOL[dtype], rtol=TOL[dtype])
    if dtype == torch.bfloat16:
        assert _row_err(g, w) <= ROW_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("H,hk,hd", [(4, 4, 64), (8, 1, 128), (6, 2, 40)])
def test_paged_write_decode_matches_the_kernel_pair(dev, dtype, q8, H, hk,
                                                    hd):
    """``paged_decode_write`` against ``kv_pool_insert`` then
    ``paged_decode`` at a capacity of 4 splits: rows writing the first key
    of their second split, the first and the last key of the table, the
    first slot of a block and one inside; a parked all-trash row past the
    horizon (its output left out). MHA, G = 8 at hd 128, and hd 40 (int8
    rows of 8-byte copies)."""
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    gen = torch.Generator().manual_seed(50)
    B, bt, nb = 6, 16, 64
    cap, P = nb * bt, B * nb + 1
    q, k, v = _fresh_rows(gen, B, H, hk, hd, dtype, dev)
    pool, scale = _decode_cache(gen, q8, dtype, dev, 2, P, hk, bt, hd)
    table = (torch.randperm(P - 1, generator=gen)[:B * nb] + 1).reshape(
        B, nb).to(torch.int32)
    table[4] = 0                                   # parked: all trash
    pos = torch.tensor([16, 0, cap - 1, 17 * bt, cap + 7, 300],
                       dtype=torch.int32)
    table, pos = table.to(dev), pos.to(dev)
    S = D.split_plan(q, pool, table=table, kv_scale=scale)["S"]
    assert S == 4 and 16 in _split_start(17, S, bt)[1:]
    counter = (lambda: D.write_q8_launches) if q8 else (
        lambda: D.write_launches)
    _fused_matches_pair(
        lambda c, s: D.paged_write_decode_cuda(q, k, v, c, table, pos,
                                               kv_scale=s),
        _paged_pair(q, k, v, table, pos),
        lambda c, s: D.paged_write_decode_plain(q, k, v, c, table, pos,
                                                kv_scale=s),
        pool, scale, [0, 1, 2, 3, 5], counter, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("H,hk,hd", [(4, 4, 64), (8, 1, 128), (6, 2, 40)])
@pytest.mark.parametrize("lockstep", [True, False],
                         ids=["lockstep", "per_row"])
def test_dense_write_decode_matches_the_kernel_pair(dev, dtype, q8, H, hk,
                                                    hd, lockstep):
    """``dense_decode_write`` against ``kv_insert`` (or ``kv_insert_rows``)
    then ``dense_decode`` over a cache of 4 splits: a lockstep slot that is
    the first key of the second split, or per-row slots (that key, 0, the
    last, and two inside); a slot mask that masks one row's written slot
    (the write still lands) and a left-pad run of another."""
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    gen = torch.Generator().manual_seed(51)
    B, T = 5, 1024
    q, k, v = _fresh_rows(gen, B, H, hk, hd, dtype, dev)
    cache, scale = _decode_cache(gen, q8, dtype, dev, 2, B, hk, T, hd)
    if lockstep:
        pos = torch.arange(T, dtype=torch.int32, device=dev)[16]
    else:
        pos = torch.tensor([16, 0, T - 1, 511, 700], dtype=torch.int32,
                           device=dev)
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[3, 16 if lockstep else 511] = False       # the written slot
    mask[4, :200] = False                          # a left-pad run
    mask = mask.to(dev)
    S = D.split_plan(q, cache, kv_scale=scale)["S"]
    assert S == 4 and 16 in _split_start(17, S, 16)[1:]
    counter = (lambda: D.dense_write_q8_launches) if q8 else (
        lambda: D.dense_write_launches)
    live = [0, 1, 2, 3] if lockstep else list(range(B))
    _fused_matches_pair(
        lambda c, s: D.dense_write_decode_cuda(q, k, v, c, pos,
                                               slot_mask=mask, kv_scale=s),
        _dense_pair(q, k, v, pos, mask),
        lambda c, s: D.dense_write_decode_plain(q, k, v, c, pos,
                                                slot_mask=mask, kv_scale=s),
        cache, scale, live, counter, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q8", [False, True])
def test_fused_ticks_past_one_window(dev, dtype, q8):
    """A capacity of 17,600 keys (paged, 1,100 blocks of 16) and 17,408
    slots (dense, a masked run inside): the full row's written key lies
    past the first lookup window of its split, in a later ring tile, so
    the write must land before a later window's copies too."""
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    gen = torch.Generator().manual_seed(52)
    B, H, hk, hd, bt, nb = 2, 4, 2, 64, 16, 1100
    P = B * nb + 1
    q, k, v = _fresh_rows(gen, B, H, hk, hd, dtype, dev)
    pool, scale = _decode_cache(gen, q8, dtype, dev, 2, P, hk, bt, hd)
    table = (torch.randperm(P - 1, generator=gen)[:B * nb] + 1).reshape(
        B, nb).to(dev, torch.int32)
    pos = torch.tensor([nb * bt - 1, 1500], dtype=torch.int32, device=dev)
    plan = D.split_plan(q, pool, table=table, kv_scale=scale)
    assert nb * bt - 1 - _split_start(nb * bt, plan["S"], bt)[-1] >= 1024
    counter = (lambda: D.write_q8_launches) if q8 else (
        lambda: D.write_launches)
    _fused_matches_pair(
        lambda c, s: D.paged_write_decode_cuda(q, k, v, c, table, pos,
                                               kv_scale=s),
        _paged_pair(q, k, v, table, pos),
        lambda c, s: D.paged_write_decode_plain(q, k, v, c, table, pos,
                                                kv_scale=s),
        pool, scale, [0, 1], counter, dtype)
    T = 17408
    cache, scale = _decode_cache(gen, q8, dtype, dev, 2, B, hk, T, hd)
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    mask[0, 3000:9000] = False
    pos = torch.tensor([T - 1, 2000], dtype=torch.int32, device=dev)
    plan = D.split_plan(q, cache, kv_scale=scale)
    assert T - 1 - _split_start(T, plan["S"], 16)[-1] >= 1024
    counter = (lambda: D.dense_write_q8_launches) if q8 else (
        lambda: D.dense_write_launches)
    _fused_matches_pair(
        lambda c, s: D.dense_write_decode_cuda(q, k, v, c, pos,
                                               slot_mask=mask, kv_scale=s),
        _dense_pair(q, k, v, pos, mask),
        lambda c, s: D.dense_write_decode_plain(q, k, v, c, pos,
                                                slot_mask=mask, kv_scale=s),
        cache, scale, [0, 1], counter, dtype)


@pytest.mark.parametrize("q8", [False, True])
def test_fused_ticks_on_two_streams_at_once(dev, q8):
    """The fused paged and dense ticks, launched again and again on two
    streams with nothing between them (each stream its own cache copies,
    which every launch rewrites with the same row): each stream keeps its
    own merge scratch, so every output has the bits of one launch on the
    default stream."""
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(53)
    hd, bt, nb, B, H, T = 64, 16, 64, 8, 4, 1024
    P = B * nb + 1
    q, k, v = _fresh_rows(gen, B, H, H, hd, dtype, dev)
    pool, pscale = _decode_cache(gen, q8, dtype, dev, 2, P, H, bt, hd)
    table = (torch.randperm(P - 1, generator=gen)[:B * nb] + 1).reshape(
        B, nb).to(dev, torch.int32)
    pos = torch.randint(0, nb * bt, (B,), generator=gen,
                        dtype=torch.int32).to(dev)
    cache, dscale = _decode_cache(gen, q8, dtype, dev, 2, B, H, T, hd)
    assert D.split_plan(q, pool, table=table, kv_scale=pscale)["S"] > 1
    assert D.split_plan(q, cache, kv_scale=dscale)["S"] > 1

    def copies():
        return ((pool.clone(), None if pscale is None else pscale.clone()),
                (cache.clone(), None if dscale is None else dscale.clone()))

    def paged(c):
        return D.paged_write_decode_cuda(q, k, v, c[0], table, pos,
                                         kv_scale=c[1])

    def dense(c):
        return D.dense_write_decode_cuda(q, k, v, c[0], pos, kv_scale=c[1])

    first = copies()
    want = {"paged": paged(first[0]), "dense": dense(first[1])}
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    own = [copies() for _ in streams]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            torch.cuda._sleep(50_000_000)   # the launches below queue up
    got = []
    for _ in range(20):
        for s, (pc, dc) in zip(streams, own):
            with torch.cuda.stream(s):
                got += [("paged", paged(pc)), ("dense", dense(dc))]
    for s in streams:
        torch.cuda.current_stream(dev).wait_stream(s)
    torch.cuda.synchronize()
    for name, out in got:
        assert torch.equal(out, want[name]), name
    for pc, dc in own:
        assert torch.equal(pc[0], first[0][0]) and torch.equal(dc[0],
                                                                first[1][0])


# ---- the captured decode programs (CUDA graphs) ----------------------------

def _tiny_on_card(dev, dtype):
    """GPT-2-tiny (positions lifted to 128) from seed 0, on the card in
    ``dtype``."""
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
        GPT2, GPT2Config)
    cfg = GPT2Config(vocab_size=256, max_seq_len=128, num_layers=2,
                     num_heads=4, d_model=64, d_ff=128)
    cpu = GPT2(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = GPT2(cfg, device=dev, dtype=dtype)
    gpu.load_state_dict(cpu.state_dict())
    return gpu


def _moved(before):
    from distributed_compute_pytorch_tpu_torch.utils.graphs import (
        launch_counts)
    now = launch_counts()
    return {(mod.__name__, name): now[(mod, name)] - n
            for (mod, name), n in before.items() if now[(mod, name)] != n}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_captured_segment_matches_eager(dev, dtype, kv_dtype):
    """Two serve calls on a batcher whose segment is captured and on one
    kept eager (``_capture = False``): bit-identical tokens in each call;
    the graph batcher runs its first segment eagerly, captures once and
    replays every later segment, the second call too, without a new
    capture; each call moves every launch counter as the eager one does (a
    replay counts its launches: the fused tick 2 layers x ticks); both
    calls, the capture included, run under
    ``set_sync_debug_mode("error")``."""
    from distributed_compute_pytorch_tpu_torch.serve import (
        ContinuousBatcher, Request)
    from distributed_compute_pytorch_tpu_torch.utils.graphs import (
        launch_counts)
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = _tiny_on_card(dev, dtype)
    rng = np.random.default_rng(6)
    calls = [[([int(x) for x in rng.integers(0, 256, rng.integers(1, 11))],
               int(rng.integers(3, 10))) for _ in range(7)]
             for _ in range(2)]
    fused = ("distributed_compute_pytorch_tpu_torch.ops.decode_attention",
             "write_q8_launches" if kv_dtype == "int8" else "write_launches")
    runs = {}
    for capture in (True, False):
        cb = ContinuousBatcher(gpu, slots=2, t_max=128, prompt_buf=10,
                               segment=3, kv_dtype=kv_dtype, device=dev)
        cb._capture = capture
        runs[capture] = []
        for reqs in calls:
            before, ticks0 = launch_counts(), cb.ticks
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                outs = cb.serve([Request(list(t), n) for t, n in reqs])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            moved = _moved(before)
            assert moved[fused] == 2 * (cb.ticks - ticks0)
            runs[capture].append((outs, moved))
            assert cb.last_block_leaks == 0
        segments = cb.ticks // 3
        want = (1, 1, segments - 1) if capture else (segments, 0, 0)
        assert (cb.stats["eager_segments"], cb.stats["graph_captures"],
                cb.stats["graph_replays"]) == want
    assert runs[True] == runs[False]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_captured_tick_matches_eager(dev, dtype, kv_quant):
    """Greedy generation of a left-padded batch with the captured tick and
    with the eager loop (``_eager=True``): bit-identical tokens, with and
    without an eos, float and int8 caches; the captured call runs its first
    tick eagerly, captures once and replays the other ticks, and moves
    every launch counter as the eager one does (the fused tick 2 layers x
    (N - 1))."""
    from distributed_compute_pytorch_tpu_torch.infer import make_generate_fn
    from distributed_compute_pytorch_tpu_torch.utils.graphs import (
        launch_counts)
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = _tiny_on_card(dev, dtype)
    rng = np.random.default_rng(12)
    lens, N = [9, 3, 40], 12
    T0 = max(lens)
    prompt = np.zeros((3, T0), np.int64)
    mask = np.zeros((3, T0), np.int64)
    for i, n in enumerate(lens):
        prompt[i, T0 - n:] = rng.integers(0, 256, n)
        mask[i, T0 - n:] = 1
    fused = ("distributed_compute_pytorch_tpu_torch.ops.decode_attention",
             "dense_write_q8_launches" if kv_quant
             else "dense_write_launches")
    eos_id = None
    for _ in range(2):
        out = {}
        for eager in (True, False):
            fn = make_generate_fn(gpu, N, eos_id=eos_id, kv_quant=kv_quant,
                                  _eager=eager)
            before = launch_counts()
            out[eager] = fn(prompt, prompt_mask=mask).cpu()
            moved = _moved(before)
            assert moved[fused] == 2 * (N - 1)
            out[eager] = (out[eager], moved)
            want = (0, 0) if eager else (1, N - 2)
            assert (fn.stats["graph_captures"],
                    fn.stats["graph_replays"]) == want
            assert (fn.stats["capture_ms"] is None) == eager
        assert torch.equal(out[True][0], out[False][0])
        assert out[True][1] == out[False][1]
        eos_id = int(out[True][0][0, T0 + 1])   # row 0 emits it early
    assert (out[True][0][0, T0 + 1:] == eos_id).all()


# ---- the captured train step (a CUDA graph) ---------------------------------

def _tiny_train(dev, optimizer, **kw):
    """GPT-2-tiny (dropout 0.1, T 32) from seed 0 on the card, f32, its
    step functions (``kw``: ``make_step_fns`` options), a fresh state and
    one batch of 8."""
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
        GPT2, GPT2Config)
    from distributed_compute_pytorch_tpu_torch.train.optim import (
        build_optimizer)
    from distributed_compute_pytorch_tpu_torch.train.step import make_step_fns
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPT2Config(vocab_size=256, max_seq_len=32, num_layers=2,
                     num_heads=4, d_model=64, d_ff=128, dropout_rate=0.1)
    model = GPT2(cfg, device=dev)
    tx = build_optimizer(optimizer, 1e-2, steps_per_epoch=8, total_steps=8,
                         warmup_steps=2)
    init_fn, train_step, _ = make_step_fns(model, tx, **kw)
    state = init_fn(0)
    x = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (8, 32))).to(dev)
    return train_step, state, x


def _train_bits(state):
    opt = state.opt_state
    return ([p.detach().clone() for p in state.params.values()]
            + [t.clone() for v in opt.moments().values() for t in v.values()]
            + [opt.count.clone()])


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_fused"])
def test_captured_train_step_matches_eager(dev, optimizer):
    """Six updates with dropout 0.1, captured and eager (``_eager=True``):
    bit-identical losses, parameters, moments and count; the captured
    step ran its first update eagerly, captured once and replayed five
    times, and moved every launch counter as the eager one did (the
    flash kernels 2 layers a step, fused AdamW 1 a step)."""
    from distributed_compute_pytorch_tpu_torch.utils.graphs import (
        launch_counts)
    runs = {}
    for eager in (True, False):
        train_step, state, x = _tiny_train(dev, optimizer, _eager=eager)
        before = launch_counts()
        losses = [train_step(state, x, x)[1]["loss"] for _ in range(6)]
        torch.cuda.synchronize()
        runs[eager] = (losses, _train_bits(state), _moved(before))
        assert state.step == 6
        if not eager:
            assert (train_step.stats["eager_steps"],
                    train_step.stats["graph_captures"],
                    train_step.stats["graph_replays"]) == (1, 1, 5)
    (l_e, b_e, m_e), (l_g, b_g, m_g) = runs[True], runs[False]
    assert len(set(id(v) for v in l_g)) == 6      # fresh tensors a step
    assert [v.item() for v in l_g] == [v.item() for v in l_e]
    assert all(torch.equal(a, b) for a, b in zip(b_g, b_e))
    assert m_g == m_e
    fa = "distributed_compute_pytorch_tpu_torch.ops.flash_attention"
    assert m_g[(fa, "launches")] == m_g[(fa, "dq_launches")] == 12
    assert m_g.get(("distributed_compute_pytorch_tpu_torch.ops.fused_adamw",
                    "launches"), 0) == (6 if optimizer == "adamw_fused"
                                        else 0)


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_fused"])
def test_captured_step_skips_a_poisoned_update(dev, optimizer):
    """``nonfinite_policy="skip"`` on the captured step: a replay with one
    ``wte`` element set to inf reports ``skipped`` 1 and a non-finite
    ``grad_sumsq`` and leaves params, moments and count bit-identical;
    the element restored, the next replays train (``skipped`` 0, the
    count advancing)."""
    train_step, state, x = _tiny_train(dev, optimizer,
                                       nonfinite_policy="skip",
                                       sentinel=True)
    for _ in range(3):
        _, m = train_step(state, x, x)
        assert m["skipped"].item() == 0.0
    wte = state.params["wte.weight"].detach()
    clean = wte[3, 5].item()
    wte[3, 5] = float("inf")
    before = _train_bits(state)
    _, m = train_step(state, x, x)
    assert m["skipped"].item() == 1.0
    assert not torch.isfinite(m["grad_sumsq"]).item()
    assert all(torch.equal(a, b) for a, b in zip(_train_bits(state), before))
    wte[3, 5] = clean
    for k in range(2):
        _, m = train_step(state, x, x)
        assert m["skipped"].item() == 0.0
        assert torch.isfinite(m["loss"]).item()
    assert int(state.opt_state.count) == 5 and state.step == 6
    assert train_step.stats["graph_replays"] == 5


def test_train_capture_and_replays_pass_sync_debug_error(dev):
    """After the eager warm-up, the capture and every replay, with the
    batch copies before them and the metric copies after, run under
    ``torch.cuda.set_sync_debug_mode("error")``: no step waits for the
    card."""
    train_step, state, x = _tiny_train(dev, "adamw_fused",
                                       nonfinite_policy="skip",
                                       sentinel=True)
    train_step(state, x, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            _, m = train_step(state, x, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert train_step.stats["graph_captures"] == 1
    assert train_step.stats["graph_replays"] == 4
    assert m["skipped"].item() == 0.0


def _convnet_train(dev, optimizer, **kw):
    """The ConvNet (random weights, seed 0) with ``optimizer`` and StepLR
    over 2 steps an epoch, its step functions, a fresh state and a batch
    of 16 (numpy seed 8)."""
    from distributed_compute_pytorch_tpu_torch.models.convnet import ConvNet
    from distributed_compute_pytorch_tpu_torch.train.optim import (
        build_optimizer)
    from distributed_compute_pytorch_tpu_torch.train.step import (
        make_step_fns)
    model = ConvNet(device=dev).init(torch.Generator().manual_seed(0))
    lr = 1.0 if optimizer == "adadelta" else 0.05
    tx = build_optimizer(optimizer, lr, gamma=0.7, steps_per_epoch=2)
    init_fn, train_step, _ = make_step_fns(model, tx, **kw)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(0, 1, (16, 28, 28, 1)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 10, 16)).to(dev)
    return train_step, init_fn(0), x, y


def _convnet_bits(state):
    return _train_bits(state) + [t.clone()
                                 for t in state.model_state.values()]


@pytest.mark.parametrize("optimizer", ["adadelta", "sgd"])
def test_captured_convnet_step_matches_eager(dev, optimizer):
    """Six ConvNet updates (dropout on, StepLR dropping every 2 steps),
    captured and eager: bit-identical losses, parameters, slots, count
    and BatchNorm running stats; the captured step ran its first update
    eagerly, captured once and replayed five times."""
    runs = {}
    for eager in (True, False):
        train_step, state, x, y = _convnet_train(dev, optimizer,
                                                 _eager=eager)
        losses = [train_step(state, x, y)[1]["loss"] for _ in range(6)]
        torch.cuda.synchronize()
        runs[eager] = ([v.item() for v in losses], _convnet_bits(state))
        if not eager:
            assert (train_step.stats["eager_steps"],
                    train_step.stats["graph_captures"],
                    train_step.stats["graph_replays"]) == (1, 1, 5)
    assert runs[True][0] == runs[False][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1],
                                                 runs[False][1]))
    assert not torch.equal(runs[False][1][-1], torch.ones_like(
        runs[False][1][-1]))


def test_captured_convnet_step_skips_a_poisoned_update(dev):
    """``nonfinite_policy="skip"``: a replay on a batch holding a NaN
    reports ``skipped`` 1 and leaves parameters, slots, count and the
    BatchNorm running stats bit-identical; the next replay trains."""
    train_step, state, x, y = _convnet_train(dev, "adadelta",
                                             nonfinite_policy="skip")
    for _ in range(3):
        assert train_step(state, x, y)[1]["skipped"].item() == 0.0
    before = _convnet_bits(state)
    bad = x.clone()
    bad[2, 4, 4, 0] = float("nan")
    assert train_step(state, bad, y)[1]["skipped"].item() == 1.0
    assert all(torch.equal(a, b) for a, b in zip(_convnet_bits(state),
                                                 before))
    assert train_step(state, x, y)[1]["skipped"].item() == 0.0
    assert int(state.opt_state.count) == 4
    assert train_step.stats["graph_replays"] == 4


def test_captured_convnet_step_in_a_one_rank_nccl_group(dev):
    """The captured step under a one-process ``nccl`` group (its gradient
    all-reduce and sync-BN all-reduces inside the graph) gives the
    ungrouped captured step's bits: a SUM over one rank, divided by 1."""
    import socket

    from distributed_compute_pytorch_tpu_torch.core import mesh
    train_step, state, x, y = _convnet_train(dev, "adadelta")
    want = [train_step(state, x, y)[1]["loss"].item() for _ in range(4)]
    want_bits = _convnet_bits(state)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert mesh.initialize_distributed(f"127.0.0.1:{port}", 1, 0, "cuda")
    try:
        train_step, state, x, y = _convnet_train(dev, "adadelta")
        assert state.flat_grads is not None
        got = [train_step(state, x, y)[1]["loss"].item() for _ in range(4)]
        assert train_step.stats["graph_replays"] == 3
        assert got == want
        assert all(torch.equal(a, b) for a, b in zip(_convnet_bits(state),
                                                     want_bits))
    finally:
        mesh.shutdown_distributed()


# ---- the sharded train step (ZeRO-1, FSDP) ---------------------------------

def test_fused_adamw_refuses_an_unaligned_shard_view(dev):
    """A ZeRO-1 shard is a view of the flat buffers; the kernel's
    ``float4`` loads need it 16-byte aligned. A view four elements in
    runs; one element in raises, with nothing launched."""
    from distributed_compute_pytorch_tpu_torch.ops import fused_adamw as FA
    n = 1024
    bufs = [torch.zeros(n + 4, device=dev) for _ in range(4)]
    tx = FA.fused_adamw(1e-3)
    count = FA.device_count(dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    before = FA.launches
    FA.fused_adamw_update(*(b[4:] for b in bufs), tx.scalars(count), count,
                          ok, **tx.hyper)
    with pytest.raises(ValueError, match="16-byte"):
        FA.fused_adamw_update(*(b[1:n + 1] for b in bufs),
                              tx.scalars(count), count, ok, **tx.hyper)
    torch.cuda.synchronize()
    assert FA.launches == before + 1 and int(count) == 1


def _logical_bits(state):
    """Every master, both moments and the count, by leaf name (gathered
    where sharded)."""
    opt = state.opt_state
    params, moments = opt.param_leaves(), opt.moments()
    return ([params[n].detach().clone() for n in sorted(params)]
            + [moments[k][n].clone() for k in sorted(moments)
               for n in sorted(moments[k])] + [opt.count.clone()])


@pytest.mark.parametrize("layout", ["replicated", "zero1", "fsdp"])
def test_one_rank_gpt2_captured_step_matches_ungrouped(dev, layout):
    """GPT-2-tiny's captured step under a one-process ``nccl`` group: the
    replicated update (``auto`` at world 1), the ZeRO-1 dataflow forced on
    (``shard_update=True``: the flat gradient reduce-scattered, the fused
    kernel on the shard, the shard all-gathered in place) and FSDP (each
    unit gathered and its gradient reduce-scattered by the autograd
    Function, ``adamw``) all give the ungrouped captured step's losses
    and bits: sums over one rank, divided by 1."""
    import socket

    from distributed_compute_pytorch_tpu_torch.core import mesh
    from distributed_compute_pytorch_tpu_torch.parallel.api import FSDP
    optimizer = "adamw" if layout == "fsdp" else "adamw_fused"
    kw = {"zero1": {"shard_update": True},
          "fsdp": {"strategy": FSDP()}}.get(layout, {})
    train_step, state, x = _tiny_train(dev, optimizer)
    want = [train_step(state, x, x)[1]["loss"].item() for _ in range(4)]
    want_bits = _logical_bits(state)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert mesh.initialize_distributed(f"127.0.0.1:{port}", 1, 0, "cuda")
    try:
        train_step, state, x = _tiny_train(dev, optimizer, **kw)
        assert state.opt_state.layout.mode == layout
        got = [train_step(state, x, x)[1]["loss"].item() for _ in range(4)]
        assert train_step.stats["graph_replays"] == 3
        assert got == want
        assert all(torch.equal(a, b) for a, b in zip(_logical_bits(state),
                                                     want_bits))
        del train_step, state
    finally:
        mesh.shutdown_distributed()


# ---- slice 13: BERT's non-causal masked attention, ResNet and BERT steps -

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,d", [(4, 2, 512, 64), (3, 2, 200, 64),
                                     (2, 3, 77, 80)])
def test_noncausal_masked_flash_kernels_match_plain(dev, dtype, b, h, t, d):
    """BERT's attention: the three flash kernels non-causal under a
    ragged key mask (every row keeps 1/4 to all of its keys), on
    split-head views of one fused QKV, against their plain versions; the
    pad keys' dk and dv are exactly zero; a second launch gives the same
    bits."""
    from distributed_compute_pytorch_tpu_torch.ops import attention as A
    from distributed_compute_pytorch_tpu_torch.ops import flash_attention as F
    gen = torch.Generator().manual_seed(13)
    qkv = _randn(gen, b, t, 3 * h * d, dtype=dtype, dev=dev)
    q, k, v = (A.split_heads(x, h) for x in qkv.split(h * d, dim=-1))
    do = _randn(gen, b, t, h, d, dtype=dtype, dev=dev).transpose(1, 2)
    lengths = torch.randint(t // 4, t + 1, (b,), generator=gen)
    lengths[0] = t
    mask = (torch.arange(t)[None] < lengths[:, None]).float().to(dev)
    kw = {"causal": False, "kv_mask": mask}
    o, lse = F.flash_fwd(q, k, v, **kw)
    want, lse_want = F.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    got = (F.flash_bwd_dq(*args, **kw), *F.flash_bwd_dkv(*args, **kw))
    again = (F.flash_fwd(q, k, v, **kw)[0], F.flash_bwd_dq(*args, **kw),
             *F.flash_bwd_dkv(*args, **kw))
    grads = F.flash_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _rel_err(o, want) <= TOL[dtype]
    torch.testing.assert_close(lse, lse_want, atol=2e-5, rtol=2e-5)
    for name, g, w in zip(("o", "dq", "dk", "dv"), (o, *got),
                          (want, *grads)):
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= TOL[dtype], name
        if dtype == torch.bfloat16:
            assert _row_err(g, w) <= ROW_TOL, name
    for g, g2 in zip((o, *got), again):
        assert torch.equal(g, g2)
    pad = mask == 0
    for g in got[1:]:
        assert (g.transpose(1, 2)[pad] == 0).all()


def _ladder_step(dev, name, _eager):
    """A captured (or eager) step of a ResNet-18 at width 16 with
    ``flip-crop`` on 32 x 32 images (SGD), or of BERT-tiny with a pad mask
    and dropout 0.1 (``adamw_fused``, bf16)."""
    import dataclasses

    from distributed_compute_pytorch_tpu_torch.models.bert import (
        BertConfig, BertMLM)
    from distributed_compute_pytorch_tpu_torch.models.resnet import ResNet
    from distributed_compute_pytorch_tpu_torch.ops.augment import (
        build_augment)
    from distributed_compute_pytorch_tpu_torch.train.optim import (
        build_optimizer)
    from distributed_compute_pytorch_tpu_torch.train.step import (
        make_step_fns)
    rng = np.random.default_rng(13)
    if name == "resnet18":
        model = ResNet.build("resnet18", width=16, device=dev)
        init_fn, train_step, _ = make_step_fns(
            model, build_optimizer("sgd", 0.05, gamma=0.7,
                                   steps_per_epoch=2),
            augment=build_augment("flip-crop"), _eager=_eager)
        x = torch.from_numpy(rng.normal(size=(16, 32, 32, 3)).astype(
            np.float32)).to(dev)
        y = torch.from_numpy(rng.integers(0, 10, 16)).to(dev)
        return train_step, init_fn(0), x, y
    cfg = dataclasses.replace(BertConfig.tiny(), pad_token_id=0,
                              dropout_rate=0.1)
    model = BertMLM(cfg, device=dev)
    init_fn, train_step, _ = make_step_fns(
        model, build_optimizer("adamw_fused", 1e-3),
        compute_dtype="bfloat16", _eager=_eager)
    toks = rng.integers(2, cfg.vocab_size, (8, 64))
    toks[np.arange(64)[None] >= rng.integers(16, 65, 8)[:, None]] = 0
    x = torch.from_numpy(toks).to(dev)
    return train_step, init_fn(0), x, x


@pytest.mark.parametrize("name", ["resnet18", "bert"])
def test_captured_ladder_step_matches_eager(dev, name):
    """Six updates captured and eager: bit-identical losses, parameters,
    slots, count and (ResNet) BatchNorm running stats, the augment and MLM
    draws inside the graph from its registered generator."""
    runs = {}
    for eager in (True, False):
        train_step, state, x, y = _ladder_step(dev, name, eager)
        losses = [train_step(state, x, y)[1]["loss"] for _ in range(6)]
        torch.cuda.synchronize()
        runs[eager] = ([v.item() for v in losses], _convnet_bits(state))
        if not eager:
            assert train_step.stats["graph_replays"] == 4
    assert runs[True][0] == runs[False][0]
    assert all(math.isfinite(v) for v in runs[True][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1],
                                                 runs[False][1]))


# ---- Llama: grouped-query attention on the card -----------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_on_repeated_kv_matches_dense_autograd(dev, dtype, masked):
    """Llama's whole-window attention: 12 query heads over 4 kv heads,
    K/V repeated inside ``attention`` (``repeat_interleave``, head h reads
    kv head h // 3) into the flash kernels, forward and backward, against
    autograd through the plain version on K/V repeated the same way; dK
    and dV come back at kv-head width, summed over each group."""
    from distributed_compute_pytorch_tpu_torch.ops import attention as A
    from distributed_compute_pytorch_tpu_torch.ops import flash_attention as F
    gen = torch.Generator().manual_seed(21)
    b, t, H, hk, d = 2, 96, 12, 4, 64
    q0 = _randn(gen, b, t, H * d, dtype=dtype, dev=dev)
    kv0 = _randn(gen, b, t, 2 * hk * d, dtype=dtype, dev=dev)
    g = _randn(gen, b, t, H * d, dtype=dtype, dev=dev)
    mask = None
    if masked:
        mask = (torch.arange(t)[None] < torch.tensor([[t], [t - 37]])
                ).float().to(dev)
    grads = []
    for plain in (False, True):
        q_in, kv_in = (x.clone().requires_grad_() for x in (q0, kv0))
        q = A.split_heads(q_in, H)
        k, v = (A.split_heads(x, hk) for x in kv_in.split(hk * d, dim=-1))
        if plain:
            k, v = (x.repeat_interleave(H // hk, dim=1) for x in (k, v))
            o = F.flash_attention_plain(q, k, v, causal=True, kv_mask=mask)
        else:
            before = (F.launches, F.dq_launches, F.dkv_launches)
            o = A.attention(q, k, v, causal=True, kv_mask=mask)
        A.merge_heads(o).backward(g)
        if not plain:
            moved = (F.launches - before[0], F.dq_launches - before[1],
                     F.dkv_launches - before[2])
            assert moved == (1, 1, 1), moved
        grads.append((o.detach(), q_in.grad, kv_in.grad))
    assert grads[0][2].shape == (b, t, 2 * hk * d)
    for name, got, want in zip(("o", "dq", "dkv"), *grads):
        assert torch.isfinite(got).all(), name
        assert _rel_err(got, want) <= TOL[dtype], name
        if dtype == torch.bfloat16:
            assert _row_err(got, want) <= ROW_TOL, name


def _llama_pair(dev):
    """A 2-layer Llama at G = 3 (6 query heads of 64 over 2 kv heads), f32,
    random weights, on the CPU and a copy on the card."""
    from distributed_compute_pytorch_tpu_torch.models.llama import (
        LlamaConfig, LlamaLM)
    cfg = LlamaConfig(vocab_size=256, max_seq_len=128, num_layers=2,
                      num_heads=6, num_kv_heads=2, d_model=384, d_ff=512)
    cpu = LlamaLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = LlamaLM(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_llama_serve_on_card_matches_cpu(dev, kv_dtype):
    """The Llama decode tick through the paged pool, float and int8: a
    Llama at G = 3 served on the card gives the CPU's (the plain path's)
    greedy tokens in f32, through ``flash_fwd`` on repeated K/V, the
    admission scatter and the fused ``paged_decode_write`` (or its
    ``_q8`` form)."""
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    from distributed_compute_pytorch_tpu_torch.serve import (
        ContinuousBatcher, Request)
    rng = np.random.default_rng(8)
    reqs = [([int(x) for x in rng.integers(0, 256, rng.integers(1, 11))],
             int(rng.integers(3, 10))) for _ in range(7)]
    outs = []
    counter = ((lambda: D.write_q8_launches) if kv_dtype == "int8"
               else (lambda: D.write_launches))
    for model, device in zip(_llama_pair(dev), ("cpu", dev)):
        before = counter()
        cb = ContinuousBatcher(model, slots=2, t_max=128, prompt_buf=10,
                               segment=3, kv_block_tokens=16,
                               kv_dtype=kv_dtype, device=device)
        outs.append(cb.serve([Request(list(t), n) for t, n in reqs]))
        assert cb.last_block_leaks == 0
    assert counter() > before
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_llama_generate_on_card_matches_cpu(dev, kv_quant):
    """The Llama decode tick through the dense cache, float and int8:
    left-padded prompts generated on the card (the captured greedy tick,
    the fused ``dense_decode_write`` or ``_q8`` at G = 3) give the CPU's
    tokens in f32."""
    from distributed_compute_pytorch_tpu_torch import infer
    from distributed_compute_pytorch_tpu_torch.ops import decode_attention as D
    prompt = np.random.default_rng(9).integers(0, 256, (3, 9))
    mask = np.ones((3, 9), np.int64)
    mask[1, :4] = 0
    mask[2, :8] = 0
    counter = ((lambda: D.dense_write_q8_launches) if kv_quant
               else (lambda: D.dense_write_launches))
    outs = []
    for model in _llama_pair(dev):
        before = counter()
        outs.append(infer.generate(model, prompt, 12, prompt_mask=mask,
                                   kv_quant=kv_quant).cpu())
    assert counter() > before
    assert torch.equal(outs[0], outs[1])
