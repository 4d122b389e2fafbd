"""The flash backward's plain version (``flash_bwd_plain``: the math the
two CUDA backward kernels are held to on the card) against ``jax.vjp`` of
the JAX package's Pallas ``flash_attention``, whose backward is its two
Pallas kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) in interpret mode
on the CPU, at ``block_q = block_k = 32``. The same numpy inputs go to
both; ``lse`` and ``delta`` come from the port's plain forward. Tolerance
1e-4 in f32: only the summation order differs. Rows whose every allowed
key the mask refuses carry no upstream gradient (``dO`` is zero there, as
the loss of a padded position is), so they add nothing anywhere.

Then the port's differentiable ``flash_attention`` on CPU tensors (the
``FlashAttention`` autograd Function) against autograd of the dense math.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash)
from distributed_compute_pytorch_tpu_torch.ops import attention as A
from distributed_compute_pytorch_tpu_torch.ops import flash_attention as F

TOL = 1e-4
B, H, D = 2, 2, 16


def _inputs(seed, t, tk, masked):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, H, t, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, H, tk, D)).astype(np.float32)
            for _ in range(2))
    mask = None
    if masked:
        lengths = np.array([tk, max(1, tk // 3)])
        mask = (np.arange(tk)[None] < lengths[:, None]).astype(np.float32)
    return q, k, v, do, mask


def _live_rows(t, tk, causal, mask):
    """[B, t] rows with at least one key both the causal rule and the
    mask allow."""
    allowed = np.ones((t, tk), bool)
    if causal:
        allowed = np.arange(tk)[None] <= np.arange(t)[:, None] + (tk - t)
    keys = np.ones((B, tk), bool) if mask is None else mask > 0
    return (allowed[None] & keys[:, None]).any(-1)


@pytest.mark.parametrize("t,tk,causal,masked", [
    (64, 64, True, False),      # causal square
    (40, 64, True, False),      # causal t < tk: bottom-right offset
    (64, 64, True, True),       # causal, ragged kv_mask
    (37, 53, False, False),     # non-causal, odd lengths
    (48, 48, False, True),      # non-causal, masked
], ids=["causal", "causal_offset", "causal_masked", "odd", "masked"])
def test_flash_bwd_plain_matches_pallas_backward(t, tk, causal, masked):
    q, k, v, do, mask = _inputs(t * 7 + tk, t, tk, masked)
    live = _live_rows(t, tk, causal, mask)
    do = do * live[:, None, :, None]           # dead rows: no gradient

    def fwd(q_, k_, v_):
        return jax_flash(q_, k_, v_, causal=causal,
                         kv_mask=None if mask is None else jnp.asarray(mask),
                         block_q=32, block_k=32)
    _, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk_, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = F.flash_fwd_plain(tq, tk_, tv, causal=causal, kv_mask=tmask)
    delta = (tdo * o).sum(-1)
    got = F.flash_bwd_plain(tq, tk_, tv, tdo, lse, delta, causal=causal,
                            kv_mask=tmask)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL,
                                   err_msg=name)
    # the wrappers on CPU tensors are the plain version
    dq = F.flash_bwd_dq(tq, tk_, tv, tdo, lse, delta, causal=causal,
                        kv_mask=tmask)
    dk, dv = F.flash_bwd_dkv(tq, tk_, tv, tdo, lse, delta, causal=causal,
                             kv_mask=tmask)
    for g, w in zip((dq, dk, dv), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("causal,masked,scale", [(True, False, None),
                                                 (True, True, None),
                                                 (False, True, 0.3)])
def test_flash_attention_function_on_cpu_matches_dense_autograd(causal,
                                                                masked,
                                                                scale):
    """``attention(...)`` on CPU tensors runs the ``FlashAttention``
    Function: same output as the dense math and, through its plain
    backward, the same q, k and v gradients as autograd of it (the
    default ``d**-0.5`` scale and an explicit one)."""
    t, tk = 24, 40
    q, k, v, do, mask = _inputs(5, t, tk, masked)
    live = _live_rows(t, tk, causal, mask)
    do = do * live[:, None, :, None]
    tmask = None if mask is None else torch.from_numpy(mask)
    outs = []
    for fn in ("flash", "dense"):
        tq, tk_, tv = (torch.from_numpy(a.copy()).requires_grad_()
                       for a in (q, k, v))
        if fn == "flash":
            o = A.attention(tq, tk_, tv, causal=causal, scale=scale,
                            kv_mask=tmask)
        else:
            o = A.dot_product_attention(
                tq, tk_, tv, causal=causal, scale=scale,
                mask=None if tmask is None else (tmask > 0)[:, None, None])
        o.backward(torch.from_numpy(do))
        outs.append((o.detach(), tq.grad, tk_.grad, tv.grad))
    before = (F.launches, F.dq_launches, F.dkv_launches)
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    assert (F.launches, F.dq_launches, F.dkv_launches) == before


def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    """On CUDA tensors the wrappers launch or raise; here every check
    that precedes a launch is exercised on shapes alone."""
    q = torch.zeros(1, 2, 4, 8)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="causal"):
        F.flash_bwd_dq(q, q[:, :, :2], q[:, :, :2], q, lse, lse,
                       causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        F._bwd_prepare("flash_bwd_dq", q, q, q, q, lse, lse, False, None)
    with pytest.raises(ValueError, match="dO shape"):
        F._bwd_prepare("flash_bwd_dkv", q, q, q, q[:, :1], lse, lse, False,
                       None)


def _bthd_grad(b, t, h, d, dtype):
    return torch.zeros(b, t, h, d, dtype=dtype).transpose(1, 2)


def _fwd_operands(dtype=torch.bfloat16, d=64, qkv_pad=0, q_offset=0):
    """q, k, v as split-head views of one fused QKV ``[2, 5, 3 * 3 * d +
    qkv_pad]`` (q starting ``q_offset`` elements in) and the ``_like_bthd``
    output: the operands of one forward call."""
    qkv = torch.zeros(2, 5, 3 * 3 * d + qkv_pad, dtype=dtype)
    q, k, v = (A.split_heads(qkv[..., i * 3 * d:(i + 1) * 3 * d], 3)
               for i in range(3))
    if q_offset:
        q = A.split_heads(qkv[..., q_offset:q_offset + 3 * d], 3)
    return [q, k, v, F._like_bthd(q)]


# (name, tensors of one backward or forward call, whether the tensor-core
# kernel takes it); built lazily so that collection allocates nothing
_RULE_CASES = {
    "fused_qkv_views_bf16": (lambda: [
        *(A.split_heads(x, 3) for x in torch.zeros(
            2, 5, 3 * 3 * 64, dtype=torch.bfloat16).split(3 * 64, dim=-1)),
        _bthd_grad(2, 5, 3, 64, torch.bfloat16)], True),
    "like_bthd_outputs": (lambda: [
        F._like_bthd(torch.zeros(2, 3, 5, 64, dtype=torch.bfloat16))
        for _ in range(4)], True),
    "f32": (lambda: [torch.zeros(2, 3, 5, 64) for _ in range(4)], False),
    "head_dim_20": (lambda: [torch.zeros(2, 3, 5, 20, dtype=torch.bfloat16)
                             for _ in range(4)], False),
    "base_off_by_one_element": (lambda: [
        torch.zeros(2, 3, 5, 72, dtype=torch.bfloat16)[..., 1:65],
        *(torch.zeros(2, 3, 5, 64, dtype=torch.bfloat16)
          for _ in range(3))], False),
    "row_stride_not_16_bytes": (lambda: [
        torch.zeros(2, 5, 3 * 64 + 4, dtype=torch.bfloat16)[..., :3 * 64]
        .reshape(2, 5, 3, 64).transpose(1, 2),
        *(torch.zeros(2, 3, 5, 64, dtype=torch.bfloat16)
          for _ in range(3))], False),
    "fwd_fused_qkv_views_bf16": (_fwd_operands, True),
    "fwd_f32": (lambda: _fwd_operands(torch.float32), False),
    "fwd_head_dim_20": (lambda: _fwd_operands(d=20), False),
    "fwd_base_off_by_one_element": (lambda: _fwd_operands(q_offset=1),
                                    False),
    "fwd_row_stride_not_16_bytes": (lambda: _fwd_operands(qkv_pad=4),
                                    False),
}


@pytest.mark.parametrize("case", list(_RULE_CASES))
def test_tensor_core_path_rule(case):
    """The path rule on shapes, dtypes and strides alone, for the
    backward's operands and the forward's (q, k, v and the ``_like_bthd``
    output): bf16, ``d % 8 == 0``, 16-byte aligned bases and b/h/t strides
    take the tensor-core kernels; f32, odd head dims and misaligned views
    the CUDA-core ones."""
    make, want = _RULE_CASES[case]
    tensors = make()
    ptrs = [x.data_ptr() for x in tensors]
    strides = [s for x in tensors for s in x.stride()[:3]]
    assert F._tensor_core_path(tensors[0].dtype, tensors[0].shape[-1], ptrs,
                               strides) is want
