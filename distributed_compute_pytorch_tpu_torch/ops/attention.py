"""Attention ops — port of ``distributed_compute_pytorch_tpu/ops/attention.py``.

The dense math here (``dot_product_attention``, ``cached_attention``,
``cached_attention_q8``, ``gather_kv_blocks``) is the REFERENCE the
kernels are held to: it is the plain version the CPU path runs and
``chip_smoke.py`` compares against.
On CUDA tensors the serving and generation paths go through the
hand-written kernels:

- :func:`attention` -> ``ops/flash_attention.py`` (admission prefill);
- :func:`cache_write_and_attend` -> ``ops/decode_attention.py``'s fused
  ticks, one launch a layer: the K/V slot write, in place (into the paged
  pool, or into generation's dense pair cache; for an int8 cache the write
  quantizes), and the read that follows it (the paged read through the
  block table, with no gathered copy of the cache, or the dense read; each
  also reads the int8 cache with its per-row scales);
- :func:`cache_verify_and_attend` -> ``decode_attention.paged_verify_write``,
  one launch a layer a speculative verify step: a draft window's K/V
  written through the block table and its queries attending the pool and
  the window under the per-query staircase.

Layouts follow the JAX package: ``[batch, heads, seq, head_dim]``.
"""

from __future__ import annotations

import torch

NEG_FILL = -1e30   # finite mask fill: a fully-masked row averages, never NaN


def attention_logits(q, k, *, causal: bool = False, mask=None,
                     scale: float | None = None):
    """The masked f32 logits of :func:`dot_product_attention`: ``q k^T *
    scale``, keys past the bottom-right causal limit at ``-inf``, keys the
    boolean ``mask`` refuses at the finite ``-1e30`` fill."""
    q_len, head_dim = q.shape[-2:]
    kv_len = k.shape[-2]
    scale = head_dim ** -0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        row = torch.arange(q_len, device=q.device)[:, None]
        col = torch.arange(kv_len, device=q.device)[None, :]
        logits = logits.masked_fill(row < col - (kv_len - q_len),
                                    float("-inf"))
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_FILL)
    return logits


def dot_product_attention(q, k, v, *, causal: bool = False, mask=None,
                          scale: float | None = None):
    """Multi-head scaled dot-product attention over ``[b, h, t, d]``
    (reference ``ops/attention.py:21-54``): logits and softmax in f32,
    bottom-right causal alignment ``row >= col - (kv_len - q_len)``
    (excluded keys take no weight), then the boolean ``mask`` (True =
    attend; broadcastable to ``[b, h, q_len, kv_len]``) with the finite
    ``-1e30`` fill. The probabilities are cast to ``q.dtype`` before the
    value product, as the reference does."""
    logits = attention_logits(q, k, causal=causal, mask=mask, scale=scale)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights, v)


def attention(q, k, v, *, causal: bool = False, scale: float | None = None,
              kv_mask=None):
    """The attention dispatcher (reference ``:74-115``), differentiable:
    the flash kernels (forward, and the dQ / dK-dV backward) on CUDA
    tensors, their plain versions on CPU tensors
    (``ops/flash_attention.py::flash_attention`` decides by device).
    ``kv_mask``: optional ``[b, kv_len]`` key validity, nonzero = attend.

    Grouped-query attention (``k``/``v`` with ``hk`` heads, a divisor of
    q's ``H``), as the reference's ``models/transformer.py::
    dispatch_attention`` gives it to its flash and dense engines: K and V
    are repeated to ``H`` heads with ``repeat_interleave(H // hk, dim=1)``,
    so query head ``h`` reads kv head ``h // G`` (``jnp.repeat``; a
    ``repeat``/``tile`` would map it to ``h % hk``). The flash kernels take
    equal head counts, and autograd's backward of the repeat sums dK and dV
    over each group."""
    from distributed_compute_pytorch_tpu_torch.ops.flash_attention import (
        flash_attention)
    H, hk = q.shape[1], k.shape[1]
    if hk != H:
        if H % hk:
            raise ValueError(f"{H} query heads do not group over {hk} kv "
                             f"heads")
        k = k.repeat_interleave(H // hk, dim=1)
        v = v.repeat_interleave(H // hk, dim=1)
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           kv_mask=kv_mask)


def split_heads(x, num_heads: int):
    """``[b, t, d]`` -> ``[b, h, t, d/h]`` (a view)."""
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x):
    """``[b, h, t, hd]`` -> ``[b, t, h*hd]``."""
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _pos_vector(pos, batch: int, device) -> torch.Tensor:
    """A scalar or ``[B]`` position as an int32 ``[B]`` tensor."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return pos.reshape(-1).expand(batch) if pos.ndim == 0 else pos


def _multi_pos_valid_mask(pos, t_max: int):
    """``[B, 1, W, T]`` bool mask for a verify window of queries (reference
    ``:130-143``): query ``w`` of row ``b`` sits at slot ``pos[b, w]`` and
    attends the cache slots at or before it, the per-query form of the
    decode mask (the same at ``W == 1``). Window queries are consecutive
    slots, so this staircase is the causal rule over prefix and window."""
    slots = torch.arange(t_max, device=pos.device)
    return slots[None, None, None, :] <= pos[:, None, :, None]


def _valid_slots(q, pos, t_max: int, slot_mask):
    """The read's slot mask ``[B, 1, q_len, T]`` (or ``[B, 1, 1, T]``):
    per query under a ``[B, q_len]`` ``pos``, else per row; the optional
    ``[B, T]`` ``slot_mask`` (nonzero = keep) on top."""
    if torch.is_tensor(pos) and pos.ndim == 2:
        valid = _multi_pos_valid_mask(pos, t_max)
    else:
        pos = _pos_vector(pos, q.shape[0], q.device)
        slots = torch.arange(t_max, device=q.device)
        valid = slots[None, None, None, :] <= pos[:, None, None, None]
    if slot_mask is not None:
        valid = valid & (slot_mask != 0)[:, None, None, :]
    return valid


def _fold_groups(q, hk: int, pos):
    """GQA's folded query (reference ``:183-201``): ``[B, H, q_len, hd]``
    -> ``[B, hk, G * q_len, hd]``, folded row ``g * q_len + w`` for head
    ``g`` of the group and query ``w``. Several query positions need a
    per-query ``[B, q_len]`` pos."""
    B, H, q_len, hd = q.shape
    if q_len != 1 and not (torch.is_tensor(pos) and pos.ndim == 2):
        raise ValueError("GQA cached attention over several query "
                         "positions needs a per-query [B, q_len] pos")
    return q.reshape(B, hk, (H // hk) * q_len, hd)


def _tile_groups(valid, G: int):
    """The per-query mask ``[B, 1, W, T]`` tiled over the folded group
    rows (``jnp.tile``): folded row ``g * W + w`` takes mask row ``w``."""
    return valid.repeat(1, 1, G, 1) if valid.shape[2] > 1 else valid


def cached_attention(q, k_cache, v_cache, pos, *, scale: float | None = None,
                     slot_mask=None):
    """Decode attention over a dense ``[B, Hk, T, hd]`` cache (reference
    ``:143-204``): ``pos`` a scalar or ``[B]`` (the query at that slot), or
    ``[B, q_len]`` (a verify window: query ``w`` at slot ``pos[b, w]``);
    each query attends the slots at or before its own that the optional
    ``[B, T]`` ``slot_mask`` keeps (nonzero; left-padded prompts mask their
    pad slots), the rest masked with the finite fill. GQA folds the query's
    group into its sequence dim, so the narrow cache is read as is.
    Returns ``[B, H, q_len, hd]``."""
    B, H, q_len, hd = q.shape
    hk, t_max = k_cache.shape[1], k_cache.shape[2]
    grouped = H != hk
    if grouped:
        q = _fold_groups(q, hk, pos)
    valid = _valid_slots(q, pos, t_max, slot_mask)
    if grouped:
        valid = _tile_groups(valid, H // hk)
    out = dot_product_attention(q, k_cache, v_cache, mask=valid, scale=scale)
    return out.reshape(B, H, q_len, hd) if grouped else out


def cached_attention_q8(q, cache, pos, *, scale: float | None = None,
                        slot_mask=None):
    """:func:`cached_attention` over an int8 K/V cache (reference
    ``:219-280``): ``cache`` is ``{"k", "v": int8 [B, Hk, T, hd],
    "k_scale", "v_scale": f32 [B, Hk, T, 1]}``, per-row symmetric scales
    (``utils/quantize.py::quantize_kv``). The scales commute out of both
    contractions: ``score_t = (q . k_t) * scale * k_scale_t`` in f32, and
    ``out = sum_t (p_t * v_scale_t) * v_t``, where ``p * v_scale`` is cast
    to ``q.dtype`` before the value product, as the reference does. Masked
    slots take the finite ``-1e30`` fill. ``pos`` as
    :func:`cached_attention`'s. Returns ``[B, H, q_len, hd]`` in
    ``q.dtype``."""
    B, H, q_len, hd = q.shape
    k_q, v_q = cache["k"], cache["v"]
    hk, t_max = k_q.shape[1], k_q.shape[2]
    grouped = H != hk
    if grouped:
        q = _fold_groups(q, hk, pos)
    sc = hd ** -0.5 if scale is None else scale
    scores = torch.matmul(q.float(), k_q.float().transpose(-1, -2)) * sc
    scores = scores * cache["k_scale"][:, :, None, :, 0]
    valid = _valid_slots(q, pos, t_max, slot_mask)
    if grouped:
        valid = _tile_groups(valid, H // hk)
    probs = torch.softmax(scores.masked_fill(~valid, NEG_FILL), dim=-1)
    pv = (probs * cache["v_scale"][:, :, None, :, 0]).to(q.dtype)
    out = torch.matmul(pv.float(), v_q.float()).to(q.dtype)
    return out.reshape(B, H, q_len, hd) if grouped else out


def gather_kv_blocks(pool_leaf, table):
    """The logical per-row view of a paged pool leaf (reference
    ``:283-310``): ``pool_leaf [s, P, hk, bt, hd]`` through ``table
    [B, nb]`` -> ``[s, B, hk, nb * bt, hd]``; row ``b``'s slot ``t`` is
    ``pool_leaf[:, table[b, t // bt], :, t % bt]``. This copy is what the
    paged decode kernel avoids; it stays as that kernel's plain version."""
    g = pool_leaf[:, table.long()]             # [s, B, nb, hk, bt, hd]
    s, B, nb, hk, bt, hd = g.shape
    return g.permute(0, 1, 3, 2, 4, 5).reshape(s, B, hk, nb * bt, hd)


def cache_write_and_attend(q, k, v, cache, pos, *, slot_mask=None):
    """One decode tick's cache write + attention (reference ``:425-466``),
    for both cache formats, float or int8; the write is IN PLACE, where the
    JAX package donates the buffer. ``q, k, v``: ``[B, H(k), 1, hd]``.
    Returns ``(o [B, H, 1, hd], cache)``.

    - The dense pair cache ``{"kv": [2, B, Hk, T, hd]}`` (generation): a
      scalar ``pos`` (a Python int or a 0-dim int32 tensor: the lockstep
      tick) writes every row's K/V at that slot, a ``[B]`` ``pos`` each
      row at its own (as ``kv_insert`` / ``kv_insert_rows`` write); then
      row ``b`` attends slots ``0..pos[b]`` that ``slot_mask`` (optional
      ``[B, T]``) keeps (as ``decode_attention`` reads).
    - The PAGED pool (serving, reference ``:313-353``): ``{"kv": [2, P,
      hk, bt, hd], "table": int32 [B, nb]}``. Row ``b`` writes its K/V at
      the physical (block, offset) its table maps logical slot ``pos[b]``
      to, then attends its logical slots ``0..pos[b]`` through the table.
      The horizon is the table's, ``nb * bt``; the slot lookup clamps to
      the last table entry, which only parked rows (all-trash tables)
      reach. No ``slot_mask``: serving lays prompts out from slot 0.

    Either format takes the int8 form: ``"kv"`` int8 beside a ``"scale"``
    leaf, f32 ``[..., 1]`` (one scale per cached row). The write quantizes
    the float K/V per row (``utils/quantize.py::quantize_kv``, fused into
    the kernels) and the read is :func:`cached_attention_q8`'s (the decode
    kernels' int8 form), over the quantized row.

    On CUDA tensors each format's write and read are one launch
    (``decode_attention.dense_write_decode`` and ``paged_write_decode``);
    CPU tensors run their plain versions, the write then the read."""
    from distributed_compute_pytorch_tpu_torch.ops import (
        decode_attention as DA)
    sc = cache.get("scale")
    leaves = set(cache) - {"scale"}
    if leaves == {"kv"}:
        return DA.dense_write_decode(q, k, v, cache["kv"], pos,
                                     slot_mask=slot_mask,
                                     kv_scale=sc), cache
    if leaves != {"kv", "table"} or slot_mask is not None:
        raise NotImplementedError(
            f"cache_write_and_attend takes the dense pair cache {{'kv'}} or "
            f"the paged pool {{'kv', 'table'}} (each with an optional int8 "
            f"'scale' leaf) without a slot_mask; got keys {sorted(cache)}, "
            f"slot_mask {'set' if slot_mask is not None else 'None'}")
    pos = _pos_vector(pos, q.shape[0], q.device)
    return DA.paged_write_decode(q, k, v, cache["kv"], cache["table"], pos,
                                 kv_scale=sc), cache


def cache_verify_and_attend(q, k, v, cache, positions):
    """One speculative VERIFY step against the paged pool (reference
    ``:356-430``): all ``W`` window positions of every row written and
    attended in one pass; the write is IN PLACE. ``q, k, v``: ``[B, H(k),
    W, hd]``, window position ``w`` of row ``b`` at logical slot
    ``positions[b, w]`` (int32 ``[B, W]``, consecutive per row). ``cache``:
    ``{"kv": [2, P, hk, bt, hd], "table": int32 [B, nb]}``, with a
    ``"scale"`` leaf beside an int8 ``"kv"``. Returns ``(o [B, H, W, hd],
    cache)``.

    The window's K/V land at the (block, offset) each row's table maps its
    slots to, slots at or past the table's horizon ``nb * bt`` DROPPED (so
    drafted tokens never write past a row's extent; an int8 pool's rows
    quantized with ``quantize_kv``); query ``w`` then attends slots ``<=
    positions[b, w]`` of the gathered view: the prefix and the window's own
    bottom-right triangle, the same keys and masks as ``W`` sequential
    decode ticks. Rejected drafts need no undo: the scheduler rewinds the
    row's position, and the stale K/V past it is never attended. The
    horizon is the table's, so a width-bucketed caller must hand a table
    covering ``max(positions) + 1`` slots.

    On CUDA tensors one launch of ``decode_attention.paged_verify_write``
    (its int8 form with the scale leaf); CPU tensors run its plain
    version, the scatter then the gathered read. No ``slot_mask``: serving
    lays prompts out from slot 0."""
    from distributed_compute_pytorch_tpu_torch.ops import (
        decode_attention as DA)
    if set(cache) - {"scale"} != {"kv", "table"}:
        raise NotImplementedError(
            f"cache_verify_and_attend takes the paged pool {{'kv', "
            f"'table'}} (with an optional int8 'scale' leaf); got keys "
            f"{sorted(cache)}")
    return DA.paged_verify_write(q, k, v, cache["kv"], cache["table"],
                                 positions, kv_scale=cache.get("scale")), \
        cache
