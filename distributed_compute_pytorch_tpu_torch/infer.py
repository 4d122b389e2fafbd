"""One-shot KV-cache generation for GPT-2 — the port of
``distributed_compute_pytorch_tpu/infer.py`` (``prefill``, ``_sample``,
``make_generate_fn``, ``generate``).

- **Prefill** runs the blocks' full-sequence forward over the prompt (the
  ``flash_fwd`` kernel on the card, with the prompt mask), capturing each
  layer's K/V into a fresh dense KV-pair cache ``{"kv": [2, B, Hk, t_max,
  hd]}`` in the model's dtype.
- **Decode** is ``max_new_tokens - 1`` ticks (the reference's
  ``lax.scan``). Each tick embeds one token per row, runs every block's
  ``decode_step`` — the lockstep K/V write at the one slot ``pos`` and the
  dense read of slots ``0..pos``, in place on the cache and one launch on
  the card (the fused ``dense_decode_write``) — samples the next token,
  writes it into its column of the output and advances ``pos``. A tick
  reads and writes static device buffers made before the first tick: the
  caches, a 0-dim int32 ``pos``, the current token, the eos flags and the
  ``[B, max_new_tokens]`` output. On CUDA a greedy call runs its first tick
  eagerly (the capture's warm-up: kernels loaded, the decode reads' merge
  scratch sized), captures the tick as a CUDA graph (``utils/graphs.py``)
  and replays it for every other tick: one ``cudaGraphLaunch`` a tick. A
  sampled tick draws from the caller's ``torch.Generator`` and stays eager.
  On the CPU every tick runs eagerly. Nothing waits for the device until
  the tokens return.

Left-padded prompt batches (``prompt_mask``, 1 = real token) decode each
row as it would alone: pad slots are masked out of the prefill
(``kv_mask``) and out of every tick's read (``slot_mask``), and each row
embeds its own logical positions ``max(slot - pad_count, 0)``.

Differences from the reference: the model holds its weights (an
``nn.Module``: no ``params`` argument); randomness is a ``torch.Generator``
on the model's device, which cannot draw ``jax.random``'s bits, so sampled
streams are held to invariants (the same generator seed gives the same
tokens; no draw lands on a filtered logit) while greedy decoding and the
top-k / nucleus masking (:func:`_filter_logits`) are held to the reference
exactly; the TPU's slot-window alignment of ``t_max`` (8 slots, 32 for
int8) does not carry over (it changes nothing a caller sees). Sharded
generation (``mesh``) raises ``NotImplementedError``.

``kv_quant=True`` keeps the cache in int8 with one f32 scale per (row,
head, slot) (``{"kv": int8, "scale": f32 [2, B, Hk, t_max, 1]}``, about
half the bytes): the prefill quantizes the prompt's K/V once
(``utils/quantize.py::quantize_kv``), each tick's write quantizes as it
lands and the read takes the int8 rows and their scales (one launch, the
fused ``dense_decode_write_q8``). The prefill's own attention stays
float, so the first token is the float cache's.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_compute_pytorch_tpu_torch.ops.decode_attention import (
    merge_scratch)
from distributed_compute_pytorch_tpu_torch.utils.graphs import capture
from distributed_compute_pytorch_tpu_torch.utils.quantize import quantize_kv


def prefill(model, prompt, t_max: int, prompt_mask=None,
            kv_quant: bool = False):
    """Run the prompt ``[B, T0]`` through the blocks, filling fresh decode
    caches (reference ``:108-170``). ``prompt_mask`` (``[B, T0]``, 1 =
    real) supports LEFT-padded prompts: pad slots are excluded from
    attention and every row embeds its own logical positions. With left
    padding the last slot is every row's last real token, so the returned
    logits are valid for all rows.

    Returns ``(last_logits [B, vocab], caches)``: one ``{"kv": [2, B, Hk,
    t_max, hd]}`` per layer, the prompt's K/V at slots ``0..T0-1``, zeros
    after. ``kv_quant`` stores the int8 form instead, ``{"kv": int8,
    "scale": f32 [2, B, Hk, t_max, 1]}`` (reference ``:152-163``)."""
    B, T0 = prompt.shape
    if T0 > t_max:
        raise ValueError(f"prompt length {T0} exceeds t_max={t_max}")
    hk, hd = model.kv_cache_spec()
    positions = None
    if prompt_mask is not None:
        pad_count = T0 - prompt_mask.to(torch.int64).sum(1)
        positions = (torch.arange(T0, device=prompt.device)[None, :]
                     - pad_count[:, None]).clamp(min=0)
    x = model.embed(prompt, positions)
    caches = []
    for block in model.blocks:
        sink: list = []
        x = block(x, kv_mask=prompt_mask, kv_sink=sink)
        (k, v), = sink
        if kv_quant:
            kv = x.new_zeros(2, B, hk, t_max, hd, dtype=torch.int8)
            sc = x.new_zeros(2, B, hk, t_max, 1, dtype=torch.float32)
            for i, a in enumerate((k, v)):
                kv[i, :, :, :T0], sc[i, :, :, :T0] = quantize_kv(a)
            caches.append({"kv": kv, "scale": sc})
            continue
        kv = x.new_zeros(2, B, hk, t_max, hd)
        kv[0, :, :, :T0] = k
        kv[1, :, :, :T0] = v
        caches.append({"kv": kv})
    return model.readout(x)[:, -1], caches


def _filter_logits(logits, top_k: int | None = None,
                   top_p: float | None = None):
    """The reference's truncation (``:180-193``), masking with ``-inf``:
    first every logit below the ``top_k``-th highest, then every logit below
    the cutoff of the smallest sorted prefix whose probability mass reaches
    ``top_p`` (the highest token always stays: shifted cumsum)."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True) - 1
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _sample(logits, temperature: float, generator=None,
            top_k: int | None = None, top_p: float | None = None):
    """Greedy at ``temperature=0``; else softmax sampling of ``logits /
    temperature`` after :func:`_filter_logits`, drawn from ``generator``
    by the Gumbel-max rule (``argmax(logits + Gumbel noise)``, one draw per
    logit): a masked logit stays ``-inf`` and is never drawn, and nothing
    waits for the device. Returns int64 ``[B]`` tokens."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _filter_logits(logits.float() / temperature, top_k, top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a 32-bit
    constant, with the product split at 16 bits so nothing overflows 64."""
    return (((((x >> 16) * c) & 0xFFFF) << 16) + (x & 0xFFFF) * c) & _M32


def _fmix32(h):
    """murmur3's 32-bit finalizer over int64 values in ``[0, 2**32)``: a
    bijection whose every input bit reaches every output bit."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def row_hash(seeds, positions, vocab: int):
    """The counter-based hash behind serving's per-row draws: int64
    ``[B, vocab]`` values in ``[0, 2**32)``, a function of (row seed,
    logical position, vocab index) alone. ``seeds``, ``positions``: int64
    ``[B]`` on one device. Integer tensor ops only, so a captured segment
    replays it with no generator."""
    h = _fmix32((seeds & _M32) ^ 0x9E3779B9)
    h = _fmix32(h ^ (positions & _M32))
    v = _fmix32(torch.arange(vocab, device=seeds.device))
    return _fmix32(h[:, None] ^ v[None, :])


def row_uniforms(seeds, positions, vocab: int):
    """f64 uniforms ``(k + 0.5) / 2**24`` in ``(0, 1)`` from the top 24
    bits ``k`` of :func:`row_hash` (exact in f64, never 0 or 1, so the
    Gumbel noise ``-log(-log(u))`` is finite)."""
    k = row_hash(seeds, positions, vocab) >> 8
    return (k.double() + 0.5) / 2.0 ** 24


def filter_rows(logits, temperature, top_k, top_p):
    """The per-row truncation of :func:`sample_rows` (reference
    ``sample_rows``, ``:197-235``): ``logits [B, V]`` in f32 over each
    row's temperature (floored at 1e-6), every logit below the row's
    ``top_k``-th sorted value at ``-inf`` (``top_k`` 0: none), then every
    logit below the cutoff of the smallest sorted prefix of the top-k-masked
    distribution whose mass reaches ``top_p`` (the highest token always
    stays: shifted cumsum; ``top_p`` >= 1: none). Cutoffs are gathered at
    traced indices: static shapes, no host sync."""
    V = logits.shape[-1]
    lg = logits.float() / temperature.clamp(min=1e-6)[:, None]
    desc = torch.sort(lg, dim=-1, descending=True).values
    kth = desc.gather(-1, (top_k - 1).clamp(0, V - 1)[:, None])
    lg = lg.masked_fill((top_k > 0)[:, None] & (lg < kth), float("-inf"))
    desc = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs
    cut = ((cum < top_p[:, None]).sum(-1, keepdim=True) - 1).clamp(0, V - 1)
    cutoff = desc.gather(-1, cut)
    return lg.masked_fill((top_p < 1.0)[:, None] & (lg < cutoff),
                          float("-inf"))


def sample_rows(logits, temperature, top_k, top_p, seeds, positions):
    """Per-row sampling inside one program (reference ``infer.sample_rows``,
    the serving segment's draw): every knob is a ``[B]`` tensor —
    ``temperature`` (0 = greedy for that row), ``top_k`` (int64, 0 =
    none), ``top_p`` (>= 1 = none) — and each row draws by the Gumbel-max
    rule over :func:`filter_rows`'s masked logits with the noise of
    :func:`row_uniforms` at (its ``seeds``, its logical ``positions``), so
    a row's t-th draw depends only on (seed, tokens so far): the same
    whatever the slots, segment, prefix attach or chunking. Greedy rows
    take the plain ``argmax``, so a greedy request keeps its standalone
    tokens beside sampling rows. Returns int64 ``[B]`` tokens."""
    greedy = torch.argmax(logits, dim=-1)
    lg = filter_rows(logits, temperature, top_k, top_p)
    u = row_uniforms(seeds, positions, logits.shape[-1])
    gumbel = (-torch.log(-torch.log(u))).float()
    sampled = torch.argmax(lg + gumbel, dim=-1)
    return torch.where(temperature == 0.0, greedy, sampled)


def verify_sample_rows(logits, temperature, top_k, top_p, seeds, n_logical):
    """:func:`sample_rows` over a speculative verify window (reference
    ``:241-256``): ``logits [B, W, V]`` -> int64 ``[B, W]``, column ``i``
    drawn at logical position ``n_logical + i`` with the row's seed. That
    key is exactly the one plain decode draws with after emitting ``i``
    window tokens, so column ``i`` is the token plain decode would sample
    there: at the first draft mismatch it IS the deterministic rejection
    resample, the whole exactness argument of the accept rule."""
    return torch.stack([sample_rows(logits[:, i], temperature, top_k, top_p,
                                    seeds, n_logical + i)
                        for i in range(logits.shape[1])], dim=1)


def _check_prompt_mask(m: np.ndarray, shape) -> None:
    if m.shape != tuple(shape):
        raise ValueError(f"prompt_mask shape {m.shape} != prompt shape "
                         f"{tuple(shape)}")
    if not ((m == 0) | (m == 1)).all():
        # fractional values would split: pad_count counts them as pads
        # while the attention masks attend them
        raise ValueError("prompt_mask must be binary (0/1)")
    if not (m[:, 1:] >= m[:, :-1]).all():
        # generation appends at the END, so right-padded rows would
        # interleave pads into the decoded sequence
        raise ValueError("prompt_mask must be LEFT-padded (zeros before "
                         "ones in every row)")
    if not (m[:, -1] == 1).all():
        raise ValueError("prompt_mask has fully-padded rows (or trailing "
                         "pads); every row needs at least its final slot "
                         "real")


def make_generate_fn(model, max_new_tokens: int, *, t_max: int | None = None,
                     temperature: float = 0.0, eos_id: int | None = None,
                     top_k: int | None = None, top_p: float | None = None,
                     mesh=None, kv_quant: bool = False,
                     _eager: bool = False):
    """Build ``generate(prompt [B, T0], generator=None, prompt_mask=None)
    -> tokens [B, T0 + max_new_tokens]`` for ``model`` (reference
    ``:260-459``), with the reference's checks and messages.

    ``t_max`` caps the cache length (default ``T0 + max_new_tokens``).
    ``eos_id``: rows that emit this token keep emitting it for the rest of
    the fixed-shape output (callers trim at the first eos). ``generator``:
    a ``torch.Generator`` on the model's device (default: seed 0), used
    only when ``temperature > 0``. ``kv_quant``: the int8 KV cache (see
    :func:`prefill`). ``_eager``: decode every tick eagerly on the card too
    (the reference the card's checks hold the captured tick to).

    The returned function keeps its last call's graph in ``stats``:
    ``{"graph_captures", "graph_replays", "capture_ms"}`` (0, 0, ``None``
    for an eager call; ``stats`` is set by the first call)."""
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if mesh is not None:
        raise NotImplementedError("sharded generation (mesh=) is not ported "
                                  "yet (ROADMAP.md queue 1.7.3)")
    vocab = model.config.vocab_size
    if top_k is not None and not 1 <= top_k <= vocab:
        raise ValueError(f"top_k must be in [1, vocab={vocab}], got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        # top_p <= 0 would underflow the nucleus cutoff index and sample
        # the FULL vocabulary — the opposite of most-restrictive
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature < 0.0:
        # a negative temperature inverts the distribution
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature == 0.0 and (top_k is not None or top_p is not None):
        # greedy ignores truncation: returning greedy output would mislead
        # a caller who believes they sampled
        raise ValueError("top_k/top_p require temperature > 0 "
                         "(temperature 0 is greedy)")

    def generate(prompt, generator=None, prompt_mask=None):
        dev = model.device
        prompt = torch.as_tensor(prompt, device=dev).long()
        B, T0 = prompt.shape
        final = T0 + max_new_tokens
        tm = t_max or final
        if final > tm:
            raise ValueError(f"t_max={tm} can't hold prompt {T0} + "
                             f"{max_new_tokens} new tokens")
        cap = model.config.max_seq_len
        if final > cap:
            # past this the position table would be indexed out of range
            raise ValueError(f"prompt ({T0}) + {max_new_tokens} new tokens "
                             f"exceeds the model's max_seq_len={cap}")
        if prompt_mask is not None:
            _check_prompt_mask(np.asarray(torch.as_tensor(prompt_mask).cpu()),
                               prompt.shape)
            prompt_mask = torch.as_tensor(prompt_mask, device=dev)
        generate.stats = {"graph_captures": 0, "graph_replays": 0,
                          "capture_ms": None}
        if max_new_tokens == 0:
            return prompt
        if generator is None and temperature > 0.0:
            generator = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            return _decode(prompt, tm, generator, prompt_mask)

    def _decode(prompt, tm, generator, prompt_mask):
        B, T0 = prompt.shape
        dev = prompt.device
        last_logits, caches = prefill(model, prompt, tm, prompt_mask,
                                      kv_quant=kv_quant)
        slot_mask = pad_count = None
        if prompt_mask is not None:
            pad_count = T0 - prompt_mask.to(torch.int64).sum(1)
            slot_mask = torch.cat(
                [prompt_mask != 0,
                 torch.ones(B, tm - T0, dtype=torch.bool, device=dev)], dim=1)
        # the tick's static buffers: the current token, the eos flags, the
        # output columns, and the slot the tick writes (T0 + i at tick i),
        # which the tick itself advances
        tok = _sample(last_logits, temperature, generator, top_k, top_p)
        done = None if eos_id is None else tok == eos_id
        out = torch.empty(B, max_new_tokens, dtype=torch.long, device=dev)
        out[:, 0] = tok
        pos = torch.full((), T0, dtype=torch.int32, device=dev)
        scratch: dict = {}

        def tick():
            # each row's LOGICAL position: left pads shift it down
            positions = (pos.reshape(1, 1) if pad_count is None
                         else (pos - pad_count)[:, None])
            x = model.embed(tok[:, None], positions)
            with merge_scratch(scratch):
                for block, cache in zip(model.blocks, caches):
                    x, _ = block.decode_step(x, cache, pos,
                                             slot_mask=slot_mask)
            nxt = _sample(model.readout(x)[:, -1], temperature, generator,
                          top_k, top_p)
            if done is not None:
                # finished rows keep emitting eos (callers trim at eos)
                nxt = torch.where(done, eos_id, nxt)
                done.logical_or_(nxt == eos_id)
            tok.copy_(nxt)
            out.index_copy_(1, (pos - (T0 - 1)).long().reshape(1),
                            nxt[:, None])
            pos.add_(1)

        ticks = max_new_tokens - 1
        graphed = (dev.type == "cuda" and not _eager and temperature == 0.0
                   and ticks > 1)
        program = None
        for _ in range(ticks):
            if program is not None:
                program.replay()
                continue
            tick()
            if graphed:
                program = capture(tick)
        if program is not None:
            generate.stats = {"graph_captures": 1,
                              "graph_replays": program.replays,
                              "capture_ms": program.capture_ms}
        return torch.cat([prompt, out], dim=1)

    return generate


def generate(model, prompt, max_new_tokens: int, *, t_max: int | None = None,
             temperature: float = 0.0, generator=None, prompt_mask=None,
             eos_id: int | None = None, top_k: int | None = None,
             top_p: float | None = None, mesh=None, kv_quant: bool = False):
    """One-shot generation (reference ``:475-492``): ``prompt [B, T0]``
    (token ids) -> ``[B, T0 + max_new_tokens]`` int64 tokens on the model's
    device. ``prompt_mask`` (``[B, T0]``, 1 = real) enables LEFT-padded
    variable-length prompt batches; ``eos_id`` stops rows at that token
    (they pad the fixed-shape tail with it); ``kv_quant`` keeps the KV
    cache in int8. See :func:`make_generate_fn`. Each call fills fresh
    caches."""
    return make_generate_fn(model, max_new_tokens, t_max=t_max,
                            temperature=temperature, eos_id=eos_id,
                            top_k=top_k, top_p=top_p, mesh=mesh,
                            kv_quant=kv_quant)(
        prompt, generator=generator, prompt_mask=prompt_mask)
