"""BERT (bidirectional encoder, masked-LM objective) — port of
``distributed_compute_pytorch_tpu/models/bert.py`` (BASELINE's rung 3,
BERT-base MLM).

Token and learned-position embeddings (positions N(0, 0.01)) with an
embedding LayerNorm and dropout, post-LN bidirectional blocks (a
``blocks`` ``nn.ModuleList``; the reference stacks them into ``[L, ...]``
leaves, ``interop.py`` unstacks), and the MLM head: a dense layer,
tanh-GELU, LayerNorm and the readout tied to the token table. Defaults
are BERT-base; ``tiny()`` is the test size.

With ``pad_token_id`` set, the blocks' attention refuses the pad keys
(``kv_mask`` from :meth:`BertMLM.padding_mask`): on CUDA the flash kernels
run non-causal under that mask, forward and backward.

The MLM objective is the model's own (:meth:`BertMLM.train_loss`, which
the train step calls where a model has one): 15 % of the real positions
selected, each then ``[MASK]`` (80 %), a random token (10 %) or kept (10
%), the loss the mean cross-entropy over the selected positions. The draw
(:meth:`BertMLM.draw_masks`, from the step's ``torch.Generator``; under a
process group the global batch's draw, this rank's rows kept) is split
from the pure :meth:`BertMLM.mask_inputs` and :meth:`BertMLM.mlm_loss`,
so the tests feed the JAX package's draw to the pure half.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from distributed_compute_pytorch_tpu_torch.core import mesh
from distributed_compute_pytorch_tpu_torch.device import resolve_device
from distributed_compute_pytorch_tpu_torch.models import layers as L
from distributed_compute_pytorch_tpu_torch.models.transformer import (
    TransformerBlock)


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_seq_len: int = 512
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    dropout_rate: float = 0.1
    mask_rate: float = 0.15
    mask_token_id: int = 103       # [MASK] in the WordPiece vocab
    # the token id of padding ([PAD] = 0 in the WordPiece vocab): its
    # positions are refused as attention keys and never selected for the
    # MLM loss. None: fixed-length data, no mask.
    pad_token_id: int | None = None

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "BertConfig":
        """The reference's test size (``bert.py:62-65``)."""
        return cls(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=4,
                   d_model=64, d_ff=128, dropout_rate=0.0, mask_token_id=1)


class BertMLM(nn.Module):
    """Built on CUDA unless ``device="cpu"`` (``RuntimeError`` when CUDA
    is absent and the CPU was not asked for); parameters start at zero
    until :meth:`init` or a weight load."""

    def __init__(self, config: BertConfig = BertConfig(), *, device=None,
                 dtype=torch.float32):
        super().__init__()
        c = self.config = config
        if not 0 <= c.mask_token_id < c.vocab_size:
            raise ValueError(f"mask_token_id {c.mask_token_id} is outside "
                             f"the vocab of {c.vocab_size}")
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.wte = L.Embedding(c.vocab_size, c.d_model, **kw)
        self.wpe = L.Embedding(c.max_seq_len, c.d_model, init_std=0.01, **kw)
        self.emb_ln = L.LayerNorm(c.d_model, **kw)
        self.blocks = nn.ModuleList(
            TransformerBlock(c.d_model, c.num_heads, c.d_ff,
                             dropout_rate=c.dropout_rate, causal=False,
                             pre_ln=False, **kw)
            for _ in range(c.num_layers))
        self.mlm_dense = L.Dense(c.d_model, c.d_model, **kw)
        self.mlm_ln = L.LayerNorm(c.d_model, **kw)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def init(self, generator: torch.Generator) -> "BertMLM":
        """Random weights from ``generator`` (a CPU ``torch.Generator``)
        with the reference's distributions; returns ``self``."""
        for layer in (self.wte, self.wpe, self.emb_ln, *self.blocks,
                      self.mlm_dense, self.mlm_ln):
            layer.init(generator)
        return self

    def padding_mask(self, tokens):
        """``[B, T]`` f32 key validity (1 = a real token), or ``None`` when
        the config has no ``pad_token_id`` (reference ``:94-100``)."""
        pad = self.config.pad_token_id
        return None if pad is None else (tokens != pad).float()

    def forward(self, tokens, *, train: bool = False, generator=None,
                kv_mask=None):
        """``tokens [B, T]`` -> MLM logits ``[B, T, vocab]`` (reference
        ``apply``, ``:102-148``). ``kv_mask`` overrides the mask
        :meth:`padding_mask` derives from ``tokens``; ``train`` with a
        ``generator`` applies dropout."""
        c = self.config
        if kv_mask is None:
            kv_mask = self.padding_mask(tokens)
        t = tokens.shape[1]
        x = self.wte(tokens) + self.wpe(torch.arange(t, device=tokens.device))
        x = self.emb_ln(x)
        train = train and generator is not None
        x = L.dropout(x, c.dropout_rate, generator, train)
        for block in self.blocks:
            x = block(x, train=train, generator=generator, kv_mask=kv_mask)
        h = F.gelu(self.mlm_dense(x), approximate="tanh")
        return self.wte.attend(self.mlm_ln(h))

    # --- the MLM objective ---

    def mask_inputs(self, tokens, selected, kind, random_tok):
        """The reference's ``_mask_inputs`` (``:150-162``) on given draws:
        ``selected`` (bool ``[B, T]``, before the pad positions are taken
        out), ``kind`` (uniform ``[B, T]``) and ``random_tok`` (ids ``[B,
        T]``). Returns ``(inputs, selected)``: the selected real positions
        ``[MASK]`` where ``kind < 0.8``, ``random_tok`` where ``kind <
        0.9``, else kept."""
        c = self.config
        pm = self.padding_mask(tokens)
        if pm is not None:
            selected = selected & (pm > 0.5)
        masked = torch.where(kind < 0.8, c.mask_token_id,
                             torch.where(kind < 0.9, random_tok, tokens))
        return torch.where(selected, masked, tokens), selected

    def draw_masks(self, tokens, generator):
        """:meth:`mask_inputs` on draws from ``generator`` (on the tokens'
        device): selection at ``mask_rate``, the kind, the random ids, in
        that order, each for the global batch under a process group, this
        rank's rows kept."""
        b, t = tokens.shape
        world, r = mesh.process_count(), mesh.process_index()
        shape, dev = (b * world, t), tokens.device

        def rows(x):
            return x[r * b:(r + 1) * b]
        sel = rows(torch.rand(shape, generator=generator, device=dev)
                   < self.config.mask_rate)
        kind = rows(torch.rand(shape, generator=generator, device=dev))
        rand = rows(torch.randint(0, self.config.vocab_size, shape,
                                  generator=generator, device=dev))
        return self.mask_inputs(tokens, sel, kind, rand)

    def mlm_loss(self, inputs, selected, tokens, kv_mask, *,
                 train: bool = True, generator=None):
        """The cross-entropy of ``tokens`` at the ``selected`` positions of
        the forward on ``inputs`` under ``kv_mask``, over ``max(selected
        count, 1)``, on the device (reference ``train_loss``,
        ``:164-180``, after the draw). Under a process group the count is
        the global batch's (one all-reduce) and the loss is scaled by the
        world size, so the step's mean over the ranks is the global
        batch's loss, as the reference's one SPMD program computes it."""
        logits = self(inputs, train=train, generator=generator,
                      kv_mask=kv_mask)
        per_tok = L.cross_entropy_with_logits(logits, tokens, "none")
        total = (per_tok * selected).sum()
        n_sel = selected.sum()
        if mesh.distributed():
            dist.all_reduce(n_sel)
            total = total * mesh.process_count()
        return total / n_sel.clamp(min=1)

    def train_loss(self, tokens, targets, *, generator):
        """The train step's loss: masks drawn from ``generator``, then
        :meth:`mlm_loss`; the key mask comes from the ORIGINAL tokens, so
        ``[MASK]``-ing a position never changes whether it is attended.
        Returns ``(loss, {})`` (no model state)."""
        del targets   # the MLM targets are the tokens themselves
        kv_mask = self.padding_mask(tokens)
        inputs, selected = self.draw_masks(tokens, generator)
        return self.mlm_loss(inputs, selected, tokens, kv_mask,
                             generator=generator), {}

    def eval_metrics(self, logits, tokens, valid=None):
        """Every real position scored, no masking (reference ``:182-189``):
        ``loss_sum``, ``correct`` and ``count``; ``valid`` weights whole
        sequences, pad positions weigh nothing."""
        per_tok = L.cross_entropy_with_logits(logits, tokens, "none")
        return L.token_eval_metrics(per_tok, logits.argmax(-1) == tokens,
                                    valid,
                                    token_mask=self.padding_mask(tokens))
