"""Speculative-decoding proposers and configuration — the port's own copy
of ``distributed_compute_pytorch_tpu/spec_decode.py`` (the port imports
nothing of the JAX package).

Decode streams every weight once a tick to emit one token a row.
Speculation verifies ``k`` DRAFTED tokens a weight stream instead: the
blocks' ``verify_step`` scores a whole draft window in one forward pass
(``models/{transformer,llama}.py``, ``ops/attention.py::
cache_verify_and_attend``), and ``serve.ContinuousBatcher`` applies an
EXACT accept/reject rule, so the output never depends on draft quality.
This module is the host-side half: where drafts come from.

- :class:`NGramProposer` (the default): self-drafting by suffix lookup over
  the row's own history (prompt + generated). When the recent suffix has
  occurred before, propose its historical continuation: no second model,
  and strong exactly where speculation pays (templated or quoted text,
  code, lists).
- :class:`DraftModelProposer`: greedy continuations of a small draft model
  through the port's ``infer.generate`` over a fixed context window.

Any object with ``propose(context: list[int], k: int) -> list[int]`` is a
proposer (``SpecConfig.proposer`` duck-types); tests use this to force
rejections.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class SpecConfig:
    """Speculation settings for ``serve.ContinuousBatcher(speculate=...)``.

    ``k``: drafted tokens a verify step; each step scores ``k + 1``
    positions (the row's current token and its ``k`` drafts) in one
    forward pass and emits 1 to ``k + 1`` tokens.

    ``proposer``: ``"ngram"`` (self-drafting, default), ``"draft"``
    (needs ``draft_model``; ``draft_params``, a state dict, is loaded into
    it first when given), or any object with a ``propose(context, k)``
    method.

    Auto-disable: a verify step streams the weights once, as a plain tick
    does, but scores ``k + 1`` positions, so drafts that are not accepted
    are pure waste. Over each window of ``autodisable_window`` proposed
    tokens, an acceptance rate below ``autodisable_below`` flips the
    batcher back to plain segments for the rest of its life (sticky until
    ``reset()``); outputs are the same either way.
    """

    k: int = 4
    proposer: Any = "ngram"
    ngram_max: int = 4
    ngram_min: int = 1
    draft_model: Any = None
    draft_params: Any = None
    draft_window: int = 32
    autodisable_window: int = 64
    autodisable_below: float = 0.10

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculate k must be >= 1, got {self.k}")
        if self.ngram_min < 1 or self.ngram_max < self.ngram_min:
            raise ValueError("need 1 <= ngram_min <= ngram_max")


class NGramProposer:
    """Self-drafting by longest-suffix n-gram lookup: for the history
    ``ctx``, the most recent earlier occurrence of the longest matching
    suffix (``ngram_max`` tokens down to ``ngram_min``) proposes the ``k``
    tokens that followed it; no match proposes the last token ``k``
    times."""

    def __init__(self, ngram_max: int = 4, ngram_min: int = 1):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError("need 1 <= ngram_min <= ngram_max")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    def propose(self, context: list[int], k: int) -> list[int]:
        n_ctx = len(context)
        for n in range(min(self.ngram_max, n_ctx - 1), self.ngram_min - 1,
                       -1):
            pat = context[-n:]
            # the most recent earlier occurrence wins
            for s in range(n_ctx - n - 1, -1, -1):
                if context[s:s + n] == pat:
                    cont = context[s + n:s + n + k]
                    if cont:
                        # a short continuation repeats its tail: extra
                        # columns are verified like any other draft
                        while len(cont) < k:
                            cont.append(cont[-1])
                        return cont
        # nothing recurs: repeating the last token costs nothing to verify
        return [context[-1]] * k if context else [0] * k


class DraftModelProposer:
    """Drafts from a small model's greedy continuation, through the port's
    ``infer.make_generate_fn`` over a FIXED context window (left-padded by
    repeating its first token), so every row and request shares one
    generate function a ``k``. ``params``: a state dict loaded into
    ``model`` first (``None``: its current weights). The draft model's
    quality moves only the acceptance rate, never the output."""

    def __init__(self, model, params=None, window: int = 32):
        if params is not None:
            model.load_state_dict(params)
        self.model = model
        self.window = int(window)
        self._gen = None
        self._gen_k = None

    def propose(self, context: list[int], k: int) -> list[int]:
        import torch

        from distributed_compute_pytorch_tpu_torch import infer
        ctx = list(context[-self.window:])
        if not ctx:
            return [0] * k
        ctx = [ctx[0]] * (self.window - len(ctx)) + ctx
        if self._gen is None or self._gen_k != k:
            self._gen = infer.make_generate_fn(self.model, k)
            self._gen_k = k
        toks = self._gen(torch.tensor([ctx], dtype=torch.long,
                                      device=self.model.device))
        return [int(t) for t in toks[0, self.window:self.window + k]]


def make_proposer(cfg: SpecConfig):
    """Resolve ``cfg.proposer`` to an object with ``propose(ctx, k)``."""
    if cfg.proposer == "ngram":
        return NGramProposer(cfg.ngram_max, cfg.ngram_min)
    if cfg.proposer == "draft":
        if cfg.draft_model is None:
            raise ValueError("proposer='draft' needs draft_model")
        return DraftModelProposer(cfg.draft_model, cfg.draft_params,
                                  cfg.draft_window)
    if hasattr(cfg.proposer, "propose"):
        return cfg.proposer
    raise ValueError(f"unknown proposer {cfg.proposer!r}")
