"""The port's per-row sampling in serving, on the CPU in f32.

The port draws with a counter-based hash of (request seed, logical
position, vocab index) where the JAX package folds (seed, tokens so far)
into a ``jax.random`` key, so sampled streams cannot be held to JAX's
bits. What can be held:

- the hash against an independent numpy version (uint32 arithmetic), and
  its uniforms inside ``(0, 1)``;
- ``infer.filter_rows``'s ``-inf`` set against ``infer._filter_logits``
  (the reference's masking, held exactly in ``test_torch_generate.py``)
  row by row for mixed per-row settings;
- rows with ``top_k=1`` and a temperature above 0 beside greedy rows give
  the JAX batcher's tokens exactly (their draw is the argmax);
- the invariants of the reference's own tests (``tests/test_serve.py``
  ``:438-687``, ``test_serve_prefill.py``): the same seeds give the same
  tokens and other seeds other tokens; tokens do not change with
  ``slots``, ``segment``, the prefix cache or chunked prefill; greedy rows
  keep their tokens beside sampled rows; no sampled token lies outside its
  row's top-k/top-p set, recomputed from teacher-forced logits;
- the two segment programs (greedy, sampled) each run eagerly once and
  are then captured, on a stand-in graph;
- ``dcp-serve`` with the new flags prints the JAX CLI's lines, attached
  prefix lengths included.
"""

import contextlib
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.serve import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest)
from distributed_compute_pytorch_tpu_torch import infer, interop
from distributed_compute_pytorch_tpu_torch import serve as serve_mod
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.models.llama import (
    LlamaConfig, LlamaLM)
from distributed_compute_pytorch_tpu_torch.serve import (
    ContinuousBatcher, Request)
from distributed_compute_pytorch_tpu_torch.utils import graphs

COMMON = dict(slots=2, t_max=64, prompt_buf=24, segment=3,
              kv_block_tokens=8)


@pytest.fixture(scope="module")
def models():
    """JAX GPT-2-tiny (positions lifted to 128) and the port's copy of its
    weights; a port Llama-tiny with random weights."""
    jm = JaxGPT2(dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=128))
    params, _ = jm.init(jax.random.key(0))
    tm = interop.load_gpt2_params(
        GPT2(dataclasses.replace(GPT2Config.tiny(), max_seq_len=128),
             device="cpu"), jax.tree.map(np.asarray, params))
    llama = LlamaLM(dataclasses.replace(LlamaConfig.tiny(), max_seq_len=128),
                    device="cpu").init(torch.Generator().manual_seed(3))
    return jm, params, tm, llama


def _requests(seed, n, sampled=True, shared=0):
    """``n`` requests of 2-10 prompt tokens (after ``shared`` common
    ones) and 6-10 new tokens; with ``sampled`` they cycle through four
    sampling settings, each with its own seed."""
    rng = np.random.default_rng(seed)
    head = [int(t) for t in rng.integers(0, 256, shared)]
    out = []
    for i in range(n):
        r = Request(head + [int(t) for t in rng.integers(
            0, 256, int(rng.integers(2, 11)))], int(rng.integers(6, 11)))
        if sampled:
            r.temperature = 0.9
            r.top_k = [None, 20, None, 50][i % 4]
            r.top_p = [None, None, 0.9, 0.8][i % 4]
            r.seed = 100 + i
        out.append(r)
    return out


def _clone(reqs):
    return [dataclasses.replace(r, tokens=list(r.tokens)) for r in reqs]


def _serve(model, reqs, **kw):
    cb = ContinuousBatcher(model, device="cpu", **{**COMMON, **kw})
    return cb.serve(_clone(reqs)), cb


# ---------------------------------------------------------------- the draw


def _fmix32_np(h):
    """murmur3's finalizer in native uint32 arithmetic (wrapping)."""
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _row_hash_np(seeds, positions, vocab):
    with np.errstate(over="ignore"):
        h = _fmix32_np((seeds & 0xFFFFFFFF).astype(np.uint32)
                       ^ np.uint32(0x9E3779B9))
        h = _fmix32_np(h ^ positions.astype(np.uint32))
        v = _fmix32_np(np.arange(vocab, dtype=np.uint32))
        return _fmix32_np(h[:, None] ^ v[None, :])


def test_row_hash_equals_its_numpy_version():
    seeds = np.array([0, 1, 7, 2**31 - 1, 2**32 - 1, 2**40 + 5, 123456789])
    positions = np.array([0, 1, 1, 500, 2047, 9, 100000])
    got = infer.row_hash(torch.from_numpy(seeds), torch.from_numpy(
        positions), 1000).numpy()
    want = _row_hash_np(seeds, positions, 1000)
    np.testing.assert_array_equal(got, want.astype(np.int64))
    u = infer.row_uniforms(torch.from_numpy(seeds),
                           torch.from_numpy(positions), 1000).numpy()
    np.testing.assert_array_equal(u, ((want >> 8).astype(np.float64) + 0.5)
                                  / 2.0 ** 24)
    assert 0.0 < u.min() and u.max() < 1.0
    assert np.isfinite(-np.log(-np.log(u))).all()
    # a row's stream is its own: one seed or position apart, other bits
    assert (got[1] != got[2]).mean() > 0.99
    assert (got[0] != got[1]).mean() > 0.99


def test_filter_rows_masks_as_filter_logits_row_by_row():
    """Mixed per-row settings in one call: each row's ``-inf`` set is the
    one ``_filter_logits`` gives that row's settings alone."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(10, 256, generator=g) * 3
    temp = torch.tensor([0.3, 0.7, 1.0, 1.5, 0.9, 0.9, 0.5, 1.2, 2.0, 0.8])
    top_k = [None, 1, 20, 256, None, 50, 7, None, 3, 100]
    top_p = [0.9, None, None, 0.5, 0.8, 0.95, 0.3, None, 0.99, 0.6]
    masked = infer.filter_rows(
        logits, temp, torch.tensor([k or 0 for k in top_k]),
        torch.tensor([2.0 if p is None else p for p in top_p]))
    for b in range(10):
        want = infer._filter_logits(logits[b:b + 1] / temp[b], top_k[b],
                                    top_p[b])[0]
        np.testing.assert_array_equal(masked[b].isinf().numpy(),
                                      want.isinf().numpy())


def test_sample_rows_greedy_rows_and_top_k_one():
    """Greedy rows take the argmax and ``top_k=1`` rows draw it; others
    draw inside their set, the same draw for the same (seed, position)."""
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(6, 300, generator=g)
    temp = torch.tensor([0.0, 0.8, 0.8, 1.0, 0.0, 1.3])
    top_k = torch.tensor([0, 1, 5, 0, 0, 0])
    top_p = torch.tensor([2.0, 2.0, 2.0, 0.7, 2.0, 2.0])
    seeds = torch.arange(6) + 11
    pos = torch.tensor([3, 3, 9, 9, 40, 40])
    tok = infer.sample_rows(logits, temp, top_k, top_p, seeds, pos)
    argmax = logits.argmax(-1)
    assert tok[[0, 1, 4]].tolist() == argmax[[0, 1, 4]].tolist()
    allowed = ~infer.filter_rows(logits, temp, top_k, top_p).isinf()
    assert allowed.gather(1, tok[:, None]).all()
    again = infer.sample_rows(logits, temp, top_k, top_p, seeds, pos)
    assert torch.equal(tok, again)
    draws = {int(infer.sample_rows(logits[5:], temp[5:], top_k[5:],
                                   top_p[5:], seeds[5:] + s, pos[5:]))
             for s in range(40)}
    assert len(draws) > 5                 # the seed moves the draw


# ------------------------------------------------------- served streams


def test_top_k_one_rows_equal_jax_beside_greedy_rows(models):
    """Sampled rows with ``top_k=1`` draw the argmax, so beside greedy
    rows (one segment samples, the other rows take the plain argmax) every
    token equals the JAX batcher's, which samples those rows through
    ``jax.random``."""
    jm, params, tm, _ = models
    reqs = _requests(59, 6, sampled=False)
    for i, r in enumerate(reqs):
        if i % 2:
            r.temperature, r.top_k, r.seed = 0.7, 1, 5 + i
    jcb = JaxBatcher(jm, params, decode_width_buckets=1, **COMMON)
    want = jcb.serve([JaxRequest(list(r.tokens), r.max_new,
                                 temperature=r.temperature, top_k=r.top_k,
                                 seed=r.seed) for r in reqs])
    got, cb = _serve(tm, reqs)
    assert got == want
    assert cb.stats["sampled_segments"] > 0


def test_sampling_deterministic_and_seed_sensitive(models):
    _, _, tm, _ = models
    reqs = _requests(47, 6)
    first, cb = _serve(tm, reqs)
    assert cb.serve(_clone(reqs)) == first          # a second call
    reseeded = _clone(reqs)
    for i, r in enumerate(reseeded):
        r.seed = 900 + i
    other, _ = _serve(tm, reseeded)
    assert other != first
    # a seed of None is the request's index in the call
    by_index = _clone(reqs)
    for i, r in enumerate(by_index):
        r.seed = None
    indexed = _clone(reqs)
    for i, r in enumerate(indexed):
        r.seed = i
    assert _serve(tm, by_index)[0] == _serve(tm, indexed)[0]


@pytest.mark.parametrize("which", ["gpt2", "llama"])
def test_sampling_invariant_to_slots_and_segment(models, which):
    """A row's draw is keyed on (seed, tokens so far), so the schedule
    cannot move it."""
    model = models[2] if which == "gpt2" else models[3]
    reqs = _requests(53, 5)
    outs = [_serve(model, reqs, slots=slots, segment=seg)[0]
            for slots, seg in ((2, 1), (2, 4), (4, 1), (4, 4))]
    assert outs[0] == outs[1] == outs[2] == outs[3]


@pytest.mark.parametrize("which", ["gpt2", "llama"])
def test_sampling_invariant_to_prefix_cache_and_chunking(models, which):
    """Attaching a cached prefix and chunking a prompt change where K/V
    come from and when, never a logical position: sampled streams stay."""
    model = models[2] if which == "gpt2" else models[3]
    reqs = _requests(71, 6, shared=11)
    base, _ = _serve(model, reqs)
    prefix, cb = _serve(model, reqs, prefix_cache=True)
    chunked, ccb = _serve(model, reqs, prefill_chunk_tokens=5)
    both, _ = _serve(model, reqs, prefix_cache=True, prefill_chunk_tokens=5)
    assert prefix == base and chunked == base and both == base
    assert cb.stats["prefix_hits"] > 0 and cb.stats["cow_copies"] > 0
    assert ccb.prefill["chunk_waves"] > 0


def test_greedy_rows_keep_their_tokens_beside_sampled_rows(models):
    jm, params, tm, _ = models
    greedy = _requests(61, 3, sampled=False)
    sampled = _requests(62, 3)
    mixed = [r for pair in zip(greedy, sampled) for r in pair]
    got, cb = _serve(tm, mixed)
    alone, _ = _serve(tm, greedy)
    assert got[0::2] == alone
    jcb = JaxBatcher(jm, params, decode_width_buckets=1, **COMMON)
    assert alone == jcb.serve([JaxRequest(list(r.tokens), r.max_new)
                               for r in greedy])
    assert cb.stats["sampled_segments"] > 0


def test_sampled_tokens_lie_in_their_rows_filtered_sets(models):
    """Teacher-forced: each sampled token is allowed by its row's top-k /
    top-p set over the logits of one full-sequence forward of the prompt
    and the tokens before it."""
    _, _, tm, _ = models
    reqs = _requests(81, 8)
    outs, _ = _serve(tm, reqs)
    with torch.no_grad():
        for r, out in zip(reqs, outs):
            seq = torch.tensor([r.tokens + out[:-1]])
            logits = tm(seq)[0, len(r.tokens) - 1:]
            n = len(out)
            allowed = ~infer.filter_rows(
                logits, torch.full((n,), r.temperature),
                torch.full((n,), r.top_k or 0),
                torch.full((n,), 2.0 if r.top_p is None else r.top_p)
            ).isinf()
            assert allowed.gather(1, torch.tensor(out)[:, None]).all()


class _Replayer:
    """A stand-in for a captured graph: a replay runs the captured
    function again, over the same buffers."""

    def __init__(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.fn()
        self.replays += 1


def test_two_programs_capture_schedule_on_a_stand_in_graph(models,
                                                           monkeypatch):
    """The greedy and the sampled segment are two programs, as the
    reference's static ``sampling`` flag makes two: on a stand-in graph
    each runs its first dispatch eagerly and is captured at its second,
    and the replayed tokens equal the eager loop's."""
    _, _, tm, _ = models
    reqs = _requests(91, 3, sampled=False) + _requests(92, 5)
    want, _ = _serve(tm, reqs)
    monkeypatch.setattr(serve_mod, "capture", lambda fn: graphs.record(
        _Replayer(fn), contextlib.nullcontext(), lambda: None))
    cb = ContinuousBatcher(tm, device="cpu", **COMMON)
    cb._capture = True
    assert cb.serve(_clone(reqs)) == want
    assert cb.serve(_clone(reqs)) == want
    assert cb.stats["eager_segments"] == cb.stats["graph_captures"] == 2
    assert set(cb._programs) == {("segment", False, cb.nb),
                                 ("segment", True, cb.nb)}
    assert cb.stats["graph_replays"] == cb.ticks // cb.S - 2
    assert cb._graph is cb._programs[("segment", False, cb.nb)]


# ------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A v1 checkpoint of GPT-2-tiny random weights (max_seq_len 128),
    written by the port's trainer in the JAX layout."""
    from distributed_compute_pytorch_tpu_torch.train import checkpoint as ck
    from distributed_compute_pytorch_tpu_torch.train.optim import (
        build_optimizer)
    from distributed_compute_pytorch_tpu_torch.train.step import make_step_fns
    model = GPT2(dataclasses.replace(GPT2Config.tiny(), max_seq_len=128),
                 device="cpu").init(torch.Generator().manual_seed(7))
    init_fn, _, _ = make_step_fns(model, build_optimizer("adamw", 1e-3))
    path = str(tmp_path_factory.mktemp("sampling") / "ck.npz")
    ck.save(path, init_fn(None))
    return path


def test_cli_serve_new_flags_match_jax(checkpoint, tmp_path, capsys):
    """``--temperature --top_k 1 --seed`` (every draw the argmax), one
    request overriding them back to greedy, ``--prefix_cache`` over a
    shared prompt, ``--prefill_chunk_tokens`` and ``--admit_policy
    skip_fit``: the port prints the JAX CLI's lines, ``cached_prefix``
    included."""
    from distributed_compute_pytorch_tpu.cli_serve import main as jax_main
    from distributed_compute_pytorch_tpu_torch.cli_serve import (
        main as port_main)
    shared = list(range(40, 61))
    lines = [",".join(map(str, shared + [3, 4])),
             json.dumps({"tokens": shared + [9], "max_new": 4,
                         "temperature": 0.0, "top_k": None}),
             json.dumps({"tokens": [5, 6, 7], "id": "short", "seed": 11,
                         "temperature": 1.3}),
             json.dumps({"tokens": shared + [1, 2, 3, 4, 5, 6],
                         "max_new": 3})]
    reqfile = tmp_path / "reqs.txt"
    reqfile.write_text("\n".join(lines) + "\n")
    common = ["--ckpt_path", checkpoint, "--model", "gpt2", "--model_preset",
              "tiny", "--max_seq_len", "128", "--requests", str(reqfile),
              "--slots", "2", "--segment", "3", "--max_new_tokens", "5",
              "--temperature", "0.7", "--top_k", "1", "--seed", "3",
              "--prefix_cache", "--prefill_chunk_tokens", "8",
              "--admit_policy", "skip_fit"]
    capsys.readouterr()
    assert jax_main(common + ["--heartbeat", "0"]) == 0
    want = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert port_main(common + ["--device", "cpu"]) == 0
    got = [json.loads(ln) for ln in
           capsys.readouterr().out.strip().splitlines()]
    assert got == want
    assert [ln["id"] for ln in got] == ["req-00000", "req-00001", "short",
                                        "req-00003"]
    assert max(ln["cached_prefix"] for ln in got) >= len(shared)


def test_cli_serve_refuses_truncation_without_temperature(capsys):
    from distributed_compute_pytorch_tpu_torch.cli_serve import main
    with pytest.raises(SystemExit, match="temperature"):
        main(["--init_seed", "0", "--model_preset", "tiny", "--requests",
              "-", "--device", "cpu", "--top_p", "0.9"])


@pytest.mark.parametrize("flag,item", [("--disk_cache_dir", "3.7"),
                                       ("--host_cache_mb", "3.7"),
                                       ("--journal_dir", "3.8"),
                                       ("--mesh", "3.9")])
def test_cli_serve_refuses_flags_of_later_items(flag, item):
    """A flag of a later item exits naming it; the tier flags (item 3.7,
    ported) exit on their own checks here: each needs the flag below it
    (``--prefix_cache``, ``--host_cache_mb``), as the JAX CLI's do; the
    journal's (item 3.8, ported) is taken, and the line exits on the next
    check instead (a zero ``--max_new_tokens``)."""
    from distributed_compute_pytorch_tpu_torch.cli_serve import main
    want = {"3.7": rf"{flag}.*requires",
            "3.8": r"^--max_new_tokens must be"}.get(
        item, rf"{flag}.*not ported.*{item}")
    extra = ["--max_new_tokens", "0"] if item == "3.8" else []
    with pytest.raises(SystemExit, match=want):
        main(["--init_seed", "0", "--model_preset", "tiny", "--requests",
              "-", "--device", "cpu", flag, "2", *extra])
