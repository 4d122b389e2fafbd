"""The port's decode programs as the CUDA graphs capture them, on the CPU:
serving's segment over the batcher's static device buffers and
generation's tick over a static ``pos``, held token for token to the JAX
package in f32 (float and int8 caches), the capture's launch-count
bookkeeping (``utils/graphs.py``) on a stand-in graph, the batcher's
capture schedule on a stand-in graph that replays by running the segment
again, and the rule that the CPU path never reaches ``torch.cuda``'s
graphs. The graphs themselves run only on the card
(``tests/test_torch_cuda.py``, marker ``cuda``)."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu import infer as jax_infer
from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.serve import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest)
from distributed_compute_pytorch_tpu_torch import infer
from distributed_compute_pytorch_tpu_torch import serve as serve_mod
from distributed_compute_pytorch_tpu_torch.interop import load_gpt2_params
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.ops import (
    cache_update, decode_attention, flash_attention, fused_adamw)
from distributed_compute_pytorch_tpu_torch.serve import (
    ContinuousBatcher, Request)
from distributed_compute_pytorch_tpu_torch.utils import graphs

SLOTS, SEGMENT, T_MAX, PROMPT_BUF = 2, 3, 128, 10
# block sizes: the JAX float pool's 8-slot window, its int8 pool's 32
BT = {"bf16": 8, "int8": 32}


@pytest.fixture(scope="module")
def models():
    """JAX tiny GPT-2 (positions lifted to 128 so the serve horizon fits),
    the port's copy of its weights, and one JAX reference batcher per
    pool form, built once for the module."""
    cfg = dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=128)
    jm = JaxGPT2(cfg)
    params, _ = jm.init(jax.random.key(0))
    tm = load_gpt2_params(
        GPT2(dataclasses.replace(GPT2Config.tiny(), max_seq_len=128),
             device="cpu"), jax.tree.map(np.asarray, params))
    jcbs = {kv: JaxBatcher(jm, params, slots=SLOTS, t_max=T_MAX,
                           prompt_buf=PROMPT_BUF, segment=SEGMENT,
                           kv_block_tokens=BT[kv], decode_width_buckets=1,
                           kv_dtype=kv)
            for kv in BT}
    return jm, params, tm, jcbs


def _requests(seed, n):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(0, 256, int(rng.integers(
        1, PROMPT_BUF + 1)))], int(rng.integers(3, 10))) for _ in range(n)]


def _port(tm, kv):
    return ContinuousBatcher(tm, slots=SLOTS, t_max=T_MAX,
                             prompt_buf=PROMPT_BUF, segment=SEGMENT,
                             kv_block_tokens=BT[kv], kv_dtype=kv,
                             device="cpu")


def _buffers(cb):
    """The segment's static buffers, by address."""
    return {name: getattr(cb, name).data_ptr() for name in (
        "_tables_dev", "_pos0", "_cur_tok", "_n_logical", "_toks")}


def _serve_twice(jcb, cb):
    """Two request sets through both batchers, one serve call each; the
    port's tokens must be the JAX batcher's and its static buffers the
    same tensors after each call."""
    ptrs = _buffers(cb)
    for seed in (3, 8):
        reqs = _requests(seed, 7)
        want = jcb.serve([JaxRequest(list(t), n) for t, n in reqs])
        got = cb.serve([Request(list(t), n) for t, n in reqs])
        assert got == want
        assert _buffers(cb) == ptrs
        assert cb.last_block_leaks == 0 and cb.last_slot_leaks == 0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_static_segment_two_calls_token_identical_to_jax(models, kv):
    """One batcher, two serve calls of 7 staggered requests each through 2
    slots (several admission waves a call): every segment reads and writes
    the same static buffers (the carried token and logical position are
    rewritten in place, by the segment and by admission), and the greedy
    tokens are the JAX ``ContinuousBatcher``'s, float and int8 pools. On
    the CPU every segment runs eagerly."""
    _, _, tm, jcbs = models
    cb = _port(tm, kv)
    _serve_twice(jcbs[kv], cb)
    assert cb.stats["prefill_calls"] > 4
    assert cb.stats["eager_segments"] == cb.ticks // SEGMENT
    assert cb.stats["graph_captures"] == cb.stats["graph_replays"] == 0


class _Replayer:
    """A stand-in for a captured graph: a replay runs the captured
    function again, over the same buffers, as a graph replays its kernels
    (and nothing else: no Python state of the capture carries over)."""

    def __init__(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.fn()
        self.replays += 1


def _stand_in_capture(fn):
    """``graphs.capture`` with the stand-in graph: the capture runs
    nothing."""
    return graphs.record(_Replayer(fn), contextlib.nullcontext(),
                         lambda: None)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_capture_schedule_on_a_stand_in_graph(models, kv, monkeypatch):
    """The captured path's schedule, on the CPU with a stand-in graph: the
    batcher's first segment runs eagerly, the second dispatch captures
    (running nothing) and replays, and every later dispatch replays, in
    this serve call and the next, with no second capture; the tokens are
    the JAX batcher's, so a segment needs nothing but its static buffers
    to be replayed."""
    _, _, tm, jcbs = models
    monkeypatch.setattr(serve_mod, "capture", _stand_in_capture)
    cb = _port(tm, kv)
    cb._capture = True
    _serve_twice(jcbs[kv], cb)
    segments = cb.ticks // SEGMENT
    assert cb.stats["eager_segments"] == cb.stats["graph_captures"] == 1
    assert cb.stats["graph_replays"] == segments - 1
    assert cb._graph.replays == cb._graph.graph.replays == segments - 1


def _prompt_and_mask():
    prompt = np.random.default_rng(1).integers(0, 256, (3, 7)
                                               ).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, :3] = 0
    mask[2, :6] = 0
    return prompt, mask


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("eos", [False, True])
def test_static_pos_tick_token_identical_to_jax(models, kv_quant, eos):
    """Generation's tick over its static buffers (a 0-dim ``pos`` the tick
    advances, the current token, the eos flags, the output written a
    column a tick): greedy tokens of a left-padded batch identical to the
    JAX ``generate``, float and int8 caches, with and without an eos that
    row 0 emits early."""
    jm, params, tm, _ = models
    prompt, mask = _prompt_and_mask()
    n = 9
    eos_id = None
    if eos:
        free = np.asarray(jax_infer.generate(
            jm, params, jnp.asarray(prompt), n, kv_quant=kv_quant,
            prompt_mask=jnp.asarray(mask)))
        eos_id = int(free[0, 7 + 1])
    want = jax_infer.generate(jm, params, jnp.asarray(prompt), n,
                              kv_quant=kv_quant, eos_id=eos_id,
                              prompt_mask=jnp.asarray(mask))
    fn = infer.make_generate_fn(tm, n, kv_quant=kv_quant, eos_id=eos_id)
    got = fn(prompt, prompt_mask=mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if eos:
        assert (got[0, 7 + 1:] == eos_id).all()
    assert fn.stats == {"graph_captures": 0, "graph_replays": 0,
                        "capture_ms": None}


@pytest.fixture
def counters(monkeypatch):
    """Every launch counter, restored after the test."""
    for mod, name in graphs.launch_counts():
        monkeypatch.setattr(mod, name, getattr(mod, name))
    return graphs.launch_counts()


def test_launch_counts_cover_every_kernel_wrapper(counters):
    """The helper reads every wrapper's counter: the four kernel modules,
    float and int8 forms, read-only and fused."""
    names = {(mod.__name__.rsplit(".", 1)[1], name)
             for mod, name in counters}
    for want in (("flash_attention", "launches"),
                 ("flash_attention", "dkv_tc_launches"),
                 ("cache_update", "launches"),
                 ("cache_update", "kv_insert_rows_q8_launches"),
                 ("decode_attention", "write_launches"),
                 ("decode_attention", "dense_write_q8_launches"),
                 ("decode_attention", "dense_launches"),
                 ("fused_adamw", "launches")):
        assert want in names, want
    assert {mod for mod, _ in counters} == {
        flash_attention, cache_update, decode_attention, fused_adamw}


def test_replay_adds_the_capture_launch_counts_once_a_replay(counters):
    """A capture moves no counter (it runs nothing); each replay adds what
    the capture's wrapper calls counted, once, and nothing else."""
    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    def captured():
        # the wrappers' bumps during a capture of one 12-layer tick
        decode_attention.write_launches += 12
        cache_update.q8_launches += 3

    graph = Graph()
    program = graphs.record(graph, contextlib.nullcontext(), captured)
    assert graphs.launch_counts() == counters
    assert program.launches == {(decode_attention, "write_launches"): 12,
                                (cache_update, "q8_launches"): 3}
    for n in (1, 2, 3):
        program.replay()
        now = graphs.launch_counts()
        moved = {key: now[key] - counters[key] for key in now
                 if now[key] != counters[key]}
        assert moved == {(decode_attention, "write_launches"): 12 * n,
                         (cache_update, "q8_launches"): 3 * n}
    assert graph.replays == program.replays == 3
    assert program.capture_ms is None


def test_a_failed_capture_raises_and_restores_the_counters(counters):
    """Nothing falls back: an error inside the capture propagates, and the
    counters it moved are put back."""
    def captured():
        decode_attention.dense_write_launches += 12
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.record(object(), contextlib.nullcontext(), captured)
    assert graphs.launch_counts() == counters


def test_cpu_path_never_touches_cuda_graphs(models, monkeypatch):
    """With ``torch.cuda``'s graphs made to raise, serving (float and int8
    pools) and greedy generation (float and int8 caches) on the CPU run as
    before: the CPU path is the eager loop."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached torch.cuda's graphs")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    _, _, tm, _ = models
    reqs = _requests(3, 4)
    for kv in BT:
        cb = _port(tm, kv)
        assert not cb._capture
        outs = cb.serve([Request(list(t), n) for t, n in reqs])
        assert [len(o) for o in outs] == [n for _, n in reqs]
        assert cb.stats["graph_captures"] == 0
    prompt, mask = _prompt_and_mask()
    for kv_quant in (False, True):
        fn = infer.make_generate_fn(tm, 6, kv_quant=kv_quant)
        assert fn(prompt, prompt_mask=mask).shape == (3, 13)
        assert fn.stats["graph_captures"] == 0
