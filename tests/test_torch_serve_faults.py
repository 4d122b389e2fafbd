"""The port's request lifecycle (``serve_detailed``, ``serve_lifecycle.py``)
against the JAX batcher's, on the CPU in f32 — the drills of
``tests/test_serve_faults.py`` pointed at the port: after a raised harvest,
a hung one (the watchdog) or a slow one, GPT-2 and Llama greedy tokens equal
the JAX batcher's clean run; statuses and partial streams equal the JAX
batcher's wherever the schedule is deterministic (a cancel and a drain at
a fixed segment, a poison row, the recovery budget, shed and validation);
sampled rows after a reconstruction equal the port's own clean run (the
port's sampling bits are its own); reconstruction composes with the int8
pool, the host tier, chunked prefill and speculation; the legacy
``serve()`` is unchanged; every drill leaves no slot or block leaked.

One JAX batcher per model for the module, tiny widths and few requests."""

import dataclasses
import time

import jax
import numpy as np
import pytest

from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, LlamaLM as JaxLlama)
from distributed_compute_pytorch_tpu.serve import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest)
from distributed_compute_pytorch_tpu.serve_lifecycle import (
    ChaosInjector as JaxChaos)
from distributed_compute_pytorch_tpu_torch import interop
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.models.llama import (
    LlamaConfig, LlamaLM)
from distributed_compute_pytorch_tpu_torch.serve import (
    ContinuousBatcher, HorizonError, Request)
from distributed_compute_pytorch_tpu_torch.serve_lifecycle import (
    ChaosInjector, InjectedFault, RequestResult, TickTimeout)
from distributed_compute_pytorch_tpu_torch.spec_decode import SpecConfig

from torch_threads import one_thread  # noqa: F401 (autouse)

CFG = dict(slots=2, t_max=64, prompt_buf=10, segment=3)


@pytest.fixture(scope="module")
def models():
    """JAX GPT-2-tiny and Llama-tiny (positions lifted to 128), the port's
    copies of their weights, and one JAX batcher each."""
    out = {}
    jm = JaxGPT2(dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=128))
    params, _ = jm.init(jax.random.key(0))
    tm = interop.load_gpt2_params(
        GPT2(dataclasses.replace(GPT2Config.tiny(), max_seq_len=128),
             device="cpu"), jax.tree.map(np.asarray, params))
    out["gpt2"] = (JaxBatcher(jm, params, decode_width_buckets=1, **CFG), tm)
    jm = JaxLlama(dataclasses.replace(JaxLlamaConfig.tiny(), max_seq_len=128))
    params, _ = jm.init(jax.random.key(1))
    tm = LlamaLM(dataclasses.replace(LlamaConfig.tiny(), max_seq_len=128),
                 device="cpu")
    tm.load_state_dict(interop.llama_params_from_jax(
        jax.tree.map(np.asarray, params)))
    out["llama"] = (JaxBatcher(jm, params, decode_width_buckets=1, **CFG), tm)
    return out


def _specs(seed, n, min_new=5, max_new=9):
    """``n`` (prompt, budget) pairs from a seeded generator."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ln = int(rng.integers(2, 10))
        out.append(([int(t) for t in rng.integers(0, 256, size=ln)],
                    int(rng.integers(min_new, max_new + 1))))
    return out


def _reqs(specs, cls=Request, **kw):
    return [cls(list(t), m, **kw) for t, m in specs]


def _port(models, name="gpt2", **kw):
    return ContinuousBatcher(models[name][1], **{**CFG, **kw}, device="cpu")


def _jax(models, name="gpt2"):
    jb = models[name][0]
    jb.reset()
    return jb


def _clean(cb):
    assert cb.last_slot_leaks == 0 and cb.last_block_leaks == 0


def _outcome(res):
    return [(r.status, r.tokens) for r in res]


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_raise_reconstruction_equals_jax_clean_run(models, name):
    """A raised harvest mid-stream: the live rows are rebuilt from host
    state in place and the greedy streams equal the JAX batcher's
    uninterrupted run, with one fault, one reconstruction and no leak."""
    specs = _specs(71 if name == "gpt2" else 73, 5, 6, 12)
    want = _jax(models, name).serve(_reqs(specs, JaxRequest))
    cb = _port(models, name)
    res = cb.serve_detailed(_reqs(specs), chaos=ChaosInjector(
        fault_at_segment=2, fault_mode="raise"))
    assert all(isinstance(r, RequestResult) and r.ok for r in res)
    assert [r.tokens for r in res] == want
    assert (cb.stats["faults"], cb.stats["reconstructions"]) == (1, 1)
    assert cb.stats["reconstruction_rows"] >= 1
    assert sum(r.recoveries for r in res) >= 1
    assert all(r.ticks >= len(r.tokens) for r in res)
    _clean(cb)


def test_watchdog_hang_and_slow_tick(models):
    """The watchdog: a harvest held back past ``tick_timeout_s`` raises
    ``TickTimeout`` within the budget (not after the hang) and the
    reconstruction resumes the JAX batcher's streams; a slow tick under the
    budget triggers nothing."""
    specs = _specs(83, 4, 5, 8)
    want = _jax(models).serve(_reqs(specs, JaxRequest))
    cb = _port(models, tick_timeout_s=0.4)
    t0 = time.monotonic()
    res = cb.serve_detailed(_reqs(specs), chaos=ChaosInjector(
        fault_at_segment=2, fault_mode="hang", hang_s=30.0))
    assert time.monotonic() - t0 < 20.0          # the budget, not the hang
    assert (cb.stats["faults"], cb.stats["reconstructions"]) == (1, 1)
    assert [r.tokens for r in res] == want and all(r.ok for r in res)
    _clean(cb)
    slow = cb.serve_detailed(_reqs(specs), chaos=ChaosInjector(
        fault_at_segment=2, fault_mode="slow", slow_s=0.05))
    assert cb.stats["faults"] == 1               # unchanged
    assert [r.tokens for r in slow] == want
    _clean(cb)


def test_sampled_rows_survive_reconstruction(models):
    """Greedy and sampled rows side by side through a reconstruction: the
    streams equal the port's own clean run (a draw depends on the seed and
    the logical position alone)."""
    specs = _specs(71, 6, 6, 12)

    def reqs():
        out = _reqs(specs)
        for i in (1, 3):
            out[i].temperature, out[i].top_k, out[i].seed = 0.9, 40, 500 + i
        return out
    cb = _port(models)
    clean = cb.serve(reqs())
    res = cb.serve_detailed(reqs(), chaos=ChaosInjector(fault_at_segment=2))
    assert cb.stats["reconstructions"] == 1
    assert [r.tokens for r in res] == clean
    _clean(cb)


def _drills():
    """The deterministic drills, each ``(requests (prompt, budget) pairs,
    serve_detailed kwargs builder, batcher overrides)``; the builder takes
    (batcher, ChaosInjector class) so one recipe drives both packages."""

    class Guard:
        preempted = False

    def cancel(cb, chaos):
        return {"chaos": chaos(on_segment=lambda s: cb.cancel(0)
                               if s == 2 else None)}

    def drain(cb, chaos):
        g = Guard()
        return {"drain": g, "drain_deadline_s": 30.0,
                "chaos": chaos(on_segment=lambda s: setattr(
                    g, "preempted", g.preempted or s >= 3))}

    def poison(cb, chaos):
        return {"chaos": chaos(fault_mode="poison", poison_request=1,
                               fault_count=10)}

    def budget(cb, chaos):
        return {"chaos": chaos(fault_at_segment=1, fault_count=99)}

    def shed(cb, chaos):
        return {}

    bad = [(list(range(11)), 4), ([1, 2], 0), ([1, 999999], 4)]
    return {
        "cancel": ([([1, 2, 3], 36), ([4, 5, 6], 6), ([7, 8, 9], 6)],
                   cancel, {}),
        "drain": (_specs(89, 8, 5, 7), drain, {}),
        "poison": ([([1, 2, 3], 18)] + [([4 + i, 5, 6], 5)
                                         for i in range(4)], poison, {}),
        "budget": ([([1, 2, 3], 8), ([4, 5], 8), ([6, 7], 8)], budget,
                   {"max_recoveries": 1}),
        "shed": (bad + [([1, 2, 3], 4), ([4, 5], 4), ([6, 7], 4),
                        ([8, 9], 4)], shed, {"max_pending": 1}),
    }


@pytest.mark.parametrize("drill", ["cancel", "drain", "poison", "budget",
                                   "shed"])
def test_deterministic_drills_equal_jax(models, drill):
    """Cancel at segment 2, a drain flipped at segment 3, a poison row
    evicted after its second fault, a persistent fault past a budget of
    one recovery, and shedding past ``slots + max_pending`` beside three
    validation failures: every status, error kind and partial stream
    equals the JAX batcher's, and nothing leaks."""
    specs, kwargs, over = _drills()[drill]
    jb = _jax(models)
    saved = {k: getattr(jb, k) for k in over}
    try:
        for k, v in over.items():
            setattr(jb, k, v)
        want = jb.serve_detailed(_reqs(specs, JaxRequest),
                                 **kwargs(jb, JaxChaos))
    finally:
        for k, v in saved.items():
            setattr(jb, k, v)
    cb = _port(models, **over)
    res = cb.serve_detailed(_reqs(specs), **kwargs(cb, ChaosInjector))
    assert _outcome(res) == _outcome(want)
    for r, w in zip(res, want):
        assert (r.error is None) == (w.error is None)
        if r.error is not None:
            assert r.error.split(" ")[0] == w.error.split(" ")[0]
    statuses = {r.status for r in res}
    assert {"cancel": {"cancelled", "ok"}, "drain": {"shed", "ok"},
            "poison": {"failed", "ok"}, "budget": {"failed"},
            "shed": {"failed", "ok", "shed"}}[drill] == statuses
    _clean(cb)


def test_deadlines_queued_and_in_flight(models):
    """A deadline expired at submission ends ``timeout`` with no device
    work; one that expires mid-stream cuts the row with its partial stream
    while its neighbour completes."""
    cb = _port(models)
    res = cb.serve_detailed([Request([1, 2, 3], 6),
                             Request([4, 5], 6, deadline_s=1e-9)])
    assert res[0].ok and len(res[0].tokens) == 6
    assert res[1].status == "timeout" and res[1].tokens == []
    assert res[1].ticks == 0 and "expired" in res[1].error
    res = cb.serve_detailed(
        [Request([1, 2, 3], 40, deadline_s=0.1), Request([7, 8], 5)],
        chaos=ChaosInjector(on_segment=lambda s: time.sleep(0.06)))
    assert res[0].status == "timeout" and 0 < len(res[0].tokens) < 40
    assert res[1].ok
    _clean(cb)
    with pytest.raises(ValueError, match="deadline_s"):
        cb.serve([Request([1, 2], 3, deadline_s=0)])


def test_arrivals_and_drain_deadline(models):
    """Open-loop arrivals: a request arriving later is admitted no sooner,
    and its tokens are what it gets alone; a drain deadline too short for
    the work in flight cuts the row ``cancelled`` with its partial
    stream."""
    cb = _port(models)
    alone = cb.serve([Request([4, 5, 6], 5)])[0]
    res = cb.serve_detailed([Request([1, 2, 3], 4),
                             Request([4, 5, 6], 5, arrival_s=0.3)])
    assert all(r.ok for r in res) and res[1].tokens == alone
    assert res[1].queue_wait_s is not None and res[1].latency_s < 5.0
    assert res[1].ttft_s >= 0 and res[1].tpot_s is not None

    class Guard:
        preempted = False
    g = Guard()
    res = cb.serve_detailed(
        [Request([1, 2, 3], 40)], drain=g, drain_deadline_s=0.01,
        chaos=ChaosInjector(on_segment=lambda s: (
            setattr(g, "preempted", True), time.sleep(0.05))))
    assert res[0].status == "cancelled" and "drain deadline" in res[0].error
    assert 0 < len(res[0].tokens) < 40
    _clean(cb)


def _hot(rng, n=3, ln=17):
    return [[int(t) for t in rng.integers(0, 256, ln)] for _ in range(n)]


def _composed(case):
    """(batcher overrides, drilled-batcher extras, requests) of one
    composition case."""
    rng = np.random.default_rng(23)
    if case == "host_tier":
        heads = _hot(rng)
        specs = [(h + [int(t) for t in rng.integers(0, 256, 2)], 6)
                 for h in heads + heads[:1]]
        return (dict(slots=1, t_max=32, prompt_buf=24, segment=4,
                     prefix_cache=True, pool_blocks=8),
                dict(host_cache_blocks=64), specs)
    if case == "mid_chunk":
        specs = [([int(t) for t in rng.integers(0, 256, int(n))], 6)
                 for n in rng.integers(16, 23, 4)]
        return (dict(prompt_buf=24), dict(prefill_chunk_tokens=6), specs)
    if case == "spec":
        specs = _specs(71, 3, 6, 10) + [([5, 6, 7, 5, 6, 7, 5, 6], 8)] * 2
        return dict(prompt_buf=12), dict(speculate=SpecConfig(k=3)), specs
    return {}, dict(kv_dtype="int8"), _specs(37, 4, 6, 10)   # int8


@pytest.mark.parametrize("case", ["int8", "host_tier", "mid_chunk", "spec"])
def test_reconstruction_composes(models, case):
    """Reconstruction under the int8 pool (the replay quantizes as the
    admission did), with demoted host-tier entries outstanding (every tier
    reset with the pool), while a long prompt is mid-chunk (its whole head
    replayed) and with speculation live (the verify harvest takes the chaos
    hooks; the proposer rebuilds from tokens): each drilled stream, greedy
    and sampled, equals a fault-free run of the plain configuration (the
    int8 pool's own), with nothing leaked."""
    over, extra, specs = _composed(case)

    def reqs():
        out = _reqs(specs)
        out[1].temperature, out[1].seed = 0.8, 7
        return out
    plain = _port(models, **over, **(extra if case == "int8" else {}))
    want = plain.serve(reqs())
    cb = _port(models, **over, **extra)
    res = cb.serve_detailed(reqs(), chaos=ChaosInjector(fault_at_segment=2))
    assert cb.stats["reconstructions"] == 1
    assert all(r.ok for r in res), [r.error for r in res]
    assert [r.tokens for r in res] == want
    if case == "host_tier":
        assert cb.tier["demotions"] >= 1 and cb.last_host_block_leaks == 0
    if case == "spec":
        assert cb.spec["verify_segments"] > 0
    _clean(cb)


def test_legacy_serve_unchanged(models):
    """``serve()`` over the same engine: plain token lists equal to the JAX
    batcher's ``serve``, ``ValueError`` for an invalid request,
    ``HorizonError`` with the completed outputs after the rest; the chaos
    classes raise the reference's errors."""
    specs = [([1, 2, 3], 4), ([5, 6], 5)]
    cb = _port(models)
    assert cb.serve(_reqs(specs)) == _jax(models).serve(
        _reqs(specs, JaxRequest))
    with pytest.raises(ValueError, match="prompt_buf"):
        cb.serve([Request(list(range(11)), 2)])
    with pytest.raises(HorizonError) as e:
        cb.serve([Request([1, 2], 3), Request([1, 2], 200)])
    assert e.value.outputs[1] == [] and len(e.value.outputs[0]) == 3
    _clean(cb)
    assert issubclass(InjectedFault, RuntimeError)
    assert issubclass(TickTimeout, RuntimeError)
    with pytest.raises(ValueError, match="poison_request"):
        ChaosInjector(fault_mode="poison")
    for bad in (dict(max_pending=-1), dict(tick_timeout_s=0),
                dict(max_recoveries=-1)):
        with pytest.raises(ValueError, match=next(iter(bad))):
            _port(models, **bad)
