"""CUDA graphs of the decode programs and the train step.

The JAX package compiles a serve segment (``serve.py:832``, a ``lax.scan``
of ticks), generation's decode (``infer.py:391``, one ``lax.scan``) and
the train step (``train/step.py:629``, ``jax.jit``) into one program
each. The port captures the same work once as a CUDA graph
(``torch.cuda.CUDAGraph``) and replays it, so a segment, a tick or an
update costs the host one ``cudaGraphLaunch`` instead of one launch per
op.

A capture records the addresses and by-value arguments of every launch,
so what a captured program reads and writes must sit in buffers that
outlive it (the callers' static buffers, the decode reads' merge scratch:
``ops/decode_attention.py::merge_scratch``), and every kernel must have
been built and launched once before the capture (``ops/_build.py`` and the
merge scratch refuse to start inside one).

Three more things a capture does not carry over on its own:

- **Launch counters.** The kernel wrappers count their launches in
  module-level integers (:data:`COUNTED`), which the capture bumps once
  (though it runs nothing) and a replay not at all. :func:`record` reads
  every counter before and after the capture and restores them, and
  :meth:`Program.replay` adds the difference on each replay, so a
  replayed kernel counts as launched, once a replay.
- **PyTorch's caches.** ``torch.cuda.graph`` synchronizes the device and
  empties PyTorch's device and pinned-host caches before each capture, so
  every allocation after it goes back to ``cudaMalloc`` and
  ``cudaHostAlloc``; a generate call captures once per call. :func:`capture`
  records on a side stream with ``capture_begin`` / ``capture_end`` alone:
  no sync (a capture and a replay pass
  ``torch.cuda.set_sync_debug_mode("error")``), no emptied cache.
- **Python's garbage collector.** A collection that runs inside a capture
  may free what a dead object held (another batcher's graphs, its pinned
  fetch buffers), and those frees call the runtime in ways a capture in
  progress does not allow: the capture is invalidated and
  ``capture_end`` raises. :func:`capture` holds the collector off for the
  capture's length; what it would have collected waits for the next
  collection.
- **Random numbers.** A capture records a generator's draws at offsets
  from a seed and offset that the graph reads from device memory. The
  generators a program draws from are registered with the graph
  (:func:`capture`'s ``generators``); before each replay PyTorch copies
  each one's current seed and offset into the graph and advances its
  offset by what the graph draws, so a generator re-seeded before a
  replay draws what an eager run from that seed draws.

Nothing falls back: a capture or a replay that fails raises.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from distributed_compute_pytorch_tpu_torch.ops import (
    cache_update, decode_attention, flash_attention, fused_adamw)

# the kernel wrappers' modules; each counter is a module-level int whose
# name ends in "launches"
COUNTED = (flash_attention, cache_update, decode_attention, fused_adamw)
# the profiler range of one replay
REPLAY_SPAN = "cuda_graph.replay"


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter: ``{(module, name): n}``."""
    return {(mod, name): n for mod in COUNTED
            for name, n in vars(mod).items()
            if name.endswith("launches") and type(n) is int}


class Program:
    """A captured graph and the kernel launches one replay makes.

    ``launches``: ``{(module, counter): launches a replay}``, the counters
    the capture moved; ``replays``: the replays so far; ``capture_ms``:
    the capture's host time, where :func:`capture` took it."""

    def __init__(self, graph, launches: dict):
        self.graph = graph
        self.launches = launches
        self.replays = 0
        self.capture_ms = None

    def replay(self) -> None:
        """Replay the graph on the current stream and count its
        launches. A profiler sees the replay as a ``REPLAY_SPAN`` range
        holding its host calls."""
        with torch.profiler.record_function(REPLAY_SPAN):
            self.graph.replay()
        for (mod, name), n in self.launches.items():
            setattr(mod, name, getattr(mod, name) + n)
        self.replays += 1


def record(graph, recording, fn) -> Program:
    """Run ``fn`` inside the context manager ``recording``, which captures
    its work into ``graph``, and return the :class:`Program`. Every launch
    counter is restored after the capture (nothing ran), and the amounts
    the capture moved them by become the program's launches a replay."""
    before = launch_counts()
    try:
        with recording:
            fn()
    finally:
        after = launch_counts()
        for (mod, name), n in before.items():
            setattr(mod, name, n)
    return Program(graph, {key: after[key] - n for key, n in before.items()
                           if after[key] != n})


@contextlib.contextmanager
def _recording(graph, generators=(), pool=None):
    """Capture the block's CUDA work into ``graph`` on a side stream (a
    capture may not run on the default stream) and into the memory pool
    ``pool`` (``torch.cuda.graph_pool_handle()``, which graphs that never
    replay at once and hand back only buffers allocated outside them may
    share), by default a private one, with ``generators`` registered with
    the graph, and Python's garbage collector off."""
    for gen in generators:
        graph.register_generator_state(gen)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(torch.cuda.Stream()):
            graph.capture_begin(pool=pool)
            try:
                yield
            finally:
                graph.capture_end()
    finally:
        if collecting:
            gc.enable()


def capture(fn, generators=(), pool=None) -> Program:
    """``fn``'s CUDA work captured into a new ``torch.cuda.CUDAGraph``
    (:func:`_recording`; ``generators``: the CUDA generators it draws
    from; ``pool``: a shared memory pool, default the graph's own), with
    :func:`record`'s launch counts and the capture's host time in
    ``capture_ms``."""
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    program = record(graph, _recording(graph, generators, pool), fn)
    program.capture_ms = 1e3 * (time.perf_counter() - t0)
    return program
