"""Preemption handling and restart backoff — the part of
``distributed_compute_pytorch_tpu/train/elastic.py`` that serving's drain and
the serve CLI's supervisor use: :class:`PreemptionGuard`,
:data:`EXIT_PREEMPTED` and :func:`backoff_delays`.

The rest of the reference module — heartbeats, coordinated multi-host
preemption, the trainer's supervisor, ``call_with_timeout`` and
``retry_with_backoff`` — is multi-host elastic training, ROADMAP queue 1
item 2.5, and is not ported yet. (Serving's tick watchdog waits on a CUDA
event instead of ``call_with_timeout``: ``serve_lifecycle.py``.)
"""

from __future__ import annotations

import os
import random
import signal
from typing import Sequence

# exit code of a process that stopped for a preemption after draining
# (EX_TEMPFAIL: transient, safe to restart)
EXIT_PREEMPTED = 75


class PreemptionGuard:
    """Latches SIGTERM/SIGINT into a pollable ``preempted`` flag.

    A context manager; the previous handlers come back on exit. The first
    signal sets the flag (serving drains, the caller exits
    :data:`EXIT_PREEMPTED`); a second one falls through to the previous
    handler, so a double Ctrl-C still kills a stuck process."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,
                                                 signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous: dict[int, object] = {}
        self.preempted = False

    def _handler(self, signum, frame):
        if self.preempted:   # second signal: as the original handler would
            prev = self._previous.get(signum)
            if prev is signal.SIG_IGN:
                # the signal was ignored before: restoring and re-raising
                # would turn "ignored" into death
                signal.signal(signum, signal.SIG_IGN)
                return
            signal.signal(signum, prev if callable(prev) else signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self.preempted = True

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()


def backoff_delays(budget: int, base_delay: float, jitter_seed: int = 0,
                   *, factor: float = 2.0, jitter: float = 0.5
                   ) -> list[float]:
    """``budget`` exponential-backoff delays, the k-th ``base_delay *
    factor**k`` stretched by up to ``jitter`` of itself, the jitter drawn
    from ``random.Random(jitter_seed)`` (an explicit seed, so a schedule is
    reproducible)."""
    if budget < 0:
        raise ValueError(f"budget must be >= 0, got {budget}")
    if base_delay < 0:
        raise ValueError(f"base_delay must be >= 0, got {base_delay}")
    rng = random.Random(jitter_seed)
    return [base_delay * factor ** k * (1.0 + jitter * rng.random())
            for k in range(budget)]
