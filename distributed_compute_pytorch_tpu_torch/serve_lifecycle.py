"""The request lifecycle's vocabulary, chaos injection and the tick watchdog
— the port of ``distributed_compute_pytorch_tpu/serve_lifecycle.py``.

``ContinuousBatcher.serve_detailed`` degrades per request, not per call:
each request ends in a :class:`RequestResult` with one of the statuses
below and whatever tokens reached the host before its terminal event.

``ok``          completed (eos or budget); tokens are the full stream.
``failed``      validation failure, horizon infeasibility, or a device fault
                the recovery budget could not absorb.
``timeout``     the request's wall-clock ``deadline_s`` expired; tokens hold
                the partial stream.
``cancelled``   ``ContinuousBatcher.cancel()`` or the drain deadline cut it;
                tokens hold the partial stream.
``shed``        rejected at submission (``max_pending`` overflow) or at
                drain start, with no device work spent on it.

The tick watchdog is where the port departs from the reference. The
reference bounds the harvest's ``np.asarray`` with
``train/elastic.call_with_timeout``, a thread it leaks on a hang. The port's
harvest already waits on the CUDA event recorded behind its segment
(``serve._Fetch``), so with ``tick_timeout_s`` set it polls
``event.query()`` until the budget is spent and then raises
:class:`TickTimeout`: no thread, no blocking sync. A :class:`ChaosInjector`
``hang`` is real device work on the card — a spin kernel of about
``hang_s`` enqueued on the segment's stream before its fetch's event
(:func:`spin`) — so the watchdog sees a device that is genuinely busy; on
the CPU it is a host delay inside the poll. The flight-recorder records of
the reference's chaos trips wait for the port's telemetry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

# terminal request states (RequestResult.status)
OK = "ok"
FAILED = "failed"
TIMEOUT = "timeout"
CANCELLED = "cancelled"
SHED = "shed"
STATUSES = (OK, FAILED, TIMEOUT, CANCELLED, SHED)

# the SM clock a spin is sized by when the device properties do not give one
# (the H100 SXM's boost clock, Hz)
DEFAULT_SM_HZ = 1.98e9


class InjectedFault(RuntimeError):
    """A chaos-injected device failure (stands in for the runtime error a
    dead device raises at the harvest)."""


class TickTimeout(RuntimeError):
    """The per-segment token harvest exceeded the tick watchdog budget: the
    serving-side signature of a hung device."""


@dataclass
class RequestResult:
    """One request's outcome from ``serve_detailed``.

    ``tokens`` is always meaningful: the full stream for ``ok``, the partial
    stream already harvested for ``timeout`` / ``cancelled`` (and for a
    ``failed`` row the device lost), ``[]`` for requests that never ran.
    ``ticks`` counts decode ticks charged to the request at dispatch;
    ``latency_s`` is the wall from its arrival to its terminal event;
    ``recoveries`` counts the reconstructions (and journal replays) its row
    lived through; ``cached_prefix_tokens`` the prompt tokens attached from
    the radix prefix cache. ``queue_wait_s`` (arrival to admission),
    ``ttft_s`` (arrival to the first harvested token, ``None`` without one)
    and ``tpot_s`` (the mean interval after the first token, ``None`` below
    two tokens) are wall seconds from the request's arrival. ``migrated``
    and ``replica`` are the router's (0 and ``None`` outside it);
    ``request_id`` the request's stable identity (its ``request_id`` or the
    positional default ``req-{i}``), which journal recovery dedups by."""

    status: str = OK
    tokens: list = field(default_factory=list)
    error: str | None = None
    ticks: int = 0
    latency_s: float = 0.0
    recoveries: int = 0
    cached_prefix_tokens: int = 0
    queue_wait_s: float | None = None
    ttft_s: float | None = None
    tpot_s: float | None = None
    migrated: int = 0
    replica: int | None = None
    request_id: str | None = None

    @property
    def ok(self) -> bool:
        return self.status == OK


def spin(torch, seconds: float) -> None:
    """Enqueue a spin kernel of about ``seconds`` on the current CUDA stream
    (``torch.cuda._sleep``, cycles of the SM clock)."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    khz = getattr(props, "clock_rate", None)
    hz = khz * 1e3 if khz else DEFAULT_SM_HZ
    torch.cuda._sleep(int(seconds * hz))


@dataclass
class ChaosInjector:
    """Deterministic fault injection for the serve loop, counted in
    dispatched segments (``stats["segments"]``).

    ``fault_at_segment`` arms the injector: once that many segments were
    dispatched, the next harvest trips ``fault_mode``:

    - ``raise``: the harvest raises :class:`InjectedFault`. Recovered by
      session reconstruction.
    - ``hang``: the harvest's data is late by ``hang_s``, so a watchdog with
      a smaller budget fires first (:meth:`in_fetch`). On the card the
      batcher enqueues a spin of ``hang_s`` on the stream at the first
      dispatch the injector is armed for; on the CPU the poll sees the
      fetch as not ready for ``hang_s``.
    - ``slow``: the harvest sleeps ``slow_s`` on the host, then succeeds;
      must not trigger a recovery under the watchdog's budget.
    - ``poison``: every harvest whose plan holds request
      ``poison_request`` raises; the scheduler must evict that row.

    ``fault_count`` bounds the trips (default 1: one transient fault).
    ``on_segment`` is a host hook called after every dispatch with the
    running segment count (drills flip drain flags or cancel there)."""

    fault_at_segment: int | None = None
    fault_mode: str = "raise"
    fault_count: int = 1
    slow_s: float = 0.05
    hang_s: float = 2.0
    poison_request: int | None = None
    on_segment: Callable[[int], None] | None = None

    def __post_init__(self):
        modes = ("raise", "hang", "slow", "poison")
        if self.fault_mode not in modes:
            raise ValueError(f"fault_mode must be one of {modes}, got "
                             f"{self.fault_mode!r}")
        if self.fault_mode == "poison" and self.poison_request is None:
            raise ValueError("fault_mode 'poison' needs poison_request")
        self.trips = 0

    def _armed(self, segments: int) -> bool:
        if self.trips >= self.fault_count:
            return False
        return (self.fault_at_segment is not None
                and segments >= self.fault_at_segment)

    def pre_fetch(self, segments: int, plan_requests: list[int]) -> None:
        """Called by the harvest just before its wait. May raise
        (``raise`` / ``poison``) or sleep (``slow``)."""
        if self.fault_mode == "poison":
            if (self.trips < self.fault_count
                    and self.poison_request in plan_requests):
                self.trips += 1
                raise InjectedFault(
                    f"injected poison row (request {self.poison_request}) "
                    f"at segment {segments}")
            return
        if not self._armed(segments):
            return
        if self.fault_mode == "raise":
            self.trips += 1
            raise InjectedFault(f"injected tick fault at segment {segments}")
        if self.fault_mode == "slow":
            self.trips += 1
            time.sleep(self.slow_s)

    def in_fetch(self, segments: int) -> float:
        """The seconds a ``hang`` holds a fetch's data back once armed, else
        0: on the CPU called by the harvest inside its watchdogged wait,
        on the card by a dispatch after its launches (the spin it
        enqueues before its fetch's event)."""
        if self.fault_mode == "hang" and self._armed(segments):
            self.trips += 1
            return self.hang_s
        return 0.0
