"""fp4trace — simulated-clock tracing and telemetry (stdlib only).

Counterpart of ``repro.obs.trace``, kept as the port's own copy: the same
classes and the same event stream under the tick clock.

One ``Tracer`` records three kinds of telemetry, all host-side:

  * **spans** — ``begin(track, name)`` / ``end(track, name)`` pairs, e.g.
    one span per serve request from ``submit`` to done/cancelled, one span
    per engine tick;
  * **counters** — monotonically accumulated totals (``counter(name, d)``):
    page allocations, prefix-cache hits, √3-threshold crossings;
  * **gauges** — instantaneous values (``gauge(name, v)``): queue depth,
    gradient-to-noise ratio per layer.

Timestamps are SIMULATED clock readings — scheduler ticks on the serve
side, optimizer steps on the train side — driven by ``set_time``.  Wall
clock is an optional per-event annotation (``wall=True``) that never
participates in assertions, so traces stay deterministic and replayable.

The exporter writes Chrome trace-event JSON (the ``traceEvents`` array
form), loadable in Perfetto / ``chrome://tracing``: spans become "B"/"E"
duration events, counters and gauges "C" counter events, one-off marks "i"
instants.

Discipline: a tracer is HOST-ONLY bookkeeping.  It never reads a device
tensor (that would be a host sync).  With tracing disabled, code paths
hold the shared ``NULL_TRACER`` singleton whose methods are empty —
near-zero call cost, bit-identical behaviour.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

# Chrome trace-event required keys (validated by ``validate_events``).
REQUIRED_EVENT_KEYS = ("name", "ph", "ts", "pid", "tid")

# Event phases we emit: duration begin/end, counter, instant, metadata.
_PHASES = ("B", "E", "C", "i", "M")


class Counters:
    """Monotonic named totals — the counter substrate shared by ``Tracer``
    and ``serve/metrics.MetricsRecorder``.

    Mapping-like: ``dict(c)``, ``c["x"]``, ``"x" in c``, ``len(c)`` all
    work, so summaries that previously held a plain dict are unchanged.
    """

    __slots__ = ("_c",)

    def __init__(self, init: Optional[Dict[str, int]] = None):
        self._c: Dict[str, int] = dict(init) if init else {}

    def inc(self, name: str, delta: int = 1) -> int:
        total = self._c.get(name, 0) + delta
        self._c[name] = total
        return total

    def set(self, name: str, value: int) -> None:
        self._c[name] = value

    def get(self, name: str, default: int = 0) -> int:
        return self._c.get(name, default)

    def snapshot(self) -> Dict[str, int]:
        return dict(self._c)

    def clear(self) -> None:
        self._c.clear()

    # mapping protocol (enough for dict(...), iteration, membership)
    def __getitem__(self, name: str) -> int:
        return self._c[name]

    def __iter__(self):
        return iter(self._c)

    def __len__(self) -> int:
        return len(self._c)

    def __contains__(self, name: str) -> bool:
        return name in self._c

    def keys(self):
        return self._c.keys()

    def values(self):
        return self._c.values()

    def items(self):
        return self._c.items()

    def __repr__(self) -> str:
        return f"Counters({self._c!r})"


class NullTracer:
    """The disabled tracer: every method is an empty no-op.

    Shared singleton ``NULL_TRACER`` is what instrumented code holds when
    no tracer was passed — guard any non-trivial bookkeeping behind
    ``if tracer.enabled``.
    """

    __slots__ = ()
    enabled = False
    clock = "none"

    def set_time(self, t: int) -> None:
        pass

    def begin(self, track: str, name: str, ts: Optional[int] = None,
              **args: Any) -> None:
        pass

    def end(self, track: str, name: str, ts: Optional[int] = None,
            **args: Any) -> None:
        pass

    def instant(self, track: str, name: str, ts: Optional[int] = None,
                **args: Any) -> None:
        pass

    def counter(self, name: str, delta: int = 1,
                ts: Optional[int] = None) -> int:
        return 0

    def gauge(self, name: str, value: float, ts: Optional[int] = None,
              track: str = "gauges") -> None:
        pass

    @contextmanager
    def span(self, track: str, name: str, **args: Any) -> Iterator[None]:
        yield

    @property
    def counters(self) -> Counters:
        return Counters()

    @property
    def n_events(self) -> int:
        return 0

    @property
    def spans_opened(self) -> int:
        return 0

    @property
    def spans_closed(self) -> int:
        return 0

    def open_spans(self) -> Dict[Tuple[str, str], int]:
        return {}

    def trace_events(self) -> List[dict]:
        return []

    def export(self, path: str) -> str:
        raise RuntimeError("NULL_TRACER records nothing; nothing to export")


NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer: spans, counters, gauges on a simulated clock.

    ``clock`` names the time unit ("tick" for serve, "step" for train) and
    is stamped into the exported JSON so a trace is self-describing.  Set
    ``wall=True`` to additionally annotate each event with a
    ``wall`` arg (perf_counter seconds) — annotation only, assertions must
    never read it.
    """

    enabled = True

    def __init__(self, clock: str = "tick", process: str = "repro",
                 wall: bool = False):
        self.clock = clock
        self.process = process
        self.wall = wall
        self.counters = Counters()
        self.gauges: Dict[str, float] = {}
        self._now = 0
        self._events: List[dict] = []
        self._meta: List[dict] = []
        self._tids: Dict[str, int] = {}
        self._open: Dict[Tuple[str, str], int] = {}
        self._opened = 0
        self._closed = 0
        self._meta.append({"name": "process_name", "ph": "M", "ts": 0,
                           "pid": 1, "tid": 0,
                           "args": {"name": f"{process} [{clock} clock]"}})

    # ---- clock ---------------------------------------------------------

    def set_time(self, t: int) -> None:
        """Advance the simulated clock (scheduler tick / optimizer step)."""
        self._now = int(t)

    @property
    def now(self) -> int:
        return self._now

    # ---- emission ------------------------------------------------------

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids) + 1
            self._meta.append({"name": "thread_name", "ph": "M", "ts": 0,
                               "pid": 1, "tid": tid,
                               "args": {"name": track}})
        return tid

    def _emit(self, ph: str, track: str, name: str, ts: Optional[int],
              args: Dict[str, Any]) -> None:
        if self.wall:
            args = dict(args)
            args["wall"] = time.perf_counter()
        ev = {"name": name, "ph": ph,
              "ts": self._now if ts is None else int(ts),
              "pid": 1, "tid": self._tid(track)}
        if args:
            ev["args"] = args
        if ph == "i":
            ev["s"] = "t"        # instant scope: thread
        self._events.append(ev)

    def begin(self, track: str, name: str, ts: Optional[int] = None,
              **args: Any) -> None:
        key = (track, name)
        self._open[key] = self._open.get(key, 0) + 1
        self._opened += 1
        self._emit("B", track, name, ts, args)

    def end(self, track: str, name: str, ts: Optional[int] = None,
            **args: Any) -> None:
        key = (track, name)
        self._open[key] = self._open.get(key, 0) - 1
        if self._open[key] == 0:
            del self._open[key]
        self._closed += 1
        self._emit("E", track, name, ts, args)

    @contextmanager
    def span(self, track: str, name: str, **args: Any) -> Iterator[None]:
        self.begin(track, name, **args)
        try:
            yield
        finally:
            self.end(track, name)

    def instant(self, track: str, name: str, ts: Optional[int] = None,
                **args: Any) -> None:
        self._emit("i", track, name, ts, args)

    def counter(self, name: str, delta: int = 1,
                ts: Optional[int] = None) -> int:
        """Accumulate ``delta`` into a running total; emits a "C" event."""
        total = self.counters.inc(name, delta)
        self._emit("C", "counters", name, ts, {name: total})
        return total

    def gauge(self, name: str, value: float, ts: Optional[int] = None,
              track: str = "gauges") -> None:
        """Record an instantaneous value; emits a "C" event."""
        self.gauges[name] = value
        self._emit("C", track, name, ts, {name: value})

    # ---- introspection (span balance, self-checks) ---------------------

    @property
    def n_events(self) -> int:
        return len(self._events)

    @property
    def spans_opened(self) -> int:
        return self._opened

    @property
    def spans_closed(self) -> int:
        return self._closed

    def open_spans(self) -> Dict[Tuple[str, str], int]:
        """(track, name) -> nesting depth of spans begun but not ended.

        Empty at end-of-run means every request/tick span was balanced
        (an ``end`` without a ``begin`` shows up as a negative depth).
        """
        return dict(self._open)

    # ---- export --------------------------------------------------------

    def trace_events(self) -> List[dict]:
        """All events (metadata first) in Chrome trace-event dict form."""
        return self._meta + self._events

    def export(self, path: str) -> str:
        """Write Perfetto/chrome://tracing-loadable JSON; returns ``path``."""
        doc = {"traceEvents": self.trace_events(),
               "displayTimeUnit": "ms",
               "otherData": {"clock": self.clock, "process": self.process}}
        with open(path, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
        return path


# ---- trace-file helpers (used by check_env --obs and tests) --------------


def load_trace(path: str) -> List[dict]:
    """Load an exported trace; accepts the object form or a bare array."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError(f"{path}: traceEvents is not a list")
    return events


def validate_events(events: List[dict]) -> List[str]:
    """Schema check: every event has the Chrome trace-event required keys,
    a known phase, and an int timestamp.  Returns a list of problems
    (empty == valid)."""
    problems: List[str] = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        missing = [k for k in REQUIRED_EVENT_KEYS if k not in ev]
        if missing:
            problems.append(f"event {i} ({ev.get('name')!r}): "
                            f"missing keys {missing}")
        if ev.get("ph") not in _PHASES:
            problems.append(f"event {i}: unknown phase {ev.get('ph')!r}")
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i}: non-numeric ts {ev.get('ts')!r}")
    return problems
