"""The port's one timing mechanism: named spans and counters.

    from stitchax_torch.utils import tracing

    with tracing.span("eval.align"):
        ...
    tracing.count("host_syncs")

`span(name, timings=None, key=None, device=None, root=None)` has three
modes:

- Off (the default) and no `timings`: it returns one shared no-op context;
  the cost is one test of a module-level bool.
- A `timings` dict, on or off: the device (`device`, else the current CUDA
  device) is synchronised at both ends and the host ms between them are
  added to `timings[key]`. This is what the train steps' and the stitcher's
  `timings` arguments give; the synchronisations belong to that
  measurement.
- On (`enable()`): the span is recorded with its name, its parent, its
  root (the outermost open span: one per evaluation batch or train step;
  `root=` names it, e.g. the train state's step, else it is the root span's
  own id), its start and end on CLOCK_REALTIME in ns (`time.time_ns()`,
  the clock torch.profiler stamps its events with: a profiler event starts
  at `prof.profiler.kineto_results.trace_start_ns()` plus its relative
  start), and, on a CUDA device, a pair of CUDA events recorded on the
  current stream at its ends, from a pool made once by `enable()`. Nothing
  synchronises: the device ms between the two events are read by
  `snapshot()`.

`count(name, n=1)` bumps a counter when on; each bump is kept in the same
bounded buffer as the spans, under the innermost open span, so a reader
can split a counter by batch or step. The buffer keeps the newest
`capacity` records; the oldest go and `dropped` says how many.
`count_sync(device, n=1)` bumps `host_syncs` for a forced wait of the
host on work queued on `device`, a CUDA device (a read on the CPU waits
for nothing and is not counted).

The tracer adds nothing to torch.profiler's trace: no `record_function`,
no profiler annotation, no NVTX range. Spans therefore never count as
device activity in a profiled slice; they share its clock instead.
Spans are recorded from one thread (the one that drives the device).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import torch

CLOCK = "CLOCK_REALTIME ns (time.time_ns)"

_ON = False
_NULL = contextlib.nullcontext()


class _Tracer:
    """The buffer: a ring of `capacity` records, each a span or a count,
    with one pair of CUDA events per slot."""

    def __init__(self, capacity: int, device: Optional[torch.device]):
        self.capacity = capacity
        self.device = device
        self.records: List[Optional[list]] = [None] * capacity
        self.events = ([(torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                        for _ in range(capacity)] if device is not None
                       else None)
        self.seq = 0                # records taken, also the next id
        self.stack: List[list] = []  # the open spans, innermost last
        self.totals: Dict[str, int] = {}

    def take(self, record: list) -> int:
        """Store `record` in the next slot (its id first) and return the
        slot; the record it replaces is dropped."""
        slot = self.seq % self.capacity
        record[0] = self.seq
        self.records[slot] = record
        self.seq += 1
        return slot

    def stream(self, device: Optional[torch.device]):
        """The stream to record a span's events on, or None for a span of
        work on another kind of device."""
        if self.events is None or (device is not None
                                   and device.type != "cuda"):
            return None
        return torch.cuda.current_stream(self.device)


_TRACER: Optional[_Tracer] = None


def _sync(device) -> None:
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif device.type == "cuda":
        torch.cuda.synchronize(device)


class _Span:
    # a span record: [id, "span", name, parent id, root id, start ns,
    # end ns (None while open), slot's events recorded]
    __slots__ = ("name", "timings", "key", "device", "root", "t0", "rec",
                 "slot")

    def __init__(self, name, timings, key, device, root):
        self.name, self.timings, self.key = name, timings, key
        self.device, self.root = device, root
        self.rec = None

    def __enter__(self):
        if self.timings is not None:
            _sync(self.device)
            self.t0 = time.perf_counter()
        tr = _TRACER
        if _ON and tr is not None:
            parent = tr.stack[-1] if tr.stack else None
            rec = [0, "span", self.name, None if parent is None
                   else parent[0], None, time.time_ns(), None, False]
            self.slot = tr.take(rec)
            rec[4] = (parent[4] if parent is not None else
                      rec[0] if self.root is None else self.root)
            stream = tr.stream(self.device)
            if stream is not None:
                tr.events[self.slot][0].record(stream)
                rec[7] = True
            tr.stack.append(rec)
            self.rec = rec
        return self

    def __exit__(self, *exc):
        rec, tr = self.rec, _TRACER
        if rec is not None and tr is not None and tr.stack \
                and tr.stack[-1] is rec:
            tr.stack.pop()
            if tr.records[self.slot] is rec:
                if rec[7]:
                    tr.events[self.slot][1].record(tr.stream(self.device))
                rec[6] = time.time_ns()
        if self.timings is not None:
            _sync(self.device)
            self.timings[self.key] = (self.timings.get(self.key, 0.0)
                                      + (time.perf_counter() - self.t0)
                                      * 1e3)
        return False


def span(name: str, timings: Optional[dict] = None,
         key: Optional[str] = None, device: Optional[torch.device] = None,
         root: Optional[int] = None):
    """A context manager over one named piece of work (see the module's
    docstring): `timings[key]` gains its synchronised host ms when
    `timings` is a dict; it is recorded when the tracer is on. `device`
    is where its work runs (default: the current CUDA device); `root`
    names the batch or step when this span is the outermost one."""
    if not _ON and timings is None:
        return _NULL
    return _Span(name, timings, key, device, root)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (while the tracer is on)."""
    if not _ON:
        return
    tr = _TRACER
    parent = tr.stack[-1] if tr.stack else None
    tr.take([0, "count", name, None if parent is None else parent[0],
             None if parent is None else parent[4], time.time_ns(), n])
    tr.totals[name] = tr.totals.get(name, 0) + n


# the device types on which a host read waits for queued work
SYNC_DEVICES = ("cuda",)


def count_sync(device, n: int = 1) -> None:
    """Add n to `host_syncs` (while the tracer is on) for a forced wait
    of the host on `device`'s queue, where `device` is of SYNC_DEVICES."""
    if _ON and device is not None \
            and torch.device(device).type in SYNC_DEVICES:
        count("host_syncs", n)


def enable(capacity: int = 8192, device=None) -> Dict[str, Any]:
    """Start recording into a new buffer of `capacity` records. Device
    ms are taken on `device` (default: the current CUDA device when there
    is a card, else none). Returns {"clock", "capacity", "device"}."""
    global _ON, _TRACER
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        dev = None
    _TRACER = _Tracer(capacity, dev)
    _ON = True
    return {"clock": CLOCK, "capacity": capacity,
            "device": None if dev is None else str(dev)}


def disable() -> Dict[str, Any]:
    """Stop recording; the buffer is kept for `snapshot()` until the next
    `enable()`. Returns {"on": False}."""
    global _ON
    _ON = False
    return {"on": False}


def snapshot() -> Dict[str, Any]:
    """The buffer as plain data (synchronises the tracer's device once,
    to read the events): {"clock", "on", "dropped", "counters": {name:
    total since enable()}, "spans": [{"id", "name", "parent", "root",
    "start_ns", "end_ns", "host_ms", "device_ms" (None off a card)}],
    "counts": [{"id", "name", "span", "root", "t_ns", "n"}]}, oldest
    first. Spans still open are left out."""
    tr = _TRACER
    out: Dict[str, Any] = {"clock": CLOCK, "on": _ON, "dropped": 0,
                           "counters": {}, "spans": [], "counts": []}
    if tr is None:
        return out
    out["dropped"] = max(0, tr.seq - tr.capacity)
    out["counters"] = dict(tr.totals)
    if tr.events is not None:
        torch.cuda.synchronize(tr.device)
    first = max(0, tr.seq - tr.capacity)
    for i in range(first, tr.seq):
        slot = i % tr.capacity
        rec = tr.records[slot]
        if rec[1] == "count":
            out["counts"].append({"id": rec[0], "name": rec[2],
                                  "span": rec[3], "root": rec[4],
                                  "t_ns": rec[5], "n": rec[6]})
        elif rec[6] is not None:
            a, b = tr.events[slot] if rec[7] else (None, None)
            out["spans"].append({
                "id": rec[0], "name": rec[2], "parent": rec[3],
                "root": rec[4], "start_ns": rec[5], "end_ns": rec[6],
                "host_ms": (rec[6] - rec[5]) / 1e6,
                "device_ms": a.elapsed_time(b) if rec[7] else None})
    return out
