"""Spans and counters inside the port, on the host clock of the benchmark.

- `span(name)`: a context manager that records a `Record` (name, start,
  end, parent, request, id) on `time.perf_counter`, the clock of the
  benchmark's own spans (`benchmark/harness.py::Spans`). `parent` is the id
  of the span open on this thread when this one opened (each thread keeps
  its own stack: the mesh renders each slab on a host thread of its own),
  `request` the id of the outermost open span (a frame's `render.tiles`, a
  training group's `group`). Records go to a bounded buffer
  (`MAX_RECORDS`, oldest dropped): `records()` returns them, `reset()`
  clears them and the counters.
- `count(name, n)`: a host counter; `count_device(name, mask)`: adds the
  true elements of `mask` to an int64 counter on its device, with no
  synchronisation, and never inside a CUDA graph capture. The masks are
  kept and summed `FOLD` at a time (three device operations for the lot:
  one per call would add two small kernels to every call, which the
  device trace would show). `counters()` sums what is left and reads them
  all (one synchronisation per device counter).
- `device_span(name, device)`: a `span`, and on a CUDA device also a pair
  of timing events recorded on the device's current stream at its entry
  and exit (none while the stream captures a CUDA graph): the span's
  stretch of the stream, which `device_times()` reads once the work is
  done (the traced slice ends in a synchronise). Nothing is recorded,
  allocated or synchronised while tracing is off.
- `count_launch(counts, key)`: adds one to a kernel wrapper's `LAUNCHES`
  dict (kept in the kernel's module), whether tracing is on or not (tests
  and `chip_smoke.py` read them).

Spans, device spans and the two counters above record only while a
`torch.profiler` records (`torch.autograd._profiler_enabled()`) or between
`enable()` and `disable()`. Off, a span costs one check and returns a
shared no-op: no clock read, no allocation, no device work. Spans are not
profiler annotations (`record_function`): the benchmark takes every device
event of a name it does not know for a device operation, and an annotation
would count as busy time on the card.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled

MAX_RECORDS = 1 << 16
FOLD = 64   # masks a device counter keeps before it sums them


class Record(NamedTuple):
    name: str
    start: float               # time.perf_counter() seconds
    end: float
    parent: Optional[int]      # id of the span open on this thread at the start, or None
    request: int               # id of the outermost span open on this thread (its own if none)
    id: int


_records: "collections.deque[Record]" = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count()
_local = threading.local()
_lock = threading.Lock()
_enabled = False
_host: Dict[str, int] = {}
_device: Dict[tuple, torch.Tensor] = {}          # (name, device) -> int64 counter
_pending: Dict[tuple, List[torch.Tensor]] = {}   # (name, device) -> masks not summed yet
_launch_lock = threading.Lock()
# (span id, start event, end event) of the device spans on a card
_timed: "collections.deque[tuple]" = collections.deque(maxlen=MAX_RECORDS)


def enable() -> None:
    """Record spans and counters until `disable()`, profiler or not."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def on() -> bool:
    """Whether spans and counters record now."""
    return _enabled or _profiler_enabled()


class _Span:
    __slots__ = ("name", "id", "parent", "request", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.request = stack[0].id if stack else self.id
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _local.stack.pop()
        _records.append(Record(self.name, self.start, end, self.parent, self.request, self.id))
        return False


class _DeviceSpan(_Span):
    __slots__ = ("device", "begin")

    def __init__(self, name: str, device: torch.device):
        super().__init__(name)
        self.device = device

    def __enter__(self):
        super().__enter__()
        self.begin = None
        if self.device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
            self.begin = torch.cuda.Event(enable_timing=True)
            self.begin.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        if self.begin is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            _timed.append((self.id, self.begin, end))
        return super().__exit__(*exc)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A span named `name` around a `with` block (a no-op while off)."""
    if _enabled or _profiler_enabled():
        return _Span(name)
    return _OFF


def device_span(name: str, device):
    """`span(name)` that also times its stretch of `device`'s current stream
    when that is a CUDA device (a no-op while off)."""
    if _enabled or _profiler_enabled():
        return _DeviceSpan(name, torch.device(device))
    return _OFF


def device_times() -> Dict[int, float]:
    """Device milliseconds of each device span on a card, by span id: the
    time between its two events on the stream (each end event waited for,
    so read it once the traced work has been synchronised)."""
    out = {}
    for span_id, begin, end in list(_timed):
        end.synchronize()
        out[span_id] = begin.elapsed_time(end)
    return out


def records() -> List[Record]:
    """The recorded spans, oldest first (each appended when it closed)."""
    return list(_records)


def self_times(recs: Iterable[Record]) -> Dict[int, float]:
    """Each span's seconds less what its child spans cover, by id (children
    nest inside their parent on one thread and do not overlap)."""
    recs = list(recs)
    out = {r.id: r.end - r.start for r in recs}
    for r in recs:
        if r.parent in out:
            out[r.parent] -= r.end - r.start
    return out


def count(name: str, n: int) -> None:
    """Add n to the host counter `name` while tracing is on."""
    if _enabled or _profiler_enabled():
        with _lock:
            _host[name] = _host.get(name, 0) + int(n)


def count_device(name: str, mask: torch.Tensor) -> None:
    """Add the number of true elements of `mask` to the counter `name` on
    the mask's device while tracing is on: the mask is kept, and every
    `FOLD` masks are summed into the counter on the device, with no
    synchronisation. Nothing while the stream captures a CUDA graph (a
    replay would not count)."""
    if not (_enabled or _profiler_enabled()):
        return
    if mask.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    key = (name, mask.device)
    with _lock:
        masks = _pending.setdefault(key, [])
        masks.append(mask)
        if len(masks) >= FOLD:
            _fold(key)


def _fold(key: tuple) -> None:
    """Sum a device counter's kept masks into it (under `_lock`)."""
    masks = _pending.pop(key, [])
    if not masks:
        return
    acc = _device.get(key)
    if acc is None:
        acc = _device[key] = torch.zeros((), dtype=torch.int64, device=key[1])
    acc.add_(torch.cat([m.reshape(-1) for m in masks]).sum())


def count_launch(counts: Dict[str, int], key: str) -> None:
    """Add one to a wrapper's launch count: under a lock of its own, since
    the slabs of a mesh launch from a host thread each."""
    with _launch_lock:
        counts[key] += 1


def counters() -> Dict[str, int]:
    """The host and device counters by name."""
    with _lock:
        for key in list(_pending):
            _fold(key)
        out = dict(_host)
        for (name, _), acc in _device.items():
            out[name] = out.get(name, 0) + int(acc)
    return out


def reset() -> None:
    """Clear the spans, the device spans' events and the host and device
    counters."""
    with _lock:
        _records.clear()
        _timed.clear()
        _host.clear()
        _device.clear()
        _pending.clear()
