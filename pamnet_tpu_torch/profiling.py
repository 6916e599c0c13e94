"""Timing calls on the card and reading ``torch.profiler`` records: the
event-timed mean of a call, the card's own time of the kernels it launches,
which records are work on the card, the seconds the card was busy in a
profiled span, and a profiled run's kernel launches and device time by
kernel name.  ``bench.py`` and ``chip_smoke.py``'s kernel phases time and
read their profiles through these; ``device_busy_s`` is the arithmetic that
the benchmark's busy time copies (``benchmark/trace.py``).  ``trace`` writes
a profiled span (``main_qm9 --trace_dir``: epoch 0) as a Chrome trace, with
the program's spans in it.

The span recorder: the program marks the work at each layer boundary with
``span(name, ref)`` (the step's phases, the epoch pipeline's threads, the
scoring request's stages; the names are listed in PERF.md).  It records
exactly while a ``torch.profiler`` profile runs in the process, on every
thread, and does nothing otherwise: the switch is PyTorch's process-global
``torch.autograd.profiler._is_profiler_enabled``, which every profile sets
and which, unlike ``torch.autograd._profiler_enabled()`` and
``record_function``, is true on threads started inside the profile too
(the collation, staging and HTTP handler threads).  Each record holds its
name, thread, id, parent (the span open on the same thread when it
started), ``ref`` (what a batch's or a request's spans share across
threads; a span given none takes its parent's) and start and end by
``time.time_ns()``, the clock of the profiler's records.  Spans are not
profiler annotations, so nothing of them enters ``is_kernel`` or
``device_busy_s``.  The records stay in memory (at most ``MAX_SPANS``;
``dropped()`` counts the rest) until ``clear()``: ``spans()`` reads them,
``host_spans()`` gives them as self-time segments.  The recorder is one
per process, as the profiler's switch is."""

from __future__ import annotations

import contextlib
import heapq
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

NAME_CHARS = 120


def time_ms(fn, iters: int = 20, warmup: int = 3, cuda: bool = True) -> float:
    """Mean time of one call over ``iters`` calls in a row, after ``warmup``
    calls: by CUDA events around the calls on the card, by the host's clock
    where ``cuda`` is false (the CPU)."""
    for _ in range(warmup):
        fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, tries: int = 3) -> float | None:
    """Mean device time of the kernels one call launches, from the profiler's
    kernel records over ``iters`` calls: the card's own time, where an
    event-timed run of small calls measures the host's issue rate.  The
    profiler can drop records of a run, so each kernel counts its mean
    record times its launches per call (records over calls, rounded, at
    least one), not its total over ``iters``.  A profile that recorded no
    kernel is taken again; None ("not measured") after ``tries`` such
    profiles."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(device_us(ev) / ev.count * max(1, round(ev.count / iters))
                 for ev in prof.key_averages() if is_kernel(ev))
        if us > 0:
            return us / 1e3
    return None


def device_us(ev) -> float:
    """The card's own time of a profiler record, in microseconds."""
    return getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))


def is_kernel(ev) -> bool:
    """A record of work on the card (not a host op or an autograd node that
    the card's time is also attributed to).  A user annotation on the card,
    such as the optimizer's ``Optimizer.step#Adam.step``, counts too, though
    its span covers the kernels inside it: every profile total of the port
    has counted it so, and they stay comparable."""
    return str(getattr(ev, "device_type", "")).endswith("CUDA") and device_us(ev) > 0


def device_busy_s(prof) -> float:
    """The seconds in which the card did work during a profiled span: the
    union of the intervals of its kernels, copies and sets (user annotations
    left out), so work on two streams at once counts once.  Read from the
    profiler's raw records, which a long span (an epoch: ~10^5 records)
    leaves too many of for ``key_averages``."""
    spans = sorted((ev.start_ns(), ev.end_ns()) for ev in prof.profiler.kineto_results.events()
                   if str(ev.device_type()).endswith("CUDA") and not ev.is_user_annotation())
    busy, end = 0, 0
    for start, stop in spans:
        busy += max(0, stop - max(start, end))
        end = max(end, stop)
    return busy / 1e9


def kernel_totals(events, calls: int) -> dict:
    """Kernel launches and device ms per call of ``calls`` profiled calls,
    in total and by kernel name (``[launches, ms]`` per call), from the
    records of ``prof.key_averages()``.  Names are cut to ``NAME_CHARS``
    characters; records whose cut names meet are added together, so every
    record counts once."""
    by_name: dict[str, list[float]] = {}
    for ev in events:
        if not is_kernel(ev):
            continue
        row = by_name.setdefault(ev.key[:NAME_CHARS], [0.0, 0.0])
        row[0] += ev.count / calls
        row[1] += device_us(ev) / calls / 1e3
    return {"kernel_launches": sum(r[0] for r in by_name.values()),
            "device_ms": sum(r[1] for r in by_name.values()),
            "by_name": dict(sorted(by_name.items()))}


@contextlib.contextmanager
def trace(log_dir: str, device, name: str = "trace"):
    """Profile the span with ``torch.profiler`` (CPU activity, and CUDA
    activity where ``device`` is a card) and write it to
    ``<log_dir>/<name>.json`` as a Chrome trace (the JAX package's
    ``utils/profiling.py::trace`` writes a device trace of the same span),
    the program's spans recorded during the profile added to it as
    complete events on their threads.  On a card
    the CUDA activity is required: where the profiler cannot trace the card
    (no CUPTI), or recorded no kernel, it raises rather than write a trace
    of the host alone."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("trace: this PyTorch cannot trace the card (no CUPTI); "
                               "refusing to write a trace of the host alone")
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        first = next(_ids)  # every span recorded inside the profile has a larger id
        yield prof
        if cuda:
            torch.cuda.synchronize()
    if cuda and not any(is_kernel(ev) for ev in prof.key_averages()):
        raise RuntimeError("trace: the profiler recorded no work on the card (CUPTI "
                           "unavailable?); refusing to write a trace of the host alone")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    _add_spans_to_trace(path, [s for s in spans() if s.id > first])


# ---- the span recorder (module docstring) ----------------------------------

MAX_SPANS = 1_000_000


class Span(NamedTuple):
    """One recorded span: ``tid`` is the thread's native id (the Chrome
    trace's ``tid``), ``parent`` the id of the span open on the same thread
    when it started (None at the thread's top)."""

    name: str
    thread: str
    tid: int
    id: int
    parent: int | None
    ref: object
    start_ns: int
    end_ns: int


_records: list[Span] = []
_dropped = 0
_records_lock = threading.Lock()
_ids = itertools.count(1)
_open = threading.local()  # .stack: the thread's open spans, innermost last


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _NoSpan:
    """The span while no profile runs: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    """A span being recorded, placed under the thread's open span."""

    __slots__ = ("name", "id", "parent", "ref", "start_ns")

    def __init__(self, name: str, ref):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.name, self.id = name, next(_ids)
        self.parent = None if parent is None else parent.id
        self.ref = parent.ref if ref is None and parent is not None else ref

    def __enter__(self):
        _stack().append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = time.time_ns()
        _stack().pop()
        self.add(self.start_ns, end_ns)
        return False

    def add(self, start_ns: int, end_ns: int) -> None:
        global _dropped
        thread = threading.current_thread()
        rec = Span(self.name, thread.name, thread.native_id, self.id, self.parent, self.ref,
                   start_ns, end_ns)
        with _records_lock:
            if len(_records) < MAX_SPANS:
                _records.append(rec)
            else:
                _dropped += 1


def span(name: str, ref=None):
    """A context manager that records the block as span ``name`` while a
    profile runs, else the shared no-op (nothing allocated)."""
    if _autograd_profiler._is_profiler_enabled:
        return _OpenSpan(name, ref)
    return _NO_SPAN


def record(name: str, start_ns: int, end_ns: int, ref=None) -> None:
    """Record a span the caller timed itself (``time.time_ns()`` reads that
    feed a counter of its own too), under the thread's open span, while a
    profile runs."""
    if _autograd_profiler._is_profiler_enabled:
        _OpenSpan(name, ref).add(start_ns, end_ns)


def spans() -> list[Span]:
    """The recorded spans, in the order they ended."""
    with _records_lock:
        return list(_records)


def dropped() -> int:
    """Spans not recorded because ``MAX_SPANS`` were held: a reader of the
    records reads nothing where this is not 0."""
    return _dropped


def clear() -> None:
    """Forget every recorded span and the dropped count."""
    global _dropped
    with _records_lock:
        _records.clear()
        _dropped = 0


def host_spans(thread: str | None = None) -> list[tuple[str, int, int]]:
    """The spans of ``thread`` (a thread name; None: every thread) as
    ``(name, start_ns, end_ns)`` self-time segments, in time order: they do
    not overlap, and each instant covered by a span falls in the segment of
    the latest-started span covering it (on one thread, its innermost), so
    a parent's time around a child keeps the parent's name.  Neighbouring
    segments of one name are merged.  This is the form
    ``benchmark/trace.py::DeviceTrace.reduce`` takes for its idle labels."""
    recs = sorted((s for s in spans() if thread is None or s.thread == thread),
                  key=lambda s: (s.start_ns, -s.end_ns))
    bounds = sorted({t for s in recs for t in (s.start_ns, s.end_ns)})
    out: list[list] = []
    heap: list = []  # (-start, order, end, name) of the spans begun so far
    k = 0
    for a, b in zip(bounds, bounds[1:]):
        while k < len(recs) and recs[k].start_ns <= a:
            s = recs[k]
            heapq.heappush(heap, (-s.start_ns, -k, s.end_ns, s.name))
            k += 1
        while heap and heap[0][2] <= a:
            heapq.heappop(heap)
        if not heap:
            continue
        name = heap[0][3]
        if out and out[-1][0] == name and out[-1][2] == a:
            out[-1][2] = b
        else:
            out.append([name, a, b])
    return [tuple(seg) for seg in out]


def _add_spans_to_trace(path: str, records: list[Span]) -> None:
    """Append ``records`` to the Chrome trace at ``path`` as complete
    events on their threads (this process's ``pid``, each thread's native
    id), in the trace's time base (``baseTimeNanoseconds``, microseconds),
    with each span's id, parent and ref as its arguments; a thread the
    trace does not name yet is named."""
    with open(path) as f:
        doc = json.load(f)
    base, pid = doc.get("baseTimeNanoseconds", 0), os.getpid()
    events = doc.setdefault("traceEvents", [])
    named = {ev.get("tid") for ev in events if ev.get("ph") == "M"
             and ev.get("name") == "thread_name" and ev.get("pid") == pid}
    for tid, thread in sorted({(s.tid, s.thread) for s in records}):
        if tid not in named:
            named.add(tid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                           "args": {"name": thread}})
    for s in records:
        ref = s.ref if s.ref is None or isinstance(s.ref, (int, float, str)) else str(s.ref)
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": s.tid, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent, "ref": ref}})
    with open(path, "w") as f:
        json.dump(doc, f)
