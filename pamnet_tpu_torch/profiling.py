"""Timing calls on the card and reading ``torch.profiler`` records: the
event-timed mean of a call, the card's own time of the kernels it launches,
which records are work on the card, the seconds the card was busy in a
profiled span, and a profiled run's kernel launches and device time by
kernel name.  ``chip_smoke.py`` and ``bench.py`` time
and read their profiles through these.  ``trace`` writes a profiled span
(``main_qm9 --trace_dir``: epoch 0) as a Chrome trace."""

from __future__ import annotations

import contextlib
import os
import time

import torch

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
    ``utils/profiling.py::trace`` writes a device trace of the same span).
    On a card the CUDA activity is required: where the profiler cannot
    trace the card (no CUPTI), or recorded no kernel, it raises rather than
    write a trace of the host alone."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("trace: this PyTorch cannot trace the card (no CUPTI); "
                               "refusing to write a trace of the host alone")
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    if cuda and not any(is_kernel(ev) for ev in prof.key_averages()):
        raise RuntimeError("trace: the profiler recorded no work on the card (CUPTI "
                           "unavailable?); refusing to write a trace of the host alone")
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))
