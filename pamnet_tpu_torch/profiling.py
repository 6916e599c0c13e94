"""Reading ``torch.profiler`` records: which are work on the card, their
device time, and a profiled run's kernel launches and device time by
kernel name.  ``chip_smoke.py`` reads its profiles through these."""

from __future__ import annotations

NAME_CHARS = 120


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
