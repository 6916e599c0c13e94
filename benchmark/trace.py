"""The device trace of a measured window and what the metrics read from it.

``DeviceTrace`` profiles the window with ``torch.profiler`` (CUDA activity:
the card's kernels, copies and sets) and reduces the records to

* ``busy_s``: the union of the card's intervals inside the window, user
  annotations left out, so work on two streams at once counts once (the
  arithmetic of ``pamnet_tpu_torch/profiling.py::device_busy_s`` at
  commit 3e9441f, clipped to the window);
* ``kernel_s``: device seconds by kernel name, and ``port_kernel_s``, the
  seconds of the kernels whose names hold a token of
  ``counts/port_kernels*.json`` (the port's own kernels);
* the breakdown: the ten device operations that took most time, and the
  idle time grouped by what the host was doing (the host spans the driver
  recorded, by ``time.time_ns()``, the profiler's clock).
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

NAME_CHARS = 120
_HERE = Path(__file__).resolve().parent


def port_kernel_tokens() -> list[str]:
    """The tokens of every ``counts/port_kernels*.json`` (a kernel the port
    gains later comes with a file of its own)."""
    return sorted({t for f in (_HERE / "counts").glob("port_kernels*.json")
                   for t in json.loads(f.read_text())["kernels"]})


class DeviceTrace:
    """Context manager over a measured window; ``reduce`` after it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, supported_activities

        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("this PyTorch cannot trace the card (no CUPTI)")
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def reduce(self, t0_ns: int, t1_ns: int, host_spans: list, idle_label: str) -> dict:
        """The window [t0_ns, t1_ns]'s device facts.  ``host_spans``:
        (label, start_ns, end_ns) of what the host did; an idle gap takes
        the label of the span around its middle, else ``idle_label``."""
        tokens = port_kernel_tokens()
        spans, by_name = [], {}
        for ev in self.prof.profiler.kineto_results.events():
            if not str(ev.device_type()).endswith("CUDA") or ev.is_user_annotation():
                continue
            start, stop = max(ev.start_ns(), t0_ns), min(ev.end_ns(), t1_ns)
            if stop <= start:
                continue
            spans.append((start, stop))
            name = ev.name()[:NAME_CHARS]
            by_name[name] = by_name.get(name, 0) + stop - start
        spans.sort()
        busy, end, gaps = 0, t0_ns, []
        for start, stop in spans:
            if start > end:
                gaps.append((end, start))
            busy += max(0, stop - max(start, end))
            end = max(end, stop)
        if t1_ns > end:
            gaps.append((end, t1_ns))
        host_spans = sorted(host_spans, key=lambda s: s[1])
        starts = [s[1] for s in host_spans]
        idle: dict[str, list] = {}
        for a, b in gaps:
            mid = (a + b) // 2
            k = bisect.bisect_right(starts, mid) - 1
            label = host_spans[k][0] if k >= 0 and mid < host_spans[k][2] else idle_label
            row = idle.setdefault(label, [0, 0, 0])
            row[0] += b - a
            row[1] += 1
            row[2] = max(row[2], b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {
            "busy_s": busy / 1e9,
            "window_s": (t1_ns - t0_ns) / 1e9,
            "records": len(spans),
            "kernel_s": {k: v / 1e9 for k, v in by_name.items()},
            "port_kernel_s": sum(v for k, v in by_name.items()
                                 if any(t in k for t in tokens)) / 1e9,
            "device_ops": [[k, v / 1e9] for k, v in ops],
            "idle_gaps": [[f"{label} ({count} gaps, longest {longest / 1e6:.3f} ms)", total / 1e9]
                          for label, (total, count, longest)
                          in sorted(idle.items(), key=lambda kv: -kv[1][0])[:10]],
        }
