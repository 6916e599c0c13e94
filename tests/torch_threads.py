"""The intra-op thread count of PyTorch in the port's test processes.

Under ``pytest -n N`` each of the N worker processes would run PyTorch with
one intra-op thread per core, N times as many threads as the host has cores,
and every small op's parallel region then waits on threads that are not
scheduled.  Each ``tests/test_torch_*.py`` module calls
``limit_intra_op_threads()`` when it is imported, which every worker does
while it collects, before any test runs.  The port itself never sets the
count: its users' processes keep PyTorch's default.
"""

from __future__ import annotations

import os

import torch


def intra_op_threads() -> int:
    """The host's usable cores shared among the run's worker processes
    (``PYTEST_XDIST_WORKER_COUNT``, which xdist sets in each worker; one
    process without it), at least one."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    return max(1, (cores or 1) // max(1, workers))


def limit_intra_op_threads() -> None:
    """Give PyTorch ``intra_op_threads()`` intra-op threads in this process."""
    want = intra_op_threads()
    if torch.get_num_threads() != want:
        torch.set_num_threads(want)
