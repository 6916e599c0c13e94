"""The FLOP and byte counts against hand counts at a tiny size, and the
metric readers' arithmetic."""

from __future__ import annotations

import pytest

from benchmark import run
from benchmark.counts import pamnet as counts

TINY = {"kind": "qm9", "dim": 2, "n_layer": 1, "num_spherical": 2, "num_radial": 1,
        "num_rbf": 1, "compute_dtype": "float32", "folded": False}
C = {"n": 3, "eg": 4, "el": 2, "t2": 1, "t1": 2}


def test_forward_flops_by_hand():
    # rbf MLPs (eg + el) * 1 * 2 = 12; sbf MLPs (t2 + t1) * 2 * 2 = 12 MACs.
    # Node layers: 3 * (11 * 4 + 2 * 2) = 144 MACs each plex; global edges
    # 4 * (3 * 4 + 4) = 64; local edges 2 * (6 * 4 + 2 * 4) = 64, triplets
    # 3 * 2 * 4 = 24.
    assert counts.forward_flops(TINY, C) == 2.0 * (12 + 12 + 144 + 64 + 144 + 64 + 24)


def test_mp_bytes_by_hand():
    b, i, d, n, eg, el = 4, 4, 2, 3, 4, 2
    emb = 5 * d * 4 + n * i + n * d * 4
    glob = 2 * n * d * b + 2 * eg * d * b + eg * b + 2 * eg * i + (n + 1) * i + n * d * b
    msgs = sum(2 * n * d * b + (1 + g) * el * d * b + 2 * el * i + el * d * b for g in (0, 1))
    streams = sum(el * 2 * 1 * b + t * i + t * 2 * b + el * d * b + t * d * b + t * i
                  + (el + 1) * i + el * d * b for t in (1, 2))
    gated = 2 * el * d * b + (n + 1) * i + n * d * b
    assert counts.mp_bytes(TINY, C) == emb + glob + msgs + streams + gated


def test_backward_and_bf16_and_folded_counts_grow_as_they_should():
    fwd = counts.mp_bytes(TINY, C)
    assert counts.mp_bytes(TINY, C, backward=True) > 2 * fwd
    half = counts.mp_bytes(dict(TINY, compute_dtype="bfloat16"), C)
    assert half < fwd
    folded = dict(TINY, folded=True)
    assert counts.mp_bytes(folded, C) != fwd
    # Linear in the counts: two batches count as their sum.
    double = {k: 2 * v for k, v in C.items()}
    assert counts.forward_flops(TINY, double) == 2 * counts.forward_flops(TINY, C)


@pytest.mark.parametrize("name,facts,want", [
    ("train_graphs_per_s", {"graphs": 100, "window_s": 4.0}, 25.0),
    ("scored_per_s", {"scored": 30, "window_s": 10.0}, 3.0),
    ("score_p95_s", {"latencies_s": [float(k) for k in range(1, 101)]}, 95.05),
    ("setup_s", {"setup_s": 12.5}, 12.5),
    ("batch_wait_share.train", {"queue_wait_s": 1.0, "window_s": 4.0}, 25.0),
    ("eval_share.train", {"eval_s": 0.5, "window_s": 10.0}, 5.0),
    ("mfu.train", {"flops": 1e12, "graphs": 1, "window_s": 1.0, "peak_flops": 1e14}, 1.0),
    ("mfu.score", {"flops": 1e12, "scored": 1, "window_s": 2.0, "peak_flops": 1e14}, 0.5),
    ("kernels_roofline.train", {"mp_bytes": 3.35e9, "port_kernel_s": 0.01}, 10.0),
    ("device_idle_share.score", {"busy_s": 1.0, "trace_window_s": 4.0}, 75.0),
    ("host_build_share.score", {"host_build_s": 3.0, "window_s": 4.0}, 75.0),
])
def test_metric_readers(name, facts, want):
    assert run.metric_reader(name).read(facts) == pytest.approx(want)


@pytest.mark.parametrize("name", ["kernels_roofline.score", "device_idle_share.train",
                                  "mfu.train", "host_build_share.score"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert run.metric_reader(name).read({"window_s": 1.0}) is None
