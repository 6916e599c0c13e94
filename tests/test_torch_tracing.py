"""The port's span recorder (``pamnet_tpu_torch/profiling.py``) on the CPU:
off outside a profile, on for every thread inside one, the spans of a
pipelined training epoch and of concurrent scoring requests, their export
into ``profiling.trace``'s Chrome trace, their self-time segments, and the
benchmark's nine readers of them over hand-made span lists.  One test,
marked ``gpu``, holds a span against the card's record of the kernel inside
it (``python -m pytest --noconftest tests/test_torch_tracing.py -m gpu`` on
the card)."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import json
import os
import sys
import tempfile
import threading
import urllib.request
from collections import defaultdict

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from benchmark import run as bench_run
from pamnet_tpu_torch import profiling, serve
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset, synthetic_rna_dataset
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.profiling import Span
from pamnet_tpu_torch.train.ema import ema_init
from pamnet_tpu_torch.train.loop import Optimizer, StackedEval, mae, run_epoch
from pamnet_tpu_torch.train.schedules import constant
from pamnet_tpu_torch.weights import init_params

QM9 = dict(dataset="QM9", dim=16, n_layer=1, cutoff_l=5.0, cutoff_g=5.0,
           compute_dtype="bfloat16")
RNA = dict(dataset="rna_serve", dim=16, n_layer=1, cutoff_l=2.6, cutoff_g=20.0,
           flow="target_to_source")
STEP = ("pipeline.queue_wait", "step.forward", "step.backward", "step.update")
SERVE = ("serve.parse", "serve.validate", "serve.lock_wait", "loader.build", "loader.collate",
         "serve.h2d", "serve.forward", "serve.d2h", "serve.reply")


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _qm9_training(n: int = 12):
    loader = GraphLoader(synthetic_qm9_dataset(n, seed=0), "qm9", 5.0, 5.0, batch_size=4,
                         shuffle=True, build_perms=True, wire_geometry="derive")
    model = PAMNet(PAMNetConfig(**QM9), torch.Generator().manual_seed(0))
    optimizer = Optimizer(model.parameters(), constant(1e-4))
    return loader, model, optimizer, ema_init(model.state_dict())


@pytest.fixture(scope="module")
def server():
    service = serve.RNAScoringService(init_params(PAMNetConfig(**RNA),
                                                  torch.Generator().manual_seed(1)),
                                      PAMNetConfig(**RNA), batch_size=2, device="cpu")
    httpd = serve.make_server(service, "127.0.0.1", 0, "test")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(30)
    assert not thread.is_alive()


def _post(url: str, mol: dict) -> dict:
    body = json.dumps({"molecules": [{"z": mol["z"].tolist(),
                                      "pos": mol["pos"].tolist()}]}).encode()
    req = urllib.request.Request(url + "/score", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _rna_mols(n: int) -> list[dict]:
    return synthetic_rna_dataset(n, seed=3, n_atoms=40)


def test_nothing_is_recorded_outside_a_profile(server):
    """Off: a pipelined epoch and a served request record nothing, and
    ``span`` hands out one shared object."""
    loader, model, optimizer, ema = _qm9_training(8)
    run_epoch(model, optimizer, ema, loader, "cpu", "l1")
    assert _post(server, _rna_mols(1)[0])["scores"]
    assert profiling.spans() == [] and profiling.dropped() == 0
    assert profiling.span("a") is profiling.span("b", ref=3)
    with profiling.span("a") as s:
        assert s is profiling.span("c")


def test_the_switch_is_process_global():
    """A thread started inside a profile records: the recorder reads PyTorch's
    process-global flag, which a thread-local check would miss there."""
    assert profiling._autograd_profiler._is_profiler_enabled is False
    with _cpu_profile():
        assert torch.autograd._profiler_enabled()

        def work():
            assert not torch.autograd._profiler_enabled()  # the thread-local view
            with profiling.span("thread.work", ref="r"):
                pass

        t = threading.Thread(target=work, name="started-inside")
        t.start()
        t.join(30)
        assert not t.is_alive()
    assert profiling._autograd_profiler._is_profiler_enabled is False
    (rec,) = profiling.spans()
    assert (rec.name, rec.thread, rec.ref, rec.parent) == ("thread.work", "started-inside", "r",
                                                           None)
    assert rec.tid == t.native_id and rec.start_ns <= rec.end_ns


def test_a_pipelined_epoch_records_each_batch_on_its_thread():
    loader, model, optimizer, ema = _qm9_training(12)
    stats = {}
    with _cpu_profile():
        _, _, _, steps = run_epoch(model, optimizer, ema, loader, "cpu", "l1", stats=stats)
    recs = profiling.spans()
    by = defaultdict(list)
    for r in recs:
        by[r.name].append(r)
    assert steps == 3
    assert sorted(r.ref for r in by["loader.collate"]) == [0, 1, 2]
    assert {r.thread for r in by["loader.collate"]} == {"pamnet-prefetch"}
    assert sorted(r.ref for r in by["pipeline.stage"]) == [0, 1, 2]
    assert {r.thread for r in by["pipeline.stage"]} == {"pamnet-stage"}
    for name in STEP:  # the step thread's spans of batch k carry k (the last wait: the end)
        assert {r.thread for r in by[name]} == {"MainThread"}, name
        assert sorted(r.ref for r in by[name])[:3] == [0, 1, 2], name
    assert len(by["pipeline.queue_wait"]) == 4 and len(by["epoch.drain"]) == 1
    waited = sum(r.end_ns - r.start_ns for r in by["pipeline.queue_wait"]) / 1e9
    assert stats["queue_wait_s"] == pytest.approx(waited, abs=1e-6)
    # bf16: each forward casts once inside step.forward, each backward once.
    forwards = {r.id: r for r in by["step.forward"]}
    casts = [r for r in by["nn.cast"] if r.parent in forwards]
    assert len(casts) == 3 and all(forwards[c.parent].ref == c.ref for c in casts)
    assert len(by["nn.cast"]) == 6
    # On the step thread the spans follow each other in time.
    main = sorted((r for r in recs if r.thread == "MainThread" and r.parent is None),
                  key=lambda r: r.start_ns)
    assert all(a.end_ns <= b.start_ns for a, b in zip(main, main[1:]))


def test_an_evaluation_and_a_data_parallel_step_record_their_spans():
    """``StackedEval.predict`` is ``eval.predict`` with its split as ``ref``;
    ``dp_train_step`` adds ``step.all_reduce`` between backward and update
    (one gloo rank)."""
    loader, model, optimizer, ema = _qm9_training(8)
    split = StackedEval(loader, "cpu", verbose=False, split="val")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rdv')}",
                                rank=0, world_size=1)
        try:
            with _cpu_profile():
                mae(model, split, "cpu")
                run_epoch(model, optimizer, ema, loader, "cpu", "l1", dp=2)
        finally:
            dist.destroy_process_group()
    recs = profiling.spans()
    (ev,) = [r for r in recs if r.name == "eval.predict"]
    assert ev.ref == "val" and ev.thread == "MainThread"
    steps = sorted((r for r in recs if r.name.startswith("step.")), key=lambda r: r.start_ns)
    assert [r.name for r in steps[:4]] == ["step.forward", "step.backward", "step.all_reduce",
                                           "step.update"]


def test_concurrent_requests_record_their_trees(server):
    mols = _rna_mols(2)
    with _cpu_profile():
        threads = [threading.Thread(target=_post, args=(server, m)) for m in mols]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    recs = profiling.spans()
    requests = [r for r in recs if r.name == "serve.request"]
    assert len(requests) == 2 and len({r.ref for r in requests}) == 2
    by_id = {r.id: r for r in recs}
    for req in requests:
        mine = [r for r in recs if r.ref == req.ref and r is not req]
        assert sorted(r.name for r in mine) == sorted(SERVE + ("build.graph", "build.basis"))
        for r in mine:
            assert r.thread == req.thread
            parent = by_id[r.parent]
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
            want = "loader.build" if r.name.startswith("build.") else "serve.request"
            assert parent.name == want, r.name


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    loader, model, optimizer, ema = _qm9_training(8)
    with _cpu_profile():  # an earlier profile's span stays out of the trace
        with profiling.span("before.the.trace"):
            pass
    with profiling.trace(str(tmp_path), "cpu", "epoch"):
        run_epoch(model, optimizer, ema, loader, "cpu", "l1")
    doc = json.loads((tmp_path / "epoch.json").read_text())
    events = doc["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program_span"]
    recs = {r.id: r for r in profiling.spans() if r.name != "before.the.trace"}
    assert len(mine) == len(recs) == len(profiling.spans()) - 1
    assert {e["name"] for e in mine} >= set(STEP)
    base = doc["baseTimeNanoseconds"]
    for e in mine:
        r = recs[e["args"]["id"]]
        assert e["ph"] == "X" and e["pid"] == os.getpid() and e["tid"] == r.tid
        assert e["ts"] == pytest.approx((r.start_ns - base) / 1e3)
        assert e["dur"] == pytest.approx((r.end_ns - r.start_ns) / 1e3)
        assert e["args"]["parent"] == r.parent and e["args"]["ref"] == r.ref
    named = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {e["tid"] for e in mine} <= set(named)
    # The profiler's ops of the step thread lie inside its backward spans there.
    backward = [e for e in mine if e["name"] == "step.backward"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("tid") == backward[0]["tid"]
           and e["name"] == "autograd::engine::evaluate_function: _CastAllBackward"]
    assert ops and all(any(b["ts"] <= op["ts"] <= b["ts"] + b["dur"] for b in backward)
                       for op in ops)


def _span(name, start, end, id_, parent=None, thread="T", ref=None):
    return Span(name, thread, 1, id_, parent, ref, start, end)


def test_host_spans_are_self_time_segments(monkeypatch):
    """Each instant under its innermost span, parents resumed around their
    children, other threads filtered, neighbours of one name merged."""
    recs = [
        _span("step.forward", 0, 100, 1),
        _span("nn.cast", 10, 20, 2, parent=1),
        _span("step.backward", 100, 200, 3),
        _span("nn.cast", 150, 160, 4, parent=3),
        _span("loader.collate", 5, 300, 5, thread="P"),
        _span("pipeline.queue_wait", 200, 210, 6),
        _span("pipeline.queue_wait", 210, 220, 7),
        _span("step.forward", 250, 260, 8),
    ]
    monkeypatch.setattr(profiling, "_records", recs)
    assert profiling.host_spans("T") == [
        ("step.forward", 0, 10), ("nn.cast", 10, 20), ("step.forward", 20, 100),
        ("step.backward", 100, 150), ("nn.cast", 150, 160), ("step.backward", 160, 200),
        ("pipeline.queue_wait", 200, 220), ("step.forward", 250, 260)]
    every = profiling.host_spans()
    assert all(a[2] <= b[1] for a, b in zip(every, every[1:]))
    assert ("loader.collate", 220, 250) in every and every[-1] == ("loader.collate", 260, 300)


def test_spans_nest_take_their_parents_ref_and_survive_an_error():
    with _cpu_profile():
        with profiling.span("outer", ref=7):
            with pytest.raises(ValueError):
                with profiling.span("inner"):
                    raise ValueError("x")
            with profiling.span("other", ref=8):
                pass
        with profiling.span("top"):
            pass
    inner, other, outer, top = profiling.spans()
    assert (inner.name, inner.parent, inner.ref) == ("inner", outer.id, 7)
    assert (other.parent, other.ref) == (outer.id, 8)
    assert (top.parent, top.ref) == (None, None)


def test_the_recorder_holds_at_most_max_spans(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with _cpu_profile():
        for _ in range(5):
            with profiling.span("s"):
                pass
    assert len(profiling.spans()) == 3 and profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_threads_racing_to_record_lose_no_span(monkeypatch):
    """More threads than cores, the interpreter switching threads every
    microsecond: each span is held or counted dropped, ids never repeat, and
    each thread's parents stay its own."""
    threads_n, each = 4 * (os.cpu_count() or 1), 500
    monkeypatch.setattr(profiling, "MAX_SPANS", threads_n * each * 3 // 4)  # a quarter dropped

    def work():
        for _ in range(each // 2):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            threads = [threading.Thread(target=work) for _ in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    recs = profiling.spans()
    assert len(recs) == threads_n * each * 3 // 4
    assert len(recs) + profiling.dropped() == threads_n * each
    assert len({r.id for r in recs}) == len(recs)
    by_id = {r.id: r for r in recs}
    assert all(by_id[r.parent].thread == r.thread for r in recs if r.parent in by_id)


# The benchmark's readers over hand-made spans, in a 10 s window: two
# requests of 1 s (0.6 s waiting on the lock in all), two builds of 0.25 s
# (0.2 s of basis in all), a collation of 0.1 s; 2 s of forwards (0.5 s of
# casts inside, 0.25 s more on the autograd thread), 3 s of backwards, 1 s
# of updates, 4 s of collation and 0.5 s of staging on threads of their own.
S = 10 ** 9
HAND = [
    _span("serve.request", 0, S, 1), _span("serve.request", S, 2 * S, 2),
    _span("serve.lock_wait", 0, S // 10, 3, 1), _span("serve.lock_wait", S, S + S // 2, 4, 2),
    _span("loader.build", 0, S // 4, 5, 1), _span("loader.build", S, S + S // 4, 6, 2),
    _span("build.basis", 0, S // 10, 7, 5), _span("build.basis", S, S + S // 10, 8, 6),
    _span("loader.collate", 0, S // 10, 9, 1),
    _span("step.forward", 0, 2 * S, 10), _span("nn.cast", 0, S // 2, 11, 10),
    _span("nn.cast", 0, S // 4, 12, thread="autograd"),
    _span("step.backward", 0, 3 * S, 13), _span("step.update", 0, S, 14),
    _span("loader.collate", 0, 4 * S, 15, thread="P"),
    _span("pipeline.stage", 0, S // 2, 16, thread="Q"),
]
READINGS = {
    "lock_wait_share.score": 30.0,
    "graph_build_share.score": 100.0 * (0.5 + 4.1) / 10,
    "basis_share.score": 40.0,
    "collate_share.train": 41.0,
    "stage_share.train": 5.0,
    "step_forward_share.train": 20.0,
    "step_backward_share.train": 30.0,
    "step_update_share.train": 10.0,
    "param_cast_share.train": 7.5,
}


def test_the_readers_are_the_benchmarks_new_per_layer_metrics():
    entries = {m["name"]: m for m in bench_run.benchmark_file()["per_layer"]
               if m["source"] == "program_span"}
    assert set(entries) == set(READINGS)


@pytest.mark.parametrize("name", sorted(READINGS))
def test_a_reader_reads_the_spans(name, monkeypatch):
    monkeypatch.setattr(profiling, "_records", list(HAND))
    got = bench_run.metric_reader(name).read({"window_s": 10.0})
    assert got == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_a_reader_reads_nothing_without_spans_or_with_dropped_ones(name, monkeypatch):
    reader = bench_run.metric_reader(name)
    assert reader.read({"window_s": 10.0}) is None  # nothing recorded (an untraced run)
    monkeypatch.setattr(profiling, "_records", list(HAND))
    monkeypatch.setattr(profiling, "_dropped", 1)
    assert reader.read({"window_s": 10.0}) is None
    monkeypatch.setattr(profiling, "_dropped", 0)
    monkeypatch.delattr(profiling, "spans")  # a program without the recorder
    assert reader.read({"window_s": 10.0}) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_span_brackets_the_card_record_of_its_kernel(cuda):
    """The spans' clock (``time.time_ns``) is the profiler's: a span around a
    kernel and ``torch.cuda.synchronize()`` holds the kernel's CUDA record."""
    x = torch.randn(4096, 4096, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling.span("probe"):
            (x @ x).sum()
            torch.cuda.synchronize()
    (probe,) = profiling.spans()
    kernels = [ev for ev in prof.profiler.kineto_results.events()
               if str(ev.device_type()).endswith("CUDA") and not ev.is_user_annotation()]
    assert kernels
    for ev in kernels:
        assert probe.start_ns <= ev.start_ns() <= ev.end_ns() <= probe.end_ns, ev.name()
