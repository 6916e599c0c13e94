"""Whole paths of the port on the card, at small sizes: what neither the
benchmark's cells (``python3 -m benchmark.run``) nor the kernels' card tests
(``tests/test_torch_cuda.py``) hold.  Each path is held to its plain route,
its serial route, another entry point or the one-process step.  The
launches of each path's step at its recipe are ``chip_smoke.py``'s
``LAUNCHES``.  Skipped without a CUDA card; on the card
``python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
tests/test_torch_card_paths.py``."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import contextlib
import io
import json
import math
import os
import re
import shutil
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from pamnet_tpu_torch import (inference_rna_puzzles, main_pdbbind, main_qm9, main_rna_puzzles,
                              preprocess_pdbbind, preprocess_rna_puzzles)
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data import loader as loader_mod
from pamnet_tpu_torch.data.batch import collate_structures
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule, synthetic_pdbbind_dataset,
                                             synthetic_qm9_dataset, synthetic_rna_dataset,
                                             write_raw_pdbbind, write_raw_rna_puzzles)
from pamnet_tpu_torch.data.tu import TUDataset, write_tu_split
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.ops import gather as gather_ops
from pamnet_tpu_torch.ops import sbf_modulate as sbf_ops
from pamnet_tpu_torch.ops import triplet as triplet_ops
from pamnet_tpu_torch.serve import RNAScoringService, make_server
from pamnet_tpu_torch.train import loop
from pamnet_tpu_torch.train.checkpoint import export_state_dict
from pamnet_tpu_torch.train.ema import ema_init
from pamnet_tpu_torch.train.loop import (Optimizer, StackedEval, batch_loss, dp_train_step,
                                         predict, run_epoch, train_step)
from pamnet_tpu_torch.train.schedules import constant, multistep, warmup_exponential
from pamnet_tpu_torch.weights import init_params, load_reference_checkpoint
from test_torch_cuda import _count_syncs

pytestmark = pytest.mark.gpu

COUNTERS = (gather_ops.edge_message, gather_ops.edge_message_sum, gather_ops.row_gather,
            gather_ops.edge_message_backward, sbf_ops.sbf_modulate,
            sbf_ops.sbf_modulate_backward, triplet_ops.triplet_aggregate,
            triplet_ops.triplet_aggregate_grad_ab, triplet_ops.gated_sum_backward,
            triplet_ops.group_sum, triplet_ops.group_sum_split)
QM9_SMALL = dict(dataset="QM9", dim=32, n_layer=2)
RNA = dict(dim=16, n_layer=1, cutoff_l=2.6, cutoff_g=20.0, flow="target_to_source")
PDBBIND = dict(dataset="PDBbind", dim=32, n_layer=2, cutoff_l=2.0, cutoff_g=6.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _launched(fn) -> list[int]:
    """The launches of each counted wrapper during ``fn()``."""
    before = [f.launches for f in COUNTERS]
    fn()
    return [f.launches - b for f, b in zip(COUNTERS, before)]


def _grads(model, gb, kind: str, plain: bool = False) -> dict:
    """Every parameter's gradient of the batch's loss (zeros where none)."""
    model.zero_grad()
    batch_loss(model, gb, kind, plain=plain).backward()
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in model.named_parameters()}


def _assert_grads_close(got: dict, want: dict) -> None:
    """Per tensor within 1e-4 * max|want| + 1e-6."""
    for name, w in want.items():
        assert float((got[name] - w).abs().max()) <= 1e-4 * float(w.abs().max()) + 1e-6, name


def _state(model, ema) -> list:
    return ([p.detach().clone() for p in model.parameters()]
            + ([] if ema is None else [v.clone() for v in ema.values()]))


def _repeat_step_bitwise(model, make_opt, ema, gb, kind: str) -> None:
    """One step from the same parameters and EMA twice, with a fresh
    optimizer each time: the loss, parameters and EMA bit for bit."""
    start = {k: v.clone() for k, v in model.state_dict().items()}
    ema_start = None if ema is None else {k: v.clone() for k, v in ema.items()}
    runs = []
    for _ in range(2):
        model.load_state_dict(start)
        if ema is not None:
            for k, v in ema_start.items():
                ema[k].copy_(v)
        loss = train_step(model, make_opt(model), ema, gb, kind)
        runs.append([loss] + _state(model, ema))
    model.load_state_dict(start)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _qm9_batch(cuda, **kw):
    mols = synthetic_qm9_dataset(8, seed=2)
    return next(iter(GraphLoader(mols, "qm9", 5.0, 5.0, 8, build_perms=True, **kw))).to(cuda)


def _rna_batch(cuda, **kw):
    mols = synthetic_rna_dataset(4, seed=2, n_atoms=60)
    return next(iter(GraphLoader(mols, "rna", 2.6, 20.0, 4, build_perms=True, **kw))).to(cuda)


def _pdbbind_mols(n: int, seed: int = 2) -> list[dict]:
    return [pdbbind_molecule(g) for g in synthetic_pdbbind_dataset(n, seed=seed)]


def _pdbbind_batch(cuda, mols=None, **kw):
    mols = mols or _pdbbind_mols(6)
    return next(iter(GraphLoader(mols, "pdbbind", 2.0, 6.0, len(mols), build_perms=True,
                                 **kw))).to(cuda)


def _path(cuda, name: str, **cfg_kw):
    """(model, batch, loss, optimizer factory, EMA or None) of a small
    training path: its recipe's loss, clip and EMA at a small width, with
    seeded weights, and a constant learning rate of 1e-3, so that the first
    step moves every parameter that takes a gradient."""
    if name.startswith("qm9") or name == "pamnet_s":
        geometry = "host" if name in ("qm9", "pamnet_s") else "derive"
        variant = "s" if name == "pamnet_s" else "full"
        cfg = PAMNetConfig(**QM9_SMALL, variant=variant,
                           device_graph=name == "qm9_device_graph", **cfg_kw)
        gb = _qm9_batch(cuda, variant=variant, wire_geometry=geometry)
        model = PAMNet(cfg, torch.Generator().manual_seed(0)).to(cuda)
        return (model, gb, "l1",
                lambda m: Optimizer(m.parameters(), constant(1e-3), clip_norm=1000.0),
                ema_init(model.state_dict()))
    if name.startswith("rna"):
        cfg = PAMNetConfig(dataset="rna_train", **RNA, **cfg_kw)
        gb = _rna_batch(cuda, wire_geometry="derive" if name == "rna_derive" else "host")
        return (PAMNet(cfg, torch.Generator().manual_seed(0)).to(cuda), gb, "smooth_l1",
                lambda m: Optimizer(m.parameters(), constant(1e-3)), None)
    cfg = PAMNetConfig(**PDBBIND, **cfg_kw)
    return (PAMNet(cfg, torch.Generator().manual_seed(0)).to(cuda), _pdbbind_batch(cuda), "mse",
            lambda m: Optimizer(m.parameters(), constant(1e-3)), None)


@pytest.mark.parametrize("name", ["qm9", "pamnet_s", "rna", "pdbbind", "qm9_derive",
                                  "qm9_device_graph"])
def test_step_kernels_vs_plain_and_repeat(cuda, name):
    """A training step through the kernels against PyTorch's autograd of the
    plain route on the same batch: each parameter's gradient within
    1e-4 * max|g| + 1e-6, the loss within 1e-5 + 1e-4 |loss|; and one step
    from the same state twice bit for bit (loss, parameters and EMA)."""
    model, gb, kind, make_opt, ema = _path(cuda, name)
    _assert_grads_close(_grads(model, gb, kind), _grads(model, gb, kind, plain=True))
    with torch.no_grad():
        got, want = (batch_loss(model, gb, kind, plain=p) for p in (False, True))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    _repeat_step_bitwise(model, make_opt, ema, gb, kind)


@pytest.mark.parametrize("name,tol,extra_syncs", [("qm9_derive", (1e-4, 1e-5), 0),
                                                  ("rna_derive", (1e-4, 1e-5), 0),
                                                  ("qm9_device_graph", (2e-4, 2e-5), 1)])
def test_step_on_card_geometry_is_the_host_geometry_step(cuda, name, tol, extra_syncs):
    """A step whose geometry (or graph) the card computes against the
    host-geometry step of the same molecules and parameters: predictions and
    loss within ``tol`` (rtol, atol), the parameters after one step of a
    fresh optimizer within rtol 5e-3, atol 5e-4 (the JAX package's
    f32-geometry tolerance, tests/test_wire_geometry.py), some parameter
    moved; and exactly ``extra_syncs`` more host syncs a step than the host
    step (the device graph reads its counts once)."""
    model, gb, kind, make_opt, ema = _path(cuda, name)
    host_name = "qm9" if name.startswith("qm9") else "rna"
    host_model, gb_host, _, _, _ = _path(cuda, host_name)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    host_model.load_state_dict(start)
    rtol, atol = tol
    with torch.no_grad():
        torch.testing.assert_close(model(gb), host_model(gb_host), rtol=rtol, atol=atol)
    after, syncs = {}, {}
    for which, m, b in (("host", host_model, gb_host), ("card", model, gb)):
        m.load_state_dict(start)
        opt, e = make_opt(m), (None if ema is None else ema_init(m.state_dict()))
        loss = train_step(m, opt, e, b, kind)
        after[which] = (float(loss), {k: v.clone() for k, v in m.state_dict().items()})
        train_step(m, opt, e, b, kind)
        syncs[which] = _count_syncs(lambda: train_step(m, opt, e, b, kind))
    (loss_h, params_h), (loss_c, params_c) = after["host"], after["card"]
    assert abs(loss_c - loss_h) <= atol + rtol * abs(loss_h)
    for k, v in params_h.items():
        torch.testing.assert_close(params_c[k], v, rtol=5e-3, atol=5e-4)
    assert max(float((params_c[k] - start[k]).abs().max()) for k in start) > 0.0
    assert syncs["card"] == syncs["host"] + extra_syncs


def _pdbbind_copies(mol: dict) -> list[dict]:
    """A PDBbind graph's three subgraphs as graphs of their own, each where
    the signed pool adds (x <= 40 A): the complex, the pocket shifted back by
    100 A and the ligand by 200 A (exact: the shifts keep every difference of
    positions, so every distance and angle, bit for bit)."""
    x = mol["pos"][:, 0]
    out = []
    for sel, shift in ((x <= 40.0, 0.0), ((x > 40.0) & (x <= 140.0), 100.0),
                       (x > 140.0, 200.0)):
        pos = mol["pos"][sel].copy()
        pos[:, 0] -= shift
        out.append(dict(pos=pos, feat=mol["feat"][sel], y=mol["y"]))
    return out


def _distance(a: dict, b: dict) -> float:
    """|a - b| over every tensor as one vector, relative to |b|."""
    num = sum(float(((a[n] - v).double() ** 2).sum()) for n, v in b.items())
    return math.sqrt(num / sum(float((v.double() ** 2).sum()) for v in b.values()))


@pytest.mark.parametrize("name", ["qm9", "rna", "pdbbind"])
def test_bf16_step_against_its_plain_route_and_f32(cuda, name):
    """A bfloat16 step against the plain bfloat16 route and the float32
    model of the same weights: each parameter's gradient within 2e-2 *
    max|g_plain| + 1e-6, or twice the tensor's distance between the plain
    bfloat16 and float32 routes; predictions within 1e-2 * max of the plain
    route's and 3e-2 * max of float32's; the loss within 1e-2 of the plain
    route's; the float32 step's launches; a repeated step bit for bit; ten
    steps whose loss is finite and falls.  PDBbind's pool subtracts copies
    of the same atoms, which leaves its heads' gradients to rounding noise,
    so its gradients and predictions are held per tensor on the same
    complexes with their three copies as graphs of their own, and on the
    signed batch the whole gradient (every tensor as one vector) within
    2e-2 of the plain route's or twice that route's distance from float32."""
    m32, gb, kind, make_opt, ema = _path(cuda, name)
    m16 = _path(cuda, name, compute_dtype="bfloat16")[0]
    m16.load_state_dict(m32.state_dict())
    held = gb
    if name == "pdbbind":
        held = _pdbbind_batch(cuda, [c for m in _pdbbind_mols(6) for c in _pdbbind_copies(m)])
        g16, p16, p32 = (_grads(m16, gb, kind), _grads(m16, gb, kind, plain=True),
                         _grads(m32, gb, kind, plain=True))
        assert _distance(g16, p16) <= max(2e-2, 2 * _distance(p16, p32))
    g16, p16, p32 = (_grads(m16, held, kind), _grads(m16, held, kind, plain=True),
                     _grads(m32, held, kind, plain=True))
    for n, w in p16.items():
        assert g16[n].dtype == torch.float32
        bound = max(2e-2 * float(w.abs().max()) + 1e-6, 2 * float((w - p32[n]).abs().max()))
        assert float((g16[n] - w).abs().max()) <= bound, n
    with torch.no_grad():
        pred, plain, f32 = m16(held), m16(held, plain=True), m32(held)
        losses = [float(batch_loss(m16, gb, kind, plain=p)) for p in (False, True)]
    assert pred.dtype == torch.float32
    assert float((pred - plain).abs().max()) <= 1e-2 * float(plain.abs().max())
    assert float((pred - f32).abs().max()) <= 3e-2 * float(f32.abs().max())
    assert abs(losses[0] - losses[1]) <= 1e-2 * max(abs(v) for v in losses)
    assert (_launched(lambda: batch_loss(m16, gb, kind).backward())
            == _launched(lambda: batch_loss(m32, gb, kind).backward()))
    _repeat_step_bitwise(m16, make_opt, ema, gb, kind)
    opt = Optimizer(m16.parameters(), constant(1e-3))
    falls = [float(train_step(m16, opt, None, gb, kind)) for _ in range(10)]
    assert all(math.isfinite(v) for v in falls) and falls[-1] < falls[0]


def _qm9_dp_model(cuda, dtype: str = "float32"):
    model = PAMNet(PAMNetConfig(**QM9_SMALL, compute_dtype=dtype),
                   torch.Generator().manual_seed(0)).to(cuda)
    return (model, Optimizer(model.parameters(), constant(1e-4), clip_norm=1000.0),
            ema_init(model.state_dict()))


def _qm9_host_batches(n: int) -> tuple[GraphLoader, list]:
    """A QM9 loader of ``n`` batches of 8 and its batches in order, on the host."""
    loader = GraphLoader(synthetic_qm9_dataset(8 * n, seed=4), "qm9", 5.0, 5.0, 8,
                         build_perms=True)
    return loader, [loader.collate(list(range(8 * i, 8 * i + 8))) for i in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dp_one_nccl_rank_is_the_one_process_step(cuda, tmp_path, dtype):
    """One rank over NCCL: three ``dp_train_step``s give the parameters,
    EMA and losses of three ``train_step``s bit for bit, with the same
    launches."""
    from pamnet_tpu_torch.parallel import init_dp, teardown

    batches = [b.to(cuda) for b in _qm9_host_batches(3)[1]]
    init_dp(1, 0, "cuda:0", init_method=f"file://{tmp_path}/rendezvous")
    try:
        runs = {}
        for route in ("train_step", "dp_train_step"):
            model, opt, ema = _qm9_dp_model(cuda, dtype)
            step = ((lambda gb: dp_train_step(model, opt, ema, gb, "l1", gb.num_graphs))
                    if route == "dp_train_step" else
                    (lambda gb: train_step(model, opt, ema, gb, "l1")))
            losses = []
            launches = _launched(lambda: losses.extend(float(step(gb)) for gb in batches))
            runs[route] = (losses, _state(model, ema), launches)
    finally:
        teardown()
    (lt, st, nt), (ld, sd, nd) = runs["train_step"], runs["dp_train_step"]
    assert lt == ld and nt == nd and all(torch.equal(a, b) for a, b in zip(st, sd))


def _dp_rank(rank: int, world: int, init_method: str, job: dict) -> None:
    """One of two ranks on the one card over gloo: three data-parallel steps
    on pairs of batches (rank r takes batch r of each pair); the first
    step's summed gradients, the losses, parameters and EMA to
    ``<out>/rank<r>.pt``."""
    from pamnet_tpu_torch.parallel import init_dp, teardown

    dev = init_dp(world, rank, "cuda:0", backend="gloo", init_method=init_method)
    try:
        model, opt, ema = _qm9_dp_model(dev)
        losses, grads = [], None
        for pair in job["pairs"]:
            gb = pair[rank].to(dev)
            losses.append(float(dp_train_step(model, opt, ema, gb, "l1",
                                              sum(b.num_graphs for b in pair))))
            if grads is None:  # the clip at 1000 leaves the summed gradients as they are
                grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        torch.save({"losses": losses, "grads": grads,
                    "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
                    "ema": {k: v.cpu() for k, v in ema.items()}},
                   os.path.join(job["out"], f"rank{rank}.pt"))
    finally:
        teardown()


def test_dp_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """Two ranks sharing the card over gloo, three steps on pairs of
    batches: the replicas bit for bit equal, the first step's summed
    gradients within 1e-4 * max|g| + 1e-6 of one process stepping the union
    of the pair, and its loss within 1e-5 + 1e-4 |loss|."""
    from pamnet_tpu_torch.parallel import spawn

    loader, host = _qm9_host_batches(6)
    pairs = [(host[2 * i], host[2 * i + 1]) for i in range(3)]
    spawn(_dp_rank, 2, {"pairs": pairs, "out": str(tmp_path)})
    a, b = (torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(2))
    assert a["losses"] == b["losses"]
    assert all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
    assert all(torch.equal(a["ema"][k], b["ema"][k]) for k in a["ema"])
    union = collate_structures(loader.structs[:16], build_perms=True, num_atom_types=5).to(cuda)
    model = _qm9_dp_model(cuda)[0]
    _assert_grads_close({n: g.to(cuda) for n, g in a["grads"].items()},
                        _grads(model, union, "l1"))
    with torch.no_grad():
        want = float(batch_loss(model, union, "l1"))
    assert abs(a["losses"][0] - want) <= 1e-5 + 1e-4 * abs(want)


def test_dp_more_ranks_than_cards_raises(cuda, tmp_path):
    """``--dp N`` with more ranks than the machine has cards raises before it
    starts a rank."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"--dp {n} needs {n} devices"):
        main_qm9.main(["--synthetic", "--limit", "16", "--epochs", "1", "--dp", str(n),
                       "--save_dir", str(tmp_path)])


def _pipeline_recipe(name: str) -> dict:
    """A small training recipe as its driver builds it: the training loader
    shuffled with the seed, its batches deriving their geometry; the
    evaluation loaders (host geometry) by split, None for the training
    loader itself; the model's initial parameters; the optimizer; the loss;
    the EMA (QM9, which trains in bfloat16 as ``main_qm9``)."""
    if name == "qm9":
        mols, bs = synthetic_qm9_dataset(64, seed=5), 8
        cfg, kind = PAMNetConfig(**QM9_SMALL, compute_dtype="bfloat16"), "l1"
        train, evals = mols[:48], {"val": mols[48:56], "test": mols[56:]}

        def make_opt(m, steps):
            return Optimizer(m.parameters(), warmup_exponential(1e-4, steps,
                                                                frac_steps_per_epoch=6),
                             clip_norm=1000.0)
    elif name == "rna":
        mols, bs = synthetic_rna_dataset(10, seed=5, n_atoms=60), 2
        cfg, kind = PAMNetConfig(dataset="rna_train", **RNA), "smooth_l1"
        train, evals = mols[:8], {"train": None, "val": mols[8:]}

        def make_opt(m, steps):
            return Optimizer(m.parameters(), constant(1e-4))
    else:
        mols, bs = _pdbbind_mols(20, seed=5), 4
        cfg, kind = PAMNetConfig(**PDBBIND), "mse"
        train, evals = mols[:12], {"train": None, "val": mols[12:16], "test": mols[16:]}

        def make_opt(m, steps):
            return Optimizer(m.parameters(), multistep(1e-3, steps_per_epoch=steps))
    common = dict(dataset_kind=cfg.dataset_kind, cutoff_l=cfg.cutoff_l, cutoff_g=cfg.cutoff_g,
                  batch_size=bs)
    loader = GraphLoader(train, shuffle=True, seed=0, build_perms=True, wire_geometry="derive",
                         **common)
    return {"cfg": cfg, "kind": kind, "ema": name == "qm9", "train": loader,
            "splits": {k: loader if v is None else GraphLoader(v, **common)
                       for k, v in evals.items()},
            "state": PAMNet(cfg, torch.Generator().manual_seed(0)).state_dict(),
            "make_opt": make_opt}


def _pipeline_epoch(rec: dict, way: str, cuda) -> dict:
    """One epoch of ``rec`` and the predictions of every split, from its
    initial parameters and the training loader's generator after the train
    split's draw: "serial" (``run_epoch(pipelined=False)``; every split
    collated and copied again) or "pipelined" (``run_epoch``; the splits'
    resident ``StackedEval`` batches, as the drivers run it)."""
    model = PAMNet(rec["cfg"])
    model.load_state_dict(rec["state"])
    model = model.to(cuda)
    opt = rec["make_opt"](model, len(rec["train"]))
    ema = ema_init(model.state_dict()) if rec["ema"] else None
    evaluated = PAMNet(rec["cfg"]).to(cuda) if ema is not None else model
    rec["train"].set_rng_state(rec["rng"])
    out = {}
    launches = _launched(lambda: out.update(zip(
        ("loss_sum", "graphs", "losses", "steps"),
        run_epoch(model, opt, ema, rec["train"], cuda, rec["kind"],
                  pipelined=way == "pipelined"))))
    if ema is not None:
        evaluated.load_state_dict(ema)
    preds = {}
    for k, ld in rec["splits"].items():
        source = (rec["staged"][k] if way == "pipelined" else
                  [ld.collate(idxs, build_perms=False) for idxs in rec["order"][k]])
        preds[k] = predict(evaluated, source, cuda)[0]
    return {**out, "losses": torch.stack(out["losses"]).cpu(), "launches": launches,
            "params": _state(model, None), "preds": preds}


@pytest.mark.parametrize("name", ["qm9", "rna", "pdbbind"])
def test_pipelined_epoch_is_the_serial_one(cuda, name):
    """The drivers' epoch (collation and pinned copies in threads beside the
    steps, the evaluation splits resident) against the serial epoch, twice
    in turns, from the same parameters and loader order: per-step losses,
    the loss sum, the parameters after the epoch, every split's predictions
    and the launches bit for bit."""
    rec = _pipeline_recipe(name)
    train = rec["train"]
    before = train.rng_state()
    rec["staged"] = {k: StackedEval(ld, cuda, verbose=False) for k, ld in rec["splits"].items()}
    rec["rng"] = train.rng_state()
    train.set_rng_state(before)
    rec["order"] = {k: ld.batches() for k, ld in rec["splits"].items()}
    assert train.rng_state() == rec["rng"]
    runs = [_pipeline_epoch(rec, way, cuda) for way in ("serial", "pipelined") * 2]
    first = runs[0]
    assert math.isfinite(first["loss_sum"]) and first["steps"] == len(train)
    for run in runs[1:]:
        assert run["loss_sum"] == first["loss_sum"] and run["launches"] == first["launches"]
        assert torch.equal(run["losses"], first["losses"])
        assert all(torch.equal(a, b) for a, b in zip(run["params"], first["params"]))
        assert all(np.array_equal(run["preds"][k], v) for k, v in first["preds"].items())


def _kernel_b_dtypes(monkeypatch) -> dict:
    """The operand types kernel B's forward and backward kernels are
    launched on from now on, read through the operand check each launch
    makes."""
    seen = {"sbf_modulate": set(), "sbf_modulate_backward": set()}
    check = sbf_ops._check_operands

    def recorded(what, proj, m_neighbor, *a, **k):
        seen[what].add(m_neighbor.dtype)
        return check(what, proj, m_neighbor, *a, **k)

    monkeypatch.setattr(sbf_ops, "_check_operands", recorded)
    return seen


def _rna_cfg(dtype: str, dataset: str = "rna_serve") -> PAMNetConfig:
    return PAMNetConfig(dataset=dataset, **RNA, compute_dtype=dtype)


def _dtoh_copies(fn) -> int:
    """Device-to-host copies that the profiler records in one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages() if "DtoH" in ev.key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_csv_driver_against_serial_scores(cuda, tmp_path, monkeypatch, dtype):
    """``inference_rna_puzzles`` on the card: the CSV's header, tags and
    puzzle number; the scores bit for bit the serial loop's (each exact-pads
    batch collated and copied on the calling thread); against the scoring
    service, float32 within 5e-5 + 1e-4 |score|, bfloat16 within 1e-2 *
    max|score| of the bfloat16 service and 3e-2 * max|score| of the float32
    one; one device-to-host copy a run; kernel B twice a batch."""
    dataset = "rna_p21"
    mols = synthetic_rna_dataset(6, seed=7, n_atoms=60)
    write_tu_split(str(tmp_path / "data"), dataset,
                   [dict(m, name=f"{dataset}_candidate_{i}.pdb") for i, m in enumerate(mols)])
    state = init_params(_rna_cfg("float32"), torch.Generator().manual_seed(0))
    export_state_dict(state, str(tmp_path / "save" / "model.pt"))
    structures = TUDataset(str(tmp_path / "data"), dataset).molecules()
    monkeypatch.chdir(tmp_path)
    out = {}

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            out.update(inference_rna_puzzles.main(
                ["--dataset", dataset, "--batch_size", "4", "--saved_model", "model.pt",
                 "--data_root", str(tmp_path / "data"), "--compute_dtype", dtype]))

    kernel_b = sbf_ops.sbf_modulate.launches
    assert _dtoh_copies(run) == 1
    assert sbf_ops.sbf_modulate.launches - kernel_b == 2 * len(out["pads"])
    with open(out["csv"]) as f:
        lines = f.read().splitlines()
    rows = [ln.split(",") for ln in lines[1:]]
    assert lines[0] == "PAMNet,tag,puzzle_number"
    assert [r[1] for r in rows] == [f"{dataset}_candidate_{i}" for i in range(len(mols))]
    assert {r[2] for r in rows} == {"21"}
    got = np.array([float(r[0]) for r in rows])
    model = PAMNet(_rna_cfg(dtype, dataset))
    model.load_state_dict(state, strict=True)
    model = model.to(cuda).eval()
    loader = GraphLoader(structures, "rna", 2.6, 20.0, batch_size=4, ladder_pads="exact")
    with torch.inference_mode():
        serial = torch.cat([model(gb.to(cuda))[:gb.num_graphs] for gb in loader]).cpu().numpy()
    assert np.array_equal(got.astype(np.float32), serial)
    served = {d: RNAScoringService(state, _rna_cfg(d), batch_size=4, device=cuda)
              .score_molecules(structures) for d in ("float32", dtype)}
    if dtype == "float32":
        np.testing.assert_allclose(got, served["float32"], atol=5e-5, rtol=1e-4)
    else:
        assert np.abs(got - served[dtype]).max() <= 1e-2 * np.abs(served[dtype]).max()
        assert np.abs(got - served["float32"]).max() <= 3e-2 * np.abs(served["float32"]).max()


def test_scoring_forward_folded_unfolded_plain_and_served(cuda):
    """The scoring model's forward on a batch of the service's shape:
    folded through kernel B, unfolded, each route's plain version and the
    service's own call on the same structures agree within 5e-5 + 1e-4
    |score|."""
    mols = synthetic_rna_dataset(4, seed=8, n_atoms=60)
    cfg = _rna_cfg("float32")
    state = init_params(cfg, torch.Generator().manual_seed(0))
    service = RNAScoringService(state, cfg, batch_size=4, device=cuda)
    unfolded = PAMNet(PAMNetConfig(**{**cfg.__dict__, "fold_sbf": False}))
    unfolded.load_state_dict(state, strict=True)
    unfolded = unfolded.to(cuda).eval()
    assert service.model.fold_sbf() and not unfolded.fold_sbf()
    gb = next(iter(GraphLoader(mols, "rna", 2.6, 20.0, batch_size=4, ladder_pads=True))).to(cuda)
    with torch.inference_mode():
        got = service.model(gb)[:4]
        for want in (service.model(gb, plain=True), unfolded(gb), unfolded(gb, plain=True)):
            torch.testing.assert_close(got, want[:4], atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(torch.from_numpy(service.score_molecules(mols)), got.cpu(),
                               atol=5e-5, rtol=1e-4)


def _post(url: str, data: bytes, ctype: str) -> dict:
    req = urllib.request.Request(url, data=data, method="POST", headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _pdb_text(z, pos) -> str:
    elem = "CNO"
    return "\n".join(
        f"ATOM  {i % 99999:5d}  {elem[zi]:<3s}  G A{i % 9999:4d}    "
        f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}  1.00  0.00           {elem[zi]}"
        for i, (zi, p) in enumerate(zip(z, pos))) + "\nTER\n"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_http_service_against_direct_scoring(cuda, monkeypatch, dtype):
    """The HTTP service on the card: ``/healthz``; JSON requests of one and
    two structures and a raw-PDB request scored as ``score_molecules``
    scores them directly, within 5e-5 + 1e-4 |score|; in bfloat16, kernel B
    runs on bfloat16 operands."""
    mols = synthetic_rna_dataset(3, seed=8, n_atoms=60)
    cfg = _rna_cfg(dtype)
    service = RNAScoringService(init_params(cfg, torch.Generator().manual_seed(0)), cfg,
                                batch_size=4, device=cuda)
    seen = _kernel_b_dtypes(monkeypatch)
    server = make_server(service, "127.0.0.1", 0, "seed 0")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            assert json.loads(r.read())["ok"] is True
        for lo, hi in ((0, 1), (1, 3)):
            body = json.dumps({"molecules": [
                {"name": f"s{i}", "z": mols[i]["z"].tolist(), "pos": mols[i]["pos"].tolist()}
                for i in range(lo, hi)]}).encode()
            res = _post(f"{base}/score", body, "application/json")
            assert res["names"] == [f"s{i}" for i in range(lo, hi)]
            np.testing.assert_allclose(res["scores"], service.score_molecules(mols[lo:hi]),
                                       atol=5e-5, rtol=1e-4)
        z, pos = mols[0]["z"], np.round(mols[0]["pos"].astype(np.float64), 3)
        res = _post(f"{base}/score?name=pdb0", _pdb_text(z, pos).encode(), "chemical/x-pdb")
        assert res["names"] == ["pdb0"]
        np.testing.assert_allclose(res["scores"], service.score_molecules([dict(z=z, pos=pos)]),
                                   atol=5e-5, rtol=1e-4)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert seen["sbf_modulate"] == {getattr(torch, dtype)}


@contextlib.contextmanager
def _driver_probe():
    """Record what in-process driver runs do that their printed lines do not
    show: each ``GraphLoader``'s structure-cache chunks built, and each
    training epoch's per-step losses, launches and the parameters after it."""
    rec = {"built": [], "epochs": []}
    init, epoch = loader_mod.GraphLoader.__init__, loop.run_epoch

    def counted_init(self, *a, **kw):
        init(self, *a, **kw)
        rec["built"].append(self.cache_built or 0)

    def probed_epoch(model, *a, **kw):
        out = {}
        launches = _launched(lambda: out.update(res=epoch(model, *a, **kw)))
        rec["epochs"].append({"losses": torch.stack(out["res"][2]).cpu(), "launches": launches,
                              "params": _state(model, None)})
        return out["res"]

    loader_mod.GraphLoader.__init__, loop.run_epoch = counted_init, probed_epoch
    try:
        yield rec
    finally:
        loader_mod.GraphLoader.__init__, loop.run_epoch = init, epoch


def _cold_and_warm(main, base: list[str], cache: str, uncached: bool = False) -> list[dict]:
    """``main`` with the structure cache ``cache`` cold, then warm (and first
    without it, where ``uncached``): each run's probe record.  The warm run
    builds no chunk and the cold one some; every run's step losses,
    parameters and launches are the first run's bit for bit."""
    runs = []
    for name in ("uncached", "cold", "warm")[0 if uncached else 1:]:
        extra = [] if name == "uncached" else ["--structure_cache", cache]
        with _driver_probe() as rec, contextlib.redirect_stdout(io.StringIO()):
            rec["result"] = main(base + extra + ["--save_dir", f"{cache}_{name}"])
        runs.append(rec)
    assert sum(runs[-2]["built"]) > 0 and sum(runs[-1]["built"]) == 0
    for run in runs[1:]:
        for a, b in zip(runs[0]["epochs"], run["epochs"], strict=True):
            assert torch.equal(a["losses"], b["losses"]) and a["launches"] == b["launches"]
            assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
    return runs


@pytest.mark.parametrize("name", ["pdbbind", "rna", "qm9"])
def test_raw_files_through_the_preprocessors_into_training(cuda, tmp_path, monkeypatch, name):
    """The data-preparation path on the card, each driver in-process.
    PDBbind: raw mol2 complexes and the index through ``preprocess_pdbbind``
    into ``main_pdbbind``, without the structure cache, cold and warm.  RNA:
    candidate PDB files through ``preprocess_rna_puzzles`` (each structure
    its source within the 3 printed decimals) into ``main_rna_puzzles``,
    folded (kernel B forward and backward), cold and warm, then
    ``inference_rna_puzzles`` on the preprocessed ``val`` split.  QM9:
    ``main_qm9 --synthetic`` with two cache workers, cold and warm, then a
    ``--trace_dir`` run whose Chrome trace names the port's kernels."""
    monkeypatch.chdir(tmp_path)
    if name == "pdbbind":
        write_raw_pdbbind("PDBbind", 10, 3, seed=805)
        with contextlib.redirect_stdout(io.StringIO()):
            split = preprocess_pdbbind.main(["--data_dir", "PDBbind"])
        assert len(split["train_val"]) + len(split["test"]) == 10
        runs = _cold_and_warm(main_pdbbind.main, [
            "--data_root", "PDBbind", "--epochs", "1", "--dim", "32", "--n_layer", "2",
            "--batch_size", "4", "--lr", "1e-3", "--seed", "0"], "pdb_cache", uncached=True)
        assert all(math.isfinite(v) for v in runs[-1]["result"]["test"])
        return
    if name == "rna":
        mols = synthetic_rna_dataset(6, seed=9, n_atoms=60)
        write_raw_rna_puzzles("rna_raw", 4, 2, structures=mols)
        with contextlib.redirect_stdout(io.StringIO()):
            split = preprocess_rna_puzzles.main(["--data_dir", "rna_raw", "--save_dir", "RNA"])
        for got, src in zip(split["train"] + split["val"], mols, strict=True):
            # Coordinates are printed to 3 decimals: half a unit of the last
            # one, and float32's rounding of either side.
            assert np.array_equal(got["z"], src["z"])
            assert np.abs(got["pos"] - src["pos"]).max() <= 6e-4
        runs = _cold_and_warm(main_rna_puzzles.main, [
            "--data_root", "RNA", "--dim", "16", "--n_layer", "1", "--batch_size", "2",
            "--lr", "1e-4", "--epochs", "1", "--seed", "0"], "rna_cache")
        launches = dict(zip(COUNTERS, runs[0]["epochs"][0]["launches"]))
        assert launches[sbf_ops.sbf_modulate] >= 2 and launches[sbf_ops.sbf_modulate_backward] >= 2
        # The scoring driver takes RNA datasets by an "rna" name (the
        # reference's rule): the val split's files under the name rna_val.
        os.makedirs(os.path.join("RNA", "rna_val", "raw"))
        for f in os.listdir(os.path.join("RNA", "val", "raw")):
            shutil.copyfile(os.path.join("RNA", "val", "raw", f),
                            os.path.join("RNA", "rna_val", "raw", "rna_" + f))
        with contextlib.redirect_stdout(io.StringIO()):
            out = inference_rna_puzzles.main(
                ["--dataset", "rna_val", "--data_root", "RNA", "--batch_size", "2",
                 "--saved_model", os.path.join("rna_cache_warm", "pamnet_rna_best.pt")])
        with open(out["csv"]) as f:
            rows = [ln.split(",") for ln in f.read().splitlines()[1:]]
        assert [r[1] for r in rows] == ["cand_000", "cand_001"]
        assert all(math.isfinite(float(r[0])) for r in rows)
        return
    base = ["--synthetic", "--limit", "64", "--dim", "16", "--n_layer", "1", "--epochs", "1",
            "--batch_size", "8", "--seed", "0"]
    _cold_and_warm(main_qm9.main, base + ["--cache_workers", "2"], "qm9_cache")
    with contextlib.redirect_stdout(io.StringIO()):
        main_qm9.main(base + ["--trace_dir", "trace", "--save_dir", "qm9_trace"])
    (trace,) = os.listdir("trace")
    with open(os.path.join("trace", trace)) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    assert any("(anonymous namespace)::" in k for k in kernels)


@contextlib.contextmanager
def _fake_pyg():
    """``torch_geometric.data.data.Data`` as a plain class registered under
    PyG's module path (PyG is not installed), so ``torch.save`` pickles it
    by that name, as PyG's preprocessed artifacts name it."""
    names = ("torch_geometric", "torch_geometric.data", "torch_geometric.data.data")
    saved = {n: sys.modules.get(n) for n in names}
    for n in names:
        sys.modules[n] = type(sys)(n)
    data = type("Data", (), {"__init__": lambda self, **kw: self.__dict__.update(kw)})
    data.__module__, data.__qualname__ = names[-1], "Data"
    sys.modules[names[-1]].Data = data
    try:
        yield data
    finally:
        for n, old in saved.items():
            if old is None:
                del sys.modules[n]
            else:
                sys.modules[n] = old


def test_qm9_from_a_preprocessed_artifact(cuda, tmp_path, monkeypatch):
    """A PyG-layout ``data_v2.pt`` (x as float atom types, pos, the bonds
    offset by the nodes before each molecule, y (M, 19) with the label at
    target 7's column, and the slices) read back bit for bit, and
    ``main_qm9`` without ``--synthetic`` trained from it on the card."""
    from pamnet_tpu_torch.data.qm9 import load_qm9_preprocessed, remap_target

    mols = synthetic_qm9_dataset(40, seed=9)
    n = np.cumsum([0] + [len(m["z"]) for m in mols])
    e = np.cumsum([0] + [m["edge_index"].shape[1] for m in mols])
    y = np.random.default_rng(0).standard_normal((len(mols), 19)).astype(np.float32)
    y[:, remap_target(7)] = [m["y"] for m in mols]
    path = tmp_path / "data" / "QM9" / "processed" / "data_v2.pt"
    path.parent.mkdir(parents=True)
    with _fake_pyg() as data_cls:
        data = data_cls(
            x=torch.tensor(np.concatenate([m["z"] for m in mols]).astype(np.float32)),
            pos=torch.tensor(np.concatenate([m["pos"] for m in mols])),
            edge_index=torch.tensor(np.concatenate(
                [m["edge_index"] + n[i] for i, m in enumerate(mols)], axis=1)),
            y=torch.tensor(y))
        torch.save((data, {"x": torch.tensor(n), "pos": torch.tensor(n),
                           "edge_index": torch.tensor(e), "y": torch.arange(len(mols) + 1)}),
                   path)
    got = load_qm9_preprocessed(str(path))
    assert len(got) == len(mols)
    for g, m, yi in zip(got, mols, y):
        for k in ("z", "pos", "edge_index"):
            assert g[k].dtype == m[k].dtype and np.array_equal(g[k], m[k]), k
        assert np.array_equal(g["y"], yi.astype(np.float64))
    monkeypatch.chdir(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main_qm9.main(["--limit", "40", "--dim", "16", "--n_layer", "1", "--epochs", "1",
                             "--batch_size", "8", "--save_dir", str(tmp_path / "save")])
    assert "Data loaded! train=32 val=4 test=4" in out.getvalue()
    assert len(re.findall(r"(?:Train|Val|Test) MAE: \S+", out.getvalue())) == 3
    assert math.isfinite(res["test_mae"])
    assert (path.parent / "qm9_pamnet_tpu_torch.npz").is_file()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rna_driver_resumes_and_serves_what_it_trained(cuda, tmp_path, monkeypatch, dtype):
    """``main_rna_puzzles`` on the card: three epochs straight against two
    and a ``--resume`` for the third, whose losses and best checkpoint are
    bit for bit the straight run's; kernel B runs forward and backward on
    operands of the compute type; the scoring service on the exported best
    checkpoint scores the validation structures as ``predict`` does, within
    5e-5 + 1e-4 |score|."""
    mols = synthetic_rna_dataset(8, seed=6, n_atoms=60)
    root = str(tmp_path / "data")
    write_tu_split(root, "train", mols[:6])
    write_tu_split(root, "val", mols[6:])
    recipe = ["--dim", "16", "--n_layer", "1", "--batch_size", "2", "--lr", "1e-4", "--seed", "0",
              "--data_root", root, "--compute_dtype", dtype]
    seen = _kernel_b_dtypes(monkeypatch)

    def drive(epochs: int, save: str, *extra):
        with contextlib.redirect_stdout(io.StringIO()):
            return main_rna_puzzles.main([*recipe, "--epochs", str(epochs), "--save_dir",
                                          str(tmp_path / save), *extra])

    straight = drive(3, "a")
    cut = drive(2, "b")
    resumed = drive(3, "b", "--resume", cut["last_path"])
    assert straight["train_loss"][:2] == cut["train_loss"]
    assert straight["train_loss"][2:] == resumed["train_loss"]
    assert straight["val_loss"][2:] == resumed["val_loss"]
    assert all(math.isfinite(v) for v in straight["train_loss"] + straight["val_loss"])
    best_a = load_reference_checkpoint(straight["best_path"])
    best_b = load_reference_checkpoint(resumed["best_path"])
    assert best_a.keys() == best_b.keys() and all(torch.equal(best_a[k], best_b[k]) for k in best_a)
    assert seen["sbf_modulate"] == seen["sbf_modulate_backward"] == {getattr(torch, dtype)}
    val = TUDataset(root, "val").molecules()
    cfg = _rna_cfg(dtype)
    scores = RNAScoringService(best_b, cfg, batch_size=2, device=cuda).score_molecules(val)
    model = PAMNet(cfg)
    model.load_state_dict(best_b, strict=True)
    with torch.inference_mode():
        want, _ = predict(model.to(cuda).eval(),
                          GraphLoader(val, "rna", 2.6, 20.0, 2, ladder_pads=True), cuda)
    np.testing.assert_allclose(scores, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("argv", [[], ["--model", "PAMNet_s"], ["--device_graph"]],
                         ids=["qm9", "pamnet_s", "device_graph"])
def test_main_qm9_on_the_card(cuda, tmp_path, argv):
    """``main_qm9 --synthetic`` for an epoch on the card, in its default
    bfloat16: the epoch's train, val and test MAE, the best validation and
    the testing MAE, all finite."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main_qm9.main(["--synthetic", "--limit", "64", "--dim", "16", "--n_layer", "1",
                       "--epochs", "1", "--batch_size", "8", "--save_dir", str(tmp_path), *argv])
    maes = re.findall(r"(?:Train|Val|Test|Best Validation|Testing) MAE: ([^,\s]+)",
                      out.getvalue())
    assert len(maes) == 5 and all(math.isfinite(float(v)) for v in maes)


def test_main_pdbbind_on_the_card(cuda, tmp_path):
    """``main_pdbbind --synthetic`` (realistic complexes) for an epoch on the
    card: the epoch's train and test RMSE, MAE, SD and P, and the testing
    quad, all finite."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main_pdbbind.main(["--synthetic", "16", "--epochs", "1", "--dim", "32",
                                 "--n_layer", "2", "--batch_size", "4",
                                 "--save_dir", str(tmp_path)])
    quads = re.findall(r"(?:Train|Test) (?:RMSE|MAE|SD|P): ([^,\s]+)", out.getvalue())
    assert len(quads) == 8 and all(math.isfinite(float(v)) for v in quads)
    assert all(math.isfinite(v) for v in res["test"])
