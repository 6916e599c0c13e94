"""The epoch pipeline on the CPU: ``GraphLoader.prefetch``, ``_staged``,
the runner (``run_epoch``) and ``StackedEval``.

Held against:
  * plain iteration of the same loader, bit for bit (every tensor equal),
    for QM9, PDBbind and RNA loaders, derive and host geometry, shuffled
    and in order (JAX ``tests/test_loader.py:47``), and the shuffling
    generator's state after the epoch equal;
  * the serial epoch loop of the port before the pipeline, written out
    here, on the same loader: loss sum, graph count, per-step losses and
    parameters bit for bit, one process and two gloo ranks (``dp=2``);
  * JAX's ``EpochRunner.run`` on the same seeded batches and parameters:
    three Adam steps at lr 1e-4, the parameters within 1e-6 and the loss sum
    within 1e-5 per graph, the tolerance of ``tests/test_torch_rna_train.py``
    for three Adam steps against JAX's train step;
  * ``predict`` over the same batches collated anew, bit for bit
    (``StackedEval``);
  * the JAX drivers' batch order: ``main_pdbbind`` and ``main_rna_puzzles``
    train their first epoch on the JAX training loader's second permutation
    (JAX's ``StackedEval(train_loader)`` draws the first before epoch 1)
    and take their train-split metrics over the first; ``main_qm9``, whose
    JAX driver evaluates no train split, trains on the first.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from pamnet_tpu.config import PAMNetConfig as JaxConfig
from pamnet_tpu.data.loader import GraphLoader as JaxLoader
from pamnet_tpu.models import init_pamnet
from pamnet_tpu.train import loop as jloop
from pamnet_tpu.train.schedules import constant as jax_constant
from pamnet_tpu_torch import main_pdbbind, main_qm9, main_rna_puzzles
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.batch import GraphBatch
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule, synthetic_pdbbind_dataset,
                                             synthetic_qm9_dataset, synthetic_rna_dataset)
from pamnet_tpu_torch.data.tu import write_tu_split
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.parallel import init_dp, teardown
from pamnet_tpu_torch.profiling import device_busy_s
from pamnet_tpu_torch.train.ema import ema_init
from pamnet_tpu_torch.train.loop import (Optimizer, StackedEval, _staged, dp_train_step,
                                         predict, run_epoch, train_step)
from pamnet_tpu_torch.train.schedules import constant
from pamnet_tpu_torch.weights import from_jax_params

KINDS = {  # model config, loss
    "qm9": (dict(dataset="QM9", dim=16, n_layer=1, cutoff_l=5.0, cutoff_g=5.0), "l1"),
    "pdbbind": (dict(dataset="PDBbind", dim=16, n_layer=1, cutoff_l=2.0, cutoff_g=6.0), "mse"),
    "rna": (dict(dataset="rna_train", dim=16, n_layer=1, cutoff_l=2.6, cutoff_g=20.0,
                 flow="target_to_source"), "smooth_l1"),
}


def _mols(kind: str, n: int, seed: int = 3) -> list[dict]:
    if kind == "qm9":
        return synthetic_qm9_dataset(n, seed=seed)
    if kind == "pdbbind":
        return [pdbbind_molecule(g) for g in synthetic_pdbbind_dataset(n, seed=seed)]
    return [dict(m, y=m["y"] / 8.0) for m in synthetic_rna_dataset(n, seed=seed, n_atoms=40)]


def _loader(kind: str, mols: list[dict], batch_size: int = 3, **kw) -> GraphLoader:
    cfg, _ = KINDS[kind]
    return GraphLoader(mols, kind, cfg["cutoff_l"], cfg["cutoff_g"], batch_size, **kw)


def _assert_same(a: GraphBatch, b: GraphBatch) -> None:
    for f in dataclasses.fields(GraphBatch):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        elif f.name == "perms":
            assert x.keys() == y.keys()
            assert all(torch.equal(x[k], y[k]) for k in x), f.name
        else:
            assert x == y, f.name


def _background_threads() -> list[threading.Thread]:
    return [t for t in threading.enumerate() if t.name == "pamnet-background" and t.is_alive()]


@pytest.mark.parametrize("shuffle", [False, True], ids=["in_order", "shuffled"])
@pytest.mark.parametrize("geometry", ["derive", "host"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_prefetch_is_plain_iteration_bit_for_bit(kind, geometry, shuffle):
    mols = _mols(kind, 8)
    kw = dict(shuffle=shuffle, seed=5, build_perms=True, wire_geometry=geometry)
    plain, fetched = _loader(kind, mols, **kw), _loader(kind, mols, **kw)
    for _ in range(2):  # two epochs: the second permutation too
        want, got = list(plain), list(fetched.prefetch())
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _assert_same(a, b)
        assert fetched.rng_state() == plain.rng_state()
    assert not _background_threads()


def test_prefetch_draws_its_permutation_when_called_and_resumes_as_plain():
    """The epoch's permutation is drawn by the call, as ``batches()`` draws
    it, so the generator's state after a prefetched epoch is a plain
    epoch's, and a loader set to it continues alike (``last.ckpt``)."""
    mols = _mols("qm9", 8)
    plain = _loader("qm9", mols, shuffle=True, seed=9)
    fetched = _loader("qm9", mols, shuffle=True, seed=9)
    before = fetched.rng_state()
    batches = fetched.prefetch()
    assert fetched.rng_state() != before
    list(plain)
    assert fetched.rng_state() == plain.rng_state()
    list(batches)
    resumed = _loader("qm9", mols, shuffle=True, seed=0)
    resumed.set_rng_state(fetched.rng_state())
    assert resumed.batches() == plain.batches()


def test_prefetch_raises_a_worker_error_in_the_consumer(monkeypatch):
    loader = _loader("qm9", _mols("qm9", 8))
    collate = loader.collate
    calls = []

    def failing(idxs, build_perms=None):
        calls.append(idxs)
        if len(calls) == 2:
            raise RuntimeError("collation failed")
        return collate(idxs, build_perms)

    monkeypatch.setattr(loader, "collate", failing)
    got = []
    with pytest.raises(RuntimeError, match="collation failed"):
        for gb in loader.prefetch():
            got.append(gb)
    assert len(got) == 1
    assert not _background_threads()


def test_staged_keeps_order_relays_errors_and_stops_early():
    batches = list(_loader("rna", _mols("rna", 8), build_perms=True))
    staged = list(_staged(iter(batches), "cpu"))
    assert len(staged) == len(batches)
    for a, b in zip(staged, batches):
        _assert_same(a, b)

    def broken():
        yield batches[0]
        raise ValueError("no second batch")

    with pytest.raises(ValueError, match="no second batch"):
        list(_staged(broken(), "cpu"))

    # A consumer that stops after one batch: the staging thread and the
    # collation thread under it both end, none left blocked on a full queue.
    loader = _loader("rna", _mols("rna", 8) * 3, batch_size=1)
    stream = _staged(loader.prefetch(depth=1), "cpu", depth=1)
    next(stream)
    assert len(_background_threads()) == 2
    stream.close()
    assert not _background_threads()


def test_collate_plan_is_built_once_under_threads():
    """The loader's lazily built collate plan, which the collation thread
    and the caller may both reach first: more threads than cores at a short
    switch interval all get one plan."""
    loader = _loader("qm9", _mols("qm9", 8))
    plans, interval = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: plans.append(loader.plan()))
                   for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(plans) == len(threads)
    assert all(p is plans[0] for p in plans)


def _fresh(kind: str, state: dict, seed_loader: GraphLoader, rng: dict):
    """A model at ``state``, its optimizer chain (QM9: clip and EMA), and the
    loader's generator set to ``rng``."""
    cfg, _ = KINDS[kind]
    model = PAMNet(PAMNetConfig(**cfg))
    model.load_state_dict(state)
    qm9 = kind == "qm9"
    opt = Optimizer(model.parameters(), constant(1e-3), clip_norm=1000.0 if qm9 else None)
    seed_loader.set_rng_state(rng)
    return model, opt, ema_init(model.state_dict()) if qm9 else None


def _serial_epoch(model, opt, ema, loader, kind):
    """The port's epoch loop before the pipeline: collate, copy, step."""
    loss_sum = torch.zeros((), dtype=torch.float64)
    graphs, losses = 0, []
    for gb in loader:
        loss = train_step(model, opt, ema, gb.to("cpu"), kind)
        loss_sum += loss.double() * gb.num_graphs
        graphs += gb.num_graphs
        losses.append(loss)
    return float(loss_sum), graphs, losses


@pytest.mark.parametrize("kind", list(KINDS))
def test_run_epoch_is_the_serial_loop_bit_for_bit(kind):
    cfg, loss_kind = KINDS[kind]
    loader = _loader(kind, _mols(kind, 7), shuffle=True, seed=4, build_perms=True,
                     wire_geometry="derive")
    state = PAMNet(PAMNetConfig(**cfg), torch.Generator().manual_seed(1)).state_dict()
    rng = loader.rng_state()
    model, opt, ema = _fresh(kind, state, loader, rng)
    want = _serial_epoch(model, opt, ema, loader, loss_kind)
    want_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    for pipelined in (True, False):
        model, opt, ema = _fresh(kind, state, loader, rng)
        stats = {}
        loss_sum, graphs, losses, dispatches = run_epoch(
            model, opt, ema, loader, "cpu", loss_kind, pipelined=pipelined, stats=stats)
        assert (loss_sum, graphs) == want[:2] and dispatches == len(losses) == 3
        assert all(torch.equal(a, b) for a, b in zip(losses, want[2], strict=True))
        for n, p in model.named_parameters():
            assert torch.equal(p, want_params[n]), n
        assert set(stats) == ({"queue_wait_s"} if pipelined else {"collate_s", "h2d_s"})


def test_run_epoch_raises_a_collation_error(monkeypatch):
    cfg, loss_kind = KINDS["qm9"]
    loader = _loader("qm9", _mols("qm9", 8), build_perms=True)
    model = PAMNet(PAMNetConfig(**cfg))
    opt = Optimizer(model.parameters(), constant(1e-3))
    collate = loader.collate

    def failing(idxs, build_perms=None):
        if idxs[0] == 3:
            raise RuntimeError("truncated epoch")
        return collate(idxs, build_perms)

    monkeypatch.setattr(loader, "collate", failing)
    with pytest.raises(RuntimeError, match="truncated epoch"):
        run_epoch(model, opt, None, loader, "cpu", loss_kind)
    assert opt.count == 1 and not _background_threads()


def test_run_epoch_matches_jax_epoch_runner():
    """Three Adam steps (lr 1e-4, SmoothL1) over a shuffled RNA loader of
    6 structures in batches of 2 against ``EpochRunner.run`` on JAX's
    loader at the same seed, which draws the same permutation."""
    cfg, loss_kind = KINDS["rna"]
    jcfg = JaxConfig(**cfg)
    params = init_pamnet(jax.random.PRNGKey(3), jcfg)
    mols = _mols("rna", 6, seed=17)
    jl = JaxLoader(mols, "rna", cfg["cutoff_l"], cfg["cutoff_g"], batch_size=2, shuffle=True,
                   seed=8, build_tables=False, build_perms=True)
    optimizer = jloop.make_optimizer(jax_constant(1e-4))
    runner = jloop.EpochRunner(jcfg, optimizer, loss_kind, ema_decay=None)
    state, jloss_sum, jng, jnb = runner.run(
        jloop.init_train_state(params, optimizer, use_ema=False), jl.prefetch(),
        lambda t: jax.tree.map(jnp.asarray, t))
    model = PAMNet(PAMNetConfig(**cfg))
    model.load_state_dict(from_jax_params(params))
    opt = Optimizer(model.parameters(), constant(1e-4))
    loss_sum, graphs, _, dispatches = run_epoch(
        model, opt, None, _loader("rna", mols, batch_size=2, shuffle=True, seed=8,
                                  build_perms=True), "cpu", loss_kind)
    assert (graphs, dispatches) == (jng, jnb) == (6, 3) and opt.count == int(state.step)
    assert abs(loss_sum - jloss_sum) <= 1e-5 * graphs
    want = from_jax_params(state.params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("kind", list(KINDS))
def test_stacked_eval_is_predict_bit_for_bit(kind, capsys):
    """An evaluation loader (host geometry, in order) and a training loader
    (derive, shuffled: the split is its next permutation), each against
    ``predict`` over the same batches collated anew."""
    cfg, _ = KINDS[kind]
    mols = _mols(kind, 7)
    model = PAMNet(PAMNetConfig(**cfg), torch.Generator().manual_seed(2))
    for loader in (_loader(kind, mols),
                   _loader(kind, mols, shuffle=True, seed=6, build_perms=True,
                           wire_geometry="derive")):
        rng = loader.rng_state()
        split = StackedEval(loader, "cpu")
        assert "StackedEval: 3 batches, " in capsys.readouterr().err
        drawn = loader.rng_state()
        loader.set_rng_state(rng)
        order = loader.batches()
        assert loader.rng_state() == drawn and split.mask.sum() == len(mols)
        assert not any(gb.perms for gb in split.batches)
        want = predict(model, [loader.collate(i, build_perms=False) for i in order], "cpu")
        for got in (split.predict(model), predict(model, split, "cpu")):
            assert got[0].dtype == want[0].dtype
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def _dp_rank(rank: int, world: int, init_method: str, job: dict) -> None:
    """One of two gloo ranks: ``run_epoch(dp=2)`` pipelined and serial, and
    the parent's serial DP loop written out, each from the same state and
    loader order; ``StackedEval(dp=2)`` and ``predict(dp=2)``."""
    limit_intra_op_threads()
    init_dp(world, rank, "cpu", init_method=init_method)
    try:
        kind = job["kind"]
        cfg, loss_kind = KINDS[kind]
        loader = _loader(kind, job["mols"], batch_size=2, shuffle=True, seed=3,
                         build_perms=True)
        rng, out = loader.rng_state(), {}
        for name in ("pipelined", "serial", "parent"):
            model, opt, ema = _fresh(kind, job["state"], loader, rng)
            if name == "parent":
                res = _parent_dp_epoch(model, opt, ema, loader, loss_kind, world)
            else:
                res = run_epoch(model, opt, ema, loader, "cpu", loss_kind, dp=world,
                                pipelined=name == "pipelined")[:3]
            out[name] = dict(loss_sum=res[0], graphs=res[1], losses=torch.stack(res[2]),
                             params={n: p.detach().clone() for n, p in model.named_parameters()})
        evaluate = _loader(kind, job["mols"], batch_size=2)
        model = PAMNet(PAMNetConfig(**cfg))
        model.load_state_dict(job["state"])
        out["stacked"] = StackedEval(evaluate, "cpu", dp=world, verbose=False).predict(model)
        out["predict"] = predict(model, list(evaluate), "cpu", dp=world)
        torch.save(out, os.path.join(job["out"], f"rank{rank}.pt"))
    finally:
        teardown()


def _parent_dp_epoch(model, opt, ema, loader, kind, dp):
    """The port's DP epoch before the pipeline (groups of ``dp`` batches, rank
    r collating and stepping batch g * dp + r, trailing batches alone)."""
    loss_sum = torch.zeros((), dtype=torch.float64)
    graphs, losses = 0, []
    order, r = loader.batches(), dist.get_rank()
    whole = len(order) - len(order) % dp
    steps = [(loader.collate(order[g + r]), sum(len(i) for i in order[g:g + dp]), True)
             for g in range(0, whole, dp)]
    steps += [(loader.collate(idxs), len(idxs), False) for idxs in order[whole:]]
    for gb, count, group in steps:
        loss = (dp_train_step(model, opt, ema, gb.to("cpu"), kind, count) if group
                else train_step(model, opt, ema, gb.to("cpu"), kind))
        loss_sum += loss.double() * count
        graphs += count
        losses.append(loss)
    return float(loss_sum), graphs, losses


def test_run_epoch_dp2_is_the_serial_dp_loop_bit_for_bit(tmp_path):
    """Nine QM9 molecules in batches of 2 on two ranks: two groups and a
    trailing batch stepped alone; every route equal on each rank and across
    the ranks; DP evaluation from resident batches equals ``predict(dp=2)``
    and one process's ``predict``."""
    cfg, _ = KINDS["qm9"]
    mols = _mols("qm9", 9, seed=12)
    state = PAMNet(PAMNetConfig(**cfg), torch.Generator().manual_seed(4)).state_dict()
    job = dict(kind="qm9", mols=mols, state=state, out=str(tmp_path))
    torch.multiprocessing.spawn(_dp_rank, args=(2, f"file://{tmp_path}/rendezvous", job),
                                nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    model = PAMNet(PAMNetConfig(**cfg))
    model.load_state_dict(state)
    one = predict(model, list(_loader("qm9", mols, batch_size=2)), "cpu")
    want = ranks[0]["parent"]
    assert want["graphs"] == 9 and len(want["losses"]) == 3
    for r in ranks:
        for name in ("pipelined", "serial", "parent"):
            got = r[name]
            assert (got["loss_sum"], got["graphs"]) == (want["loss_sum"], want["graphs"]), name
            assert torch.equal(got["losses"], want["losses"]), name
            assert all(torch.equal(got["params"][n], p) for n, p in want["params"].items()), name
        for pred, y in (r["stacked"], r["predict"]):
            assert np.array_equal(pred, one[0]) and np.array_equal(y, one[1])


def _record_collation(monkeypatch) -> list[tuple[bool, bool | None, list[int]]]:
    """Every ``GraphLoader.collate`` call as (the loader shuffles,
    ``build_perms`` as passed, the indices)."""
    calls = []
    collate = GraphLoader.collate

    def recorded(self, idxs, build_perms=None):
        calls.append((self.shuffle, build_perms, list(idxs)))
        return collate(self, idxs, build_perms)

    monkeypatch.setattr(GraphLoader, "collate", recorded)
    return calls


def _jax_permutations(train_mols: list[dict], kind: str, args) -> tuple[list, list]:
    """The first two epochs' batches of the JAX drivers' training loader
    (shuffled with ``--seed``, no drop_last) over the same molecules."""
    jl = JaxLoader(train_mols, kind, args.cutoff_l, args.cutoff_g, batch_size=args.batch_size,
                   shuffle=True, seed=args.seed, build_tables=False, build_perms=True)
    first, second = jl.batches(), jl.batches()
    assert first != second
    return first, second


@pytest.mark.parametrize("driver", ["pdbbind", "rna"])
def test_drivers_train_in_the_jax_drivers_batch_order(driver, monkeypatch, tmp_path):
    """Fails before the pipeline: the port's epoch 1 trained on the first
    permutation, JAX's on the second."""
    root = str(tmp_path / "data")
    common = ["--data_root", root, "--epochs", "1", "--dim", "8", "--n_layer", "1",
              "--batch_size", "3", "--device", "cpu", "--save_dir", str(tmp_path / "save")]
    if driver == "pdbbind":
        mols = _mols("pdbbind", 16, seed=21)
        write_tu_split(root, "train_val", mols[:12])
        write_tu_split(root, "test", mols[12:])
        module, kind = main_pdbbind, "pdbbind"
        train_mols = module.load_complexes(module.build_parser().parse_args(common))[0]
    else:
        mols = _mols("rna", 9, seed=21)
        write_tu_split(root, "train", mols[:7])
        write_tu_split(root, "val", mols[7:])
        module, kind = main_rna_puzzles, "rna"
        train_mols = module.load_structures(module.build_parser().parse_args(common))[0]
    first, second = _jax_permutations(train_mols, kind, module.build_parser().parse_args(common))
    calls = _record_collation(monkeypatch)
    module.main(common)
    shuffled = [(perms, idxs) for shuffles, perms, idxs in calls if shuffles]
    assert [idxs for perms, idxs in shuffled if perms is False] == first  # the train split
    assert [idxs for perms, idxs in shuffled if perms is None] == second  # epoch 1


def test_main_qm9_trains_on_the_first_permutation(monkeypatch, tmp_path):
    """JAX's QM9 driver stages no train split, so epoch 1 trains on the
    training loader's first permutation (drop_last) in both packages."""
    argv = ["--synthetic", "--limit", "40", "--epochs", "1", "--dim", "8", "--n_layer", "1",
            "--batch_size", "4", "--device", "cpu", "--save_dir", str(tmp_path / "save")]
    args = main_qm9.build_parser().parse_args(argv)
    mols, n_train, _ = main_qm9.load_molecules(args)
    jl = JaxLoader(mols[:n_train], "qm9", args.cutoff_l, args.cutoff_g,
                   batch_size=args.batch_size, shuffle=True, seed=args.seed, drop_last=True,
                   build_tables=False, build_perms=True)
    calls = _record_collation(monkeypatch)
    main_qm9.main(argv)
    assert [idxs for shuffles, _, idxs in calls if shuffles] == jl.batches()


def test_device_busy_s_counts_overlapping_work_once():
    """The union of the card's intervals: a copy on a second stream under a
    kernel counts once, an annotation over kernels not at all, host records
    not at all."""

    class Event:
        def __init__(self, start, end, device="DeviceType.CUDA", annotation=False):
            self.span, self.device, self.annotation = (start, end), device, annotation

        def start_ns(self):
            return self.span[0]

        def end_ns(self):
            return self.span[1]

        def device_type(self):
            return self.device

        def is_user_annotation(self):
            return self.annotation

    events = [Event(0, 100), Event(50, 120), Event(200, 250), Event(210, 220),
              Event(0, 1000, annotation=True), Event(300, 900, device="DeviceType.CPU")]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    assert device_busy_s(Prof) == pytest.approx(170e-9)
