"""Data parallelism on the CPU: two ranks over gloo (``torch.distributed``,
spawned with a ``file://`` rendezvous under the test's temporary directory)
run the port's ``dp_train_step``, ``run_epoch(dp=2)`` and ``predict(dp=2)``
at dim 16, 2 layers, on the QM9, PDBbind and RNA branches.

Held against:
  * JAX's ``make_dp_train_step`` on a 2-device CPU mesh, the same
    parameters (``from_jax_params``) and the same micro-batches (3 and 2
    graphs: the global count weights them): parameters after one SGD step
    (lr 0.1) within rtol 1e-4, atol 1e-6, the tolerance of JAX's own test
    of DP against one batch (``tests/test_parallel.py``); after two steps
    of the full chain (Adam, the QM9 recipe's clip 1000 and EMA 0.999,
    lr 1e-3) within atol 2e-5 on parameters and EMA: Adam's first steps
    move each parameter by about lr whatever the gradient's size, so a
    rounding difference in a gradient near 0 moves that parameter by up to
    a few percent of lr; the losses within rtol 1e-5;
  * the port's own step on the union of the two micro-batches, within
    rtol 1e-4, atol 1e-6 after one SGD step; in bfloat16 each gradient
    within 2e-2 * max|g| + 1e-6 (bfloat16 rounds each rank's products, the
    union rounds them once);
  * JAX's ``EpochRunner.run(dp=2)`` over three batches (one group and a
    trailing batch stepped alone): its loss sum, graph count and step count
    and the parameters within the SGD tolerance.
The two ranks' parameters and EMA are equal bit for bit, DP evaluation
equals one process's bit for bit, and with one rank ``dp_train_step`` is
``train_step`` bit for bit, in float32 and bfloat16.
"""

from torch_threads import intra_op_threads, limit_intra_op_threads

limit_intra_op_threads()

import functools
import math
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from pamnet_tpu.config import PAMNetConfig as JaxConfig
from pamnet_tpu.data.loader import GraphLoader as JaxLoader
from pamnet_tpu.models import init_pamnet
from pamnet_tpu.train import loop as jloop
from pamnet_tpu.train.schedules import constant as jax_constant
from pamnet_tpu_torch import main_pdbbind, main_qm9, main_rna_puzzles
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.batch import collate_structures
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule, synthetic_pdbbind_dataset,
                                             synthetic_qm9_dataset, synthetic_rna_dataset)
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.parallel import init_dp, teardown
from pamnet_tpu_torch.train.ema import ema_init
from pamnet_tpu_torch.train.loop import Optimizer, dp_train_step, predict, run_epoch, train_step
from pamnet_tpu_torch.train.schedules import constant
from pamnet_tpu_torch.weights import from_jax_params

BRANCHES = {
    "qm9": (dict(dataset="QM9", dim=16, n_layer=2, cutoff_l=5.0, cutoff_g=5.0), "l1"),
    "pdbbind": (dict(dataset="PDBbind", dim=16, n_layer=2, cutoff_l=2.0, cutoff_g=6.0), "mse"),
    "rna": (dict(dataset="rna_dp", dim=16, n_layer=2, cutoff_l=2.6, cutoff_g=20.0,
                 flow="target_to_source"), "smooth_l1"),
}
PER = 3  # graphs a micro-batch; the second holds PER - 1
SGD_LR, ADAM_LR = 0.1, 1e-3


def _mols(branch: str, n: int):
    if branch == "qm9":
        return synthetic_qm9_dataset(n, seed=11)
    if branch == "pdbbind":
        return [pdbbind_molecule(g) for g in synthetic_pdbbind_dataset(n, seed=11)]
    return synthetic_rna_dataset(n, seed=11, n_atoms=60)


def _loader(branch: str, mols, batch_size: int, **kw):
    cfg, _ = BRANCHES[branch]
    return GraphLoader(mols, branch, cfg["cutoff_l"], cfg["cutoff_g"], batch_size, **kw)


def _model(cfg: dict, state: dict):
    model = PAMNet(PAMNetConfig(**cfg))
    model.load_state_dict(state, strict=True)
    return model


def _chain(branch: str, model):
    """The full optimizer chain: Adam, and for QM9 the recipe's clip and EMA."""
    qm9 = branch == "qm9"
    return (Optimizer(model.parameters(), constant(ADAM_LR), clip_norm=1000.0 if qm9 else None),
            ema_init(model.state_dict()) if qm9 else None)


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _worker(rank: int, world: int, init_method: str, job: dict) -> None:
    """One rank: every data-parallel computation of ``job``'s branch; its
    results to ``<out>/rank<r>.pt``."""
    limit_intra_op_threads()
    init_dp(world, rank, "cpu", init_method=init_method)
    try:
        branch, state, micro = job["branch"], job["state"], job["micro"]
        cfg, kind = BRANCHES[branch]
        count = sum(gb.num_graphs for gb in micro)
        out = {}
        model = _model(cfg, state)
        loss = dp_train_step(model, torch.optim.SGD(model.parameters(), lr=SGD_LR), None,
                             micro[rank], kind, count)
        out["sgd"] = dict(params=_params(model), loss=float(loss))
        model = _model(cfg, state)
        opt, ema = _chain(branch, model)
        losses = [float(dp_train_step(model, opt, ema, micro[rank], kind, count))
                  for _ in range(2)]
        out["chain"] = dict(params=_params(model), ema=ema, losses=losses)
        out["eval"] = predict(_model(cfg, state), job["eval"], "cpu", dp=world)
        if branch == "qm9":
            model = _model(dict(cfg, compute_dtype="bfloat16"), state)
            dp_train_step(model, torch.optim.SGD(model.parameters(), lr=SGD_LR), None,
                          micro[rank], kind, count)
            out["bf16"] = _params(model)
            loader = _loader(branch, job["epoch_mols"], 2, build_perms=True)
            model = _model(cfg, state)
            res = run_epoch(model, torch.optim.SGD(model.parameters(), lr=SGD_LR), None,
                            loader, "cpu", kind, dp=world)
            out["epoch"] = dict(loss_sum=res[0], graphs=res[1],
                                losses=[float(v) for v in res[2]], params=_params(model))
        torch.save(out, os.path.join(job["out"], f"rank{rank}.pt"))
    finally:
        teardown()


@functools.lru_cache(maxsize=None)
def _inputs(branch: str):
    """JAX's initial parameters, the micro-batches' molecules and, for QM9,
    the epoch's."""
    params = init_pamnet(jax.random.PRNGKey(5), JaxConfig(**BRANCHES[branch][0]))
    return params, _mols(branch, 2 * PER - 1), synthetic_qm9_dataset(5, seed=12)


def _jax_reference(branch: str):
    """JAX's DP results on the inputs."""
    cfg, kind = BRANCHES[branch]
    jcfg = JaxConfig(**cfg)
    params, mols, epoch_mols = _inputs(branch)
    jmicro = [jax.tree.map(jnp.asarray, b) for b in JaxLoader(
        mols, branch, cfg["cutoff_l"], cfg["cutoff_g"], batch_size=PER, build_tables=False,
        build_perms=True)]
    stacked = jloop.stack_microbatches(jmicro)
    mesh = jloop.make_mesh(2)
    sgd = optax.sgd(SGD_LR)
    state, loss = jloop.make_dp_train_step(jcfg, sgd, kind, mesh, ema_decay=None)(
        jloop.init_train_state(params, sgd, use_ema=False), stacked)
    out = dict(sgd=(from_jax_params(state.params), float(loss)))
    qm9 = branch == "qm9"
    chain = jloop.make_optimizer(jax_constant(ADAM_LR), clip_norm=1000.0 if qm9 else None)
    step = jloop.make_dp_train_step(jcfg, chain, kind, mesh, ema_decay=0.999 if qm9 else None)
    state = jloop.init_train_state(params, chain, use_ema=qm9)
    losses = []
    for _ in range(2):
        state, loss = step(state, stacked)
        losses.append(float(loss))
    out["chain"] = (from_jax_params(state.params),
                    from_jax_params(state.ema) if qm9 else None, losses)
    if qm9:  # EpochRunner over 5 molecules in batches of 2: one group, one trailing batch
        batches = list(JaxLoader(epoch_mols, branch, cfg["cutoff_l"], cfg["cutoff_g"],
                                 batch_size=2, build_tables=False, build_perms=True))
        runner = jloop.EpochRunner(jcfg, sgd, kind, dp=2)
        state, loss_sum, ng, nb = runner.run(jloop.init_train_state(params, sgd, use_ema=False),
                                             batches,
                                             lambda t: jax.tree.map(jnp.asarray, t))
        out["epoch"] = (from_jax_params(state.params), loss_sum, ng, nb)
    return out


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """``dp_run(branch)``: the JAX reference and both ranks' results."""
    runs = {}

    def run(branch: str):
        if branch not in runs:
            params, mols, epoch_mols = _inputs(branch)
            out = tmp_path_factory.mktemp(f"dp_{branch}")
            micro = list(_loader(branch, mols, PER, build_perms=True))
            assert [gb.num_graphs for gb in micro] == [PER, PER - 1]
            eval_batches = list(_loader(branch, _mols(branch, 7), 2))  # 4 batches, the last of 1
            job = dict(branch=branch, state=from_jax_params(params), micro=micro,
                       eval=eval_batches, epoch_mols=epoch_mols, out=str(out))
            # The ranks run while this process computes JAX's results.
            ranks = torch.multiprocessing.spawn(
                _worker, args=(2, f"file://{out}/rendezvous", job), nprocs=2, join=False)
            ref = _jax_reference(branch)
            while not ranks.join():
                pass
            runs[branch] = (ref, job, [torch.load(out / f"rank{r}.pt", weights_only=False)
                                       for r in range(2)])
        return runs[branch]

    return run


def _assert_close(got: dict, want: dict, rtol: float, atol: float, what: str) -> None:
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {name}")


def _assert_equal(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), f"{what}: {name}"


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_dp_step_matches_jax(dp_run, branch):
    ref, _, ranks = dp_run(branch)
    want_params, want_loss = ref["sgd"]
    _assert_close(ranks[0]["sgd"]["params"], want_params, 1e-4, 1e-6, f"{branch} SGD")
    assert math.isclose(ranks[0]["sgd"]["loss"], want_loss, rel_tol=1e-5)
    want_params, want_ema, want_losses = ref["chain"]
    got = ranks[0]["chain"]
    _assert_close(got["params"], want_params, 0.0, 2e-5, f"{branch} Adam")
    if want_ema is not None:
        _assert_close(got["ema"], want_ema, 0.0, 2e-5, f"{branch} EMA")
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_replicas_are_equal_bit_for_bit(dp_run, branch):
    _, _, ranks = dp_run(branch)
    for part in ("sgd", "chain"):
        _assert_equal(ranks[0][part]["params"], ranks[1][part]["params"], part)
    assert ranks[0]["sgd"]["loss"] == ranks[1]["sgd"]["loss"]
    assert ranks[0]["chain"]["losses"] == ranks[1]["chain"]["losses"]
    if branch == "qm9":
        _assert_equal(ranks[0]["chain"]["ema"], ranks[1]["chain"]["ema"], "EMA")
        _assert_equal(ranks[0]["bf16"], ranks[1]["bf16"], "bf16")
        _assert_equal(ranks[0]["epoch"]["params"], ranks[1]["epoch"]["params"], "epoch")


def _union_sgd(branch: str, job: dict, compute_dtype: str = "float32"):
    """The port's one-process SGD step on the union of the micro-batches:
    (parameters after it, its loss)."""
    cfg, kind = BRANCHES[branch]
    union = collate_structures(_loader(branch, _inputs(branch)[1], 2 * PER).structs,
                               build_perms=True,
                               num_atom_types=None if branch == "pdbbind" else
                               PAMNetConfig(**cfg).num_atom_types)
    model = _model(dict(cfg, compute_dtype=compute_dtype), job["state"])
    loss = train_step(model, torch.optim.SGD(model.parameters(), lr=SGD_LR), None, union, kind)
    return _params(model), float(loss)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_dp_step_matches_the_union_batch(dp_run, branch):
    _, job, ranks = dp_run(branch)
    params, loss = _union_sgd(branch, job)
    _assert_close(ranks[0]["sgd"]["params"], params, 1e-4, 1e-6, f"{branch} union")
    assert math.isclose(ranks[0]["sgd"]["loss"], loss, rel_tol=1e-5)


def test_bf16_dp_step_matches_the_union_batch(dp_run):
    _, job, ranks = dp_run("qm9")
    params, _ = _union_sgd("qm9", job, "bfloat16")
    for name, p0 in job["state"].items():
        want = (p0 - params[name]) / SGD_LR  # the union's gradient
        got = (p0 - ranks[0]["bf16"][name]) / SGD_LR
        bound = 2e-2 * float(want.abs().max()) + 1e-6
        assert float((got - want).abs().max()) <= bound, name


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_dp_evaluation_is_one_process_bit_for_bit(dp_run, branch):
    _, job, ranks = dp_run(branch)
    cfg, _ = BRANCHES[branch]
    pred, y = predict(_model(cfg, job["state"]), job["eval"], "cpu")
    assert len(job["eval"]) == 4 and job["eval"][-1].num_graphs == 1
    for r in ranks:
        got_pred, got_y = r["eval"]
        assert got_pred.dtype == pred.dtype and np.array_equal(got_pred, pred)
        assert np.array_equal(got_y, y)


def test_epoch_trailing_group_matches_epoch_runner(dp_run):
    """Batches of 2, 2 and 1 graphs: one DP group of 4 graphs, then the last
    batch stepped alone on both ranks; the loss sum weights each step's
    mean loss by its graphs, as ``EpochRunner.run``."""
    ref, _, ranks = dp_run("qm9")
    want_params, loss_sum, ng, nb = ref["epoch"]
    got = ranks[0]["epoch"]
    assert got["graphs"] == ng == 5 and len(got["losses"]) == nb == 2
    l0, l1 = (np.float32(v) for v in got["losses"])
    assert got["loss_sum"] == float(np.float64(l0) * 4 + np.float64(l1) * 1)
    assert math.isclose(got["loss_sum"], loss_sum, rel_tol=1e-5)
    _assert_close(got["params"], want_params, 1e-4, 1e-6, "epoch")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_one_rank_is_train_step_bit_for_bit(tmp_path, compute_dtype):
    """World size 1: parameters, EMA and losses of three steps of the QM9
    recipe's chain are ``train_step``'s bit for bit."""
    cfg, kind = BRANCHES["qm9"]
    cfg = dict(cfg, compute_dtype=compute_dtype)
    state = PAMNet(PAMNetConfig(**cfg), torch.Generator().manual_seed(3)).state_dict()
    batches = list(_loader("qm9", synthetic_qm9_dataset(9, seed=4), PER, build_perms=True))
    runs = []
    init_dp(1, 0, "cpu", init_method=f"file://{tmp_path}/rendezvous")
    try:
        for dp in (False, True):
            model = _model(cfg, state)
            opt, ema = _chain("qm9", model)
            losses = [dp_train_step(model, opt, ema, gb, kind, gb.num_graphs) if dp
                      else train_step(model, opt, ema, gb, kind) for gb in batches]
            runs.append((_params(model), ema, [float(v) for v in losses]))
    finally:
        teardown()
    _assert_equal(runs[0][0], runs[1][0], "params")
    _assert_equal(runs[0][1], runs[1][1], "EMA")
    assert runs[0][2] == runs[1][2]


_EPOCH = re.compile(r"Epoch: (\d+), Train MAE: (\S+),")


def test_main_qm9_dp_writes_on_rank_0_and_resumes(tmp_path, monkeypatch, capfd):
    """``main_qm9 --dp 2`` on the CPU: one line an epoch and one CSV row an
    epoch (rank 0 alone), its checkpoint resumed by ``--resume`` repeats a
    straight run's second epoch bit for bit."""
    monkeypatch.setenv("OMP_NUM_THREADS", str(max(1, intra_op_threads() // 2)))
    base = ["--synthetic", "--limit", "40", "--dim", "16", "--n_layer", "1", "--batch_size",
            "4", "--device", "cpu", "--dp", "2", "--compute_dtype", "float32"]
    straight = main_qm9.main(base + ["--epochs", "2", "--save_dir", str(tmp_path / "a")])
    csv = tmp_path / "m.csv"
    first = main_qm9.main(base + ["--epochs", "1", "--save_dir", str(tmp_path / "b"),
                                  "--metrics_csv", str(csv)])
    last = tmp_path / "b" / "QM9" / "last.ckpt"
    assert last.is_file() and (tmp_path / "b" / "QM9" / "best_model.pt").is_file()
    resumed = main_qm9.main(base + ["--epochs", "2", "--save_dir", str(tmp_path / "b"),
                                    "--resume", str(last)])
    out = capfd.readouterr().out
    assert [int(e[0]) for e in _EPOCH.findall(out)] == [1, 2, 1, 2]
    assert len(csv.read_text().splitlines()) == 2  # the header and rank 0's row
    assert first["train_mae"] == straight["train_mae"][:1]
    assert resumed["train_mae"] == straight["train_mae"][1:]
    assert resumed["test_mae"] == straight["test_mae"]


def test_torchrun_environment_joins_its_group(tmp_path, monkeypatch):
    """Two processes started as torchrun starts them (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) join one group
    and train as ``--dp 2`` does: rank 0 prints and writes, rank 1 is quiet,
    and rank 0's epoch line is the spawned run's."""
    argv = ["--synthetic", "--limit", "40", "--dim", "16", "--n_layer", "1", "--batch_size",
            "4", "--device", "cpu", "--compute_dtype", "float32", "--epochs", "1"]
    monkeypatch.setenv("OMP_NUM_THREADS", str(max(1, intra_op_threads() // 2)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pamnet_tpu_torch.main_qm9", *argv,
         "--save_dir", str(tmp_path / "run")], cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert _EPOCH.findall(outs[0][0]) and outs[1][0] == ""
    assert (tmp_path / "run" / "QM9" / "last.ckpt").is_file()
    spawned = main_qm9.main(argv + ["--dp", "2", "--save_dir", str(tmp_path / "spawned")])
    assert float(_EPOCH.findall(outs[0][0])[0][1]) == float(f"{spawned['train_mae'][0]:.7f}")


@pytest.mark.parametrize("driver", [main_qm9, main_pdbbind, main_rna_puzzles],
                         ids=["qm9", "pdbbind", "rna"])
def test_dp_needs_a_card_a_rank(monkeypatch, driver):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--dp 2 needs 2 devices, have 1"):
        driver.main(["--synthetic", "4", "--dp", "2", "--epochs", "1"]
                    if driver is not main_qm9 else ["--synthetic", "--dp", "2"])
