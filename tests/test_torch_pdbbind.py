"""The port's PDBbind branch against the JAX package on the same inputs: the
synthetic generators, structures and training batches, the TU files, the
forward and the MSE loss's gradient with respect to every parameter, three
Adam steps under the multistep schedule, the metrics, the parameter
mapping, and the entry point run in-process; the f64 numpy oracle
(``tests/oracle_numpy.py``) judges the forward as well.

Complexes: ``synthetic_pdbbind_graph`` (12-22 pocket and 5-9 ligand atoms,
three subgraphs at x, x + 100 and x + 200 A, so the signed pool sees both
signs).  Tolerances: batch indices, offsets and permutations exact, floats
within 1e-6; predictions within 1e-5 abs; gradients per tensor
``max|d| <= 1e-4 * max|g_jax| + 1e-6``; parameters after three Adam steps
within 1e-6; the oracle within 1e-3 * max(1, |want|) (its own tolerance in
``tests/test_branch_parity.py``).  The port's gradients come from its
autograd Functions' plain backwards on the CPU; JAX's from ``jax.grad`` of
the loss of ``pamnet_tpu/train/loop.py:37-51``.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import contextlib
import dataclasses
import functools
import io
import json
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from oracle_numpy import pdbbind_forward
from pamnet_tpu.config import PAMNetConfig as JaxConfig
from pamnet_tpu.data import batch as jbatch
from pamnet_tpu.data import synthetic as jsyn
from pamnet_tpu.data.loader import GraphLoader as JaxLoader
from pamnet_tpu.data.tu import TUDataset as JaxTUDataset
from pamnet_tpu.data.tu_writer import write_tu_dataset
from pamnet_tpu.models import apply_pamnet, init_pamnet
from pamnet_tpu.train import loop as jloop
from pamnet_tpu.train.schedules import multistep as jax_multistep
from pamnet_tpu.utils import metrics as jmetrics
from pamnet_tpu_torch import bench, main_pdbbind, metrics
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data import batch as tbatch
from pamnet_tpu_torch.data import synthetic as tsyn
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.tu import TUDataset, write_tu_split
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.train.loop import Optimizer, batch_loss, train_step
from pamnet_tpu_torch.train.schedules import multistep
from pamnet_tpu_torch.weights import from_jax_params
from test_torch_model import _assert_same_batch

CUT_L, CUT_G = 2.0, 6.0


def _mols(n, seed):
    return [tsyn.pdbbind_molecule(g) for g in tsyn.synthetic_pdbbind_dataset(n, seed)]


@pytest.mark.parametrize("kind", ["graph", "complex"])
def test_synthetic_pdbbind_generators_match_jax(kind):
    make = {"graph": (jsyn.synthetic_pdbbind_dataset, tsyn.synthetic_pdbbind_dataset),
            "complex": (jsyn.synthetic_pdbbind_complex_dataset,
                        tsyn.synthetic_pdbbind_complex_dataset)}[kind]
    want, got = make[0](3, seed=11), make[1](3, seed=11)
    for w, g in zip(want, got):
        assert g.keys() == w.keys() == {"attrs", "labels", "y"} and g["y"] == w["y"]
        for k in ("attrs", "labels"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
        n = len(g["attrs"])
        assert g["labels"].shape == (n, 18)
        # [complex | pocket + 100 | ligand + 200]: both signs of the pool.
        assert 0 < int((g["attrs"][:, 0] > 40).sum()) == n // 2
    if kind == "complex":
        assert all(200 <= len(g["attrs"]) <= 700 for g in got)


def test_pdbbind_structures_and_batch_match_jax():
    """``precompute_structure`` and ``collate_structures(build_perms=True)``:
    JAX's arrays bit for bit, ``feat`` included; no CSR of ``z``."""
    mols = _mols(3, seed=4)
    js = [jbatch.attach_basis(jbatch.precompute_structure(m, "pdbbind", CUT_L, CUT_G), CUT_L)
          for m in mols]
    ts = [tbatch.attach_basis(tbatch.precompute_structure(m, "pdbbind", CUT_L, CUT_G), CUT_L)
          for m in mols]
    for j, t in zip(js, ts):
        for k in ("pos", "z", "feat", "eg", "el", "dist_g", "dist_l", "sbf_radial", "cbf1",
                  "cbf2"):
            assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), k
        for tk in ("t2", "t1"):
            for k, v in j[tk].items():
                assert np.array_equal(t[tk][k], v), (tk, k)
        assert t["el"].shape[1] > 0 and not t["z"].any()
    pads = jbatch.PadSizes.bucketed(*[int(sum(c)) for c in zip(
        *[jbatch.structure_counts(s) for s in js])], 3)
    jb = jbatch.collate_structures(js, pads, build_tables=False, build_perms=True)
    tb = tbatch.collate_structures(ts, tbatch.PadSizes(
        *(getattr(pads, f.name) for f in dataclasses.fields(tbatch.PadSizes))),
        build_perms=True)
    _assert_same_batch(jb, tb)
    np.testing.assert_array_equal(tb.feat.numpy(), np.asarray(jb.feat))
    assert tb.feat.shape == (pads.n, 18)
    for key in ("el_src", "t2_kj", "t1_jj"):
        for suffix in ("_perm", "_poff"):
            np.testing.assert_array_equal(tb.perms[key + suffix].numpy(),
                                          np.asarray(jb.tables[key + suffix]), key + suffix)
    assert "z_perm" not in tb.perms and tb.groups("z") is None
    # Global edges dst-major (source_to_target): the unsorted endpoint is src.
    assert tb.eg_dst_off is not None and "eg_src_perm" in tb.perms
    assert tb.longest["eg_dst"] > 1


def test_pdbbind_structure_without_local_edges():
    """Atoms 3-5 A apart: global edges, no local edge within 2 A, no
    triplet; the structure builds and collates as JAX's does."""
    pos = np.array([[0, 0, 0], [3, 0, 0], [0, 4, 0], [100, 0, 0], [103, 0, 0]], np.float32)
    mol = dict(pos=pos, feat=np.ones((5, 18), np.float32), y=1.0)
    j = jbatch.attach_basis(jbatch.precompute_structure(mol, "pdbbind", CUT_L, CUT_G), CUT_L)
    t = tbatch.attach_basis(tbatch.precompute_structure(mol, "pdbbind", CUT_L, CUT_G), CUT_L)
    assert t["el"].shape == (2, 0) and t["sbf_radial"].shape == j["sbf_radial"].shape == (0, 42)
    assert t["cbf1"].shape == j["cbf1"].shape == (0, 7)
    assert np.array_equal(t["eg"], j["eg"]) and t["eg"].shape[1] == 8
    tb = tbatch.collate_structures([t], build_perms=True)
    assert tb.valid["el"] == 0 and tb.valid["eg"] == 8


def test_tu_splits_round_trip_and_match_jax_writer(tmp_path):
    """The port's writer gives the JAX writer's files byte for byte; the
    port's and JAX's readers give the same complexes back (``feat`` to the
    four decimals of the files)."""
    graphs = tsyn.synthetic_pdbbind_dataset(3, seed=6)
    mols = [tsyn.pdbbind_molecule(g) for g in graphs]
    write_tu_split(str(tmp_path / "port"), "train_val", mols)
    write_tu_dataset(str(tmp_path / "jax"), "train_val", graphs)
    for suffix in ("graph_indicator", "node_attributes", "node_labels", "graph_labels"):
        name = f"train_val/raw/train_val_{suffix}.txt"
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    got = TUDataset(str(tmp_path / "port"), "train_val").molecules()
    want = JaxTUDataset(str(tmp_path / "port"), "train_val").molecules()
    for g, w, m in zip(got, want, mols):
        assert g.keys() == w.keys() == {"pos", "z", "y", "feat"}
        for k in ("pos", "feat", "z"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
        np.testing.assert_allclose(g["feat"], m["feat"], rtol=0, atol=5e-5)
        np.testing.assert_allclose(g["pos"], m["pos"], rtol=0, atol=5e-4)
        assert g["y"] == w["y"]


@functools.lru_cache(maxsize=None)
def _reference(n_layer: int, dim: int):
    """JAX params, the port's batch, and JAX's predictions and MSE gradients
    on the same complexes (no ELL tables, as JAX's main_pdbbind.py builds by default)."""
    kw = dict(dataset="PDBbind", dim=dim, n_layer=n_layer, cutoff_l=CUT_L, cutoff_g=CUT_G)
    jcfg = JaxConfig(**kw)
    params = init_pamnet(jax.random.PRNGKey(n_layer + dim), jcfg)
    mols = _mols(3, seed=n_layer + dim)
    jb = next(iter(JaxLoader(mols, "pdbbind", CUT_L, CUT_G, batch_size=4, build_tables=False,
                             build_perms=True)))
    tb = next(iter(GraphLoader(mols, "pdbbind", CUT_L, CUT_G, batch_size=4, build_perms=True)))

    def loss(p, g):
        pred = apply_pamnet(p, g, jcfg)
        total, count = jloop._loss_terms(pred, g.y, g.graph_mask, "mse")
        return total / jnp.maximum(count, 1.0), pred

    (_, pred), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, jb))
    return params, mols, tb, np.asarray(pred), from_jax_params(grads), kw


def _model(params, kw):
    model = PAMNet(PAMNetConfig(**kw))
    model.load_state_dict(from_jax_params(params), strict=True)
    return model


def _assert_grads_close(got, want):
    """Per tensor ``max|d| <= 1e-4 * max|g_jax| + 1e-6``; a head's bias
    (``W_out.bias``) takes the scale of its Linear, weight and bias
    together.  Its gradient is the signed pool's sum of the heads'
    cotangents, whose signs add to zero over a complex (the complex holds as
    many atoms as its pocket and ligand copies), so only the attention's
    difference between the copies is left of it: 0.065 against a weight
    gradient of 1.32 at (2, 8), where float32 leaves 1.8e-5 between the
    packages and puts either package up to 2.6 x 1e-4 * 0.065 from a
    float64 run of the port."""
    assert set(got) == set(want)
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        scale = float(w.abs().max())
        if name.endswith("W_out.bias"):
            scale = max(scale, float(want[name[:-4] + "weight"].abs().max()))
        bound = 1e-4 * scale + 1e-6
        assert err <= bound, f"{name}: max|d| {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("n_layer,dim", [(1, 16), (2, 8)])
def test_pdbbind_forward_and_gradients_match_jax(n_layer, dim):
    params, mols, tb, want_pred, want, kw = _reference(n_layer, dim)
    model = _model(params, kw)
    with torch.no_grad():
        pred = model(tb).numpy()
        plain = model(tb, plain=True).numpy()
    np.testing.assert_allclose(pred, want_pred, rtol=0, atol=1e-5)
    np.testing.assert_allclose(plain, want_pred, rtol=0, atol=1e-5)
    model.zero_grad()
    batch_loss(model, tb, "mse").backward()
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in
           model.named_parameters()}
    _assert_grads_close(got, want)
    # The features reach the loss through init_linear; no atom type is read.
    assert float(got["init_linear.weight"].abs().max()) > 0.0
    assert float(want["embeddings"].abs().max()) == 0.0 == float(got["embeddings"].abs().max())
    # The f64 oracle, one complex at a time (batch graph i = complex i).
    sd = {k: v.double().numpy() for k, v in model.state_dict().items()}
    for i, m in enumerate(mols):
        ref = pdbbind_forward(sd, m, n_layer=n_layer, cutoff_l=CUT_L, cutoff_g=CUT_G)
        assert abs(pred[i] - ref) < 1e-3 * max(1.0, abs(ref)), (i, pred[i], ref)


def test_three_adam_steps_with_multistep_match_jax():
    """MSE, Adam, no clip, no EMA, the multistep schedule with a milestone
    inside the three steps (32 steps an epoch fractionally: update 2 runs at
    epoch 64, lr x 0.2), against ``make_train_step``."""
    params, mols, tb, _, _, kw = _reference(1, 16)
    jb = jax.tree.map(jnp.asarray, next(iter(JaxLoader(
        mols, "pdbbind", CUT_L, CUT_G, batch_size=4, build_tables=False, build_perms=True))))
    optimizer = jloop.make_optimizer(jax_multistep(5e-4, steps_per_epoch=1 / 32))
    state = jloop.init_train_state(params, optimizer, use_ema=False)
    step = jloop.make_train_step(JaxConfig(**kw), optimizer, "mse", ema_decay=None)
    model = _model(params, kw)
    schedule = multistep(5e-4, steps_per_epoch=1 / 32)
    assert [schedule(k) for k in range(3)] == pytest.approx([5e-4, 5e-4, 1e-4])
    opt = Optimizer(model.parameters(), schedule)
    for _ in range(3):
        state, jloss = step(state, jb)
        loss = train_step(model, opt, None, tb, "mse")
        assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    want = from_jax_params(state.params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    y = rng.normal(6.0, 2.0, 50).astype(np.float32)
    f = (0.7 * y + rng.normal(0, 1.0, 50)).astype(np.float32)
    for name in ("rmse", "mae", "sd", "pearson"):
        got, want = getattr(metrics, name)(y, f), getattr(jmetrics, name)(y, f)
        assert isinstance(got, float) and got == want, name
    assert metrics.sd(y, np.full_like(y, 2.0)) == pytest.approx(float(np.std(y, ddof=1)))


@pytest.mark.parametrize("dataset,variant", [("PDBbind", "full"), ("QM9", "s")])
def test_from_jax_params_carries_every_parameter(dataset, variant):
    """Every leaf of the JAX tree lands on a parameter of the port's model of
    the same shape, and no parameter is left out: ``init_linear`` for
    PDBbind, ``mlp_sbf`` and ``mlp_m_jj`` for PAMNet_s."""
    kw = dict(dataset=dataset, dim=8, n_layer=2, variant=variant)
    params = init_pamnet(jax.random.PRNGKey(5), JaxConfig(**kw))
    sd = from_jax_params(params)
    model = PAMNet(PAMNetConfig(**kw))
    assert sd.keys() == model.state_dict().keys()
    assert sum(v.numel() for v in sd.values()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
    model.load_state_dict(sd, strict=True)
    new = ({"init_linear.weight"} if variant == "full"
           else {"mlp_sbf.0.0.weight", "local_layer.1.mlp_m_jj.0.0.bias"})
    assert new <= sd.keys()
    if variant == "s":
        assert not any("mlp_sbf1" in k or "mlp_m_kj" in k or "init_linear" in k for k in sd)


def test_main_pdbbind_trains_and_resumes_in_process(tmp_path):
    """The entry point on TU splits at a small width on the CPU: the JAX
    ``main_pdbbind.py``'s epoch line and final lines; two epochs straight against one epoch and a
    ``--resume`` for the second, bit for bit; no card, no run without
    ``--device cpu``."""
    root = str(tmp_path / "data")
    graphs = _mols(15, seed=2)
    write_tu_split(root, "train_val", graphs[:11])
    write_tu_split(root, "test", graphs[11:])
    base = ["--data_root", root, "--dim", "16", "--n_layer", "1", "--batch_size", "4",
            "--device", "cpu"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_pdbbind.main(base[:-2] + ["--epochs", "1"])

    def run(*extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = main_pdbbind.main([*base, *extra])
        return res, out.getvalue()

    straight, text = run("--epochs", "2", "--save_dir", str(tmp_path / "a"))
    assert "Data loaded! train=9 val=2 test=4" in text
    lines = re.findall(r"Epoch: (\d+), Train RMSE: (\S+), Train MAE: (\S+), Train SD: (\S+), "
                       r"Train P: (\S+), Test RMSE: (\S+), Test MAE: (\S+), Test SD: (\S+), "
                       r"Test P: (\S+) \(", text)
    assert [ln[0] for ln in lines] == ["001", "002"]
    assert all(np.isfinite(float(v.rstrip(","))) for ln in lines for v in ln[1:])
    finals = re.findall(r"Testing (RMSE|MAE|SD|P): (\S+)", text)
    assert [k for k, _ in finals] == ["RMSE", "MAE", "SD", "P"]
    assert (tmp_path / "a" / "PDBbind" / "best_model.pt").is_file()
    cut, _ = run("--epochs", "1", "--save_dir", str(tmp_path / "b"))
    resumed, text_r = run("--epochs", "2", "--save_dir", str(tmp_path / "b"),
                          "--resume", str(tmp_path / "b" / "PDBbind" / "last.ckpt"))
    assert "Resumed full train state" in text_r
    assert straight["train"][0] == cut["train"][0] and straight["train"][1] == resumed["train"][0]
    assert straight["test"] == resumed["test"]


def test_bench_prints_the_four_contract_lines(monkeypatch):
    """``python -m pamnet_tpu_torch.bench --device cpu --small``: the JAX
    bench's four lines in its order with its contract keys, each naming the
    CPU it ran on and no device time."""
    out = io.StringIO()
    monkeypatch.delenv("PAMNET_BENCH_TASK", raising=False)
    with contextlib.redirect_stdout(out):
        bench.main(["--device", "cpu", "--small"])
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [ln["metric"] for ln in lines] == [
        "qm9_pamnet_d32_L1_train_throughput", "rna_scoring_throughput",
        "qm9_epoch_wall_throughput", "pdbbind_train_throughput"]
    assert [ln["unit"] for ln in lines] == ["molecules/sec/chip", "graphs/sec/chip",
                                           "molecules/sec/chip", "graphs/sec/chip"]
    assert [ln["baseline"] for ln in lines] == [450.0, 60.0, 450.0, 100.0]
    for ln in lines:
        assert {"metric", "value", "unit", "vs_baseline", "baseline",
                "baseline_estimated"} <= ln.keys()
        assert ln["baseline_estimated"] is True and ln["value"] > 0 and ln["device"] == "cpu"
        assert ln["vs_baseline"] == round(ln["value"] / ln["baseline"], 2)
    assert lines[0]["device_ms_per_step"] is None and lines[3]["device_ms_per_step"] is None
    monkeypatch.setenv("PAMNET_BENCH_TASK", "pdbbind")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(["--device", "cpu", "--small"])
    assert [json.loads(ln)["metric"] for ln in out.getvalue().splitlines()] == [
        "pdbbind_train_throughput"]
