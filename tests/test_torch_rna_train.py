"""The port's RNA training path against the JAX package on the same inputs:
training batches with their backward arrays, the SmoothL1 loss's gradient
with respect to every parameter on the folded path (the JAX default gate
folds batches without ELL tables), optimizer steps, the TU reader and the
entry point run in-process.

Structures: the port's seeded RNA-like chains at 40-60 atoms (1.5 A steps,
so the 2.6 A local graph has edges, triplets and pairs).  Tolerances: batch
indices, offsets and permutations exact; gradients per tensor
``max|d| <= 1e-4 * max|g_jax| + 1e-6``; parameters after three Adam steps
within 1e-6 (lr 1e-4: 1% of a step).  The port's gradients come from its
autograd Functions' plain backwards on the CPU; JAX's from ``jax.grad`` of
the loss of ``pamnet_tpu/train/loop.py:80-84``, mapped to the port's names
and layouts by ``from_jax_params``.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import dataclasses
import functools
import math
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pamnet_tpu.config import PAMNetConfig as JaxConfig
from pamnet_tpu.data import batch as jbatch
from pamnet_tpu.data.loader import GraphLoader as JaxLoader
from pamnet_tpu.data.tu import TUDataset as JaxTUDataset
from pamnet_tpu.models import apply_pamnet, init_pamnet
from pamnet_tpu.ops.ell import build_perm_np as jax_build_perm_np
from pamnet_tpu.train import loop as jloop
from pamnet_tpu.train.schedules import constant as jax_constant
from pamnet_tpu_torch import main_rna_puzzles
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data import batch as tbatch
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import rna_like_structure, synthetic_rna_dataset
from pamnet_tpu_torch.data.tu import TUDataset, has_tu_split, write_tu_split
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.ops.sbf_modulate import KERNEL_SHAPES, sbf_modulate
from pamnet_tpu_torch.train.loop import Optimizer, batch_loss, smooth_l1, train_step
from pamnet_tpu_torch.train.schedules import constant
from pamnet_tpu_torch.weights import from_jax_params
from test_torch_model import _assert_same_batch

CUT_L, CUT_G = 2.6, 20.0
FLOW = "target_to_source"


def _mols(n, seed, n_atoms=40):
    """Labels scaled to O(1), so SmoothL1 sees both of its branches."""
    return [dict(m, y=m["y"] / 8.0) for m in synthetic_rna_dataset(n, seed, n_atoms)]


def test_synthetic_rna_structures_are_seeded_and_labelled():
    a, b = synthetic_rna_dataset(3, seed=9, n_atoms=30), synthetic_rna_dataset(3, seed=9,
                                                                               n_atoms=30)
    rng = np.random.default_rng(9)
    for x, y in zip(a, b):
        bare = rna_like_structure(rng, 30)  # the labels are drawn after every structure
        assert np.array_equal(x["pos"], y["pos"]) and np.array_equal(x["pos"], bare["pos"])
        assert np.array_equal(x["z"], bare["z"]) and x["y"] == y["y"]
        assert x["pos"].shape == (30, 3) and x["pos"].dtype == np.float32
        assert set(np.unique(x["z"])) <= {0, 1, 2} and 0.0 < x["y"] < 25.0
        step = np.linalg.norm(np.diff(x["pos"], axis=0), axis=1)
        np.testing.assert_allclose(step, 1.5, atol=1e-4)


@pytest.mark.parametrize("seed,n", [(3, 3), (8, 4)])
def test_rna_collate_with_perms_matches_jax(seed, n):
    """The arrays of JAX's ``collate_structures(build_perms=True,
    build_tables=False)`` bit for bit, and the port's additions (the unsorted
    global endpoint under ``target_to_source``, ``z``) against JAX's own
    ``build_perm_np`` on JAX's batch."""
    mols = _mols(n, seed, n_atoms=35 + 5 * n)
    js = [jbatch.attach_basis(jbatch.precompute_structure(m, "rna", CUT_L, CUT_G), CUT_L)
          for m in mols]
    ts = [tbatch.attach_basis(tbatch.precompute_structure(m, "rna", CUT_L, CUT_G), CUT_L)
          for m in mols]
    pads = jbatch.PadSizes.bucketed(*[int(sum(c)) for c in zip(
        *[jbatch.structure_counts(s) for s in js])], n)
    jb = jbatch.collate_structures(js, pads, build_tables=False, build_perms=True)
    tb = tbatch.collate_structures(ts, tbatch.PadSizes(
        *(getattr(pads, f.name) for f in dataclasses.fields(tbatch.PadSizes))),
        build_perms=True, num_atom_types=3)
    _assert_same_batch(jb, tb)
    for key in ("el_src", "t2_kj", "t1_jj"):
        for suffix in ("_perm", "_poff"):
            np.testing.assert_array_equal(tb.perms[key + suffix].numpy(),
                                          np.asarray(jb.tables[key + suffix]), key + suffix)
    assert "t1_jj" not in jb.tables  # no ELL tables: the JAX gate folds this batch
    # RNA global edges are src-major: the unsorted endpoint is dst.
    assert tb.eg_src_off is not None and tb.eg_dst_off is None
    n_eg = int(np.asarray(jb.eg_mask).sum())
    perm, poff = jax_build_perm_np(np.asarray(jb.eg_dst), n_eg, jb.z.shape[0],
                                   jb.eg_dst.shape[0])
    np.testing.assert_array_equal(tb.perms["eg_dst_perm"].numpy(), perm)
    np.testing.assert_array_equal(tb.perms["eg_dst_poff"].numpy(), poff)
    assert "eg_src_perm" not in tb.perms
    n_nodes = int(np.asarray(jb.node_mask).sum())
    perm, poff = jax_build_perm_np(np.asarray(jb.z), n_nodes, 3, jb.z.shape[0])
    np.testing.assert_array_equal(tb.perms["z_perm"].numpy(), perm)
    np.testing.assert_array_equal(tb.perms["z_poff"].numpy(), poff)
    for kind, idx in (("t2", "t2_kj"), ("t1", "t1_jj")):
        groups = tb.groups(idx)
        assert groups.perm is not None and groups.total == tb.valid[kind] > 0
        assert int(groups.off[-1]) == tb.valid[kind]


@functools.lru_cache(maxsize=None)
def _reference(n_layer: int, dim: int):
    """JAX params, the port's batch, and JAX's predictions and SmoothL1
    gradients (default gate: folded and fused) on the same structures."""
    kw = dict(dataset="rna_train", dim=dim, n_layer=n_layer, cutoff_l=CUT_L, cutoff_g=CUT_G,
              flow=FLOW)
    jcfg = JaxConfig(**kw)
    params = init_pamnet(jax.random.PRNGKey(n_layer + dim), jcfg)
    mols = _mols(3, seed=n_layer + dim, n_atoms=48)
    jb = next(iter(JaxLoader(mols, "rna", CUT_L, CUT_G, batch_size=4, build_tables=False,
                             build_perms=True)))
    tb = next(iter(GraphLoader(mols, "rna", CUT_L, CUT_G, batch_size=4, build_perms=True)))

    def loss(p, g):
        pred = apply_pamnet(p, g, jcfg)
        total, count = jloop._loss_terms(pred, g.y, g.graph_mask, "smooth_l1")
        return total / jnp.maximum(count, 1.0), pred

    (_, pred), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, jb))
    return params, tb, np.asarray(pred), from_jax_params(grads), kw


# The published recipe (1 layer, dim 16), kernel B's other width (dim 8) and
# main_rna_puzzles' default (2 layers, dim 64), which neither package folds
# (JAX folds where ns * dim <= 128).
CASES = [(1, 16), (1, 8), (2, 64)]


def _model(params, kw, **over):
    model = PAMNet(PAMNetConfig(**{**kw, **over}))
    model.load_state_dict(from_jax_params(params), strict=True)
    return model


def _grads(model, tb):
    model.zero_grad()
    batch_loss(model, tb, "smooth_l1").backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        bound = 1e-4 * float(w.abs().max()) + 1e-6
        assert err <= bound, f"{name}: max|d| {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("n_layer,dim", CASES)
def test_folded_training_gradients_match_jax_grad(n_layer, dim, monkeypatch):
    params, tb, want_pred, want, kw = _reference(n_layer, dim)
    model = _model(params, kw)
    # Training batches fold where kernel B is built, as under JAX's gate.
    assert model.fold_sbf() == ((7, dim) in KERNEL_SHAPES)
    calls = []
    import pamnet_tpu_torch.models.layers as layers
    monkeypatch.setattr(layers, "sbf_modulate",
                        lambda *a, **k: calls.append(k) or sbf_modulate(*a, **k))
    with torch.no_grad():
        pred = model(tb).numpy()
    np.testing.assert_allclose(pred, want_pred, rtol=0, atol=5e-5)
    got = _grads(model, tb)
    assert len(calls) == (4 * n_layer if model.fold_sbf() else 0) and all(
        k["groups"].perm is not None and k["out_groups"].perm is None
        and k["out_ids"] is not None for k in calls)
    assert float(want["mlp_sbf1.0.0.weight"].abs().max()) > 0.0
    _assert_grads_close(got, want)


@pytest.mark.parametrize("n_layer,dim", CASES)
def test_folded_gradients_match_unfolded(n_layer, dim):
    params, tb, _, _, kw = _reference(n_layer, dim)
    folded, unfolded = _model(params, kw, fold_sbf=True), _model(params, kw, fold_sbf=False)
    assert folded.fold_sbf() and not unfolded.fold_sbf()
    _assert_grads_close(_grads(folded, tb), _grads(unfolded, tb))


def test_three_adam_steps_match_jax_train_step():
    """Adam at a constant lr 1e-4, no clip, no EMA, SmoothL1: the recipe's
    optimizer, against ``make_optimizer(constant(lr))`` + ``make_train_step``."""
    params, tb, _, _, kw = _reference(1, 16)
    mols = _mols(3, seed=17, n_atoms=48)
    jb = jax.tree.map(jnp.asarray, next(iter(JaxLoader(
        mols, "rna", CUT_L, CUT_G, batch_size=4, build_tables=False, build_perms=True))))
    optimizer = jloop.make_optimizer(jax_constant(1e-4))
    state = jloop.init_train_state(params, optimizer, use_ema=False)
    step = jloop.make_train_step(JaxConfig(**kw), optimizer, "smooth_l1", ema_decay=None)
    model = _model(params, kw)
    opt = Optimizer(model.parameters(), constant(1e-4))
    for _ in range(3):
        state, jloss = step(state, jb)
        loss = train_step(model, opt, None, tb, "smooth_l1")
        assert abs(float(loss) - float(jloss)) <= 1e-5
    assert opt.count == int(state.step) == 3
    want = from_jax_params(state.params)
    start = from_jax_params(params)
    moved = 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
        moved = max(moved, float((want[name] - start[name]).abs().max()))
    assert moved > 2e-4  # three steps of about lr each


def test_tu_reader_matches_jax(tmp_path):
    mols = synthetic_rna_dataset(5, seed=2, n_atoms=20)
    for name, part in (("train", mols[:3]), ("val", mols[3:])):
        write_tu_split(str(tmp_path), name, part)
        assert has_tu_split(str(tmp_path), name)
        want = JaxTUDataset(str(tmp_path), name).molecules()
        got = TUDataset(str(tmp_path), name).molecules()
        assert len(got) == len(want) == len(part)
        for w, g, m in zip(want, got, part):
            assert g.keys() == w.keys() == {"pos", "z", "y"}
            for k in ("pos", "z"):
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
            assert g["y"] == w["y"]
            np.testing.assert_allclose(g["pos"], m["pos"], atol=5e-4)  # three decimals
            assert np.array_equal(g["z"], m["z"]) and abs(g["y"] - m["y"]) <= 5e-4
    assert not has_tu_split(str(tmp_path), "test")


_EPOCH = re.compile(r"Epoch: (\d+), Train Loss: (\S+), Val Loss: (\S+) ")
_SMALL = ["--dim", "16", "--n_layer", "1", "--batch_size", "2", "--lr", "1e-4",
          "--device", "cpu"]


def test_main_rna_puzzles_runs_in_process(capsys, tmp_path):
    csv = tmp_path / "metrics.csv"
    mols = synthetic_rna_dataset(6, seed=40, n_atoms=40)
    write_tu_split(str(tmp_path / "data"), "train", mols[:5])
    write_tu_split(str(tmp_path / "data"), "val", mols[5:])
    res = main_rna_puzzles.main(["--epochs", "1", "--data_root", str(tmp_path / "data"),
                                 "--save_dir", str(tmp_path / "save"),
                                 "--metrics_csv", str(csv), *_SMALL])
    out = capsys.readouterr().out
    assert "Data loaded! train=5 val=1" in out and "Start training!" in out
    epochs = _EPOCH.findall(out)
    assert [int(e[0]) for e in epochs] == [1]
    assert all(math.isfinite(float(v)) for v in epochs[0][1:])
    assert float(epochs[0][2]) == pytest.approx(res["val_loss"][0], abs=1e-7)
    assert res["best_val_loss"] == res["val_loss"][0]
    best = torch.load(tmp_path / "save" / "pamnet_rna_best.pt", weights_only=True)
    assert "local_layer.0.mlp_sbf.1.0.weight" in best and (tmp_path / "save" /
                                                           "pamnet_rna_last.ckpt").is_file()
    assert csv.read_text().splitlines()[0] == "epoch,train_loss,val_loss,seconds"


def test_main_rna_puzzles_reads_a_tu_directory(capsys, tmp_path):
    mols = synthetic_rna_dataset(6, seed=4, n_atoms=36)
    write_tu_split(str(tmp_path / "data"), "train", mols[:4])
    write_tu_split(str(tmp_path / "data"), "val", mols[4:])
    res = main_rna_puzzles.main(["--data_root", str(tmp_path / "data"), "--epochs", "2",
                                 "--limit", "3", "--save_dir", str(tmp_path / "save"), *_SMALL])
    assert "Data loaded! train=3 val=2" in capsys.readouterr().out
    assert len(res["val_loss"]) == 2 and all(map(math.isfinite, res["train_loss"]))
    # The loss main() prints is the evaluation the loop module defines.
    train = TUDataset(str(tmp_path / "data"), "train").molecules()[:3]
    model = PAMNet(PAMNetConfig(dataset="RNA-Puzzles", dim=16, n_layer=1, cutoff_l=CUT_L,
                                cutoff_g=CUT_G, flow=FLOW))
    model.load_state_dict(torch.load(tmp_path / "save" / "pamnet_rna_last.ckpt",
                                     weights_only=True)["model"])
    loader = GraphLoader(train, "rna", CUT_L, CUT_G, batch_size=2)
    assert smooth_l1(model, loader, "cpu") == pytest.approx(res["train_loss"][-1], abs=1e-6)


def test_synthetic_structures_split_their_last_quarter(monkeypatch, tmp_path):
    """``--synthetic N`` generates N structures at the generator's own size
    from ``--seed`` and validates on the last quarter."""
    from pamnet_tpu_torch.data import synthetic

    calls = []

    def small(n, seed, n_atoms=None):
        calls.append((n, seed, n_atoms))
        return synthetic_rna_dataset(n, seed=seed, n_atoms=12)

    monkeypatch.setattr(synthetic, "synthetic_rna_dataset", small)
    parse = main_rna_puzzles.build_parser().parse_args
    args = parse(["--synthetic", "9", "--seed", "5", "--data_root", str(tmp_path)])
    train, val = main_rna_puzzles.load_structures(args)
    assert calls == [(9, 5, None)] and (len(train), len(val)) == (7, 2)
    want = synthetic_rna_dataset(9, seed=5, n_atoms=12)
    assert all(np.array_equal(a["pos"], b["pos"]) for a, b in zip(train + val, want))
    with pytest.raises(ValueError, match="at least 4"):
        main_rna_puzzles.load_structures(parse(["--synthetic", "3", "--data_root",
                                                str(tmp_path)]))
    with pytest.raises(SystemExit):  # the size of a generated structure is not an option
        parse(["--synthetic", "8", "--synthetic_atoms", "40"])


def test_main_rna_puzzles_needs_data_and_a_card(monkeypatch, tmp_path):
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        main_rna_puzzles.main(["--data_root", str(tmp_path), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_rna_puzzles.main(["--synthetic", "4"])
    with pytest.raises(SystemExit):  # a TPU flag of the JAX main_rna_puzzles.py is not accepted silently
        main_rna_puzzles.main(["--synthetic", "4", "--device", "cpu", "--scan_steps", "4"])
