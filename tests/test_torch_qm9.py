"""The port's QM9 training path against the JAX package on the same inputs: data
(synthetic molecules bit for bit, the QM9 file reader on a staged mini
gdb9), training batches with their backward arrays, the shuffled loader,
the forward and the L1 loss's gradient with respect to every parameter.

Tolerances: batch indices, offsets and permutations exact, geometry 1e-6;
predictions atol 5e-5 * max(1, |y|) (f32 sums in another order); gradients
per tensor ``max|d| <= 1e-4 * max|g_jax| + 1e-6``.  The port's gradients
come from its autograd Functions' plain backwards on the CPU; JAX's from
``jax.grad`` of the loss of ``pamnet_tpu/train/loop.py:80-84``, mapped to
the port's names and layouts by ``from_jax_params``.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import dataclasses
import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pamnet_tpu.config import PAMNetConfig as JaxConfig
from pamnet_tpu.data import batch as jbatch
from pamnet_tpu.data import qm9 as jqm9
from pamnet_tpu.data.loader import GraphLoader as JaxLoader
from pamnet_tpu.data.synthetic import synthetic_qm9_dataset as jax_synthetic
from pamnet_tpu.models import apply_pamnet, init_pamnet
from pamnet_tpu.ops.ell import build_perm_np as jax_build_perm_np
from pamnet_tpu.train.loop import _loss_terms
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data import batch as tbatch
from pamnet_tpu_torch.data import qm9 as tqm9
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.train.loop import batch_loss
from pamnet_tpu_torch.weights import from_jax_params, init_params
from test_qm9 import _write_raw
from test_torch_model import _assert_same_batch

CUT = 5.0
_JAX_PERMS = ("el_src", "t2_kj", "t1_jj")


def test_synthetic_molecules_match_jax_bit_for_bit():
    want, got = jax_synthetic(12, seed=480), synthetic_qm9_dataset(12, seed=480)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        for k in ("z", "pos", "edge_index"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
        assert g["y"] == w["y"]


@pytest.mark.parametrize("skip_index", [None, 2])
def test_load_qm9_matches_jax(tmp_path, skip_index):
    _write_raw(tmp_path, skip_index)
    want = jqm9.load_qm9(str(tmp_path), cache=False)
    got = tqm9.load_qm9(str(tmp_path))  # writes the port's cache
    cached = tqm9.load_qm9(str(tmp_path))  # and reads it back
    assert len(got) == len(want) == len(cached) == (1 if skip_index == 2 else 2)
    for w, g, c in zip(want, got, cached):
        for k in ("z", "pos", "edge_index", "y"):
            assert np.array_equal(g[k], w[k]) and np.array_equal(c[k], w[k]), k
    for target in (0, 7, 11):
        assert [m["y"] for m in tqm9.select_target(got, target)] == \
               [m["y"] for m in jqm9.select_target(want, target)]
    np.testing.assert_array_equal(tqm9.CONVERSION, jqm9.CONVERSION)
    assert tqm9.ATOMREFS == jqm9.ATOMREFS


def test_load_qm9_without_files_says_what_to_stage(tmp_path):
    with pytest.raises(FileNotFoundError, match="gdb9.sdf"):
        tqm9.load_qm9(str(tmp_path))


def _structs(pkg, mols):
    return [pkg.attach_basis(pkg.precompute_structure(m, "qm9", CUT, CUT), CUT)
            for m in mols]


def _assert_same_perms(jb, tb):
    """JAX's build_perms arrays bit for bit, and the port's additions
    against JAX's own build_perm_np on JAX's batch."""
    for key in _JAX_PERMS:
        for suffix in ("_perm", "_poff"):
            np.testing.assert_array_equal(tb.perms[key + suffix].numpy(),
                                          np.asarray(jb.tables[key + suffix]), key + suffix)
    n_eg = int(np.asarray(jb.eg_mask).sum())
    perm, poff = jax_build_perm_np(np.asarray(jb.eg_src), n_eg, jb.z.shape[0],
                                   jb.eg_src.shape[0])
    np.testing.assert_array_equal(tb.perms["eg_src_perm"].numpy(), perm)
    np.testing.assert_array_equal(tb.perms["eg_src_poff"].numpy(), poff)
    n = int(np.asarray(jb.node_mask).sum())
    perm, poff = jax_build_perm_np(np.asarray(jb.z), n, 5, jb.z.shape[0])
    np.testing.assert_array_equal(tb.perms["z_perm"].numpy(), perm)
    np.testing.assert_array_equal(tb.perms["z_poff"].numpy(), poff)
    for kind, idx in (("t2", "t2_kj"), ("t1", "t1_jj")):
        by = "t2_ji_by_kj" if kind == "t2" else "t1_ji_by_jj"
        np.testing.assert_array_equal(
            tb.perms[by].numpy(),
            np.asarray(getattr(jb, kind + "_ji"))[np.asarray(jb.tables[idx + "_perm"])])
    assert "eg_dst_perm" not in tb.perms and "el_dst_perm" not in tb.perms


def test_collate_with_perms_matches_jax():
    mols = synthetic_qm9_dataset(6, seed=3)
    js, ts = _structs(jbatch, mols), _structs(tbatch, mols)
    pads = jbatch.PadSizes.bucketed(*[int(sum(c)) for c in zip(
        *[jbatch.structure_counts(s) for s in js])], 6)
    jb = jbatch.collate_structures(js, pads, build_tables=False, build_perms=True)
    tb = tbatch.collate_structures(ts, tbatch.PadSizes(
        *(getattr(pads, f.name) for f in dataclasses.fields(tbatch.PadSizes))),
        build_perms=True, num_atom_types=5)
    _assert_same_batch(jb, tb)
    _assert_same_perms(jb, tb)
    assert tb.eg_dst_off is not None and tb.eg_src_off is None  # dst-major
    assert tb.groups("eg_src").perm is not None and tb.groups("eg_dst").perm is None


def test_shuffled_loader_matches_jax_over_two_epochs():
    mols = synthetic_qm9_dataset(22, seed=5)
    kw = dict(batch_size=4, shuffle=True, seed=11, drop_last=True)
    jl = JaxLoader(mols, "qm9", CUT, CUT, build_tables=False, build_perms=True, **kw)
    tl = GraphLoader(mols, "qm9", CUT, CUT, build_perms=True, **kw)
    for f in dataclasses.fields(tbatch.PadSizes):
        assert getattr(tl.pads, f.name) == getattr(jl.pads, f.name), f.name
    assert len(tl) == len(jl) == 5
    for _ in range(2):
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) == 5
        for jb, tb in zip(jbs, tbs):
            _assert_same_batch(jb, tb)
            _assert_same_perms(jb, tb)


@functools.lru_cache(maxsize=None)
def _reference(n_layer: int, dim: int):
    """JAX params, the port's batch, and JAX's predictions and L1-loss
    gradients on the same molecules."""
    kw = dict(dataset="QM9", dim=dim, n_layer=n_layer, cutoff_l=CUT, cutoff_g=CUT)
    jcfg = JaxConfig(**kw)
    params = init_pamnet(jax.random.PRNGKey(n_layer + dim), jcfg)
    mols = [dict(m, y=m["y"] / 10.0) for m in synthetic_qm9_dataset(4, seed=n_layer + dim)]
    jb = next(iter(JaxLoader(mols, "qm9", CUT, CUT, batch_size=4, build_tables=False,
                             build_perms=True)))
    tb = next(iter(GraphLoader(mols, "qm9", CUT, CUT, batch_size=4, build_perms=True)))

    def loss(p, g):
        pred = apply_pamnet(p, g, jcfg)
        total, count = _loss_terms(pred, g.y, g.graph_mask, "l1")
        return total / jnp.maximum(count, 1.0), pred

    (_, pred), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, jb))
    return params, tb, np.asarray(pred), from_jax_params(grads), PAMNetConfig(**kw)


CASES = [(1, 16), (2, 16), (1, 128)]


def _model(params, cfg):
    model = PAMNet(cfg)
    model.load_state_dict(from_jax_params(params), strict=True)
    return model


@pytest.mark.parametrize("n_layer,dim", CASES)
def test_forward_matches_apply_pamnet(n_layer, dim):
    params, tb, want, _, cfg = _reference(n_layer, dim)
    with torch.inference_mode():
        got = _model(params, cfg)(tb).numpy()
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert np.all(got[tb.num_graphs:] == 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("n_layer,dim", CASES)
def test_loss_gradients_match_jax_grad(n_layer, dim):
    params, tb, _, want, cfg = _reference(n_layer, dim)
    model = _model(params, cfg)
    batch_loss(model, tb, "l1").backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    assert got["init_linear.weight"] is None  # unused by the QM9 forward
    assert np.all(want["init_linear.weight"].numpy() == 0.0)
    for name, w in want.items():
        g = torch.zeros_like(w) if got[name] is None else got[name]
        err = float((g - w).abs().max())
        bound = 1e-4 * float(w.abs().max()) + 1e-6
        assert err <= bound, f"{name}: max|d| {err:.3g} > {bound:.3g}"


def test_from_jax_params_carries_init_linear():
    jcfg = JaxConfig(dataset="QM9", dim=16, n_layer=1)
    params = init_pamnet(jax.random.PRNGKey(0), jcfg)
    sd = from_jax_params(params)
    np.testing.assert_array_equal(sd["init_linear.weight"].numpy(),
                                  np.asarray(params["init_linear"]["w"]).T)
    cfg = PAMNetConfig(dataset="QM9", dim=16, n_layer=1)
    own = init_params(cfg, torch.Generator().manual_seed(0))
    assert own.keys() == sd.keys()
    assert own["init_linear.weight"].shape == (16, 18)
    rna = init_params(PAMNetConfig(dataset="rna", dim=16, n_layer=1),
                      torch.Generator().manual_seed(0))
    assert "init_linear.weight" not in rna


def test_training_batch_without_perms_refuses_grad():
    """A batch built without backward arrays cannot train silently."""
    mols = synthetic_qm9_dataset(2, seed=1)
    tb = next(iter(GraphLoader(mols, "qm9", CUT, CUT, batch_size=2)))
    model = PAMNet(PAMNetConfig(dataset="QM9", dim=16, n_layer=1))
    with pytest.raises(ValueError, match="Groups"):
        batch_loss(model, tb, "l1")
    with torch.inference_mode():
        assert torch.isfinite(model(tb)).all()


def _zip_of_raw(tmp_path):
    """A local qm9.zip (gdb9.sdf + gdb9.sdf.csv) and uncharacterized.txt as
    the reference's two URLs serve them, from the mini gdb9 of
    ``tests/test_qm9.py``."""
    import zipfile

    src = tmp_path / "src"
    _write_raw(src)
    with zipfile.ZipFile(src / "qm9.zip", "w") as zf:
        for name in ("gdb9.sdf", "gdb9.sdf.csv"):
            zf.write(src / "raw" / name, name)
    return {tqm9.RAW_URL: src / "qm9.zip", tqm9.RAW_URL2: src / "raw" / "uncharacterized.txt"}


def _patched_urlretrieve(monkeypatch, served: dict, fetched: list):
    import shutil
    import urllib.request

    def urlretrieve(url, filename):
        fetched.append(url)
        shutil.copyfile(served[url], filename)
        return filename, None

    monkeypatch.setattr(urllib.request, "urlretrieve", urlretrieve)


def test_download_fetches_the_reference_files(tmp_path, monkeypatch):
    """``download`` (``urlretrieve`` patched to copy local files: nothing
    reaches the network) unpacks the zip and stores the skip list where
    ``load_qm9`` reads them; ``allow_download`` loads them as JAX reads the
    same raw files."""
    served, fetched = _zip_of_raw(tmp_path), []
    _patched_urlretrieve(monkeypatch, served, fetched)
    assert (tqm9.RAW_URL, tqm9.RAW_URL2, tqm9.PROCESSED_URL) == \
        (jqm9.RAW_URL, jqm9.RAW_URL2, jqm9.PROCESSED_URL)
    tqm9.download(str(tmp_path / "a"))
    assert fetched == [tqm9.RAW_URL, tqm9.RAW_URL2]
    assert sorted(os.listdir(tmp_path / "a" / "raw")) == \
        ["gdb9.sdf", "gdb9.sdf.csv", "uncharacterized.txt"]
    with pytest.raises(FileNotFoundError, match="allow_download"):
        tqm9.load_qm9(str(tmp_path / "b"))
    got = tqm9.load_qm9(str(tmp_path / "b"), allow_download=True)
    want = jqm9.load_qm9(str(tmp_path / "a"), cache=False)
    assert len(fetched) == 4 and len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("z", "pos", "edge_index", "y"):
            assert np.array_equal(g[k], w[k]), k


def test_download_without_network_says_what_to_stage(tmp_path, monkeypatch):
    import urllib.error
    import urllib.request

    def refuse(url, filename):
        raise urllib.error.URLError("no route to host")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    with pytest.raises(ConnectionError, match="stage gdb9.sdf") as err:
        tqm9.load_qm9(str(tmp_path), allow_download=True)
    assert "no route to host" in str(err.value) and tqm9.RAW_URL in str(err.value)
    assert isinstance(err.value.__cause__, urllib.error.URLError)
