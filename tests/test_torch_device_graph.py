"""The graph rebuilt on the device (``pamnet_tpu_torch/ops/neighbors.py``,
``pamnet_tpu_torch/models/device_graph.py``) against the JAX package's
(``pamnet_tpu/ops/neighbors.py``, ``pamnet_tpu/models/device_graph.py``) and
against the host batches, on the CPU.

Exact: the neighbour searches' arrays (radius edges source-major, JAX's
query-major: compared in one order); the triplet
and pair tables' valid rows (JAX reads ``ids[0]`` at padded rows, the port
writes 0 as the host batches do); the rebuilt edge and triplet sets per
graph and their counts; the rebuilt batch against the host batch of the same
molecules, field by field, CSR offsets and the backward's permutations
(``build_perm_np``) included.  Forwards with ``device_graph=True`` within
2e-5 + 2e-4 |want| of JAX's and of the port's host forward (the tolerance
of ``tests/test_device_graph.py:88-91``: the same sets summed in another
order)."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import dataclasses
import math
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pamnet_tpu.config import PAMNetConfig as JaxConfig
from pamnet_tpu.data.loader import GraphLoader as JaxLoader
from pamnet_tpu.models import apply_pamnet, init_pamnet
from pamnet_tpu.models import device_graph as jdg
from pamnet_tpu.ops import neighbors as jnb
from pamnet_tpu_torch import main_qm9
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.batch import build_perm_np
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule, synthetic_pdbbind_dataset,
                                             synthetic_qm9_dataset, synthetic_rna_dataset)
from pamnet_tpu_torch.models import device_graph as tdg
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.ops import neighbors as tnb
from pamnet_tpu_torch.weights import from_jax_params

CASES = {
    "qm9": ("qm9", dict(dataset="QM9", dim=16, n_layer=2, cutoff_l=5.0, cutoff_g=5.0),
            lambda: synthetic_qm9_dataset(6, seed=31)),
    "pamnet_s": ("qm9", dict(dataset="QM9", dim=16, n_layer=2, cutoff_l=5.0, cutoff_g=5.0,
                             variant="s"),
                 lambda: synthetic_qm9_dataset(6, seed=32)),
    "pdbbind": ("pdbbind", dict(dataset="PDBbind", dim=8, n_layer=2, cutoff_l=2.0,
                                cutoff_g=6.0),
                lambda: [pdbbind_molecule(g) for g in synthetic_pdbbind_dataset(3, seed=33)]),
    "rna": ("rna", dict(dataset="rna", dim=16, n_layer=1, cutoff_l=2.6, cutoff_g=20.0,
                        flow="target_to_source"),
            lambda: synthetic_rna_dataset(3, seed=34, n_atoms=120)),
}


def _loaders(name, build_perms=False, **kw_loader):
    kind, kw, make = CASES[name]
    mols = make()
    variant = kw.get("variant", "full")
    args = (mols, kind, kw["cutoff_l"], kw["cutoff_g"])
    jb = next(iter(JaxLoader(*args, batch_size=8, build_tables=False, variant=variant,
                             build_perms=build_perms)))
    tb = next(iter(GraphLoader(*args, batch_size=8, variant=variant, build_perms=build_perms,
                               **kw_loader)))
    return kw, mols, jb, tb


def _cloud(seed, n=150, graphs=3, scale=6.0):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * scale).astype(np.float32)
    graph = np.sort(rng.integers(0, graphs, n)).astype(np.int32)
    mask = (np.arange(n) < n - 9).astype(np.float32)  # padded nodes at the end
    return pos, graph, mask


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _query_major(src, dst, count):
    """The first ``count`` edges in JAX's query-major order (by (src, dst))."""
    src, dst = src[:count].numpy(), dst[:count].numpy()
    order = np.lexsort((dst, src))
    return src[order], dst[order]


@pytest.mark.parametrize("cap", [1000, 5])
def test_radius_edges_match_jax(cap):
    """The same edges as JAX's, source-major (JAX: query-major), the padded
    rows at 0."""
    (jp, jg, jm), (tp, tg, tm) = _both(*_cloud(1))
    want = jnb.radius_edges(jp, jg, jm, 2.0, 2048, max_num_neighbors=cap)
    src, dst, mask, count = tnb.radius_edges(tp, tg, tm, 2.0, 2048, max_num_neighbors=cap)
    n = int(count)
    assert n == int(np.asarray(want[2]).sum()) < 2048
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want[2]))
    got_src, got_dst = _query_major(src, dst, n)
    np.testing.assert_array_equal(got_src, np.asarray(want[0])[:n])
    np.testing.assert_array_equal(got_dst, np.asarray(want[1])[:n])
    assert np.all(np.diff(dst[:n].numpy().astype(np.int64) * 1000 + src[:n].numpy()) > 0)
    assert not src[n:].any() and not dst[n:].any()


def test_radius_edges_count_past_the_pad():
    (jp, jg, jm), (tp, tg, tm) = _both(*_cloud(2))
    src, dst, mask, count = tnb.radius_edges(tp, tg, tm, 2.0, 64)
    want = jnb.radius_edges(jp, jg, jm, 2.0, 4096)
    assert int(count) == int(np.asarray(want[2]).sum()) > 64 and mask.sum() == 64
    # The rows kept are the first 64 of the source-major order.
    full_src, full_dst, _, _ = tnb.radius_edges(tp, tg, tm, 2.0, 4096)
    assert torch.equal(src, full_src[:64]) and torch.equal(dst, full_dst[:64])


def test_knn_edges_match_jax():
    (jp, jg, jm), (tp, tg, tm) = _both(*_cloud(3))
    want = jnb.knn_edges(jp, jg, jm, 12)
    got = tnb.knn_edges(tp, tg, tm, 12)
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3]) == int(np.asarray(want[2]).sum())


@pytest.mark.parametrize("which", ["triplets", "pairs"])
def test_device_tables_match_jax(which):
    (jp, jg, jm), (tp, tg, tm) = _both(*_cloud(4))
    src, dst, mask, _ = tnb.radius_edges(tp, tg, tm, 1.6, 1024)
    t_pad = 4096
    want = getattr(jnb, "device_" + which)(jnp.asarray(src.numpy()), jnp.asarray(dst.numpy()),
                                          jnp.asarray(mask.numpy()), t_pad)
    got = getattr(tnb, "device_" + which)(src, dst, mask, t_pad)
    valid = int(np.asarray(want["mask"]).sum())
    assert 0 < valid < t_pad and int(got["count"]) == valid
    for key, w in want.items():
        g = got[key].numpy()
        np.testing.assert_array_equal(g[:valid], np.asarray(w)[:valid], key)
        if key != "mask":
            assert not g[valid:].any(), key
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))


def _sets(idx: dict, mask, graph_of) -> dict:
    """Rows of ``idx`` (name -> array) under ``mask`` as a set per graph."""
    rows = np.stack([np.asarray(v) for v in idx.values()], 1)[np.asarray(mask) > 0]
    out: dict = {}
    for r in rows:
        out.setdefault(int(graph_of[r[0]]), set()).add(tuple(int(x) for x in r))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_rebuild_structure_matches_jax(name):
    kw, _, jb, tb = _loaders(name)
    jg = jdg.rebuild_structure(jax.tree.map(jnp.asarray, jb), JaxConfig(**kw))
    tg = tdg.rebuild_structure(tb, PAMNetConfig(**kw))
    graph_of = tb.node_graph.numpy()
    tables = {"eg": ("eg_src", "eg_dst"), "el": ("el_src", "el_dst"),
              "t1": ("t1_i", "t1_j1", "t1_j2")}
    if kw.get("variant", "full") == "full":
        tables["t2"] = ("t2_i", "t2_j", "t2_k")
    for dim, keys in tables.items():
        want = _sets({k: getattr(jg, k) for k in keys}, getattr(jg, dim + "_mask"), graph_of)
        got = _sets({k: getattr(tg, k) for k in keys}, getattr(tg, dim + "_mask"), graph_of)
        assert got == want, dim
        assert tg.valid[dim] == int(np.asarray(getattr(jg, dim + "_mask")).sum()), dim
    assert tg.dist_g is None and tg.sbf_radial is None
    jc = jdg.structure_counts_device(jax.tree.map(jnp.asarray, jb), JaxConfig(**kw))
    tc = tdg.structure_counts_device(tb, PAMNetConfig(**kw))
    assert {k: int(v) for k, v in tc.items()} == {k: int(v) for k, v in jc.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_rebuilt_batch_equals_the_host_batch(name):
    """The card-style rebuild of a derive batch gives the host batch of the
    same molecules bit for bit: edges, tables, masks, CSR offsets, the
    backward's permutations, valid counts and longest groups."""
    kw, _, _, host = _loaders(name, build_perms=True, wire_geometry="derive")
    got = tdg.rebuild_structure(host, PAMNetConfig(**kw))
    for f in dataclasses.fields(host):
        a, b = getattr(host, f.name), getattr(got, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        elif f.name == "perms":
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), k
        else:
            assert a == b, f.name
    for key in ("el_src", "t1_jj", "eg_dst" if kw["dataset"] == "rna" else "eg_src"):
        rows = {"el": "el", "t1": "t1", "eg": "eg"}[key.split("_")[0]]
        groups = host.el_src.shape[0] if key == "t1_jj" else host.pos.shape[0]
        perm, poff = build_perm_np(getattr(host, key).numpy(), host.valid[rows], groups,
                                   getattr(host, key).shape[0])
        p, o = tdg.csr_perm(getattr(got, key), host.valid[rows], groups)
        np.testing.assert_array_equal(p.numpy(), perm)
        np.testing.assert_array_equal(o.numpy(), poff)


def test_rebuild_reads_the_host_once_and_never_compacts_by_nonzero(monkeypatch):
    _, kw_mols, _, gb = _loaders("pdbbind", build_perms=True)
    kw = CASES["pdbbind"][1]
    reads = []
    real_tolist = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda self: reads.append(self.shape) or real_tolist(self))
    for fn in ("item", "nonzero", "masked_select", "__bool__"):
        monkeypatch.setattr(torch.Tensor, fn, lambda *a, _f=fn, **k: pytest.fail(_f))
    for fn in ("nonzero", "masked_select", "argwhere", "unique"):
        monkeypatch.setattr(torch, fn, lambda *a, _f=fn, **k: pytest.fail(_f))
    tdg.rebuild_structure(gb, PAMNetConfig(**kw))
    assert len(reads) == 1


def test_rebuild_refuses_a_graph_past_the_pads():
    kw, _, _, gb = _loaders("qm9")
    squeezed = dataclasses.replace(gb, pos=gb.pos * 0.25)  # every pair within the cutoff
    with pytest.raises(ValueError, match="outgrew"):
        tdg.rebuild_structure(squeezed, PAMNetConfig(**kw))


@pytest.mark.parametrize("name", ["qm9", "pdbbind", "rna"])
def test_device_graph_forward_matches_jax_and_host(name):
    kw, mols, jb, tb = _loaders(name)
    jcfg = JaxConfig(**kw, device_graph=True)
    params = init_pamnet(jax.random.PRNGKey(len(name)), jcfg)
    want = np.asarray(jax.jit(lambda p, g: apply_pamnet(p, g, jcfg))(
        params, jax.tree.map(jnp.asarray, jb)))
    model = PAMNet(PAMNetConfig(**kw, device_graph=True))
    model.load_state_dict(from_jax_params(params), strict=True)
    host = PAMNet(PAMNetConfig(**kw))
    host.load_state_dict(model.state_dict())
    with torch.no_grad():
        got, got_host = model(tb).numpy(), host(tb).numpy()
        plain = model(tb, plain=True).numpy()
    assert np.all(np.isfinite(got)) and np.all(got[len(mols):] == 0.0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, got_host, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(plain, got, rtol=2e-4, atol=2e-5)


def test_main_qm9_device_graph_in_process(capsys, tmp_path):
    main_qm9.main(["--synthetic", "--limit", "48", "--dim", "16", "--n_layer", "1",
                   "--epochs", "1", "--batch_size", "8", "--device", "cpu", "--device_graph",
                   "--compute_dtype", "float32", "--save_dir", str(tmp_path)])
    out = capsys.readouterr().out
    maes = re.findall(r"(?:Train|Val|Test) MAE: ([^,\s]+)", out)
    assert len(maes) == 3 and all(math.isfinite(float(v)) for v in maes), out
    assert re.search(r"Testing MAE: \S+", out)


def test_main_qm9_device_graph_bf16_in_process(capsys, tmp_path):
    """The driver's default bfloat16 with the graph rebuilt every forward (at
    dim 32: the port folds at dim 16, which bfloat16 refuses)."""
    main_qm9.main(["--synthetic", "--limit", "48", "--dim", "32", "--n_layer", "1",
                   "--epochs", "1", "--batch_size", "8", "--device", "cpu", "--device_graph",
                   "--save_dir", str(tmp_path)])
    out = capsys.readouterr().out
    maes = re.findall(r"(?:Train|Val|Test) MAE: ([^,\s]+)", out)
    assert len(maes) == 3 and all(math.isfinite(float(v)) for v in maes), out
