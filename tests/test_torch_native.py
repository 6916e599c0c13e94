"""The port's native host builders (``pamnet_tpu_torch/data/native.py`` over
``pamnet_tpu_torch/csrc/graphbuild.cc``) against the JAX package's numpy
builders, bit for bit: the same arrays in the same order (JAX's own native
library, which emits radius neighbours in cell order, is switched off with
its ``PAMNET_DISABLE_NATIVE``).  Clouds are multi-graph batches above the
dispatch thresholds (512 nodes, 8,192 edges).

knn ties: where the k-th and (k+1)-th distances differ, JAX's numpy builder
orders tied sources by index, as the port does, and the arrays are equal.
Where they tie, JAX's ``argpartition`` may pick another of the tied sources;
the port picks by index, as ``torch_cluster.knn`` and JAX's own device
builder (``pamnet_tpu/ops/neighbors.py::knn_edges``) do, and is held
against the latter there."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import numpy as np
import pytest

import jax.numpy as jnp

from pamnet_tpu.data import batch as jbatch
from pamnet_tpu.data import graphbuild as jgraph
from pamnet_tpu.ops import neighbors as jneighbors
from pamnet_tpu_torch.data import batch as tbatch
from pamnet_tpu_torch.data import graphbuild as tgraph
from pamnet_tpu_torch.data import native
from pamnet_tpu_torch.data.synthetic import synthetic_rna_dataset


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's builders on their numpy path."""
    monkeypatch.setenv("PAMNET_DISABLE_NATIVE", "1")
    return jgraph


def _cloud(seed=0):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.random((600, 3)) * 15,
                          rng.random((700, 3)) * 18]).astype(np.float32)
    return pos, np.repeat([0, 1], [600, 700]).astype(np.int64)


@pytest.mark.parametrize("cap", [1000, 7])  # 7 cuts most queries' neighbours
def test_radius_graph_matches_jax_numpy(jax_numpy, cap):
    pos, batch = _cloud()
    want = jax_numpy.radius_graph_np(pos, 2.5, batch, cap)
    got = native.radius_graph(pos, 2.5, batch, cap)
    assert got.dtype == np.int32 and got.shape[1] > 8192
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgraph.radius_graph(pos, 2.5, batch, cap), want)


def test_radius_graph_boundary_distances(jax_numpy):
    """Points at exactly the cutoff on a lattice (float32 r * r decides, as
    numpy's comparison does)."""
    g = np.stack(np.meshgrid(*[np.arange(9)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = (g * np.float32(1.3)).astype(np.float32)
    for r in (1.3, 2.6, 1.3 * np.sqrt(2.0)):
        np.testing.assert_array_equal(native.radius_graph(pos, r, None, 1000),
                                      jax_numpy.radius_graph_np(pos, r, None, 1000))


def test_knn_graph_matches_jax_numpy(jax_numpy):
    pos, batch = _cloud(1)
    want = jax_numpy.knn_graph_np(pos, 12, batch)
    np.testing.assert_array_equal(native.knn_graph(pos, 12, batch), want)
    np.testing.assert_array_equal(tgraph.knn_graph(pos, 12, batch), want)


def test_knn_graph_interior_ties_match_jax_numpy(jax_numpy):
    """Atoms on lines at integer spacing: every query has sources tied in
    pairs, and with k odd no tie straddles the k-th place."""
    line = np.zeros((300, 3), np.float32)
    line[:, 0] = np.arange(300)
    pos = np.concatenate([line, line + np.float32(7.0)])
    batch = np.repeat([0, 1], 300)
    for k in (7, 51):
        want = jax_numpy.knn_graph_np(pos, k, batch)
        np.testing.assert_array_equal(native.knn_graph(pos, k, batch), want)


def test_knn_graph_boundary_ties_by_index():
    """A lattice, where ties straddle the k-th place: the port takes the
    lowest indices, as JAX's device knn does, in its numpy and native
    builders alike."""
    g = np.stack(np.meshgrid(*[np.arange(9)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = g.astype(np.float32)
    n, k = pos.shape[0], 8
    q, s, mask = jneighbors.knn_edges(jnp.asarray(pos), jnp.zeros(n, jnp.int32),
                                      jnp.ones(n, jnp.float32), k)
    want = np.stack([np.asarray(q), np.asarray(s)])
    assert np.asarray(mask).all()
    np.testing.assert_array_equal(native.knn_graph(pos, k), want)
    np.testing.assert_array_equal(tgraph.knn_graph_np(pos, k), want)


def test_triplets_and_pairs_match_jax_numpy(jax_numpy):
    pos, batch = _cloud(2)
    edges = jax_numpy.remove_self_loops_np(jax_numpy.radius_graph_np(pos, 2.6, batch, 1000))
    assert edges.shape[1] > native.NATIVE_MIN_EDGES
    for name in ("triplets", "pairs"):
        want = getattr(jax_numpy, name + "_np")(edges, pos.shape[0])
        for got in (getattr(native, name)(edges, pos.shape[0]),
                    getattr(tgraph, name)(edges, pos.shape[0])):
            assert got.keys() == want.keys()
            for key in want:
                assert got[key].dtype == np.int32
                np.testing.assert_array_equal(got[key], want[key], f"{name} {key}")


def test_rna_structure_built_natively_matches_jax(jax_numpy):
    """A 2,100-atom RNA structure: knn, triplets and pairs all above the
    thresholds, the whole structure (and its f64 basis) as JAX's."""
    mol = synthetic_rna_dataset(1, seed=3)[0]
    assert mol["pos"].shape == (2100, 3)
    want = jbatch.precompute_structure(mol, "rna", 2.6, 20.0)
    got = tbatch.precompute_structure(mol, "rna", 2.6, 20.0)
    assert got["eg"].shape[1] > native.NATIVE_MIN_EDGES
    for key in ("eg", "el"):
        np.testing.assert_array_equal(got[key], want[key], key)
    for kind in ("t2", "t1"):
        for key in want[kind]:
            np.testing.assert_array_equal(got[kind][key], want[kind][key], f"{kind} {key}")


def test_unsorted_batch_is_refused():
    pos, batch = _cloud()
    with pytest.raises(ValueError, match="sorted"):
        native.knn_graph(pos, 4, batch[::-1].copy())


def test_library_that_cannot_build_raises(monkeypatch, tmp_path):
    """No numpy fallback: a failed build raises from every builder."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    pos, _ = _cloud()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tgraph.radius_graph(pos, 2.5)
    with pytest.raises(RuntimeError):
        native.triplets(np.zeros((2, 10), np.int32), 4)
