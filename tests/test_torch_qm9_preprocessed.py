"""The port's reader of PyG's preprocessed QM9 artifact (``data_v2.pt`` /
``qm9_v2.pt``) against the JAX package's on the same files: a PyG-layout
``torch.save`` of synthetic QM9 molecules, written through stand-in
``torch_geometric`` classes (PyG is not installed) in the zip format and
the legacy stream.  Molecules bit for bit (values and dtypes), ``load_qm9``'s
resolution order and npz cache, the error that names the artifacts, and a
file carrying a foreign global refused without running it.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import contextlib
import io
import math
import os
import pickle
import re
import sys
import types

import numpy as np
import pytest

import torch

from pamnet_tpu.data import qm9 as jqm9
from pamnet_tpu_torch import main_qm9
from pamnet_tpu_torch.data import qm9 as tqm9
from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset
from pamnet_tpu_torch.data.torchpickle import load_torch_pickle
from test_qm9 import _write_raw

FIELDS = ("z", "pos", "edge_index", "y")


@contextlib.contextmanager
def _fake_pyg():
    """``torch_geometric.data.data.Data`` and ``torch_geometric.data.storage.
    GlobalStorage`` as plain classes registered under PyG's module paths, so
    ``torch.save`` pickles them by those names."""
    names = ("torch_geometric", "torch_geometric.data", "torch_geometric.data.data",
             "torch_geometric.data.storage")
    saved = {n: sys.modules.get(n) for n in names}
    for n in names:
        sys.modules[n] = types.ModuleType(n)
    classes = {}
    for module, name in (("torch_geometric.data.data", "Data"),
                         ("torch_geometric.data.storage", "GlobalStorage")):
        cls = type(name, (), {"__init__": lambda self, **kw: self.__dict__.update(kw)})
        cls.__module__, cls.__qualname__ = module, name
        setattr(sys.modules[module], name, cls)
        classes[name] = cls
    try:
        yield classes
    finally:
        for n, old in saved.items():
            if old is None:
                del sys.modules[n]
            else:
                sys.modules[n] = old


def write_artifact(path, mols, legacy=False, storage=False):
    """PyG's collated layout of ``mols``: x (float atom types), pos, the
    bond edge_index with node ids offset by the nodes before each molecule,
    y (M, 19) with the molecule's label at every column, and the slices.
    ``storage``: the tensors in a ``_store`` (PyG 2.x) instead of on the
    Data itself (PyG 1.x)."""
    n = np.cumsum([0] + [len(m["z"]) for m in mols])
    e = np.cumsum([0] + [m["edge_index"].shape[1] for m in mols])
    rng = np.random.default_rng(len(mols))
    y = rng.standard_normal((len(mols), 19))
    y[:, tqm9.remap_target(7)] = [m["y"] for m in mols]
    fields = dict(
        x=torch.tensor(np.concatenate([m["z"] for m in mols]).astype(np.float32)),
        pos=torch.tensor(np.concatenate([m["pos"] for m in mols])),
        edge_index=torch.tensor(np.concatenate(
            [m["edge_index"] + n[i] for i, m in enumerate(mols)], axis=1)),
        y=torch.tensor(y, dtype=torch.float32))
    slices = {"x": torch.tensor(n), "pos": torch.tensor(n), "edge_index": torch.tensor(e),
              "y": torch.arange(len(mols) + 1)}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with _fake_pyg() as pyg:
        data = (pyg["Data"](_store=pyg["GlobalStorage"](_mapping=fields)) if storage
                else pyg["Data"](**fields))
        torch.save((data, slices), path, _use_new_zipfile_serialization=not legacy)
    return y


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in FIELDS:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("legacy", [False, True], ids=["zip", "legacy"])
def test_reader_matches_jax_bit_for_bit(tmp_path, legacy):
    mols = synthetic_qm9_dataset(6, seed=3)
    path = str(tmp_path / "data_v2.pt")
    y = write_artifact(path, mols, legacy=legacy)
    got = tqm9.load_qm9_preprocessed(path)
    _assert_same(got, jqm9.load_qm9_preprocessed(path))
    for g, m, yi in zip(got, mols, y):
        for k in ("z", "pos", "edge_index"):
            assert np.array_equal(g[k], m[k]), k
        assert g["z"].dtype == np.int32 and g["pos"].dtype == np.float32
        assert g["y"].dtype == np.float64 and g["y"].shape == (19,)
        np.testing.assert_array_equal(g["y"], yi.astype(np.float32).astype(np.float64))


def test_reader_takes_the_pyg2_storage_layout(tmp_path):
    """Tensors held in a ``_store`` (PyG 2.x) read as those on the Data."""
    mols = synthetic_qm9_dataset(4, seed=5)
    write_artifact(str(tmp_path / "a.pt"), mols)
    write_artifact(str(tmp_path / "b.pt"), mols, storage=True)
    data, _ = load_torch_pickle(str(tmp_path / "b.pt"))
    assert type(data).__name__ == "Data" and "x" not in data.__dict__
    _assert_same(tqm9.load_qm9_preprocessed(str(tmp_path / "b.pt")),
                 tqm9.load_qm9_preprocessed(str(tmp_path / "a.pt")))


def test_load_qm9_resolution_order_and_cache(tmp_path):
    """npz cache, then the raw SDF files, then processed/data_v2.pt, then
    raw/qm9_v2.pt, as the JAX package's ``load_qm9``; a molecule list read
    from an artifact is cached."""
    a, b = synthetic_qm9_dataset(3, seed=1), synthetic_qm9_dataset(5, seed=2)
    root = tmp_path / "QM9"
    write_artifact(str(root / "raw" / "qm9_v2.pt"), a)
    got = tqm9.load_qm9(str(root), cache=False)
    _assert_same(got, jqm9.load_qm9(str(root), cache=False))
    assert len(got) == 3
    write_artifact(str(root / "processed" / "data_v2.pt"), b)
    got = tqm9.load_qm9(str(root))  # processed/ first, and cached
    _assert_same(got, jqm9.load_qm9(str(root), cache=False))
    assert len(got) == 5 and (root / "processed" / "qm9_pamnet_tpu_torch.npz").is_file()
    os.remove(root / "processed" / "data_v2.pt")
    _assert_same(tqm9.load_qm9(str(root)), got)  # the cache, not raw/qm9_v2.pt
    # The raw SDF files come before either artifact.
    sdf_root = tmp_path / "sdf"
    _write_raw(sdf_root)
    write_artifact(str(sdf_root / "processed" / "data_v2.pt"), b)
    got = tqm9.load_qm9(str(sdf_root), cache=False)
    _assert_same(got, jqm9.load_qm9(str(sdf_root), cache=False))
    assert len(got) == 2


def test_load_qm9_error_names_the_artifacts(tmp_path):
    with pytest.raises(FileNotFoundError, match="data_v2.pt") as err:
        tqm9.load_qm9(str(tmp_path), cache=False)
    assert "qm9_v2.pt" in str(err.value) and "gdb9.sdf" in str(err.value)


class _Payload:
    """Pickles as a call of ``os.system``: a file that would run a command."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return os.system, (f"touch {self.marker}",)


@pytest.mark.parametrize("legacy", [False, True], ids=["zip", "legacy"])
def test_foreign_global_is_refused_and_not_run(tmp_path, legacy):
    marker = tmp_path / "ran"
    path = str(tmp_path / "data_v2.pt")
    torch.save((_Payload(marker), {}), path, _use_new_zipfile_serialization=not legacy)
    with pytest.raises(pickle.UnpicklingError, match="system"):
        tqm9.load_qm9_preprocessed(path)
    os.makedirs(tmp_path / "processed")
    os.replace(path, tmp_path / "processed" / "data_v2.pt")
    with pytest.raises(pickle.UnpicklingError, match="system"):
        tqm9.load_qm9(str(tmp_path), cache=False)
    assert not marker.exists()


def test_main_qm9_trains_from_the_artifact(tmp_path, monkeypatch):
    """``main_qm9`` without ``--synthetic`` finds ./data/QM9/processed/
    data_v2.pt and trains on its molecules."""
    write_artifact(str(tmp_path / "data" / "QM9" / "processed" / "data_v2.pt"),
                   synthetic_qm9_dataset(40, seed=9))
    monkeypatch.chdir(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main_qm9.main(["--limit", "40", "--dim", "16", "--n_layer", "1", "--epochs", "1",
                             "--batch_size", "8", "--device", "cpu",
                             "--compute_dtype", "float32"])
    assert "Data loaded! train=32 val=4 test=4" in out.getvalue()
    assert re.search(r"Epoch: 001, Train MAE: \S+", out.getvalue())
    assert math.isfinite(res["test_mae"])
    assert (tmp_path / "data" / "QM9" / "processed" / "qm9_pamnet_tpu_torch.npz").is_file()
