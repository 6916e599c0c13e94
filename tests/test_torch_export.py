"""Torch-interop export: params_to_torch + the first-party torch-zip writer
(utils/torchpickle.py::save_torch_pickle).

Three guarantees:
1. params -> state_dict -> params round-trips exactly through our own
   reader (no torch).
2. The written archive is a real torch.save artifact: torch.load with
   weights_only=True reads it bit-for-bit (torch is a test-only import).
3. The reference's bundled pamnet_rna.pt survives ingest -> export with the
   exact key set and values (the bidirectional name-mapping proof).
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import os

import numpy as np
import pytest

from pamnet_tpu.train.checkpoint import (
    load_torch_checkpoint, load_torch_state_dict, params_to_torch,
    torch_to_params,
)
from pamnet_tpu.utils.torchpickle import load_torch_pickle, save_torch_pickle

REFERENCE_PT = "/root/reference/save/pamnet_rna.pt"


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), f"{path}: keys {set(a)} != {set(b)}"
        for k in a:
            _tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.fixture(scope="module")
def rna_params():
    import jax

    from pamnet_tpu.config import PAMNetConfig
    from pamnet_tpu.models import init_pamnet

    cfg = PAMNetConfig(dataset="rna_test", dim=8, n_layer=2, cutoff_l=2.6,
                       cutoff_g=20.0, flow="target_to_source")
    return init_pamnet(jax.random.PRNGKey(3), cfg)


def test_roundtrip_through_own_reader(tmp_path, rna_params):
    path = str(tmp_path / "export.pt")
    save_torch_pickle(path, params_to_torch(rna_params))
    restored = torch_to_params(
        {k: np.asarray(v) for k, v in load_torch_pickle(path).items()}
    )
    _tree_equal(rna_params, restored)


def test_qm9_variant_s_roundtrip(tmp_path):
    import jax

    from pamnet_tpu.config import PAMNetConfig
    from pamnet_tpu.models import init_pamnet

    cfg = PAMNetConfig(dataset="QM9", dim=8, n_layer=2, variant="s")
    params = init_pamnet(jax.random.PRNGKey(5), cfg)
    path = str(tmp_path / "qm9s.pt")
    save_torch_pickle(path, params_to_torch(params))
    restored = torch_to_params(
        {k: np.asarray(v) for k, v in load_torch_pickle(path).items()}
    )
    _tree_equal(params, restored)


def test_torch_reads_our_archive(tmp_path, rna_params):
    torch = pytest.importorskip("torch")
    sd = params_to_torch(rna_params)
    path = str(tmp_path / "export.pt")
    save_torch_pickle(path, sd)
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    assert set(loaded) == set(sd)
    for k, v in sd.items():
        got = loaded[k].numpy()
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)


def test_state_dict_wrapper_returns_torch_tensors(rna_params):
    torch = pytest.importorskip("torch")

    from pamnet_tpu.train.export import params_to_torch_state_dict

    sd = params_to_torch_state_dict(rna_params)
    ref = params_to_torch(rna_params)
    assert list(sd) == list(ref)
    for k, v in sd.items():
        assert isinstance(v, torch.Tensor), k
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_export_dtype_rules():
    """bf16 upcasts to f32 (the reference's dtype); f64 passes through —
    no silent downcast (cf. ADVICE round-2 #3 on ops/ell.py)."""
    import jax.numpy as jnp

    params = {"embeddings": jnp.ones((3, 4), jnp.bfloat16),
              "rbf_g": {"freq": np.linspace(0, 1, 5)}}  # float64
    sd = params_to_torch(params)
    assert sd["embeddings"].dtype == np.float32
    assert sd["rbf_g.freq"].dtype == np.float64


def test_mixed_dtypes_roundtrip(tmp_path):
    sd = {
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
        "f64": np.linspace(0, 1, 4).reshape(2, 2),
        "i64": np.arange(5, dtype=np.int64),
        "i32": np.array([[7]], dtype=np.int32),
        "u8": np.arange(300 % 256, dtype=np.uint8),
        "scalarish": np.float32(3.5).reshape(()),
    }
    path = str(tmp_path / "mixed.pt")
    save_torch_pickle(path, sd)
    loaded = load_torch_pickle(path)
    assert set(loaded) == set(sd)
    for k in sd:
        got = np.asarray(loaded[k])
        assert got.dtype == sd[k].dtype, k
        np.testing.assert_array_equal(got.reshape(sd[k].shape), sd[k], err_msg=k)


@pytest.mark.skipif(not os.path.exists(REFERENCE_PT),
                    reason="reference checkpoint not mounted")
def test_reference_checkpoint_ingest_export_exact(tmp_path):
    """pamnet_rna.pt -> our pytree -> export: exact key set + exact values
    (weights transpose twice, so bitwise equality is required)."""
    original = load_torch_state_dict(REFERENCE_PT)
    params = torch_to_params(original)
    exported = params_to_torch(params)
    assert set(exported) == set(original)
    for k, v in original.items():
        np.testing.assert_array_equal(exported[k], np.asarray(v), err_msg=k)
    # And the re-serialized archive loads back through the zip reader.
    path = str(tmp_path / "rna_reexport.pt")
    save_torch_pickle(path, exported)
    reloaded = load_torch_checkpoint(path)
    _tree_equal(params, reloaded)


def test_big_endian_arrays_written_little(tmp_path):
    """The archive declares byteorder 'little'; big-endian inputs must be
    byte-swapped into the payload, not written raw under that label."""
    from pamnet_tpu.utils.torchpickle import load_torch_pickle, \
        save_torch_pickle

    path = str(tmp_path / "be.pt")
    be = np.arange(6, dtype=">f4").reshape(2, 3) * 1.5
    save_torch_pickle(path, {"w": be, "i": np.arange(4, dtype=">i8")})
    got = load_torch_pickle(path)
    np.testing.assert_array_equal(got["w"], np.asarray(be, "<f4"))
    np.testing.assert_array_equal(got["i"], np.arange(4))
    torch = pytest.importorskip("torch")
    sd = torch.load(path, weights_only=True)
    np.testing.assert_array_equal(sd["w"].numpy(), np.asarray(be, "<f4"))
