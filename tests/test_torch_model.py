"""The port's batches and RNA forward against the JAX package on the same
synthetic structures and the same parameters.

Batches: indices and offsets exactly, host geometry to 1e-6.  Scores: atol
5e-5, the tolerance of the RNA goldens in tests/test_serve.py (f32 sums in a
different order: CSR sums here, compensated scans in JAX)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pamnet_tpu.config import PAMNetConfig as JaxConfig
from pamnet_tpu.data import batch as jbatch
from pamnet_tpu.data.loader import GraphLoader as JaxLoader
from pamnet_tpu.data.synthetic import synthetic_rna_dataset
from pamnet_tpu.models import apply_pamnet, init_pamnet
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data import batch as tbatch
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.weights import from_jax_params

CUT_L, CUT_G = 2.6, 20.0
_INDEX_FIELDS = ("z", "node_graph", "eg_src", "eg_dst", "el_src", "el_dst",
                 "t2_i", "t2_j", "t2_k", "t2_kj", "t2_ji",
                 "t1_i", "t1_j1", "t1_j2", "t1_jj", "t1_ji")
_FLOAT_FIELDS = ("pos", "node_mask", "eg_mask", "el_mask", "t2_mask",
                 "t1_mask", "y", "graph_mask", "dist_g", "dist_l",
                 "sbf_radial", "cbf2", "cbf1")
_OFFSETS = ("eg_src_off", "eg_dst_off", "el_dst_off", "t2_ji_off", "t1_ji_off")


def _mols(n, seed=40):
    return [dict(z=g["labels"].astype(np.int32), pos=g["attrs"], y=g["y"])
            for g in synthetic_rna_dataset(n, seed=seed)]


def _assert_same_batch(jb, tb):
    for f in _INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), f)
    for f in _FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    for f in _OFFSETS:
        got = getattr(tb, f)
        if f in jb.tables:
            np.testing.assert_array_equal(got.numpy(), np.asarray(jb.tables[f]), f)
        else:
            assert got is None, f


def test_collate_matches_jax():
    mols = _mols(3)
    js = [jbatch.attach_basis(jbatch.precompute_structure(m, "rna", CUT_L, CUT_G), CUT_L)
          for m in mols]
    ts = [tbatch.attach_basis(tbatch.precompute_structure(m, "rna", CUT_L, CUT_G), CUT_L)
          for m in mols]
    pads = jbatch.PadSizes.bucketed(*[int(sum(c)) for c in zip(
        *[jbatch.structure_counts(s) for s in js])], 3)
    jb = jbatch.collate_structures(js, pads, build_tables=False)
    tb = tbatch.collate_structures(ts, tbatch.PadSizes(
        *(getattr(pads, f.name) for f in dataclasses.fields(tbatch.PadSizes))))
    _assert_same_batch(jb, tb)
    assert tb.eg_src_off is not None  # RNA global edges are src-major


def test_loader_matches_jax():
    """Ordered ladder batches with the serving path's high-water pads."""
    mols = _mols(5, seed=11)
    jl = JaxLoader(mols, "rna", CUT_L, CUT_G, batch_size=2, build_tables=False,
                   ladder_pads=True)
    tl = GraphLoader(mols, "rna", CUT_L, CUT_G, batch_size=2, ladder_pads=True)
    for f in dataclasses.fields(tbatch.PadSizes):
        assert getattr(tl.pads, f.name) == getattr(jl.pads, f.name), f.name
    jbs, tbs = list(jl), list(tl)
    assert len(jbs) == len(tbs) == 3
    for jb, tb in zip(jbs, tbs):
        _assert_same_batch(jb, tb)
        assert tb.num_graphs == int(np.asarray(jb.graph_mask).sum())


@pytest.mark.parametrize("n_layer,fold,fuse,flow", [
    (1, None, None, "target_to_source"),  # the serving default: fold + fuse
    (2, None, None, "target_to_source"),
    (1, False, None, "target_to_source"),  # unfolded
    (2, False, None, "target_to_source"),
    (1, None, False, "target_to_source"),  # JAX folded with split gathers, port fused
    (1, None, None, "source_to_target"),  # global sums at unsorted dst
])
def test_forward_matches_apply_pamnet(n_layer, fold, fuse, flow):
    kw = dict(dataset="rna", dim=16, n_layer=n_layer, cutoff_l=CUT_L,
              cutoff_g=CUT_G, flow=flow, fold_sbf=fold)
    # The port always runs a folded stage fused (kernel B).
    jcfg, tcfg = JaxConfig(**kw, fuse_sbf_gather=fuse), PAMNetConfig(**kw)
    params = init_pamnet(jax.random.PRNGKey(n_layer), jcfg)
    mols = _mols(3, seed=n_layer + 20)
    jb = next(iter(JaxLoader(mols, "rna", CUT_L, CUT_G, batch_size=4,
                             build_tables=False, ladder_pads=True)))
    want = np.asarray(jax.jit(lambda p, g: apply_pamnet(p, g, jcfg))(
        params, jax.tree.map(jnp.asarray, jb)))

    model = PAMNet(tcfg)
    model.load_state_dict(from_jax_params(params), strict=True)
    tb = next(iter(GraphLoader(mols, "rna", CUT_L, CUT_G, batch_size=4,
                               ladder_pads=True)))
    with torch.inference_mode():
        got = model(tb).numpy()
    assert got.shape == want.shape
    assert np.all(np.isfinite(got)) and np.all(got[3:] == 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("precision", ["highest", "medium"])
def test_segment_sum_ignores_matmul_precision(precision):
    """The graph pool is the float64 sum of its f32 rows, rounded once,
    whatever matmul precision the process set (TF32 or bf16 products would
    round the pooled prediction to a 10- or 7-bit mantissa)."""
    from pamnet_tpu_torch.ops.segment import segment_sum

    rng = np.random.default_rng(11)
    data = torch.from_numpy((rng.standard_normal((300, 3)) * 1e3).astype(np.float32))
    data.requires_grad_()
    ids = torch.from_numpy(np.sort(rng.integers(0, 7, 300)).astype(np.int32))
    want = torch.zeros(7, 3, dtype=torch.float64).index_add_(0, ids.long(), data.double())
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        got = segment_sum(data, ids, 7)
    finally:
        torch.set_float32_matmul_precision(old)
    assert torch.equal(got, want.float())
    got.sum().backward()
    assert torch.equal(data.grad, torch.ones_like(data))
