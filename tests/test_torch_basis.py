"""The port's spherical basis on the device (``pamnet_tpu_torch/ops/basis.py``)
against ``pamnet_tpu/ops/basis.py`` on the same f32 inputs, against scipy in
f32 over the whole operating range (the stability case of
``tests/test_basis.py:98``), with finite gradients at padded triplets, and
the card-side geometry of a derive batch (``derive_geometry``, f32) against
the host's ``attach_basis`` (f64).

Tolerances: against JAX, both f32 evaluations of the same formulas, 2e-6
relative to the largest |value| of the table (the radial tables reach ~4.5e3
near d = 0); against scipy (f64) rtol 5e-4, atol 2e-6, JAX's own test;
f32 on the card against the f64 host tables, rtol 5e-4 + atol 1e-4 on the
radial table (the f32 evaluator's own tolerance against scipy: its series
and recurrence, not the f32 distance, set it) and atol 2e-5 on the angular
one."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import numpy as np
import pytest
from scipy import special as scipy_special

import jax
import jax.numpy as jnp
import torch

from pamnet_tpu.ops import basis as jbasis
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset, synthetic_rna_dataset
from pamnet_tpu_torch.models.pamnet import _angle, _safe_edge_dist, derive_geometry
from pamnet_tpu_torch.ops import basis as tbasis


def _close(got, want, rel=2e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, np.abs(want).max()))


def _args():
    rng = np.random.default_rng(5)
    return np.concatenate([rng.random(200) * 12, [0.0, 1e-7, 0.999, 1.0, 8.0, 9.0, 9.001,
                                                  30.0]]).astype(np.float32)


@pytest.mark.parametrize("lmax", [0, 1, 3, 6])
def test_spherical_jn_all_matches_jax(lmax):
    x = _args()
    _close(tbasis.spherical_jn_all(torch.from_numpy(x), lmax),
           jbasis.spherical_jn_all(jnp.asarray(x), lmax))


def test_spherical_jn_all_stable_in_f32():
    arg = np.concatenate([np.linspace(0.01, 0.99, 40), np.linspace(1.0, 8.9, 60),
                          np.linspace(9.0, 30.0, 40)])
    lmax = 7
    got = tbasis.spherical_jn_all(torch.tensor(arg, dtype=torch.float32), lmax).numpy()
    assert np.all(np.isfinite(got))
    for l in range(lmax + 1):
        np.testing.assert_allclose(got[:, l], scipy_special.spherical_jn(l, arg),
                                   rtol=5e-4, atol=2e-6)


@pytest.mark.parametrize("ns,nr,cutoff", [(7, 6, 5.0), (7, 6, 2.6), (3, 4, 2.0)])
def test_edge_rbf_cbf_and_basis_match_jax(ns, nr, cutoff):
    rng = np.random.default_rng(ns + nr)
    dist = np.concatenate([rng.random(150) * cutoff * 1.2,
                           [2.0 * cutoff, cutoff]]).astype(np.float32)
    angle = (rng.random(300) * np.pi).astype(np.float32)
    idx = rng.integers(0, dist.size, angle.size).astype(np.int32)
    _close(tbasis.spherical_basis_edge_rbf(torch.from_numpy(dist), ns, nr, cutoff),
           jbasis.spherical_basis_edge_rbf(jnp.asarray(dist), ns, nr, cutoff))
    _close(tbasis.legendre_cbf(torch.from_numpy(angle), ns),
           jbasis.legendre_cbf(jnp.asarray(angle), ns))
    _close(tbasis.spherical_basis(torch.from_numpy(dist), torch.from_numpy(angle),
                                  torch.from_numpy(idx), ns, nr, cutoff),
           jbasis.spherical_basis(jnp.asarray(dist), jnp.asarray(angle),
                                  jnp.asarray(idx), ns, nr, cutoff))
    # Sanitized (padded) distances zero every channel.
    pad = tbasis.spherical_basis_edge_rbf(torch.full((3,), 2.0 * cutoff), ns, nr, cutoff)
    assert torch.all(pad == 0)


def test_padded_triplets_have_finite_gradients():
    """Padded triplets and edges all point at node 0 (v1 = v2 = 0, zero
    lengths): the guarded angle and distance and the basis give finite
    gradients with respect to the positions, and so does a real triplet
    with collinear atoms."""
    pos = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0],
                        [1.0, 1.0, 0.0]], requires_grad=True)
    a, b, c = (torch.tensor(v, dtype=torch.int32) for v in ([0, 1, 0, 0], [1, 3, 0, 0],
                                                             [2, 2, 0, 0]))
    mask = torch.tensor([1.0, 1.0, 0.0, 0.0])
    angle = _angle(pos, a, b, c, mask)
    assert torch.all(torch.isfinite(angle))
    cbf = tbasis.legendre_cbf(angle, 7)
    # Two real edges and two padded ones (0 -> 0).
    dist = _safe_edge_dist(pos, a[:4], torch.tensor([1, 2, 0, 0], dtype=torch.int32), mask,
                           5.0)
    assert torch.equal(dist[2:], torch.tensor([10.0, 10.0]))
    rbf = tbasis.spherical_basis_edge_rbf(dist, 7, 6, 5.0)
    (cbf.sum() + rbf.sum()).backward()
    assert torch.all(torch.isfinite(pos.grad))
    # JAX's _angle on the same rows.
    from pamnet_tpu.models.pamnet import _angle as jangle

    want = jangle(jnp.asarray(pos.detach().numpy()), *(jnp.asarray(v.numpy())
                                                       for v in (a, b, c, mask)))
    np.testing.assert_allclose(angle.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert np.all(np.isfinite(np.asarray(jax.grad(
        lambda p: jangle(p, *(jnp.asarray(v.numpy()) for v in (a, b, c, mask))).sum())(
            jnp.asarray(pos.detach().numpy())))))


@pytest.mark.parametrize("kind", ["qm9", "rna"])
def test_derived_geometry_matches_host_f64(kind):
    """``derive_geometry`` of a derive batch (f32) against the host's f64
    ``attach_basis`` tables of the same molecules."""
    if kind == "qm9":
        mols, cl, cg, cfg = synthetic_qm9_dataset(12, seed=3), 5.0, 5.0, PAMNetConfig()
    else:
        mols, cl, cg = synthetic_rna_dataset(2, seed=4, n_atoms=200), 2.6, 20.0
        cfg = PAMNetConfig(dataset="rna", dim=16, n_layer=1, cutoff_l=cl, cutoff_g=cg)
    host = GraphLoader(mols, kind, cl, cg, len(mols)).collate(list(range(len(mols))))
    derive = GraphLoader(mols, kind, cl, cg, len(mols),
                         wire_geometry="derive").collate(list(range(len(mols))))
    got = derive_geometry(derive, cfg)
    for name, pad in (("dist_g", 2.0 * cg), ("dist_l", 2.0 * cl)):
        mask = getattr(host, ("eg" if name == "dist_g" else "el") + "_mask") > 0
        want = torch.where(mask, getattr(host, name), pad)
        np.testing.assert_allclose(getattr(got, name).numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got.sbf_radial.numpy(), host.sbf_radial.numpy(), rtol=5e-4,
                               atol=1e-4)
    for name, mask in (("cbf2", host.t2_mask), ("cbf1", host.t1_mask)):
        real = mask.numpy() > 0
        np.testing.assert_allclose(getattr(got, name).numpy()[real],
                                   getattr(host, name).numpy()[real], rtol=0, atol=2e-5,
                                   err_msg=name)
