"""Derive-geometry batches: the port against the JAX package.

A derive batch carries positions and integer tables only
(``collate_structures(wire_geometry="derive")``); the port's forward derives
distances, the radial table and the angular harmonics in f32
(``models/pamnet.py::derive_geometry``), the JAX forward in its device
fallbacks.  Both packages run the same seeded parameters
(``from_jax_params``) on batches of the same molecules.

Tolerances: forwards within 5e-5 + 1e-4 |want| (f32 sums in another order;
on RNA at dim 16 the port folds the sbf MLP through kernel B's stage where
JAX's derive forward cannot, ``_fold_gate`` needing ``sbf_radial``: a
reassociation of the same sums); one training step on derive batches
against the host-geometry step at JAX's own f32-geometry tolerance
(``tests/test_wire_geometry.py:75-107``): loss within 1e-4 relative,
parameters after the step rtol 5e-3, atol 5e-4."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pamnet_tpu.config import PAMNetConfig as JaxConfig
from pamnet_tpu.data.loader import GraphLoader as JaxLoader
from pamnet_tpu.models import apply_pamnet, init_pamnet
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.batch import GEOMETRY_FIELDS, collate_structures, precompute_structure
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule, synthetic_pdbbind_dataset,
                                             synthetic_qm9_dataset, synthetic_rna_dataset)
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.train.ema import ema_init
from pamnet_tpu_torch.train.loop import Optimizer, train_step
from pamnet_tpu_torch.train.schedules import constant
from pamnet_tpu_torch.weights import from_jax_params

# name: (dataset kind, config kwargs shared by both packages, molecules)
CASES = {
    "qm9": ("qm9", dict(dataset="QM9", dim=32, n_layer=2, cutoff_l=5.0, cutoff_g=5.0),
            lambda: synthetic_qm9_dataset(5, seed=21)),
    "pamnet_s": ("qm9", dict(dataset="QM9", dim=16, n_layer=2, cutoff_l=5.0, cutoff_g=5.0,
                             variant="s"),
                 lambda: synthetic_qm9_dataset(5, seed=22)),
    "pdbbind": ("pdbbind", dict(dataset="PDBbind", dim=8, n_layer=2, cutoff_l=2.0,
                                cutoff_g=6.0),
                lambda: [pdbbind_molecule(g) for g in synthetic_pdbbind_dataset(3, seed=23)]),
    "rna_folded": ("rna", dict(dataset="rna", dim=16, n_layer=1, cutoff_l=2.6,
                               cutoff_g=20.0, flow="target_to_source"),
                   lambda: synthetic_rna_dataset(3, seed=24, n_atoms=150)),
}


def _batches(kind, kw, mols, geometry, build_perms=False):
    variant = kw.get("variant", "full")
    jb = next(iter(JaxLoader(mols, kind, kw["cutoff_l"], kw["cutoff_g"], batch_size=4,
                             build_tables=False, build_perms=build_perms, variant=variant,
                             wire_geometry=geometry)))
    tb = next(iter(GraphLoader(mols, kind, kw["cutoff_l"], kw["cutoff_g"], batch_size=4,
                               build_perms=build_perms, variant=variant,
                               wire_geometry=geometry)))
    return jb, tb


def test_derive_batches_drop_the_float_payloads(monkeypatch):
    mols = synthetic_qm9_dataset(4, seed=2)
    host = GraphLoader(mols, "qm9", 5.0, 5.0, 4, build_perms=True).collate([0, 1, 2, 3])
    # A derive loader never builds the host basis (its structures are built
    # by structcache.build_structures, which calls batch.attach_basis).
    monkeypatch.setattr("pamnet_tpu_torch.data.batch.attach_basis",
                        lambda *a, **k: pytest.fail("host basis"))
    loader = GraphLoader(mols, "qm9", 5.0, 5.0, 4, build_perms=True, wire_geometry="derive")
    derive = loader.collate([0, 1, 2, 3])
    assert all("sbf_radial" not in s for s in loader.structs)
    for f in dataclasses.fields(host):
        a, b = getattr(host, f.name), getattr(derive, f.name)
        if f.name in GEOMETRY_FIELDS:
            assert a is not None and b is None, f.name
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
    assert derive.valid == host.valid and derive.longest == host.longest
    # Host structures collated as derive drop their tables too; without the
    # host basis a host batch keeps its distances alone.
    structs = [precompute_structure(m, "qm9", 5.0, 5.0) for m in mols]
    assert collate_structures(structs, wire_geometry="derive").dist_g is None
    no_basis = collate_structures(structs)
    assert no_basis.dist_g is not None and no_basis.sbf_radial is None
    with pytest.raises(ValueError, match="wire_geometry"):
        collate_structures(structs, wire_geometry="wire")


@pytest.mark.parametrize("name", list(CASES))
def test_derive_forward_matches_jax(name):
    kind, kw, make = CASES[name]
    mols = make()
    jcfg, cfg = JaxConfig(**kw), PAMNetConfig(**kw)
    params = init_pamnet(jax.random.PRNGKey(len(name)), jcfg)
    jb, tb = _batches(kind, kw, mols, "derive")
    assert jb.sbf_radial is None and tb.sbf_radial is None and tb.dist_g is None
    want = np.asarray(jax.jit(lambda p, g: apply_pamnet(p, g, jcfg))(
        params, jax.tree.map(jnp.asarray, jb)))
    model = PAMNet(cfg)
    model.load_state_dict(from_jax_params(params), strict=True)
    assert model.fold_sbf() == (kw["dim"] in (8, 16))  # kernel B's widths
    with torch.no_grad():
        got = model(tb).numpy()
        host = model(_batches(kind, kw, mols, "host")[1]).numpy()
    assert np.all(np.isfinite(got)) and np.all(got[len(mols):] == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(got, host, rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("name", ["qm9", "rna_folded"])
def test_derive_train_step_matches_host_step(name):
    """One step of the recipe's optimizer (QM9: L1, Adam + clip 1000 + EMA
    0.999; RNA: SmoothL1, Adam) at lr 1e-3 on the derive batch and on the
    host batch of the same molecules, from the same parameters."""
    kind, kw, make = CASES[name]
    mols = make()
    loss_kind = "l1" if kind == "qm9" else "smooth_l1"
    outs = {}
    for geometry in ("host", "derive"):
        tb = _batches(kind, kw, mols, geometry, build_perms=True)[1]
        model = PAMNet(PAMNetConfig(**kw), torch.Generator().manual_seed(3))
        if kind == "qm9":
            opt = Optimizer(model.parameters(), constant(1e-3), clip_norm=1000.0)
            ema = ema_init(model.state_dict())
        else:
            opt, ema = Optimizer(model.parameters(), constant(1e-3)), None
        loss = float(train_step(model, opt, ema, tb, loss_kind))
        outs[geometry] = (loss, {k: v.clone() for k, v in model.state_dict().items()})
    (loss_h, params_h), (loss_d, params_d) = outs["host"], outs["derive"]
    assert abs(loss_h - loss_d) < 1e-4 * max(1.0, abs(loss_h))
    for k, v in params_h.items():
        np.testing.assert_allclose(params_d[k].numpy(), v.numpy(), rtol=5e-3, atol=5e-4,
                                   err_msg=k)
    start = PAMNet(PAMNetConfig(**kw), torch.Generator().manual_seed(3)).state_dict()
    assert max(float((params_d[k] - v).abs().max()) for k, v in start.items()) > 0.0


@pytest.mark.parametrize("geometry", ["derive", "host"])
def test_bench_pdbbind_line_follows_the_geometry_option(monkeypatch, geometry):
    """The bench's PDBbind line builds derive batches, as the JAX bench's
    does, unless ``--geometry host``; it names the geometry and its
    structures' build seconds."""
    import contextlib
    import io
    import json

    from pamnet_tpu_torch import bench

    monkeypatch.setenv("PAMNET_BENCH_TASK", "pdbbind")
    out = io.StringIO()
    extra = [] if geometry == "derive" else ["--geometry", "host"]
    with contextlib.redirect_stdout(out):
        bench.main(["--device", "cpu", "--small", *extra])
    (line,) = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert line["metric"] == "pdbbind_train_throughput" and line["value"] > 0
    assert line["geometry"] == geometry and line["structure_build_s"] > 0
