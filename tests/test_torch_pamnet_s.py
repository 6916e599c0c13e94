"""The port's PAMNet_s (the one-hop local layer, ``mlp_sbf`` and
``mlp_m_jj``) against the JAX package on QM9 molecules: structures and
training batches, the forward and the L1 loss's gradient with respect to
every parameter, folded (dim 16, kernel B's width) and unfolded, three
Adam steps at the QM9 recipe's optimizer, and ``main_qm9 --model PAMNet_s``
in-process; the f64 numpy oracle (``tests/oracle_numpy.py``) judges the
forward as well.

Tolerances: batch indices and offsets exact, floats within 1e-6;
predictions within 1e-5 abs; gradients per tensor
``max|d| <= 1e-4 * max|g_jax| + 1e-6``; parameters after three Adam steps
within 1e-6; the oracle within 1e-3 * max(1, |want|) (its tolerance in
``tests/test_branch_parity.py``).
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

from oracle_numpy import qm9_forward
from pamnet_tpu.config import PAMNetConfig as JaxConfig
from pamnet_tpu.data import batch as jbatch
from pamnet_tpu.data.loader import GraphLoader as JaxLoader
from pamnet_tpu.models import apply_pamnet, init_pamnet
from pamnet_tpu.train import loop as jloop
from pamnet_tpu.train.schedules import warmup_exponential as jax_warmup
from pamnet_tpu_torch import main_qm9
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data import batch as tbatch
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset
from pamnet_tpu_torch.models import layers
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.train.ema import ema_init
from pamnet_tpu_torch.train.loop import Optimizer, batch_loss, train_step
from pamnet_tpu_torch.train.schedules import warmup_exponential
from pamnet_tpu_torch.weights import from_jax_params, load_reference_checkpoint
from test_torch_model import _assert_same_batch

CUT = 5.0


def test_s_structures_and_batch_match_jax():
    """No triplets in the structures; the batch carries JAX's padded t2
    fields but no CSR of them (nothing of size zero reaches a kernel)."""
    mols = synthetic_qm9_dataset(5, seed=21)
    js = [jbatch.attach_basis(jbatch.precompute_structure(m, "qm9", CUT, CUT, variant="s"),
                              CUT) for m in mols]
    ts = [tbatch.attach_basis(tbatch.precompute_structure(m, "qm9", CUT, CUT, variant="s"),
                              CUT) for m in mols]
    for j, t in zip(js, ts):
        assert t["t2"]["idx_ji"].size == 0 and t["cbf2"].shape == (0, 7)
        for k in ("eg", "el", "dist_g", "dist_l", "sbf_radial", "cbf1"):
            assert np.array_equal(t[k], j[k]), k
        for k, v in j["t1"].items():
            assert np.array_equal(t["t1"][k], v), k
    pads = jbatch.PadSizes.bucketed(*[int(sum(c)) for c in zip(
        *[jbatch.structure_counts(s) for s in js])], 5)
    jb = jbatch.collate_structures(js, pads, build_tables=False, build_perms=True)
    tb = tbatch.collate_structures(ts, tbatch.PadSizes(
        *(getattr(pads, f.name) for f in dataclasses.fields(tbatch.PadSizes))),
        build_perms=True, num_atom_types=5, variant="s")
    for f in ("t2_ji", "t2_kj", "t2_mask", "t1_ji", "t1_jj", "el_dst", "eg_src"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), f)
    jb.tables.pop("t2_ji_off")  # JAX offsets the empty stream; the port leaves it out
    _assert_same_batch(jb, tb)
    assert tb.valid["t2"] == 0 and tb.t2_ji_off is None and tb.groups("t2_kj") is None
    assert not any(k.startswith("t2") for k in tb.perms)
    assert "t2_ji" not in tb.longest and "t2_kj" not in tb.longest
    for key in ("el_src", "t1_jj"):
        for suffix in ("_perm", "_poff"):
            np.testing.assert_array_equal(tb.perms[key + suffix].numpy(),
                                          np.asarray(jb.tables[key + suffix]), key + suffix)
    with pytest.raises(ValueError, match="no triplets"):
        tbatch.collate_structures([tbatch.attach_basis(
            tbatch.precompute_structure(mols[0], "qm9", CUT, CUT), CUT)], variant="s")


@functools.lru_cache(maxsize=None)
def _reference(n_layer: int, dim: int, fold: bool | None):
    """JAX params, the molecules, the port's batch, and JAX's predictions and
    L1 gradients (JAX's gate folds where 7 * dim <= 128; ``fold`` forces
    it in both packages)."""
    kw = dict(dataset="QM9", dim=dim, n_layer=n_layer, cutoff_l=CUT, cutoff_g=CUT,
              variant="s", fold_sbf=fold)
    jcfg = JaxConfig(**kw)
    params = init_pamnet(jax.random.PRNGKey(7 * n_layer + dim), jcfg)
    mols = synthetic_qm9_dataset(5, seed=n_layer + dim)
    jb = next(iter(JaxLoader(mols, "qm9", CUT, CUT, batch_size=6, build_tables=False,
                             build_perms=True, variant="s")))
    tb = next(iter(GraphLoader(mols, "qm9", CUT, CUT, batch_size=6, build_perms=True,
                               variant="s")))

    def loss(p, g):
        pred = apply_pamnet(p, g, jcfg)
        total, count = jloop._loss_terms(pred, g.y, g.graph_mask, "l1")
        return total / jnp.maximum(count, 1.0), pred

    (_, pred), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, jb))
    return params, mols, tb, np.asarray(pred), from_jax_params(grads), kw


def _model(params, kw):
    model = PAMNet(PAMNetConfig(**kw))
    model.load_state_dict(from_jax_params(params), strict=True)
    return model


# Folded at kernel B's width (dim 16, by default in both packages),
# unfolded at dim 16 by the flag and at dim 32 by default.
CASES = [(2, 16, None), (1, 16, False), (1, 32, None)]


@pytest.mark.parametrize("n_layer,dim,fold", CASES)
def test_s_forward_and_gradients_match_jax(n_layer, dim, fold, monkeypatch):
    params, mols, tb, want_pred, want, kw = _reference(n_layer, dim, fold)
    model = _model(params, kw)
    assert model.fold_sbf() == (dim == 16 and fold is None)
    kinds = []
    stream = layers.LocalMP._stream
    monkeypatch.setattr(layers.LocalMP, "_stream",
                        lambda self, m, sbf, g, kind, plain: kinds.append(kind)
                        or stream(self, m, sbf, g, kind, plain))
    with torch.no_grad():
        pred = model(tb).numpy()
    assert kinds == ["t1"] * n_layer  # the one-hop stream alone
    np.testing.assert_allclose(pred, want_pred, rtol=0, atol=1e-5)
    model.zero_grad()
    batch_loss(model, tb, "l1").backward()
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in
           model.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        bound = 1e-4 * float(w.abs().max()) + 1e-6
        assert err <= bound, f"{name}: max|d| {err:.3g} > {bound:.3g}"
    assert float(got["mlp_sbf.0.0.weight"].abs().max()) > 0.0
    assert float(got["local_layer.0.mlp_m_jj.0.0.weight"].abs().max()) > 0.0
    sd = {k: v.double().numpy() for k, v in model.state_dict().items()}
    for i, m in enumerate(mols):
        ref = qm9_forward(sd, m, n_layer=n_layer, variant="s")
        assert abs(pred[i] - ref) < 1e-3 * max(1.0, abs(ref)), (i, pred[i], ref)


def test_s_three_adam_steps_match_jax():
    """The QM9 recipe's optimizer (Adam, global-norm clip 1000, EMA 0.999,
    warmup-exponential at lr 1e-3 over 2 steps an epoch, so the lr moves)
    against ``make_train_step``."""
    params, mols, tb, _, _, kw = _reference(2, 16, None)
    jb = jax.tree.map(jnp.asarray, next(iter(JaxLoader(
        mols, "qm9", CUT, CUT, batch_size=6, build_tables=False, build_perms=True,
        variant="s"))))
    optimizer = jloop.make_optimizer(jax_warmup(1e-3, steps_per_epoch=2), clip_norm=1000.0)
    state = jloop.init_train_state(params, optimizer, use_ema=True)
    step = jloop.make_train_step(JaxConfig(**kw), optimizer, "l1", ema_decay=0.999)
    model = _model(params, kw)
    opt = Optimizer(model.parameters(), warmup_exponential(1e-3, 2), clip_norm=1000.0)
    ema = ema_init(model.state_dict())
    for _ in range(3):
        state, jloss = step(state, jb)
        loss = train_step(model, opt, ema, tb, "l1")
        assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    want, want_ema = from_jax_params(state.params), from_jax_params(state.ema)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(ema[name].numpy(), want_ema[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_main_qm9_trains_pamnet_s_in_process(capsys, tmp_path):
    res = main_qm9.main(["--synthetic", "--limit", "40", "--model", "PAMNet_s", "--dim", "16",
                         "--n_layer", "1", "--epochs", "1", "--batch_size", "8",
                         "--device", "cpu", "--compute_dtype", "float32",
                         "--save_dir", str(tmp_path)])
    out = capsys.readouterr().out
    maes = re.findall(r"(Train|Val|Test) MAE: (\S+?),? ", out)
    maes += re.findall(r"(Best Validation|Testing) MAE: (\S+)", out)
    assert len(maes) == 5 and all(math.isfinite(float(v)) for _, v in maes)
    assert res["test_mae"] == float(maes[-1][1])
    best = load_reference_checkpoint(str(tmp_path / "QM9" / "best_model.pt"))
    assert "mlp_sbf.0.0.weight" in best and "local_layer.0.mlp_m_jj.0.0.weight" in best
    assert not any("mlp_sbf1" in k or "mlp_m_kj" in k or "init_linear" in k for k in best)


def test_main_qm9_trains_pamnet_s_bf16_in_process(capsys, tmp_path):
    """PAMNet_s at the driver's default bfloat16 (dim 32: the port folds at
    dim 16, which bfloat16 refuses)."""
    res = main_qm9.main(["--synthetic", "--limit", "40", "--model", "PAMNet_s", "--dim", "32",
                         "--n_layer", "1", "--epochs", "1", "--batch_size", "8",
                         "--device", "cpu", "--save_dir", str(tmp_path)])
    out = capsys.readouterr().out
    maes = re.findall(r"(Train|Val|Test) MAE: (\S+?),? ", out)
    maes += re.findall(r"(Best Validation|Testing) MAE: (\S+)", out)
    assert len(maes) == 5 and all(math.isfinite(float(v)) for _, v in maes)
    assert res["test_mae"] == float(maes[-1][1])
