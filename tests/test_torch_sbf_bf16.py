"""Kernel B in bfloat16 on the CPU: the folded RNA model in mixed precision
against the JAX package's, and the plain bfloat16 version of the stage
against a float32 computation rounded once.

JAX folds the published RNA model in bfloat16 too (``num_spherical * dim <=
128`` and no ELL tables: its loader built with ``build_tables=False``) and
casts the radial table, the projection's weight and bias and the angular
terms to bfloat16 before the fused gather
(``pamnet_tpu/models/pamnet.py:185-230``).  The port's folded bfloat16
model (dim 16 and dim 8, one layer) is held to JAX's ``apply_pamnet`` at
``compute_dtype="bfloat16"`` on the same structures and parameters with the
rule ``tests/test_torch_bf16.py`` holds the unfolded model to: predictions
within ``1e-2 * max|pred|``, each parameter's gradient within
``4e-2 * max|g| + 1e-6``.

The plain bfloat16 version of kernel B (``sbf_modulate_plain`` on bfloat16
operands: the reference its kernel is held to on the card) computes in
float32 and rounds once: its output and, through autograd, each of its
seven gradients equal bit for bit the float32 computation on the same
values rounded once to bfloat16, summed by center edge and as rows.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pamnet_tpu.config import PAMNetConfig as JaxConfig
from pamnet_tpu.data.loader import GraphLoader as JaxLoader
from pamnet_tpu.models import apply_pamnet, init_pamnet
from pamnet_tpu.train import loop as jloop
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.batch import build_perm_np
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import synthetic_rna_dataset
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.ops.sbf_modulate import sbf_modulate, sbf_modulate_plain
from pamnet_tpu_torch.ops.triplet import Groups
from pamnet_tpu_torch.train.loop import batch_loss
from pamnet_tpu_torch.weights import from_jax_params

BF16 = torch.bfloat16
RNA = dict(dataset="rna_train", n_layer=1, cutoff_l=2.6, cutoff_g=20.0,
           flow="target_to_source")


@functools.lru_cache(maxsize=None)
def _jax_reference(dim: int):
    """JAX's bfloat16 predictions and SmoothL1 loss gradients (as reference
    ``state_dict`` tensors) of the folded RNA model at ``dim`` on three
    synthetic structures; its parameters and the port's batch of them."""
    jcfg = JaxConfig(**RNA, dim=dim, compute_dtype="bfloat16")
    params = init_pamnet(jax.random.PRNGKey(dim), jcfg)
    mols = synthetic_rna_dataset(3, seed=dim, n_atoms=48)
    jb = next(iter(JaxLoader(mols, "rna", 2.6, 20.0, batch_size=4, build_tables=False,
                             build_perms=True)))
    tb = next(iter(GraphLoader(mols, "rna", 2.6, 20.0, batch_size=4, build_perms=True)))

    def loss(p, g):
        pred = apply_pamnet(p, g, jcfg)
        total, count = jloop._loss_terms(pred, g.y, g.graph_mask, "smooth_l1")
        return total / jnp.maximum(count, 1.0), pred

    (_, pred), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, jb))
    return params, tb, np.asarray(pred), from_jax_params(grads)


@pytest.mark.parametrize("dim", [16, 8])
def test_folded_bf16_rna_matches_jax(dim):
    params, tb, want_pred, want = _jax_reference(dim)
    model = PAMNet(PAMNetConfig(**RNA, dim=dim, compute_dtype="bfloat16"))
    model.load_state_dict(from_jax_params(params), strict=True)
    assert model.fold_sbf()
    calls = sbf_modulate.launches
    with torch.no_grad():
        pred = model(tb)
    assert sbf_modulate.launches == calls  # CPU tensors: the plain version
    assert pred.dtype == torch.float32 and bool(torch.isfinite(pred).all())
    np.testing.assert_allclose(pred.numpy(), want_pred, rtol=0,
                               atol=1e-2 * np.abs(want_pred).max())
    model.zero_grad()
    batch_loss(model, tb, "smooth_l1").backward()
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in model.named_parameters()}
    assert set(got) == set(want)
    assert model.mlp_sbf1[0][0].weight.grad is not None
    for name, w in want.items():
        assert got[name].dtype == torch.float32
        err = float((got[name] - w).abs().max())
        bound = 4e-2 * float(w.abs().max()) + 1e-6
        assert err <= bound, f"{name}: max|d| {err:.3g} > {bound:.3g}"


def _stage(d: int, seed: int):
    """Kernel B's operands in bfloat16 (a padded tail, masked triplets, the
    CSR of the index and random center edges with empty groups) and an
    output gradient for the sums and one for the rows."""
    rng = np.random.default_rng(seed)
    ns, edges, t, valid, num_out = 7, 40, 300, 280, 90
    idx = rng.integers(0, edges, t).astype(np.int32)
    idx[valid:] = 0
    mask = (np.arange(t) < valid).astype(np.float32)
    mask[5::11] = 0.0
    ids = np.sort(2 * rng.integers(0, num_out // 2, valid)).astype(np.int32)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF16)  # noqa: E731
    args = [r(edges, ns * d), r(edges, d), r(t, ns), r(d), r(d, d) / d**0.5, r(d),
            r(d, d) / d**0.5, r(d), torch.from_numpy(idx), torch.from_numpy(mask).to(BF16)]
    perm, poff = build_perm_np(idx, valid, edges, t)
    groups = Groups(torch.from_numpy(poff), torch.from_numpy(perm), valid)
    out_groups = Groups(torch.from_numpy(np.searchsorted(ids, np.arange(num_out + 1))
                                         .astype(np.int32)), None, valid)
    out_ids = torch.from_numpy(np.concatenate([ids, np.zeros(t - valid, np.int32)]))
    return args, groups, out_groups, out_ids, r(num_out, d), r(t, d)


GRAD_AT = (0, 1, 3, 4, 5, 6, 7)  # proj, m_neighbor, bias, w1, b1, w2, b2


@pytest.mark.parametrize("summed", [True, False], ids=["summed", "rows"])
@pytest.mark.parametrize("d", [16, 8])
def test_plain_bf16_stage_is_f32_rounded_once(d, summed):
    args, groups, out_groups, out_ids, cot_sum, cot_rows = _stage(d, seed=d + summed)
    kw = dict(groups=groups, out_groups=out_groups, out_ids=out_ids) if summed else dict(
        groups=groups)
    cot = cot_sum if summed else cot_rows
    runs = []
    for dtype in (BF16, torch.float32):
        leaves = [a.to(dtype, copy=True).requires_grad_() if i in GRAD_AT
                  else (a.to(dtype) if a.is_floating_point() else a)
                  for i, a in enumerate(args)]
        out = sbf_modulate(*leaves, **kw)
        out.backward(cot.to(dtype))
        runs.append([out] + [leaves[i].grad for i in GRAD_AT])
    for got, f32 in zip(*runs):
        assert got.dtype == BF16 and f32.dtype == torch.float32
        assert torch.equal(got, f32.to(BF16))
    # The same function through the plain version itself, and not a
    # bfloat16 rounding after each operation: that one differs.
    plain = sbf_modulate_plain(*args, out_off=out_groups.off if summed else None)
    assert torch.equal(plain, runs[0][0].detach())
    per_op = _per_op_bf16(*args, out_off=out_groups.off if summed else None)
    assert not torch.equal(per_op, plain)


def _per_op_bf16(proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, out_off=None):
    """The stage with every operation in bfloat16 (each rounded)."""
    from torch.nn import functional as F

    d = m.shape[1]
    rows = torch.cat([proj, m], dim=1)[idx.long()]
    acc = bias
    for l in range(proj.shape[1] // d):
        acc = acc + cbf[:, l:l + 1] * rows[:, l * d:(l + 1) * d]
    h = F.silu(F.linear(F.silu(F.linear(F.silu(acc), w1, b1)), w2, b2)) * mask[:, None]
    out = rows[:, -d:] * h
    if out_off is None:
        return out
    seg = torch.repeat_interleave(torch.arange(out_off.shape[0] - 1),
                                  (out_off[1:] - out_off[:-1]).long())
    return out.new_zeros(out_off.shape[0] - 1, d).index_add_(0, seg, out[:int(out_off[-1])])
