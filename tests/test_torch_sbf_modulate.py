"""Kernel B (pamnet_tpu_torch/ops/sbf_modulate.py) on CPU tensors, where the
wrapper runs its plain version forward and PyTorch's autograd backward,
against the JAX package's fused sbf gather (pamnet_tpu/models/layers.py
_fused_sbf_gather), its ``jax.grad`` and the Pallas probe's function, on the
same numpy inputs.

Tolerances: outputs rtol 1e-5 / atol 1e-6 (the same f32 operations, in a
possibly different order); each gradient ``max|d| <= 1e-5 * max|g_jax|``
plus 1e-7 absolute (sums over up to 1,024 triplets in another order);
``gradcheck`` in float64 at its defaults.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pamnet_tpu.models.layers import FoldedSBF, _fused_sbf_gather
from pamnet_tpu_torch.data.batch import build_perm_np
from pamnet_tpu_torch.ops.sbf_modulate import (KERNEL_SHAPES, sbf_modulate,
                                               sbf_modulate_backward, sbf_modulate_plain)
from pamnet_tpu_torch.ops.triplet import Groups

GRAD_NAMES = ("proj", "m", "bias", "w1", "b1", "w2", "b2")


def _inputs(rng, d, ns=7, edges=300, triplets=1024, padded=100):
    f32 = np.float32
    bound = 1.0 / np.sqrt(d)
    valid = triplets - padded
    idx = rng.integers(0, edges, triplets).astype(np.int32)
    idx[valid:] = 0  # padded triplets point at slot 0, as in batches
    return dict(
        proj=rng.standard_normal((edges, ns * d)).astype(f32),
        m=rng.standard_normal((edges, d)).astype(f32),
        cbf=rng.standard_normal((triplets, ns)).astype(f32),
        bias=rng.standard_normal(d).astype(f32),
        # JAX layout (in, out).
        w1=rng.uniform(-bound, bound, (d, d)).astype(f32),
        b1=rng.uniform(-bound, bound, d).astype(f32),
        w2=rng.uniform(-bound, bound, (d, d)).astype(f32),
        b2=rng.uniform(-bound, bound, d).astype(f32),
        idx=idx,
        mask=(np.arange(triplets) < valid).astype(f32),
        cot=rng.standard_normal((triplets, d)).astype(f32),
        valid=valid,
    )


def _port_args(x, dtype=torch.float32):
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return (t(x["proj"]), t(x["m"]), t(x["cbf"]), t(x["bias"]),
            t(np.ascontiguousarray(x["w1"].T)), t(x["b1"]),
            t(np.ascontiguousarray(x["w2"].T)), t(x["b2"]), torch.from_numpy(x["idx"]),
            t(x["mask"]))


def _groups(x) -> Groups:
    perm, poff = build_perm_np(x["idx"], x["valid"], x["m"].shape[0], x["idx"].shape[0])
    return Groups(torch.from_numpy(poff), torch.from_numpy(perm), x["valid"])


def _jax_fused(j):
    p = {"mlp_sbf": [{"w": j["w1"], "b": j["b1"]}, {"w": j["w2"], "b": j["b2"]}]}
    return _fused_sbf_gather(p, j["m"], FoldedSBF(j["proj"], j["cbf"], j["bias"]),
                             j["idx"], j["mask"])


@pytest.mark.parametrize("d", [16, 8])
def test_plain_matches_fused_sbf_gather(d):
    x = _inputs(np.random.default_rng(d), d)
    want = np.asarray(_jax_fused({k: jnp.asarray(v) for k, v in x.items() if k != "valid"}))
    got = sbf_modulate_plain(*_port_args(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(got[-100:] == 0.0)  # masked triplets are exact zeros


def test_wrapper_takes_plain_version_on_cpu():
    args = _port_args(_inputs(np.random.default_rng(3), 16))
    before = sbf_modulate.launches
    np.testing.assert_array_equal(sbf_modulate(*args).numpy(),
                                  sbf_modulate_plain(*args).numpy())
    assert sbf_modulate.launches == before


@pytest.mark.parametrize("d", [16, 8])
def test_forward_matches_the_pallas_probes_function(d):
    """``ref_impl`` of tools/fused_sbf_kernel_probe.py:74 (the function its
    Pallas kernel is held to), re-stated here since the probe runs at import:
    it takes rows gathered beforehand, (T, (ns+1)*d) = concat(proj, m)[idx]."""
    ns = 7
    x = _inputs(np.random.default_rng(40 + d), d)

    def ref_impl(rows, cbf, mask, bias, w1, b1, w2, b2):
        acc = bias + sum(cbf[:, l:l + 1] * rows[:, l * d:(l + 1) * d] for l in range(ns))
        h = acc * jax.nn.sigmoid(acc)
        h = h @ w1 + b1
        h = h * jax.nn.sigmoid(h)
        h = h @ w2 + b2
        h = h * jax.nn.sigmoid(h)
        h = h * mask
        return rows[:, ns * d:(ns + 1) * d] * h

    rows = np.concatenate([x["proj"], x["m"]], axis=1)[x["idx"]]
    want = np.asarray(ref_impl(*(jnp.asarray(a) for a in (
        rows, x["cbf"], x["mask"][:, None], x["bias"], x["w1"], x["b1"], x["w2"], x["b2"]))))
    got = sbf_modulate(*_port_args(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [16, 8])
def test_gradients_match_jax_grad_of_fused_sbf_gather(d):
    x = _inputs(np.random.default_rng(100 + d), d)
    j = {k: jnp.asarray(v) for k, v in x.items() if k != "valid"}

    def loss(proj, m, bias, w1, b1, w2, b2):
        out = _jax_fused(dict(j, proj=proj, m=m, bias=bias, w1=w1, b1=b1, w2=w2, b2=b2))
        return jnp.sum(out * j["cot"])

    want = jax.grad(loss, argnums=tuple(range(7)))(*(j[k] for k in GRAD_NAMES))
    args = list(_port_args(x))
    for i in (0, 1, 3, 4, 5, 6, 7):
        args[i].requires_grad_()
    out = sbf_modulate(*args, groups=_groups(x))
    (out * torch.from_numpy(x["cot"])).sum().backward()
    got = dict(zip(GRAD_NAMES, (args[i].grad.numpy() for i in (0, 1, 3, 4, 5, 6, 7))))
    for name, w in zip(GRAD_NAMES, want):
        w = np.asarray(w).T if name in ("w1", "w2") else np.asarray(w)
        err = np.abs(got[name] - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-7, f"{name}: {err:.3g}"
    assert args[2].grad is None and args[9].grad is None  # cbf, mask: geometry


@pytest.mark.parametrize("ns,d", KERNEL_SHAPES)
def test_plain_version_gradcheck(ns, d):
    x = _inputs(np.random.default_rng(5), d, ns=ns, edges=4, triplets=9, padded=2)
    args = list(_port_args(x, torch.float64))
    for i in (0, 1, 3, 4, 5, 6, 7):
        args[i].requires_grad_()
    groups = _groups(x)
    fn = lambda *a: sbf_modulate(a[0], a[1], args[2], *a[2:], args[8], args[9],  # noqa: E731
                                 groups=groups)
    assert torch.autograd.gradcheck(fn, tuple(args[i] for i in (0, 1, 3, 4, 5, 6, 7)))


def test_under_grad_needs_the_groups_of_idx():
    x = _inputs(np.random.default_rng(6), 16, edges=10, triplets=40, padded=4)
    args = list(_port_args(x))
    args[5].requires_grad_()  # one weight is enough
    with pytest.raises(ValueError, match="Groups"):
        sbf_modulate(*args)
    good = _groups(x)
    with pytest.raises(ValueError, match="permuted CSR"):  # sorted offsets alone
        sbf_modulate(*args, groups=Groups(good.off, None, x["valid"]))
    with pytest.raises(ValueError, match="permuted CSR"):  # the host's row count
        sbf_modulate(*args, groups=Groups(good.off, good.perm, None))
    with pytest.raises(ValueError, match="permuted CSR"):  # another table's CSR
        sbf_modulate(*args, groups=Groups(good.off[:-1], good.perm, x["valid"]))
    assert sbf_modulate(*args, groups=good).requires_grad
    with torch.no_grad():
        assert not sbf_modulate(*args).requires_grad


@pytest.mark.parametrize("which", [2, 9], ids=["cbf", "mask"])
def test_geometry_takes_no_gradient(which):
    x = _inputs(np.random.default_rng(7), 8, edges=10, triplets=40, padded=4)
    args = list(_port_args(x))
    args[which].requires_grad_()
    with pytest.raises(ValueError, match="geometry"):
        sbf_modulate(*args, groups=_groups(x))


def test_backward_wrapper_refuses_cpu_tensors():
    """The backward kernel's wrapper never runs a plain version: on CPU
    tensors it raises (autograd of the plain forward is the CPU backward)."""
    x = _inputs(np.random.default_rng(8), 16, edges=10, triplets=40, padded=4)
    before = sbf_modulate_backward.launches
    with pytest.raises(ValueError, match="cuda|CUDA|tensor on"):
        sbf_modulate_backward(*_port_args(x), _groups(x), torch.from_numpy(x["cot"]))
    assert sbf_modulate_backward.launches == before
