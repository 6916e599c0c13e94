"""The local layer's tail with the el_dst sum gated in kernel A, and kernel
A's fused backward routes, on CPU tensors (the port's plain versions)
against the JAX package on the same numpy inputs:

* ``LocalMP._tail`` (the rbf gate as kernel A's modulation of the el_dst
  sum, the ``el_mask`` product taken by the CSR's valid count) against
  ``_local_tail`` (``pamnet_tpu/models/layers.py:364-381``), and the whole
  ``LocalMP`` against ``local_mp`` on padded QM9 and RNA batches, folded and
  unfolded: outputs, and the gradients of every parameter (``lin_rbf_out``
  among them), of the message ``m`` and of ``x``;
* the batch invariant the gate rests on: ``el_mask`` is 1 on exactly the
  rows ``[0, valid["el"])`` that the el_dst CSR covers;
* the fused role swap (``triplet_aggregate_grad_ab``) against ``jax.grad``
  of ``fused_triplet_aggregate`` on a padded QM9 batch's triplet arrays,
  and against the role swap and ``gather_product`` it replaces;
* ``gated_sum_backward``'s zero rows past the valid count and the routes
  that keep multiplying before the sum (plain, argsort).

Tolerances: outputs rtol/atol 1e-5 (the same f32 operations, summed in
another order); each gradient within 1e-4 * max|g_jax| + 1e-6; where the
port's route should give another route's bits, equality.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pamnet_tpu.models import layers as jlayers
from pamnet_tpu.ops.pallas_triplet import fused_triplet_aggregate
from pamnet_tpu_torch.models import layers
from pamnet_tpu_torch.models.layers import FoldedSBF, LocalMP
from pamnet_tpu_torch.ops import triplet
from pamnet_tpu_torch.ops.triplet import (gated_sum_backward, gather_product_plain,
                                          triplet_aggregate_grad_a_plain,
                                          triplet_aggregate_grad_ab)
from pamnet_tpu_torch.weights import from_jax_params
from test_torch_walk import _batch, _scoring_batches

NS = 7
PREFIX = "local_layer.0."


def _close(got: torch.Tensor, want, name: str) -> None:
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    bound = 1e-4 * float(np.abs(want).max()) + 1e-6
    assert err <= bound, f"{name}: max|d| {err:.3g} > {bound:.3g}"


@functools.lru_cache(maxsize=None)
def _layer_params(dim: int, seed: int):
    """JAX ``init_local_mp`` parameters and the port's ``LocalMP`` holding
    the same values."""
    p = jlayers.init_local_mp(jax.random.PRNGKey(seed), dim)
    state = {k[len(PREFIX):]: v for k, v in from_jax_params({"local_layers": [p]}).items()}
    return p, state


def _port_layer(dim: int, seed: int) -> LocalMP:
    layer = LocalMP(dim)
    layer.load_state_dict(_layer_params(dim, seed)[1], strict=True)
    return layer


def _inputs(gb, dim: int, folded: bool, seed: int) -> dict:
    """Numpy inputs of a local layer on batch ``gb``: node states, the
    edges' rbf rows, the triplet streams' sbf rows (or folded tables), the
    message of the tail and cotangents of the three outputs."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    r = lambda *s: rng.standard_normal(s).astype(f32)  # noqa: E731
    n, el = gb.z.shape[0], gb.el_src.shape[0]
    x = dict(x=r(n, dim), res_x=r(n, dim), rbf=r(el, dim), m=r(el, dim),
             cot_x=r(n, dim), cot_out=r(n, 1), cot_att=r(n, 1))
    if folded:
        for kind in ("t2", "t1"):
            x[kind] = dict(proj=r(el, NS * dim) / 3, cbf=getattr(gb, "cbf" + kind[1]).numpy(),
                           bias=r(dim) / 3)
    else:
        x["t2"], x["t1"] = r(gb.t2_ji.shape[0], dim), r(gb.t1_ji.shape[0], dim)
    return x


def _jax_loss(outs, x):
    return (jnp.sum(outs[0] * x["cot_x"]) + jnp.sum(outs[1] * x["cot_out"])
            + jnp.sum(outs[2] * x["cot_att"]))


def _port_loss(outs, x):
    return sum((o * torch.from_numpy(x[k])).sum()
               for o, k in zip(outs, ("cot_x", "cot_out", "cot_att")))


def _assert_param_grads(layer: LocalMP, jax_grads, names=None):
    want = {k[len(PREFIX):]: v
            for k, v in from_jax_params({"local_layers": [jax_grads]}).items()}
    got = {n: p.grad for n, p in layer.named_parameters()}
    assert set(want) == set(got)
    for name in names or sorted(want):
        g = got[name] if got[name] is not None else torch.zeros_like(want[name])
        _close(g, want[name].numpy(), name)


@pytest.mark.parametrize("kind", ["qm9", "rna"])
def test_el_mask_is_the_valid_prefix_of_the_el_dst_csr(kind):
    """The invariant the gated sum takes the ``el_mask`` product by: on
    every collated batch (QM9 and RNA training batches, a scoring batch at
    ladder pads) ``el_mask`` is 1 on exactly the rows the el_dst CSR sums."""
    batches = [_batch(kind)] + (list(_scoring_batches().values()) if kind == "rna" else [])
    for gb in batches:
        pads_el, valid = gb.el_dst.shape[0], gb.valid["el"]
        assert torch.equal(gb.el_mask, (torch.arange(pads_el) < valid).float())
        assert gb.el_dst_off is not None and int(gb.el_dst_off[-1]) == valid < pads_el


@pytest.mark.parametrize("kind", ["qm9", "rna"])
def test_tail_matches_jax_local_tail(kind):
    """The gated el_dst sum in the tail against ``_local_tail``: outputs and
    the gradients of ``lin_rbf_out``, ``m``, ``rbf``, ``x`` and every other
    parameter of the tail."""
    gb, dim = _batch(kind), 16
    p, _ = _layer_params(dim, 3)
    x = _inputs(gb, dim, False, 11)
    i, el_mask, n = gb.el_dst.numpy(), gb.el_mask.numpy(), gb.z.shape[0]

    def jfn(p_, x_, m_, rbf_):
        return _jax_loss(jlayers._local_tail(p_, x_, jnp.asarray(x["res_x"]), m_, rbf_,
                                             jnp.asarray(i), jnp.asarray(el_mask), n, None), x)

    want = jax.grad(jfn, argnums=(0, 1, 2, 3))(
        p, *(jnp.asarray(x[k]) for k in ("x", "m", "rbf")))
    want_out = jlayers._local_tail(p, *(jnp.asarray(x[k]) for k in ("x", "res_x", "m", "rbf")),
                                   jnp.asarray(i), jnp.asarray(el_mask), n, None)
    layer = _port_layer(dim, 3)
    leaves = {k: torch.from_numpy(x[k]).requires_grad_() for k in ("x", "m", "rbf")}
    outs = layer._tail(leaves["x"], torch.from_numpy(x["res_x"]), leaves["m"], leaves["rbf"],
                       gb, False)
    for o, w in zip(outs, want_out):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    _port_loss(outs, x).backward()
    for k, w in zip(("x", "m", "rbf"), want[1:]):
        _close(leaves[k].grad, w, k)
    # Rows past the valid count enter no sum and take no gradient.
    assert not leaves["m"].grad[gb.valid["el"]:].any()
    _assert_param_grads(layer, want[0], ["lin_rbf_out.weight", "mlp_x2.0.0.weight",
                                         "mlp_out.0.0.weight", "W"])


@pytest.mark.parametrize("kind,folded", [("rna", True), ("rna", False), ("qm9", False)],
                         ids=["rna-folded", "rna-unfolded", "qm9-unfolded"])
def test_local_mp_matches_jax_local_mp(kind, folded):
    """The whole local layer, its tail gated, against ``local_mp``: outputs,
    every parameter's gradient and ``x``'s."""
    gb, dim = _batch(kind), (16 if folded else 8)
    p, _ = _layer_params(dim, 5)
    x = _inputs(gb, dim, folded, 13)
    a = lambda key: jnp.asarray(getattr(gb, key).numpy())  # noqa: E731
    idx = tuple(a(k) for k in ("t2_kj", "t2_ji", "t2_mask", "t1_jj", "t1_ji", "t1_mask",
                               "el_src", "el_dst", "el_mask"))
    n = gb.z.shape[0]

    def jsbf(kind_):
        v = x[kind_]
        if folded:
            return jlayers.FoldedSBF(*(jnp.asarray(v[k]) for k in ("proj", "cbf", "bias")))
        return jnp.asarray(v)

    def jfn(p_, x_, rbf_):
        return jlayers.local_mp(p_, x_, rbf_, jsbf("t2"), jsbf("t1"), *idx, n)

    want_out = jfn(p, jnp.asarray(x["x"]), jnp.asarray(x["rbf"]))
    want = jax.grad(lambda *args: _jax_loss(jfn(*args), x), argnums=(0, 1, 2))(
        p, jnp.asarray(x["x"]), jnp.asarray(x["rbf"]))

    def tsbf(kind_):
        v = x[kind_]
        if folded:
            return FoldedSBF(*(torch.from_numpy(np.asarray(v[k])) for k in ("proj", "cbf",
                                                                            "bias")))
        return torch.from_numpy(v)

    layer = _port_layer(dim, 5)
    leaves = {k: torch.from_numpy(x[k]).requires_grad_() for k in ("x", "rbf")}
    outs = layer(leaves["x"], leaves["rbf"], tsbf("t2"), tsbf("t1"), gb)
    for o, w in zip(outs, want_out):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    _port_loss(outs, x).backward()
    for k, w in zip(("x", "rbf"), want[1:]):
        _close(leaves[k].grad, w, k)
    assert float(np.abs(np.asarray(want[0]["lin_rbf_out"]["w"])).max()) > 0.0
    _assert_param_grads(layer, want[0])


@pytest.mark.parametrize("kind", ["t2", "t1"])
def test_fused_role_swap_matches_jax_grad(kind):
    """``triplet_aggregate_grad_ab`` on a padded QM9 batch's triplet arrays
    (b zero on padded rows, as the model masks it) against ``jax.grad`` of
    ``fused_triplet_aggregate``: d_a, and d_b on the valid rows (JAX gives
    the padded rows a d_b that the model's mask then zeroes; the port gives
    them zeros); and bit for bit the role swap and ``gather_product`` it
    replaces."""
    gb, d = _batch("qm9"), 16
    key = "t2_kj" if kind == "t2" else "t1_jj"
    idx, seg, valid = getattr(gb, key), getattr(gb, kind + "_ji"), gb.valid[kind]
    by_idx = gb.groups(key)
    seg_by_idx = gb.perms["t2_ji_by_kj" if kind == "t2" else "t1_ji_by_jj"]
    e, t = gb.el_src.shape[0], idx.shape[0]
    assert by_idx.perm is not None and valid < t
    rng = np.random.default_rng(21 + len(kind))
    a = rng.standard_normal((e, d)).astype(np.float32)
    b = rng.standard_normal((t, d)).astype(np.float32)
    b[valid:] = 0.0
    cot = rng.standard_normal((e, d)).astype(np.float32)

    def loss(a_, b_):
        out = fused_triplet_aggregate(a_, b_, jnp.asarray(idx.numpy()),
                                      jnp.asarray(seg.numpy()), e)
        return jnp.sum(out * cot)

    want_a, want_b = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb, g = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(cot)
    d_a, d_b = triplet_aggregate_grad_ab(g, by_idx, seg_by_idx, tb, ta)
    np.testing.assert_allclose(d_a.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_b.numpy()[:valid], np.asarray(want_b)[:valid], rtol=1e-5,
                               atol=1e-5)
    assert not d_b[valid:].any()
    assert torch.equal(d_a, triplet_aggregate_grad_a_plain(g, by_idx, seg_by_idx, tb))
    assert torch.equal(d_b, gather_product_plain(ta, idx, g, seg, valid))


def test_gated_sum_backward_zeroes_the_padded_rows():
    """Both gradients of the modulated sum without a gather: the formula on
    the valid rows, zeros after."""
    rng = np.random.default_rng(4)
    rows, valid, num_out, d = 50, 41, 9, 8
    a, b = (torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
            for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((num_out, d)).astype(np.float32))
    seg = torch.from_numpy(np.sort(rng.integers(0, num_out, rows)).astype(np.int32))
    d_a, d_b = gated_sum_backward(a, b, g, seg, valid)
    gs = g[seg.long()]
    assert torch.equal(d_a[:valid], gs[:valid] * b[:valid])
    assert torch.equal(d_b[:valid], a[:valid] * gs[:valid])
    assert not d_a[valid:].any() and not d_b[valid:].any()


def test_plain_and_argsort_routes_multiply_then_sum(monkeypatch):
    """Only the kernel route on a sorted el_dst CSR passes the gate as b;
    ``plain=True`` and a batch without the CSR (the argsort route) keep the
    reference's multiply-then-sum, and all three give the same sums."""
    gb, dim = _batch("rna"), 16
    x = _inputs(gb, dim, False, 17)
    calls = []
    agg = layers.aggregate
    monkeypatch.setattr(layers, "aggregate",
                        lambda *a, **k: calls.append((a[1] is not None, k.get("b") is not None,
                                                      k.get("plain", False)))
                        or agg(*a, **k))
    layer = _port_layer(dim, 7)
    args = [torch.from_numpy(x[k]) for k in ("x", "res_x", "m", "rbf")]
    unsorted = dataclasses.replace(gb, el_dst_off=None)
    with torch.no_grad():
        outs = [layer._tail(*args, gb, False), layer._tail(*args, gb, True),
                layer._tail(*args, unsorted, False)]
    assert calls == [(True, True, False), (True, False, True), (False, False, False)]
    for other in outs[1:]:
        for o, w in zip(other, outs[0]):
            torch.testing.assert_close(o, w, rtol=1e-5, atol=1e-5)


def test_kernel_a_backward_routes(monkeypatch):
    """Which backward a gathered, modulated sum takes: both gradients the
    fused role swap, ``a`` alone the role swap, ``b`` alone
    ``gather_product``; without a gather the gated backward."""
    gb, d = _batch("qm9"), 8
    rng = np.random.default_rng(8)
    e, t = gb.el_src.shape[0], gb.t2_kj.shape[0]
    a0 = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32))
    b0 = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)) * gb.t2_mask[:, None]
    calls = []
    for name in ("triplet_aggregate_grad_ab", "triplet_aggregate_grad_a", "gather_product",
                 "gated_sum_backward"):
        fn = getattr(triplet, name)
        monkeypatch.setattr(triplet, name,
                            lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    for wa, wb in ((True, True), (True, False), (False, True)):
        a, b = a0.clone().requires_grad_(wa), b0.clone().requires_grad_(wb)
        triplet.triplet_aggregate(a, gb.t2_ji_off, gb.t2_kj, b, total=gb.valid["t2"],
                                  grad=gb.triplet_grad("t2")).sum().backward()
    m = torch.randn(e, d, requires_grad=True)
    triplet.triplet_aggregate(m, gb.el_dst_off, b=torch.randn(e, d), total=gb.valid["el"],
                              grad=triplet.AggregateGrad(gb.el_dst)).sum().backward()
    assert calls == ["triplet_aggregate_grad_ab", "triplet_aggregate_grad_a", "gather_product",
                     "gated_sum_backward"]
