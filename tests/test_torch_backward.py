"""The port's backward Functions (pamnet_tpu_torch/ops/triplet.py, gather.py)
on CPU tensors, where forward and backward run their plain versions, against
``jax.grad`` of the JAX package's functions on the same numpy inputs.

* Kernel A (``triplet_aggregate``) against the custom VJP of
  ``fused_triplet_aggregate``, on its XLA path and on the Pallas kernel in
  interpret mode (T % 256 == 0, D = 128): atol 1e-5 (f32 sums in another
  order).  Padded rows: the port sums the valid rows only, so its d_b is 0
  there, while JAX sums every row (b = 0 on padded rows) and gives padded
  rows a d_b the model's mask then zeroes; d_b is compared on valid rows.
* The edge message and the row gather against ``jax.grad`` of
  ``silu(xi[i] + xj[j] + base) * gate * mask`` and of ``jnp.take``:
  atol/rtol 1e-5.
* ``torch.autograd.gradcheck`` in float64 on every Function at tiny sizes.
* No Function drops a gradient without a word.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pamnet_tpu.ops.pallas_triplet import _BT, fused_triplet_aggregate
from pamnet_tpu_torch.data.batch import build_perm_np
from pamnet_tpu_torch.ops.gather import edge_message, row_gather
from pamnet_tpu_torch.ops.sbf_modulate import sbf_modulate
from pamnet_tpu_torch.ops.triplet import (AggregateGrad, Groups, gather_product,
                                          group_sum, triplet_aggregate,
                                          triplet_aggregate_grad_a)

TOL = dict(rtol=1e-5, atol=1e-5)


def _groups(ids: np.ndarray, valid: int, num_groups: int) -> Groups:
    perm, poff = build_perm_np(ids, valid, num_groups, ids.shape[0])
    return Groups(torch.from_numpy(poff), torch.from_numpy(perm), valid)


def _triplet_case(rng, e, t, d, gather):
    """Rows sorted by segment over the first ``valid`` rows; padded rows
    point at 0 and carry b = 0, as in batches."""
    valid = t - t // 4
    a = rng.standard_normal((e if gather else t, d)).astype(np.float32)
    b = rng.standard_normal((t, d)).astype(np.float32)
    b[valid:] = 0.0
    idx = np.zeros(t, np.int32)
    idx[:valid] = rng.integers(0, e, valid)
    seg = np.zeros(t, np.int32)
    seg[:valid] = np.sort(rng.integers(0, e, valid))
    off = np.searchsorted(seg[:valid], np.arange(e + 1)).astype(np.int32)
    cot = rng.standard_normal((e, d)).astype(np.float32)
    return valid, a, b, idx, seg, off, cot


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("gather,modulate", [(True, True), (True, False), (False, False)])
def test_triplet_aggregate_grad_matches_custom_vjp(gather, modulate, use_pallas):
    e, t, d = 128, _BT, 128
    rng = np.random.default_rng(17 + 2 * gather + modulate)
    valid, a, b, idx, seg, off, cot = _triplet_case(rng, e, t, d, gather)
    jidx = idx if gather else np.arange(t, dtype=np.int32)
    ones = np.repeat((np.arange(t) < valid)[:, None], d, axis=1).astype(np.float32)
    jb = b if modulate else ones
    # The Pallas kernel holds `a` as one (num_out, D) block, so the no-gather
    # modes run with t output rows; rows >= e get no cotangent.
    num_out = e if gather else t

    def loss(a_, b_):
        out = fused_triplet_aggregate(a_, b_, jnp.asarray(jidx), jnp.asarray(seg),
                                      num_out, use_pallas, use_pallas)
        return jnp.sum(out[:e] * cot)

    want_a, want_b = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(jb))

    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_() if modulate else None
    tidx = torch.from_numpy(idx) if gather else None
    tseg = torch.from_numpy(seg)
    grad = AggregateGrad(tseg)
    if gather:
        by_idx = _groups(idx, valid, e)
        grad = AggregateGrad(tseg, by_idx, tseg[by_idx.perm.long()])
    out = triplet_aggregate(ta, torch.from_numpy(off), tidx, tb, total=valid, grad=grad)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_a), **TOL)
    if modulate:
        np.testing.assert_allclose(tb.grad.numpy()[:valid], np.asarray(want_b)[:valid], **TOL)
        assert np.all(tb.grad.numpy()[valid:] == 0.0)


def _message_inputs(rng, nodes=40, edges=300, d=16, valid=None, sorted_i=False):
    f32 = np.float32
    valid = edges if valid is None else valid
    i = rng.integers(0, nodes, edges).astype(np.int32)
    if sorted_i:
        i[:valid] = np.sort(i[:valid])
    j = rng.integers(0, nodes, edges).astype(np.int32)
    i[valid:] = 0
    j[valid:] = 0
    return dict(xi=rng.standard_normal((nodes, d)).astype(f32),
                xj=rng.standard_normal((nodes, d)).astype(f32),
                base=rng.standard_normal((edges, d)).astype(f32),
                gate=rng.standard_normal((edges, d)).astype(f32),
                mask=(np.arange(edges) < valid).astype(f32),
                cot=rng.standard_normal((edges, d)).astype(f32),
                i=i, j=j, valid=valid, nodes=nodes)


@pytest.mark.parametrize("gated,masked,sorted_i", [
    (False, False, True),   # local m_ji: rows sorted by i = el_dst
    (True, False, True),    # local m_kj
    (True, True, True),     # global (source_to_target: sorted by dst)
    (True, True, False),    # both endpoints through a permutation
])
def test_edge_message_grad_matches_jax(gated, masked, sorted_i):
    rng = np.random.default_rng(3 + 4 * gated + 2 * masked + sorted_i)
    # Unmasked messages need a zero cotangent on padded rows (the model's
    # masks give it); here every row is valid for them.
    x = _message_inputs(rng, valid=270 if masked else None, sorted_i=sorted_i)

    def loss(xi, xj, base, gate):
        m = jax.nn.silu(xi[x["i"]] + xj[x["j"]] + base)
        if gated:
            m = m * gate
        if masked:
            m = m * x["mask"][:, None]
        return jnp.sum(m * x["cot"])

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x[k]) for k in ("xi", "xj", "base", "gate")))
    t = {k: torch.from_numpy(x[k]).requires_grad_() for k in ("xi", "xj", "base", "gate")}
    valid, nodes = x["valid"], x["nodes"]
    i_groups = (Groups(torch.from_numpy(np.searchsorted(
        x["i"][:valid], np.arange(nodes + 1)).astype(np.int32)), None, valid)
        if sorted_i else _groups(x["i"], valid, nodes))
    out = edge_message(t["xi"], t["xj"], torch.from_numpy(x["i"]), torch.from_numpy(x["j"]),
                       t["base"], t["gate"] if gated else None,
                       torch.from_numpy(x["mask"]) if masked else None,
                       i_groups=i_groups, j_groups=_groups(x["j"], valid, nodes))
    (out * torch.from_numpy(x["cot"])).sum().backward()
    for k, w in zip(("xi", "xj", "base", "gate"), want):
        if k == "gate" and not gated:
            assert t[k].grad is None
            continue
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(w), err_msg=k, **TOL)


@pytest.mark.parametrize("rows,cols,n_idx", [(5, 16, 300), (256, 128, 512), (50, 42, 300)])
def test_row_gather_grad_matches_take(rows, cols, n_idx):
    """The embedding's backward (5 atom types), the Pallas probe's shape and
    an unaligned width."""
    rng = np.random.default_rng(rows)
    src = rng.standard_normal((rows, cols)).astype(np.float32)
    idx = rng.integers(0, rows, n_idx).astype(np.int32)
    cot = rng.standard_normal((n_idx, cols)).astype(np.float32)
    want = jax.grad(lambda s: jnp.sum(jnp.take(s, jnp.asarray(idx), axis=0) * cot))(
        jnp.asarray(src))
    ts = torch.from_numpy(src).requires_grad_()
    out = row_gather(ts, torch.from_numpy(idx), _groups(idx, n_idx, rows))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want), **TOL)


def test_backward_pieces_match_their_formulas():
    """The role swap, the group sum and the gather product on their own."""
    rng = np.random.default_rng(9)
    e, t, d = 20, 90, 8
    valid, a, b, idx, seg, off, _ = _triplet_case(rng, e, t, d, True)
    g = rng.standard_normal((e, d)).astype(np.float32)
    by_idx = _groups(idx, valid, e)
    seg_t = torch.from_numpy(seg)
    got = triplet_aggregate_grad_a(torch.from_numpy(g), by_idx,
                                   seg_t[by_idx.perm.long()], torch.from_numpy(b))
    want = np.zeros((e, d), np.float32)
    np.add.at(want, idx[:valid], g[seg[:valid]] * b[:valid])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want = np.zeros((e, d), np.float32)
    np.add.at(want, idx[:valid], b[:valid])
    np.testing.assert_allclose(group_sum(torch.from_numpy(b), by_idx).numpy(), want, **TOL)
    got = gather_product(torch.from_numpy(a), torch.from_numpy(idx), torch.from_numpy(g),
                         seg_t, valid).numpy()
    np.testing.assert_allclose(got[:valid], a[idx[:valid]] * g[seg[:valid]], **TOL)
    assert np.all(got[valid:] == 0.0)


def _f64(x):
    return torch.from_numpy(np.asarray(x, np.float64)).requires_grad_()


@pytest.mark.parametrize("gather,modulate", [(True, True), (True, False), (False, False)])
def test_triplet_aggregate_gradcheck(gather, modulate):
    rng = np.random.default_rng(5)
    e, t, d = 6, 20, 3
    valid, a, b, idx, seg, off, _ = _triplet_case(rng, e, t, d, gather)
    seg_t = torch.from_numpy(seg)
    grad = AggregateGrad(seg_t)
    if gather:
        by_idx = _groups(idx, valid, e)
        grad = AggregateGrad(seg_t, by_idx, seg_t[by_idx.perm.long()])
    off_t, idx_t = torch.from_numpy(off), torch.from_numpy(idx) if gather else None
    fn = lambda a_, b_: triplet_aggregate(a_, off_t, idx_t, b_, valid, grad)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (_f64(a), _f64(b) if modulate else None))


def test_row_gather_and_edge_message_gradcheck():
    rng = np.random.default_rng(6)
    x = _message_inputs(rng, nodes=7, edges=25, d=3)
    ig, jg = _groups(x["i"], 25, 7), _groups(x["j"], 25, 7)
    i, j = torch.from_numpy(x["i"]), torch.from_numpy(x["j"])
    assert torch.autograd.gradcheck(lambda s: row_gather(s, i, ig), (_f64(x["xi"]),))
    mask = torch.from_numpy(x["mask"]).double()
    args = tuple(_f64(x[k]) for k in ("xi", "xj", "base", "gate"))
    assert torch.autograd.gradcheck(
        lambda xi, xj, base, gate: edge_message(xi, xj, i, j, base, gate, mask, ig, jg),
        args)
    assert torch.autograd.gradcheck(
        lambda xi, xj, base: edge_message(xi, xj, i, j, base, None, None, ig, jg), args[:3])


def test_no_function_drops_a_gradient():
    """A wrapper whose input requires grad but lacks what its backward reads
    raises; without grad mode it runs."""
    a = torch.randn(8, 4, requires_grad=True)
    off = torch.tensor([0, 3, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="AggregateGrad"):
        triplet_aggregate(a, off)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="Groups"):
        row_gather(a, idx)
    with pytest.raises(ValueError, match="Groups"):
        edge_message(a, a.detach(), idx, idx, torch.randn(8, 4))
    with pytest.raises(ValueError, match="without a gather"):
        triplet_aggregate(a, off, b=torch.randn(8, 4), grad=AggregateGrad(idx))
    with pytest.raises(ValueError, match="total"):  # the backward reads no offset back
        triplet_aggregate(a, off, grad=AggregateGrad(idx))
    with torch.no_grad():
        triplet_aggregate(a, off)
        row_gather(a, idx)
        edge_message(a, a, idx, idx, torch.randn(8, 4))
    out = row_gather(a.detach(), idx)  # a table without grad needs no CSR
    assert not out.requires_grad


def test_sbf_modulate_raises_under_grad():
    d, ns, t = 16, 7, 5
    args = [torch.zeros(s) for s in [(4, ns * d), (4, d), (t, ns), (d,), (d, d), (d,),
                                     (d, d), (d,)]]
    args += [torch.zeros(t, dtype=torch.int32), torch.ones(t)]
    args[1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        sbf_modulate(*args)
    with torch.inference_mode():
        assert sbf_modulate(*args).shape == (t, d)


def test_every_kernel_wrapper_counts_its_launches():
    """Each wrapper carries the launch count that a run on the card reads;
    the CPU path launches nothing."""
    from pamnet_tpu_torch.ops import gather as gather_ops
    from pamnet_tpu_torch.ops import triplet as triplet_ops

    wrappers = [triplet_ops.triplet_aggregate, triplet_ops.triplet_aggregate_grad_a,
                triplet_ops.group_sum, triplet_ops.gather_product, gather_ops.row_gather,
                gather_ops.edge_message, gather_ops.edge_message_backward, sbf_modulate]
    before = [fn.launches for fn in wrappers]
    assert all(isinstance(n, int) for n in before)
    test_backward_pieces_match_their_formulas()
    test_edge_message_grad_matches_jax(True, True, False)
    assert [fn.launches for fn in wrappers] == before
