"""The port's CUDA kernels against their plain versions on the card, at small
shapes, including ragged and empty groups.  Skipped without a CUDA card;
run on the card with ``python -m pytest tests/test_torch_cuda.py``."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import numpy as np
import pytest
import torch

from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.batch import build_perm_np
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset, synthetic_rna_dataset
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.ops import gather as gather_ops
from pamnet_tpu_torch.ops import triplet as triplet_ops
from pamnet_tpu_torch.ops.gather import (edge_message, edge_message_backward,
                                         edge_message_backward_plain, edge_message_plain,
                                         edge_message_sum, row_gather, row_gather_plain)
from pamnet_tpu_torch.ops.sbf_modulate import (sbf_modulate, sbf_modulate_backward,
                                               sbf_modulate_plain)
from pamnet_tpu_torch.ops.triplet import (AggregateGrad, Groups, gated_sum_backward,
                                          gated_sum_backward_plain, gather_product,
                                          gather_product_plain, group_sum, group_sum_plain,
                                          group_sum_split, triplet_aggregate,
                                          triplet_aggregate_grad_a, group_sum_route,
                                          triplet_aggregate_grad_a_plain,
                                          triplet_aggregate_grad_ab,
                                          triplet_aggregate_grad_ab_plain,
                                          triplet_aggregate_plain, walk_shape)
from pamnet_tpu_torch.train.loop import batch_loss

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("gather,modulate", [(True, True), (True, False),
                                             (False, True), (False, False)])
@pytest.mark.parametrize("d", [16, 128, 4])
def test_triplet_aggregate_kernel(cuda, gather, modulate, d):
    g = torch.Generator(device=cuda).manual_seed(d)
    num_out, rows = 97, 1000
    valid = rows - 37
    # Ragged groups, some empty, and a padded tail past off[-1].
    seg = torch.sort(torch.randint(0, num_out, (valid,), device=cuda, generator=g))[0]
    off = torch.searchsorted(seg, torch.arange(num_out + 1, device=cuda)).to(torch.int32)
    a = torch.randn(num_out if gather else rows, d, device=cuda, generator=g)
    idx = (torch.randint(0, a.shape[0], (rows,), device=cuda, generator=g).to(torch.int32)
           if gather else None)
    b = torch.randn(rows, d, device=cuda, generator=g) if modulate else None
    before = triplet_aggregate.launches
    got = triplet_aggregate(a, off, idx, b)
    torch.cuda.synchronize()
    assert triplet_aggregate.launches == before + 1
    torch.testing.assert_close(got, triplet_aggregate_plain(a, off, idx, b),
                               rtol=1e-5, atol=1e-5)
    # Fixed per-row sum order: bitwise repeatable.
    assert torch.equal(got, triplet_aggregate(a, off, idx, b))


def test_triplet_aggregate_rejects_bad_input(cuda):
    a = torch.randn(8, 6, device=cuda)
    off = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="D % 4"):
        triplet_aggregate(a, off)
    with pytest.raises(ValueError, match="int32"):
        triplet_aggregate(torch.randn(8, 8, device=cuda), off.long())
    # A contiguous view at a 4-byte offset would misalign the 16-byte loads.
    with pytest.raises(ValueError, match="misaligned"):
        triplet_aggregate(torch.randn(65, device=cuda)[1:].view(8, 8), off)
    # off[-1], known on the host, must fit the rows the kernel reads.
    b = torch.randn(8, 8, device=cuda)
    with pytest.raises(ValueError, match="off\\[-1\\]"):
        triplet_aggregate(torch.randn(8, 8, device=cuda), off, b=b, total=9)


@pytest.mark.parametrize("d", [16, 8])
def test_sbf_modulate_kernel(cuda, d):
    g = torch.Generator(device=cuda).manual_seed(d)
    ns, edges, t = 7, 300, 2049
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    args = (r(edges, ns * d), r(edges, d), r(t, ns), r(d), r(d, d) / d**0.5, r(d),
            r(d, d) / d**0.5, r(d),
            torch.randint(0, edges, (t,), device=cuda, generator=g).to(torch.int32),
            (torch.arange(t, device=cuda) < t - 100).float())
    before = sbf_modulate.launches
    got = sbf_modulate(*args)
    torch.cuda.synchronize()
    assert sbf_modulate.launches == before + 1
    torch.testing.assert_close(got, sbf_modulate_plain(*args), rtol=1e-4, atol=1e-5)
    assert np.all(got[-100:].cpu().numpy() == 0.0)


def test_sbf_modulate_rejects_unbuilt_width(cuda):
    d, ns = 32, 7
    args = [torch.zeros(s, device=cuda) for s in
            [(4, ns * d), (4, d), (2, ns), (d,), (d, d), (d,), (d, d), (d,)]]
    args += [torch.zeros(2, dtype=torch.int32, device=cuda), torch.ones(2, device=cuda)]
    with pytest.raises(ValueError, match="no kernel"):
        sbf_modulate(*args)


@pytest.mark.parametrize("rows,d", [(34304, 16), (1000, 42), (513, 128)])
def test_row_gather_kernel(cuda, rows, d):
    g = torch.Generator(device=cuda).manual_seed(d)
    src = torch.randn(257, d, device=cuda, generator=g)
    idx = torch.randint(0, 257, (rows,), device=cuda, generator=g).to(torch.int32)
    before = row_gather.launches
    got = row_gather(src, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert torch.equal(got, row_gather_plain(src, idx))


@pytest.mark.parametrize("gated,masked", [(False, False), (True, False),
                                          (False, True), (True, True)])
@pytest.mark.parametrize("d", [16, 128])
def test_edge_message_kernel(cuda, gated, masked, d):
    g = torch.Generator(device=cuda).manual_seed(d + 2 * gated + masked)
    nodes, edges = 301, 4099
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    idx = lambda: torch.randint(0, nodes, (edges,), device=cuda,  # noqa: E731
                                generator=g).to(torch.int32)
    args = (r(nodes, d), r(nodes, d), idx(), idx(), r(edges, d),
            r(edges, d) if gated else None,
            (torch.arange(edges, device=cuda) < edges - 50).float() if masked else None)
    before = edge_message.launches
    got = edge_message(*args)
    torch.cuda.synchronize()
    assert edge_message.launches == before + 1
    torch.testing.assert_close(got, edge_message_plain(*args), rtol=1e-5, atol=1e-6)
    if masked:
        assert torch.all(got[-50:] == 0.0)


def _perm_groups(ids, valid, groups, cuda):
    perm, poff = build_perm_np(ids.cpu().numpy(), valid, groups, ids.shape[0])
    return Groups(torch.from_numpy(poff).to(cuda), torch.from_numpy(perm).to(cuda), valid)


@pytest.mark.parametrize("modulate", [True, False])
def test_triplet_aggregate_grad_a_kernel(cuda, modulate):
    """Kernel A's role swap (b read through the permutation), bitwise
    repeatable."""
    g = torch.Generator(device=cuda).manual_seed(11)
    e, t, d, valid = 97, 1000, 128, 963
    idx = torch.randint(0, e, (t,), device=cuda, generator=g).to(torch.int32)
    seg = torch.sort(torch.randint(0, e, (t,), device=cuda, generator=g))[0].to(torch.int32)
    by_idx = _perm_groups(idx, valid, e, cuda)
    seg_by_idx = seg[by_idx.perm.long()].contiguous()
    grad = torch.randn(e, d, device=cuda, generator=g)
    b = torch.randn(t, d, device=cuda, generator=g) if modulate else None
    before = triplet_aggregate_grad_a.launches
    got = triplet_aggregate_grad_a(grad, by_idx, seg_by_idx, b)
    torch.cuda.synchronize()
    assert triplet_aggregate_grad_a.launches == before + 1
    want = triplet_aggregate_grad_a_plain(grad, by_idx, seg_by_idx, b)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, triplet_aggregate_grad_a(grad, by_idx, seg_by_idx, b))


@pytest.mark.parametrize("rows,valid", [(777, 700), (3200, 1934)])
def test_gather_product_kernel(cuda, rows, valid):
    g = torch.Generator(device=cuda).manual_seed(rows)
    d = 128
    x = torch.randn(50, d, device=cuda, generator=g)
    y = torch.randn(60, d, device=cuda, generator=g)
    xi = torch.randint(0, 50, (rows,), device=cuda, generator=g).to(torch.int32)
    yi = torch.randint(0, 60, (rows,), device=cuda, generator=g).to(torch.int32)
    before = gather_product.launches
    got = gather_product(x, xi, y, yi, valid)
    torch.cuda.synchronize()
    assert gather_product.launches == before + 1
    assert torch.equal(got, gather_product_plain(x, xi, y, yi, valid))
    assert torch.all(got[valid:] == 0.0)


@pytest.mark.parametrize("gated,masked", [(False, False), (True, False), (True, True)])
def test_edge_message_backward_kernel(cuda, gated, masked):
    g = torch.Generator(device=cuda).manual_seed(13 + gated + masked)
    nodes, edges, d = 301, 4099, 128
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    idx = lambda: torch.randint(0, nodes, (edges,), device=cuda,  # noqa: E731
                                generator=g).to(torch.int32)
    args = (r(nodes, d), r(nodes, d), idx(), idx(), r(edges, d), r(edges, d) if gated else None,
            (torch.arange(edges, device=cuda) < edges - 50).float() if masked else None,
            r(edges, d))
    before = edge_message_backward.launches
    d_pre, d_gate = edge_message_backward(*args)
    torch.cuda.synchronize()
    assert edge_message_backward.launches == before + 1
    w_pre, w_gate = edge_message_backward_plain(*args)
    torch.testing.assert_close(d_pre, w_pre, rtol=1e-5, atol=1e-6)
    if gated:
        torch.testing.assert_close(d_gate, w_gate, rtol=1e-5, atol=1e-6)
    assert torch.equal(d_pre, edge_message_backward(*args)[0])


@pytest.mark.parametrize("groups,rows,d", [(5, 900, 128), (896, 21888, 128), (40, 300, 16)])
def test_group_sum_kernel(cuda, groups, rows, d):
    """The row gathers' backward: few long groups (the embedding) and many
    short ones; through a permutation and over sorted rows."""
    g = torch.Generator(device=cuda).manual_seed(groups)
    valid = rows - rows // 10
    ids = torch.randint(0, groups, (rows,), device=cuda, generator=g).to(torch.int32)
    x = torch.randn(rows, d, device=cuda, generator=g)
    for grp in (_perm_groups(ids, valid, groups, cuda),
                Groups(torch.searchsorted(torch.sort(ids[:valid])[0], torch.arange(
                    groups + 1, device=cuda, dtype=torch.int32)).to(torch.int32), None, valid)):
        before = group_sum.launches
        got = group_sum(x, grp)
        torch.cuda.synchronize()
        assert group_sum.launches == before + 1
        torch.testing.assert_close(got, group_sum_plain(x, grp), rtol=1e-5, atol=1e-4)
        assert torch.equal(got, group_sum(x, grp))


@pytest.mark.parametrize("longest", ["known", "unknown"])
@pytest.mark.parametrize("sizes,d", [
    ((7557, 5000, 4243), 16),                    # the RNA embedding's backward: 3 long groups
    ((333, 200, 0, 31, 2), 128),                 # QM9's: 5 groups, one empty
    ((20000,), 16),                              # one group holding every row
    ((0, 900, 0) + (3,) * 500 + (0, 1, 70), 16),  # few long groups, many short, empty ones
    ((1500, 40, 2), 12),                         # 3 column lanes
    ((512, 129), 20),                            # the longest group one batch of the lanes
    ((600, 600), 160),                           # ten blocks of 16 columns per group
])
def test_group_sum_split_kernel(cuda, sizes, d, longest):
    """The split group sum against the plain version, through a permutation
    and over sorted rows, with a padded tail; bitwise equal across two
    calls; group_sum routes to it by the longest group.  A known longest
    group of up to 512 rows takes a block per group and 16 columns, a longer
    or unknown one a cluster of 8 blocks."""
    g = torch.Generator(device=cuda).manual_seed(len(sizes) + d)
    valid = sum(sizes)
    rows = valid + 97
    ids = torch.repeat_interleave(torch.arange(len(sizes), device=cuda),
                                  torch.tensor(sizes, device=cuda)).to(torch.int32)
    ids = torch.cat([ids[torch.randperm(valid, device=cuda, generator=g)],
                     torch.zeros(rows - valid, dtype=torch.int32, device=cuda)])
    x = torch.randn(rows, d, device=cuda, generator=g)
    sorted_off = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32,
                              device=cuda)
    for grp in (_perm_groups(ids, valid, len(sizes), cuda),
                Groups(sorted_off, None, valid)):
        grp = grp._replace(longest=max(sizes) if longest == "known" else None)
        want = group_sum_plain(x, grp)
        before = group_sum_split.launches, group_sum.launches
        got = group_sum_split(x, grp)
        torch.cuda.synchronize()
        assert group_sum_split.launches == before[0] + 1
        atol = 1e-4 * max(1.0, max(sizes) / 512)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
        assert torch.equal(got, group_sum_split(x, grp))
        assert torch.equal(got, group_sum(x, grp))
        assert (group_sum_split.launches, group_sum.launches) == (before[0] + 3, before[1] + 1)


@pytest.mark.parametrize("d", [42, 6, 2, 16, 3])
@pytest.mark.parametrize("rows,valid", [(935, 900), (64, 64), (45, 0)])
def test_row_gather_kernel_valid_count(cuda, d, rows, valid):
    """Every width the row gather takes (float4, float2 and float columns),
    with a valid count and a part-filled last warp: exact."""
    g = torch.Generator(device=cuda).manual_seed(d * rows + valid)
    src = torch.randn(301, d, device=cuda, generator=g)
    idx = torch.randint(0, 301, (rows,), device=cuda, generator=g).to(torch.int32)
    idx[valid:] = -7  # past the valid count: never read
    before = row_gather.launches
    got = row_gather(src, idx, valid=valid)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert torch.equal(got, row_gather_plain(src, idx, valid))
    assert torch.all(got[valid:] == 0.0)


def test_row_gather_valid_rows_zero(cuda):
    src = torch.randn(7, 128, device=cuda)
    idx = torch.randint(0, 7, (100,), device=cuda).to(torch.int32)
    got = row_gather(src, idx, valid=60)
    assert torch.equal(got, row_gather_plain(src, idx, 60))
    assert torch.all(got[60:] == 0.0)


def test_training_gradients_kernels_vs_plain(cuda):
    """A QM9 loss's parameter gradients through the backward kernels against
    PyTorch's autograd of the plain versions, per tensor within
    1e-4 * max|g| + 1e-6."""
    mols = synthetic_qm9_dataset(8, seed=2)
    gb = next(iter(GraphLoader(mols, "qm9", 5.0, 5.0, 8, build_perms=True))).to(cuda)
    model = PAMNet(PAMNetConfig(dataset="QM9", dim=32, n_layer=2)).to(cuda)
    grads = []
    for plain in (False, True):
        model.zero_grad()
        batch_loss(model, gb, "l1", plain=plain).backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for name, want in grads[1].items():
        err = float((grads[0][name] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-6, name


def _sbf_case(cuda, d, edges, t, valid, seed, idx=None):
    """Inputs of kernel B with a padded tail past ``valid`` (mask 0, index
    0), a few masked triplets inside it, and the CSR of the index."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    ns = 7
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    if idx is None:
        idx = torch.randint(0, edges, (t,), device=cuda, generator=g).to(torch.int32)
    idx[valid:] = 0
    mask = (torch.arange(t, device=cuda) < valid).float()
    mask[: valid // 7] = 0.0
    args = [r(edges, ns * d), r(edges, d), r(t, ns), r(d), r(d, d) / d**0.5, r(d),
            r(d, d) / d**0.5, r(d), idx, mask]
    return args, _perm_groups(idx, valid, edges, cuda), r(t, d)


def _plain_grads(args, cot):
    leaves = [a.detach().clone().requires_grad_() if i in _SBF_GRAD else a
              for i, a in enumerate(args)]
    (sbf_modulate_plain(*leaves) * cot).sum().backward()
    return [leaves[i].grad for i in _SBF_GRAD]


# proj, m_neighbor, bias, w1, b1, w2, b2 among sbf_modulate's arguments.
_SBF_GRAD = (0, 1, 3, 4, 5, 6, 7)


def _assert_sbf_grads(got, want):
    """Each gradient within 1e-4 * max|g_plain| + 1e-6 (expf against
    torch.sigmoid, f32 sums in another order)."""
    for i, (a, w) in zip(_SBF_GRAD, zip(got, want)):
        assert a.shape == w.shape, i
        err = float((a - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-6, (i, err)


@pytest.mark.parametrize("d", [16, 8])
@pytest.mark.parametrize("edges,t,valid", [(300, 2049, 1949), (700, 513, 512), (40, 256, 256)])
def test_sbf_modulate_backward_kernel(cuda, d, edges, t, valid):
    """Kernel B's backward against autograd of the plain version: many
    triplets per edge, more edges than triplets (empty groups, groups of
    one), masked and padded triplets; bitwise repeatable."""
    args, groups, cot = _sbf_case(cuda, d, edges, t, valid, seed=d + t)
    before = sbf_modulate_backward.launches
    got = sbf_modulate_backward(*args, groups, cot)
    torch.cuda.synchronize()
    assert sbf_modulate_backward.launches == before + 1
    _assert_sbf_grads(got, _plain_grads(args, cot))
    again = sbf_modulate_backward(*args, groups, cot)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    empty = (groups.off[1:] == groups.off[:-1])
    assert torch.all(got[0][empty] == 0.0) and torch.all(got[1][empty] == 0.0)


def test_sbf_modulate_backward_one_triplet_per_edge_and_none(cuda):
    """Edge e holds triplet e alone for e < 50 (groups of one); the other
    edges hold none, and no triplet is valid past 50."""
    t, edges = 128, 90
    idx = torch.arange(t, device=cuda, dtype=torch.int32) % edges
    args, groups, cot = _sbf_case(cuda, 16, edges, t, 50, seed=1, idx=idx)
    got = sbf_modulate_backward(*args, groups, cot)
    _assert_sbf_grads(got, _plain_grads(args, cot))
    assert torch.all(got[0][50:] == 0.0) and torch.all(got[1][50:] == 0.0)


def test_sbf_modulate_function_on_the_card(cuda):
    """The Function end to end: backward through the kernel, one forward and
    one backward launch; it raises without the groups, for geometry that
    requires grad, and for a width that is not built."""
    args, groups, cot = _sbf_case(cuda, 16, 300, 1024, 1000, seed=2)
    leaves = [a.clone().requires_grad_() if i in _SBF_GRAD else a for i, a in enumerate(args)]
    f0, b0 = sbf_modulate.launches, sbf_modulate_backward.launches
    out = sbf_modulate(*leaves, groups=groups)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    assert (sbf_modulate.launches, sbf_modulate_backward.launches) == (f0 + 1, b0 + 1)
    _assert_sbf_grads([leaves[i].grad for i in _SBF_GRAD], _plain_grads(args, cot))
    with pytest.raises(ValueError, match="Groups"):
        sbf_modulate(*leaves)
    with pytest.raises(ValueError, match="geometry"):
        sbf_modulate(*leaves[:2], leaves[2].clone().requires_grad_(), *leaves[3:],
                     groups=groups)
    with torch.no_grad():  # no graph node, no groups needed
        assert not sbf_modulate(*leaves).requires_grad
    d = 32
    wide = [torch.zeros(s, device=cuda) for s in
            [(4, 7 * d), (4, d), (2, 7), (d,), (d, d), (d,), (d, d), (d,)]]
    wide += [torch.zeros(2, dtype=torch.int32, device=cuda), torch.ones(2, device=cuda)]
    with pytest.raises(ValueError, match="no kernel"):
        sbf_modulate_backward(*wide, _perm_groups(wide[8], 2, 4, cuda),
                              torch.zeros(2, d, device=cuda))


def test_rna_training_gradients_kernels_vs_plain(cuda):
    """An RNA SmoothL1 loss's parameter gradients on the folded path, through
    kernel B's backward, against PyTorch's autograd of the plain versions and
    against the unfolded path, per tensor within 1e-4 * max|g| + 1e-6."""
    mols = synthetic_rna_dataset(4, seed=2, n_atoms=60)
    gb = next(iter(GraphLoader(mols, "rna", 2.6, 20.0, 4, build_perms=True))).to(cuda)
    kw = dict(dataset="rna_train", dim=16, n_layer=2, cutoff_l=2.6, cutoff_g=20.0,
              flow="target_to_source")
    model = PAMNet(PAMNetConfig(**kw)).to(cuda)
    unfolded = PAMNet(PAMNetConfig(**kw, fold_sbf=False)).to(cuda)
    unfolded.load_state_dict(model.state_dict())
    grads = []
    for net, plain in ((model, False), (model, True), (unfolded, False)):
        net.zero_grad()
        before = sbf_modulate_backward.launches
        batch_loss(net, gb, "smooth_l1", plain=plain).backward()
        assert sbf_modulate_backward.launches - before == (4 if net is model and not plain
                                                           else 0)
        grads.append({n: p.grad.clone() for n, p in net.named_parameters()})
    for other in grads[1:]:
        assert grads[0].keys() == other.keys()
        for name, want in other.items():
            err = float((grads[0][name] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()) + 1e-6, name


def _center_groups(cuda, num_out, t, valid, seed, long_group=0):
    """The sorted CSR of random center edges over ``valid`` triplets, some
    groups empty and, with ``long_group``, center edge 3 holding that many
    triplets; returns (Groups, ids) with ids 0 past ``valid``."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    ids = torch.randint(0, num_out, (valid - long_group,), device=cuda, generator=g)
    ids = torch.sort(torch.cat([ids, torch.full((long_group,), 3, device=cuda)]))[0]
    off = torch.searchsorted(ids, torch.arange(num_out + 1, device=cuda)).to(torch.int32)
    ids = torch.cat([ids, torch.zeros(t - valid, dtype=ids.dtype, device=cuda)])
    return Groups(off, None, valid), ids.to(torch.int32)


# (center edges, triplets, valid, long group): more triplets than centers,
# more centers than triplets (empty groups), a center edge of 300 triplets.
_SUMMED_CASES = [(300, 2049, 1949, 0), (700, 513, 512, 0), (64, 1024, 1000, 300)]


@pytest.mark.parametrize("d", [16, 8])
@pytest.mark.parametrize("num_out,t,valid,long_group", _SUMMED_CASES)
def test_sbf_modulate_summed_kernel(cuda, d, num_out, t, valid, long_group):
    """The summed forward against its plain version (the (T, D) rows summed
    by kernel A's plain version), empty groups exact zeros, bitwise
    repeatable, one launch a call."""
    args, _, _ = _sbf_case(cuda, d, 300, t, valid, seed=d + t)
    out_groups, _ = _center_groups(cuda, num_out, t, valid, seed=t, long_group=long_group)
    before = sbf_modulate.launches
    got = sbf_modulate(*args, out_groups=out_groups)
    torch.cuda.synchronize()
    assert sbf_modulate.launches == before + 1 and got.shape == (num_out, d)
    torch.testing.assert_close(got, sbf_modulate_plain(*args, out_off=out_groups.off),
                               rtol=1e-4, atol=1e-4)
    empty = out_groups.off[1:] == out_groups.off[:-1]
    assert torch.all(got[empty] == 0.0)
    assert torch.equal(got, sbf_modulate(*args, out_groups=out_groups))


@pytest.mark.parametrize("d", [16, 8])
def test_sbf_modulate_identity_groups_give_the_rows(cuda, d):
    """A group per triplet: the (T, D) rows are the kernel's sums over
    identity groups, and the sums over any center edges' CSR are those rows
    added in triplet order in float32, bit for bit (the kernel's one form
    serves both)."""
    t = 1000
    args, _, _ = _sbf_case(cuda, d, 300, t, 950, seed=5)
    identity = Groups(torch.arange(t + 1, dtype=torch.int32, device=cuda), None, t)
    rows = sbf_modulate(*args)
    assert rows.shape == (t, d) and torch.equal(sbf_modulate(*args, out_groups=identity), rows)
    out_groups, _ = _center_groups(cuda, 200, t, 950, seed=6, long_group=40)
    off = out_groups.off.long()
    want = torch.zeros(200, d, device=cuda)
    for k in range(int((off[1:] - off[:-1]).max())):
        live = off[:-1] + k < off[1:]
        want[live] = want[live] + rows[(off[:-1] + k)[live]]
    assert torch.equal(sbf_modulate(*args, out_groups=out_groups), want)


@pytest.mark.parametrize("d", [16, 8])
@pytest.mark.parametrize("num_out,t,valid,long_group", _SUMMED_CASES)
def test_sbf_modulate_summed_backward_kernel(cuda, d, num_out, t, valid, long_group):
    """The summed op's backward against autograd of its plain version; two
    calls bitwise equal."""
    args, groups, _ = _sbf_case(cuda, d, 300, t, valid, seed=d + t + 1)
    out_groups, ids = _center_groups(cuda, num_out, t, valid, seed=t + 1,
                                     long_group=long_group)
    cot = torch.randn(num_out, d, device=cuda)
    leaves = [a.clone().requires_grad_() if i in _SBF_GRAD else a for i, a in enumerate(args)]
    (sbf_modulate_plain(*leaves, out_off=out_groups.off) * cot).sum().backward()
    want = [leaves[i].grad for i in _SBF_GRAD]
    before = sbf_modulate_backward.launches
    got = sbf_modulate_backward(*args, groups, cot, out_groups, ids)
    torch.cuda.synchronize()
    assert sbf_modulate_backward.launches == before + 1
    _assert_sbf_grads(got, want)
    again = sbf_modulate_backward(*args, groups, cot, out_groups, ids)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_sbf_modulate_summed_function_on_the_card(cuda):
    """The summed Function end to end: one forward and one backward launch,
    gradients as autograd of the plain version; it raises without the
    center edges' ids or with a CSR that is not sorted or holds too many
    rows."""
    args, groups, _ = _sbf_case(cuda, 16, 300, 1024, 1000, seed=3)
    out_groups, ids = _center_groups(cuda, 200, 1024, 1000, seed=4, long_group=40)
    cot = torch.randn(200, 16, device=cuda)
    leaves = [a.clone().requires_grad_() if i in _SBF_GRAD else a for i, a in enumerate(args)]
    f0, b0 = sbf_modulate.launches, sbf_modulate_backward.launches
    out = sbf_modulate(*leaves, groups=groups, out_groups=out_groups, out_ids=ids)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    assert (sbf_modulate.launches, sbf_modulate_backward.launches) == (f0 + 1, b0 + 1)
    plain = [a.clone().requires_grad_() if i in _SBF_GRAD else a for i, a in enumerate(args)]
    (sbf_modulate_plain(*plain, out_off=out_groups.off) * cot).sum().backward()
    _assert_sbf_grads([leaves[i].grad for i in _SBF_GRAD], [plain[i].grad for i in _SBF_GRAD])
    with pytest.raises(ValueError, match="out_ids"):
        sbf_modulate(*leaves, groups=groups, out_groups=out_groups)
    with pytest.raises(ValueError, match="Groups"):
        sbf_modulate(*leaves, out_groups=out_groups, out_ids=ids)
    with pytest.raises(ValueError, match="sorted CSR"):
        sbf_modulate(*leaves, groups=groups, out_groups=groups, out_ids=ids)
    with pytest.raises(ValueError, match="sorted CSR"):
        sbf_modulate(*leaves, groups=groups, out_groups=out_groups._replace(total=2000),
                     out_ids=ids)


# Group sizes the walk meets: empty, one row, a center edge's ~5 triplets, a
# node's ~49 (RNA eg_src) and ~95 (eg_dst, longest) global edges, 128.
_WALK_SIZES = (0, 1, 5, 49, 95, 128)
_WALK_ROUTES = ("sum", "gather", "modulate", "gather+modulate", "role swap", "group sum",
                "message", "message (gate, mask)")


def _walk_case(cuda, route, d, seed, dtype=torch.float32):
    """(kernel call, plain call, off) of one walk route at D=d on 36 groups
    that cycle through ``_WALK_SIZES``, with a padded tail past off[-1], in
    rows of ``dtype``."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    sizes = [_WALK_SIZES[k % len(_WALK_SIZES)] for k in range(36)]
    num_out, valid = len(sizes), sum(sizes)
    rows = valid + 29
    off = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32, device=cuda)
    r = lambda *s: torch.randn(*s, device=cuda, generator=g).to(dtype)  # noqa: E731
    ri = lambda n, hi: torch.randint(0, hi, (n,), device=cuda,  # noqa: E731
                                     generator=g).to(torch.int32)
    if route in ("sum", "gather", "modulate", "gather+modulate"):
        gather, modulate = "gather" in route, "modulate" in route
        a = r(53 if gather else rows, d)
        idx = ri(rows, 53) if gather else None
        b = r(rows, d) if modulate else None
        return (lambda: triplet_aggregate(a, off, idx, b, total=valid),
                lambda: triplet_aggregate_plain(a, off, idx, b), off)
    if route == "role swap":
        perm = torch.cat([torch.randperm(valid, device=cuda, generator=g),
                          torch.arange(valid, rows, device=cuda)]).to(torch.int32)
        by_idx = Groups(off, perm, valid, max(sizes))
        grad, seg_by_idx, b = r(41, d), ri(rows, 41), r(rows, d)
        return (lambda: triplet_aggregate_grad_a(grad, by_idx, seg_by_idx, b),
                lambda: triplet_aggregate_grad_a_plain(grad, by_idx, seg_by_idx, b), off)
    if route == "group sum":
        perm = torch.cat([torch.randperm(valid, device=cuda, generator=g),
                          torch.arange(valid, rows, device=cuda)]).to(torch.int32)
        groups = Groups(off, perm, valid, max(sizes))
        assert group_sum_route(groups) == "walk"
        x = r(rows, d)
        return lambda: group_sum(x, groups), lambda: group_sum_plain(x, groups), off
    gated = route == "message (gate, mask)"
    i_idx = torch.cat([torch.repeat_interleave(
        torch.arange(num_out, device=cuda), torch.tensor(sizes, device=cuda)),
        torch.zeros(rows - valid, dtype=torch.long, device=cuda)]).to(torch.int32)
    args = (r(num_out, d), r(num_out, d), i_idx, ri(rows, num_out), r(rows, d),
            r(rows, d) if gated else None,
            (torch.arange(rows, device=cuda) < valid).to(dtype) if gated else None)
    out_groups = Groups(off, None, valid, max(sizes))
    return (lambda: edge_message_sum(*args, out_groups),
            lambda: edge_message_plain(*args, out_off=off), off)


@pytest.mark.parametrize("d", [4, 8, 12, 16, 64, 128])
@pytest.mark.parametrize("route", _WALK_ROUTES)
def test_walk_every_route_and_team_shape(cuda, monkeypatch, route, d):
    """The CSR walk on every route it serves (kernel A's flags, the role
    swap, the walk route of group_sum, the summed edge message) at groups of
    0-128 rows, for the shape the host picks and for every team shape up to
    a block (teams of one or several warps): against the plain version,
    empty groups exact zeros, two calls bitwise equal."""
    lanes = walk_shape(d, 1, None)[0]
    picked = walk_shape(d, 36, sum(_WALK_SIZES) * 6)
    for shape in [picked] + [(lanes, s) for s in (1, 2, 4, 8, 16, 32, 64) if lanes * s <= 256]:
        monkeypatch.setattr(triplet_ops, "walk_shape", lambda *a, _s=shape: _s)
        monkeypatch.setattr(gather_ops, "walk_shape", lambda *a, _s=shape: _s)
        fn, plain_fn, off = _walk_case(cuda, route, d, seed=d + len(route))
        got = fn()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, plain_fn(), rtol=1e-5, atol=1e-4,
                                   msg=lambda m, _s=shape: f"shape {_s}: {m}")
        assert torch.all(got[off[1:] == off[:-1]] == 0.0)
        assert torch.equal(got, fn()), shape


@pytest.mark.parametrize("d", [16, 128])
def test_edge_message_sum_identity_groups_give_the_rows(cuda, d):
    """A group per row: the summed message writes the rows kernel's rows
    bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(d)
    rows = 3001
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    i_idx = torch.arange(rows, device=cuda, dtype=torch.int32)
    args = (r(rows, d), r(rows, d), i_idx,
            torch.randint(0, rows, (rows,), device=cuda, generator=g).to(torch.int32),
            r(rows, d), r(rows, d), (torch.arange(rows, device=cuda) % 7 > 0).float())
    identity = Groups(torch.arange(rows + 1, dtype=torch.int32, device=cuda), None, rows)
    assert torch.equal(edge_message(*args, out_groups=identity), edge_message(*args))


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("d", [16, 128])
def test_edge_message_summed_function_on_the_card(cuda, gated, d):
    """The summed message end to end: one summed forward launch, one
    backward kernel launch with the node gradient read at i and two group
    sums, no row gather; outputs and gradients against PyTorch's autograd of
    the plain version; the backward bitwise repeatable."""
    g = torch.Generator(device=cuda).manual_seed(7 + d + gated)
    nodes, rows = 257, 9000
    valid = rows - 333
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    i_sorted = torch.sort(torch.randint(0, nodes, (valid,), device=cuda, generator=g))[0]
    off = torch.searchsorted(i_sorted, torch.arange(nodes + 1, device=cuda)).to(torch.int32)
    i_idx = torch.cat([i_sorted, torch.zeros(rows - valid, dtype=torch.long,
                                             device=cuda)]).to(torch.int32)
    j_idx = torch.randint(0, nodes, (rows,), device=cuda, generator=g).to(torch.int32)
    j_idx[valid:] = 0
    perm, poff = build_perm_np(j_idx.cpu().numpy(), valid, nodes, rows)
    j_groups = Groups(torch.from_numpy(poff).to(cuda), torch.from_numpy(perm).to(cuda), valid,
                      int(np.diff(poff).max()))
    out_groups = Groups(off, None, valid, int((off[1:] - off[:-1]).max()))
    mask = (torch.arange(rows, device=cuda) < valid).float()
    leaves = [r(nodes, d), r(nodes, d), r(rows, d), r(rows, d) if gated else None]
    cot = r(nodes, d)

    def run(fn_plain):
        xs = [None if t is None else t.clone().requires_grad_() for t in leaves]
        if fn_plain:
            out = edge_message_plain(xs[0], xs[1], i_idx, j_idx, xs[2], xs[3], mask,
                                     out_off=off)
        else:
            out = edge_message(xs[0], xs[1], i_idx, j_idx, xs[2], xs[3], mask,
                               j_groups=j_groups, out_groups=out_groups)
        (out * cot).sum().backward()
        return out.detach(), [None if t is None else t.grad for t in xs]

    counts = lambda: (edge_message.launches, edge_message_sum.launches,  # noqa: E731
                      edge_message_backward.launches, group_sum.launches, row_gather.launches)
    before = counts()
    out, grads = run(False)
    torch.cuda.synchronize()
    assert np.subtract(counts(), before).tolist() == [1, 1, 1, 2, 0]
    want, want_grads = run(True)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
    for got_g, want_g in zip(grads, want_grads):
        if want_g is not None:
            err = float((got_g - want_g).abs().max())
            assert err <= 1e-4 * float(want_g.abs().max()) + 1e-6
    assert all(t is None or torch.equal(t[valid:], torch.zeros_like(t[valid:]))
               for t in grads[2:])
    again = run(False)
    assert all(a is None or torch.equal(a, b) for a, b in zip(grads, again[1]))


def _poison(cuda, floats: int) -> None:
    """Leave NaN in the caching allocator's free blocks, so an output row a
    kernel fails to write shows."""
    torch.full((floats,), float("nan"), device=cuda)
    torch.cuda.synchronize()


def _role_swap_case(cuda, d, seed):
    """A gathered, modulated sum's backward operands as a batch lays them
    out: ragged groups of idx (some empty), rows sorted by seg, a padded
    tail (idx = seg = 0, b = 0) past ``valid``."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    e, t, valid = 97, 1000, 963
    idx = torch.randint(0, e, (t,), device=cuda, generator=g).to(torch.int32)
    seg = torch.sort(torch.randint(0, e, (t,), device=cuda, generator=g))[0].to(torch.int32)
    idx[valid:] = 0
    seg[valid:] = 0
    by_idx = _perm_groups(idx, valid, e, cuda)
    seg_by_idx = seg[by_idx.perm.long()].contiguous()
    b = torch.randn(t, d, device=cuda, generator=g)
    b[valid:] = 0.0
    return dict(idx=idx, seg=seg, by_idx=by_idx, seg_by_idx=seg_by_idx, b=b, valid=valid,
                grad=torch.randn(e, d, device=cuda, generator=g),
                a=torch.randn(e, d, device=cuda, generator=g))


@pytest.mark.parametrize("d", [12, 16, 128])
def test_fused_role_swap_kernel(cuda, monkeypatch, d):
    """The role swap with d_b in one walk, at the shape the host picks and
    every team shape up to a block: d_a bitwise the role swap alone's, d_b
    bitwise ``gather_product``'s, the padded rows zero (written by the
    walk's tail into poisoned memory), one launch counted on its own
    counter and none on the other two, two calls bitwise equal; against
    the plain version."""
    x = _role_swap_case(cuda, d, seed=31 + d)
    args = (x["grad"], x["by_idx"], x["seg_by_idx"], x["b"], x["a"])
    lanes = walk_shape(d, 1, None)[0]
    shapes = [walk_shape(d, 97, x["valid"])] + [(lanes, s) for s in (1, 2, 4, 8, 16, 32, 64)
                                                if lanes * s <= 256]
    for shape in shapes:
        monkeypatch.setattr(triplet_ops, "walk_shape", lambda *a, _s=shape: _s)
        counts = lambda: (triplet_aggregate_grad_ab.launches,  # noqa: E731
                          triplet_aggregate_grad_a.launches, gather_product.launches)
        _poison(cuda, 4 * 1000 * d)
        before = counts()
        d_a, d_b = triplet_aggregate_grad_ab(*args)
        torch.cuda.synchronize()
        assert np.subtract(counts(), before).tolist() == [1, 0, 0], shape
        assert torch.equal(d_a, triplet_aggregate_grad_a(*args[:4])), shape
        assert torch.equal(d_b, gather_product(x["a"], x["idx"], x["grad"], x["seg"],
                                               x["valid"])), shape
        assert torch.all(d_b[x["valid"]:] == 0.0), shape
        w_a, w_b = triplet_aggregate_grad_ab_plain(*args)
        torch.testing.assert_close(d_a, w_a, rtol=1e-5, atol=1e-5)
        assert torch.equal(d_b, w_b)
        again = triplet_aggregate_grad_ab(*args)
        assert torch.equal(d_a, again[0]) and torch.equal(d_b, again[1]), shape


@pytest.mark.parametrize("d", [12, 16, 128])
def test_gated_sum_backward_kernel(cuda, d):
    """The gated sum's backward against its plain version (one product per
    element: bit for bit, within 1e-4 * max|g| + 1e-6 a fortiori), the rows
    past ``valid`` zero in poisoned memory, one launch counted."""
    g = torch.Generator(device=cuda).manual_seed(d)
    rows, valid, num_out = 5003, 4711, 613
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    seg = torch.sort(torch.randint(0, num_out, (rows,), device=cuda, generator=g))[0]
    seg = seg.to(torch.int32)
    seg[valid:] = 0
    a, b, grad = r(rows, d), r(rows, d), r(num_out, d)
    _poison(cuda, 2 * rows * d)
    before = gated_sum_backward.launches
    got = gated_sum_backward(a, b, grad, seg, valid)
    torch.cuda.synchronize()
    assert gated_sum_backward.launches == before + 1
    for t, w in zip(got, gated_sum_backward_plain(a, b, grad, seg, valid)):
        assert torch.equal(t, w)
        assert torch.all(t[valid:] == 0.0)


@pytest.mark.parametrize("d", [16, 128])
def test_gated_sum_function_on_the_card(cuda, d):
    """The modulated sum without a gather end to end, as the local layer's
    el_dst sum calls it: one forward launch of kernel A, one launch of the
    gated backward and no row gather; output and both gradients against
    PyTorch's autograd of the multiply-then-sum it replaces, the padded
    rows' gradients zero, the backward bitwise repeatable."""
    g = torch.Generator(device=cuda).manual_seed(40 + d)
    nodes, rows = 301, 4099
    valid = rows - 77
    ids = torch.sort(torch.randint(0, nodes, (valid,), device=cuda, generator=g))[0]
    off = torch.searchsorted(ids, torch.arange(nodes + 1, device=cuda)).to(torch.int32)
    seg = torch.cat([ids, torch.zeros(rows - valid, dtype=torch.long, device=cuda)])
    seg = seg.to(torch.int32)
    mask = (torch.arange(rows, device=cuda) < valid).float()
    leaves = [torch.randn(rows, d, device=cuda, generator=g) for _ in range(2)]
    cot = torch.randn(nodes, d, device=cuda, generator=g)

    def run(plain):
        m, gate = (t.clone().requires_grad_() for t in leaves)
        if plain:
            out = triplet_aggregate_plain(gate * m * mask[:, None], off)
        else:
            out = triplet_aggregate(m, off, b=gate, total=valid, grad=AggregateGrad(seg))
        (out * cot).sum().backward()
        return out.detach(), m.grad, gate.grad

    counts = lambda: (triplet_aggregate.launches, gated_sum_backward.launches,  # noqa: E731
                      row_gather.launches)
    before = counts()
    got = run(False)
    torch.cuda.synchronize()
    assert np.subtract(counts(), before).tolist() == [1, 1, 0]
    want = run(True)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    for k in (1, 2):
        err = float((got[k] - want[k]).abs().max())
        assert err <= 1e-4 * float(want[k].abs().max()) + 1e-6
        assert torch.all(got[k][valid:] == 0.0)
    again = run(False)
    assert all(torch.equal(a, b) for a, b in zip(got, again))



def _count_syncs(fn) -> int:
    """Host syncs of one call of ``fn``: the operations that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports as synchronizing."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def _geometry_batches(cuda, kind, n, build_perms=True):
    """(host batch, derive batch) of the same small molecules on the card."""
    if kind == "qm9":
        mols, cl, cg = synthetic_qm9_dataset(n, seed=5), 5.0, 5.0
    else:
        mols, cl, cg = synthetic_rna_dataset(n, seed=5, n_atoms=300), 2.6, 20.0
    return [next(iter(GraphLoader(mols, kind, cl, cg, n, build_perms=build_perms,
                                  wire_geometry=g))).to(cuda) for g in ("host", "derive")]


@pytest.mark.parametrize("kind,dim", [("qm9", 32), ("rna", 16)])
def test_derive_forward_and_gradients_kernels_vs_plain(cuda, kind, dim):
    """A derive batch on the card: the kernels' route against the plain
    route (predictions within 5e-5 + 1e-4 |want|, each gradient within
    1e-4 * max|g| + 1e-6) and against the host-geometry batch (5e-5 +
    1e-4 |want|); RNA at dim 16 folds through kernel B on the card's radial
    table."""
    host, derive = _geometry_batches(cuda, kind, 4)
    kw = (dict(dataset="QM9", dim=dim, n_layer=2) if kind == "qm9" else
          dict(dataset="rna", dim=dim, n_layer=1, cutoff_l=2.6, cutoff_g=20.0,
               flow="target_to_source"))
    model = PAMNet(PAMNetConfig(**kw)).to(cuda)
    assert model.fold_sbf() == (dim == 16)
    loss_kind = "l1" if kind == "qm9" else "smooth_l1"
    grads, preds = [], []
    for plain in (False, True):
        model.zero_grad()
        batch_loss(model, derive, loss_kind, plain=plain).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        with torch.no_grad():
            preds.append(model(derive, plain=plain))
    with torch.no_grad():
        want_host = model(host)
        assert _count_syncs(lambda: model(derive)) == 0  # the basis' constants stay on the card
    torch.testing.assert_close(preds[0], preds[1], atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(preds[0], want_host, atol=5e-5, rtol=1e-4)
    for name, want in grads[1].items():
        err = float((grads[0][name] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-6, name


@pytest.mark.parametrize("kind", ["qm9", "rna"])
def test_device_graph_on_the_card(cuda, kind):
    """The graph rebuilt on the card equals the host batch field by field
    (CSRs and the backward's permutations included) with one host sync;
    the device_graph forward holds its plain route and the host forward
    within 2e-5 + 2e-4 |want|."""
    import dataclasses

    from pamnet_tpu_torch.data.batch import GEOMETRY_FIELDS
    from pamnet_tpu_torch.models.device_graph import rebuild_structure

    host, derive = _geometry_batches(cuda, kind, 3)
    kw = (dict(dataset="QM9", dim=32, n_layer=2) if kind == "qm9" else
          dict(dataset="rna", dim=16, n_layer=1, cutoff_l=2.6, cutoff_g=20.0,
               flow="target_to_source"))
    cfg = PAMNetConfig(**kw, device_graph=True)
    rebuilt = rebuild_structure(derive, cfg)  # loads each kernel's module at its first launch
    assert _count_syncs(lambda: rebuild_structure(derive, cfg)) == 1
    for f in dataclasses.fields(host):
        a, b = getattr(host, f.name), getattr(rebuilt, f.name)
        if f.name in GEOMETRY_FIELDS:
            continue
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        elif f.name == "perms":
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert a == b, f.name
    model = PAMNet(cfg).to(cuda)
    plain_host = PAMNet(PAMNetConfig(**kw)).to(cuda)
    plain_host.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = model(derive)
        torch.testing.assert_close(got, model(derive, plain=True), atol=2e-5, rtol=2e-4)
        torch.testing.assert_close(got, plain_host(host), atol=2e-5, rtol=2e-4)


# ---- bfloat16 versions of the kernels ----

BF16 = torch.bfloat16


def _assert_bf16_ulp(got, want):
    """One bfloat16 ulp against the plain version, which computes in f32 and
    rounds once: |got - want| <= 2^-7 |want| + 1e-5 max|want|."""
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape
    g, w = got.double(), want.double()
    assert bool(torch.isfinite(g).all())
    bad = (g - w).abs() > 2.0 ** -7 * w.abs() + 1e-5 * float(w.abs().max())
    assert not bool(bad.any()), float((g - w).abs().max())


@pytest.mark.parametrize("d", [8, 12, 16, 128])
@pytest.mark.parametrize("route", [r for r in _WALK_ROUTES if r != "role swap"])
def test_walk_bf16_every_route_and_team_shape(cuda, monkeypatch, route, d):
    """The CSR walk on bfloat16 rows (16-byte vectors where D % 8 == 0,
    8-byte ones at D = 12), every route with a bfloat16 version, at the
    shape the host picks and every team shape up to a block: within one ulp
    of the plain version, empty groups zero, two calls bitwise equal."""
    lanes = walk_shape(d, 1, None, BF16)[0]
    assert lanes == min(32, 1 << ((d // (8 if d % 8 == 0 else 4)) - 1).bit_length())
    picked = walk_shape(d, 36, sum(_WALK_SIZES) * 6, BF16)
    for shape in [picked] + [(lanes, s) for s in (1, 2, 4, 8, 16, 32, 64) if lanes * s <= 256]:
        monkeypatch.setattr(triplet_ops, "walk_shape", lambda *a, _s=shape: _s)
        monkeypatch.setattr(gather_ops, "walk_shape", lambda *a, _s=shape: _s)
        fn, plain_fn, off = _walk_case(cuda, route, d, seed=d + len(route), dtype=BF16)
        got = fn()
        torch.cuda.synchronize()
        _assert_bf16_ulp(got, plain_fn())
        assert torch.all(got[off[1:] == off[:-1]] == 0.0)
        assert torch.equal(got, fn()), shape


@pytest.mark.parametrize("d", [12, 16, 128])
def test_fused_role_swap_bf16_kernel(cuda, d):
    """The fused role swap on bfloat16 rows: within one ulp of the plain
    version, the padded d_b rows zero in poisoned memory, one launch, two
    calls bitwise equal."""
    x = _role_swap_case(cuda, d, seed=31 + d)
    args = (x["grad"].to(BF16), x["by_idx"], x["seg_by_idx"], x["b"].to(BF16), x["a"].to(BF16))
    _poison(cuda, 4 * 1000 * d)
    before = triplet_aggregate_grad_ab.launches
    d_a, d_b = triplet_aggregate_grad_ab(*args)
    torch.cuda.synchronize()
    assert triplet_aggregate_grad_ab.launches == before + 1
    w_a, w_b = triplet_aggregate_grad_ab_plain(*args)
    _assert_bf16_ulp(d_a, w_a)
    assert torch.equal(d_b, w_b) and torch.all(d_b[x["valid"]:] == 0.0)
    again = triplet_aggregate_grad_ab(*args)
    assert torch.equal(d_a, again[0]) and torch.equal(d_b, again[1])


@pytest.mark.parametrize("d", [12, 16, 128])
def test_gated_sum_backward_bf16_kernel(cuda, d):
    """Each gradient one product of two bfloat16 values, rounded once: the
    plain version's bits; the rows past ``valid`` zero."""
    g = torch.Generator(device=cuda).manual_seed(d)
    rows, valid, num_out = 5003, 4711, 613
    r = lambda *s: torch.randn(*s, device=cuda, generator=g).to(BF16)  # noqa: E731
    seg = torch.sort(torch.randint(0, num_out, (rows,), device=cuda, generator=g))[0]
    seg = seg.to(torch.int32)
    seg[valid:] = 0
    a, b, grad = r(rows, d), r(rows, d), r(num_out, d)
    _poison(cuda, 2 * rows * d)
    got = gated_sum_backward(a, b, grad, seg, valid)
    for t, w in zip(got, gated_sum_backward_plain(a, b, grad, seg, valid)):
        assert t.dtype == BF16 and torch.equal(t, w) and torch.all(t[valid:] == 0.0)


@pytest.mark.parametrize("d", [42, 128, 12, 7])
def test_row_gather_bf16_kernel(cuda, d):
    """bfloat16 rows copied exactly: 16-byte vectors (D=128), the warp tile
    in bf16x2 columns (D=42, an 84-byte row), 8-byte (D=12) and 2-byte
    (D=7) units; rows past ``valid`` zero."""
    g = torch.Generator(device=cuda).manual_seed(d)
    src = torch.randn(313, d, device=cuda, generator=g).to(BF16)
    idx = torch.randint(0, 313, (2049,), device=cuda, generator=g).to(torch.int32)
    for valid in (None, 2000):
        got = row_gather(src, idx, valid=valid)
        assert got.dtype == BF16 and torch.equal(got, row_gather_plain(src, idx, valid))


@pytest.mark.parametrize("gated,masked", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("d", [16, 128])
def test_edge_message_bf16_kernels(cuda, gated, masked, d):
    """The edge message as rows and its backward (rows and the summed
    form's, the node gradient read at ``i``) on bfloat16 operands, the mask
    too: within one ulp of the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(d + 2 * gated + masked)
    nodes, rows, valid = 211, 3001, 2900
    r = lambda *s: torch.randn(*s, device=cuda, generator=g).to(BF16)  # noqa: E731
    i_idx = torch.sort(torch.randint(0, nodes, (rows,), device=cuda, generator=g))[0]
    i_idx = i_idx.to(torch.int32)
    j_idx = torch.randint(0, nodes, (rows,), device=cuda, generator=g).to(torch.int32)
    mask = (torch.arange(rows, device=cuda) < valid).to(BF16) if masked else None
    args = (r(nodes, d), r(nodes, d), i_idx, j_idx, r(rows, d), r(rows, d) if gated else None,
            mask)
    _assert_bf16_ulp(edge_message(*args), edge_message_plain(*args))
    for at_i, grad in ((False, r(rows, d)), (True, r(nodes, d))):
        kw = dict(at_i=at_i, valid=valid)
        got = edge_message_backward(*args, grad, **kw)
        want = edge_message_backward_plain(*args, grad, **kw)
        for t, w in zip(got, want):
            if w is not None:
                _assert_bf16_ulp(t, w)
                assert torch.all(t[valid:] == 0.0)


def test_kernels_without_bf16_version_raise(cuda):
    """The one-gradient routes and the split group sum take float32 only: a
    bfloat16 operand raises rather than running another route."""
    x = _role_swap_case(cuda, 16, seed=3)
    g16, b16, a16 = x["grad"].to(BF16), x["b"].to(BF16), x["a"].to(BF16)
    with pytest.raises(ValueError, match="no bfloat16 version"):
        triplet_aggregate_grad_a(g16, x["by_idx"], x["seg_by_idx"], b16)
    with pytest.raises(ValueError, match="no bfloat16 version"):
        gather_product(a16, x["idx"], g16, x["seg"], x["valid"])
    groups = x["by_idx"]._replace(longest=None)  # the split route
    assert group_sum_route(groups) == "split"
    with pytest.raises(ValueError, match="no bfloat16 version"):
        group_sum(b16, groups)


def _bf16_sbf(args, cot=None):
    """Kernel B's float operands (and an output gradient) in bfloat16."""
    out = [t.to(BF16) if t.is_floating_point() else t for t in args]
    return out if cot is None else (out, cot.to(BF16))


@pytest.mark.parametrize("d", [16, 8])
@pytest.mark.parametrize("num_out,t,valid,long_group", _SUMMED_CASES)
def test_sbf_modulate_bf16_kernel(cuda, d, num_out, t, valid, long_group):
    """Kernel B's forward on bfloat16 operands, summed and as rows: within
    one ulp of the plain version (which computes in f32 and rounds once),
    empty groups zero, one launch a call, two calls bitwise equal."""
    args, _, _ = _sbf_case(cuda, d, 300, t, valid, seed=d + t + 7)
    args = _bf16_sbf(args)
    out_groups, _ = _center_groups(cuda, num_out, t, valid, seed=t + 7, long_group=long_group)
    for groups, off in ((out_groups, out_groups.off), (None, None)):
        before = sbf_modulate.launches
        got = sbf_modulate(*args, out_groups=groups)
        torch.cuda.synchronize()
        assert sbf_modulate.launches == before + 1
        _assert_bf16_ulp(got, sbf_modulate_plain(*args, out_off=off))
        assert torch.equal(got, sbf_modulate(*args, out_groups=groups))
    assert torch.all(sbf_modulate(*args, out_groups=out_groups)[
        out_groups.off[1:] == out_groups.off[:-1]] == 0.0)


@pytest.mark.parametrize("d", [16, 8])
@pytest.mark.parametrize("num_out,t,valid,long_group", _SUMMED_CASES)
def test_sbf_modulate_backward_bf16_kernel(cuda, d, num_out, t, valid, long_group):
    """Kernel B's backward on bfloat16 operands and output gradient, summed
    and as rows: each of its seven gradients in bfloat16 within one ulp of
    PyTorch's autograd of the plain version; two calls bitwise equal."""
    args, groups, cot_rows = _sbf_case(cuda, d, 300, t, valid, seed=d + t + 8)
    out_groups, ids = _center_groups(cuda, num_out, t, valid, seed=t + 8,
                                     long_group=long_group)
    cot_sum = torch.randn(num_out, d, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(t))
    for cot, og, oi in ((cot_sum, out_groups, ids), (cot_rows, None, None)):
        b_args, b_cot = _bf16_sbf(args, cot)
        leaves = [a.clone().requires_grad_() if i in _SBF_GRAD else a
                  for i, a in enumerate(b_args)]
        out = sbf_modulate_plain(*leaves, out_off=None if og is None else og.off)
        out.backward(b_cot)
        got = sbf_modulate_backward(*b_args, groups, b_cot, og, oi)
        torch.cuda.synchronize()
        for g, i in zip(got, _SBF_GRAD):
            _assert_bf16_ulp(g, leaves[i].grad)
        again = sbf_modulate_backward(*b_args, groups, b_cot, og, oi)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_sbf_modulate_bf16_function_and_mixed_types(cuda):
    """The bfloat16 Function end to end (one forward, one backward launch,
    bfloat16 gradients), and both entry points refusing operands of two
    types, naming them."""
    args, groups, _ = _sbf_case(cuda, 16, 300, 1024, 1000, seed=9)
    out_groups, ids = _center_groups(cuda, 200, 1024, 1000, seed=10, long_group=40)
    b_args, cot = _bf16_sbf(args, torch.randn(200, 16, device=cuda))
    leaves = [a.clone().requires_grad_() if i in _SBF_GRAD else a for i, a in enumerate(b_args)]
    f0, b0 = sbf_modulate.launches, sbf_modulate_backward.launches
    out = sbf_modulate(*leaves, groups=groups, out_groups=out_groups, out_ids=ids)
    out.backward(cot)
    torch.cuda.synchronize()
    assert out.dtype == BF16
    assert (sbf_modulate.launches, sbf_modulate_backward.launches) == (f0 + 1, b0 + 1)
    assert all(leaves[i].grad.dtype == BF16 for i in _SBF_GRAD)
    mixed = [args[0]] + b_args[1:]  # float32 proj, bfloat16 m_neighbor
    with pytest.raises(ValueError, match="proj must be .*bfloat16.*got torch.float32"):
        sbf_modulate(*mixed, out_groups=out_groups)
    with pytest.raises(ValueError, match="proj must be .*bfloat16.*got torch.float32"):
        sbf_modulate_backward(*mixed, groups, cot, out_groups, ids)
    with pytest.raises(ValueError, match="g must be .*bfloat16.*got torch.float32"):
        sbf_modulate_backward(*b_args, groups, cot.float(), out_groups, ids)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sbf_modulate(*[t.half() if t.is_floating_point() else t for t in args])


def test_bf16_training_step_kernels_vs_plain_and_repeat(cuda):
    """A bfloat16 QM9 step (dim 32, 2 layers): its parameter gradients (float32)
    through the kernels against PyTorch's autograd of the plain bfloat16
    route, per tensor within 2e-2 * max|g| + 1e-6 or twice the tensor's
    distance between the bfloat16 and float32 plain routes; the same
    kernel launches as the float32 step; two steps from one state bitwise
    equal."""
    from pamnet_tpu_torch.train.loop import Optimizer, train_step
    from pamnet_tpu_torch.train.schedules import constant

    mols = synthetic_qm9_dataset(8, seed=2)
    gb = next(iter(GraphLoader(mols, "qm9", 5.0, 5.0, 8, build_perms=True))).to(cuda)
    m32 = PAMNet(PAMNetConfig(dataset="QM9", dim=32, n_layer=2)).to(cuda)
    m16 = PAMNet(PAMNetConfig(dataset="QM9", dim=32, n_layer=2,
                              compute_dtype="bfloat16")).to(cuda)
    m16.load_state_dict(m32.state_dict())
    counters = (triplet_aggregate, triplet_aggregate_grad_ab, gated_sum_backward,
                edge_message, edge_message_sum, edge_message_backward, group_sum, row_gather)

    def grads(model, plain):
        model.zero_grad()
        before = [f.launches for f in counters]
        batch_loss(model, gb, "l1", plain=plain).backward()
        launched = [f.launches - b for f, b in zip(counters, before)]
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}, launched

    (k16, n16), (p16, _), (p32, _), (_, n32) = (grads(m16, False), grads(m16, True),
                                                grads(m32, True), grads(m32, False))
    assert n16 == n32 and min(n16) > 0
    for name, w in p16.items():
        assert k16[name].dtype == torch.float32
        bound = max(2e-2 * float(w.abs().max()) + 1e-6, 2 * float((w - p32[name]).abs().max()))
        assert float((k16[name] - w).abs().max()) <= bound, name
    start = [p.detach().clone() for p in m16.parameters()]
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for p, s in zip(m16.parameters(), start):
                p.copy_(s)
        opt = Optimizer(m16.parameters(), constant(1e-3))
        runs.append([train_step(m16, opt, None, gb, "l1")]
                    + [p.detach().clone() for p in m16.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_rna_bf16_folded_step_kernels_vs_plain(cuda):
    """The RNA model at its published width in bfloat16 folds, as in JAX:
    kernel B twice forward and twice backward, in bfloat16; its parameter
    gradients (float32) against the plain bfloat16 route per tensor within
    2e-2 * max|g| + 1e-6 or twice the tensor's distance between the
    bfloat16 and float32 plain routes; predictions within 1e-2 * max|pred|
    of the plain route's."""
    mols = synthetic_rna_dataset(4, seed=3, n_atoms=60)
    gb = next(iter(GraphLoader(mols, "rna", 2.6, 20.0, 4, build_perms=True))).to(cuda)
    kw = dict(dataset="rna_train", dim=16, n_layer=1, cutoff_l=2.6, cutoff_g=20.0,
              flow="target_to_source")
    m32 = PAMNet(PAMNetConfig(**kw)).to(cuda)
    m16 = PAMNet(PAMNetConfig(**kw, compute_dtype="bfloat16")).to(cuda)
    m16.load_state_dict(m32.state_dict())
    assert m16.fold_sbf()
    with torch.no_grad():
        pred, pred_plain = m16(gb), m16(gb, plain=True)
    assert pred.dtype == torch.float32
    assert float((pred - pred_plain).abs().max()) <= 1e-2 * float(pred_plain.abs().max())

    def grads(model, plain):
        model.zero_grad()
        f0, b0 = sbf_modulate.launches, sbf_modulate_backward.launches
        batch_loss(model, gb, "smooth_l1", plain=plain).backward()
        torch.cuda.synchronize()
        launched = (sbf_modulate.launches - f0, sbf_modulate_backward.launches - b0)
        return {n: p.grad.clone() for n, p in model.named_parameters()}, launched

    (k16, n16), (p16, _), (p32, _) = grads(m16, False), grads(m16, True), grads(m32, True)
    assert n16 == (2, 2)
    for name, w in p16.items():
        assert k16[name].dtype == torch.float32
        bound = max(2e-2 * float(w.abs().max()) + 1e-6, 2 * float((w - p32[name]).abs().max()))
        assert float((k16[name] - w).abs().max()) <= bound, name
