"""The port's CUDA kernels against their plain versions on the card, at small
shapes, including ragged and empty groups.  Skipped without a CUDA card;
run on the card with ``python -m pytest tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.batch import build_perm_np
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.ops.gather import (edge_message, edge_message_backward,
                                         edge_message_backward_plain, edge_message_plain,
                                         row_gather, row_gather_plain)
from pamnet_tpu_torch.ops.sbf_modulate import sbf_modulate, sbf_modulate_plain
from pamnet_tpu_torch.ops.triplet import (Groups, gather_product, gather_product_plain,
                                          group_sum, group_sum_plain, triplet_aggregate,
                                          triplet_aggregate_grad_a,
                                          triplet_aggregate_grad_a_plain, triplet_aggregate_plain)
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
        batch_loss(model, gb, plain=plain).backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for name, want in grads[1].items():
        err = float((grads[0][name] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-6, name
