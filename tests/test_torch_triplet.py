"""Kernel A's plain version (pamnet_tpu_torch/ops/triplet.py) against the JAX
package's triplet aggregation (XLA and Pallas-interpret) and its sorted
segment sum, on the same numpy inputs.  Tolerance rtol/atol 1e-5: f32 sums
taken in a different order."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pamnet_tpu.ops.ell import segment_sum_sorted
from pamnet_tpu.ops.pallas_triplet import _BT, fused_triplet_aggregate
from pamnet_tpu.ops.segment import segment_sum
from pamnet_tpu_torch.models.layers import aggregate
from pamnet_tpu_torch.ops.triplet import triplet_aggregate, triplet_aggregate_plain

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(rng, e, t, d):
    """Rows sorted by segment with a zero-valued padded tail, as in batches
    (the shapes of tests/test_pallas_triplet.py)."""
    a = rng.standard_normal((e, d)).astype(np.float32)
    a_rows = rng.standard_normal((t, d)).astype(np.float32)
    b = rng.standard_normal((t, d)).astype(np.float32)
    b[-(t // 4):] = 0.0
    idx = rng.integers(0, e, t).astype(np.int32)
    seg = np.sort(rng.integers(0, e, t)).astype(np.int32)
    off = np.searchsorted(seg, np.arange(e + 1)).astype(np.int32)
    return a, a_rows, b, idx, seg, off


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("gather,modulate", [(True, True), (True, False),
                                             (False, True), (False, False)])
@pytest.mark.parametrize("e,t,d", [(256, 2 * _BT, 128), (128, _BT, 128)])
def test_plain_matches_fused_triplet_aggregate(e, t, d, gather, modulate, use_pallas):
    rng = np.random.default_rng(480 + e + t)
    a, a_rows, b, idx, seg, off = _case(rng, e, t, d)
    src = a if gather else a_rows
    jidx = idx if gather else np.arange(t, dtype=np.int32)
    jb = b if modulate else np.ones_like(b)
    # The Pallas kernel holds `a` as one (num_out, D) block, so the no-gather
    # modes (a row per triplet) run with t output rows; rows >= e stay 0.
    num_out = e if gather else t
    want = np.asarray(fused_triplet_aggregate(
        jnp.asarray(src), jnp.asarray(jb), jnp.asarray(jidx), jnp.asarray(seg),
        num_out, use_pallas, use_pallas,
    ))[:e]
    got = triplet_aggregate_plain(
        torch.from_numpy(src), torch.from_numpy(off),
        torch.from_numpy(idx) if gather else None,
        torch.from_numpy(b) if modulate else None,
    ).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("num_valid", [1000, 777])
def test_no_gather_matches_segment_sum_sorted(num_valid):
    """Rows past off[-1] (padding) are never summed, as in the scan."""
    rng = np.random.default_rng(num_valid)
    groups, rows, d = 96, 1024, 16
    vals = rng.standard_normal((rows, d)).astype(np.float32)
    ids = np.zeros(rows, np.int32)
    ids[:num_valid] = np.sort(rng.integers(0, groups, num_valid))
    off = np.searchsorted(ids[:num_valid], np.arange(groups + 1)).astype(np.int32)
    mask = (np.arange(rows) < num_valid).astype(np.float32)
    want = np.asarray(segment_sum_sorted(
        jnp.asarray(vals), jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(off)))
    got = triplet_aggregate_plain(torch.from_numpy(vals), torch.from_numpy(off)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    a, _, b, idx, _, off = _case(rng, 64, 256, 16)
    args = [torch.from_numpy(x) for x in (a, off, idx, b)]
    before = triplet_aggregate.launches
    np.testing.assert_array_equal(triplet_aggregate(*args).numpy(),
                                  triplet_aggregate_plain(*args).numpy())
    assert triplet_aggregate.launches == before


@pytest.mark.parametrize("modulated", [False, True])
def test_unsorted_rows_aggregate_via_permutation(modulated):
    """Rows not sorted by their key (no CSR offsets in the batch) are sorted
    in the layer and summed through the kernel's gather; masked rows drop."""
    rng = np.random.default_rng(5)
    groups, rows, d = 40, 300, 16
    vals = rng.standard_normal((rows, d)).astype(np.float32)
    ids = rng.integers(0, groups, rows).astype(np.int32)
    mask = (rng.random(rows) < 0.8).astype(np.float32)
    b = rng.standard_normal((rows, d)).astype(np.float32)
    contrib = vals * b if modulated else vals
    want = np.asarray(segment_sum(jnp.asarray(contrib * mask[:, None]),
                                  jnp.asarray(ids), groups))
    got = aggregate(torch.from_numpy(vals), None, torch.from_numpy(ids),
                    torch.from_numpy(mask), groups,
                    b=torch.from_numpy(b) if modulated else None).numpy()
    np.testing.assert_allclose(got, want, **TOL)
