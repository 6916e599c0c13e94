"""The two kernels of the port redesigned for their shapes, through their
plain versions on the CPU, against the JAX package on the same numpy inputs:
the embedding's backward (``group_sum``, split across the card where a
group is long: ``csrc/group_sum.cu``) against ``jax.grad`` of the lookup
``params["embeddings"][g.z]`` (``pamnet_tpu/models/pamnet.py:139``), and the
unfolded path's gather of the radial table (``row_gather`` at D=42) against
``jnp.take``; the host's longest group of every CSR of a training batch; and
the rule by which ``group_sum`` picks its kernel, with nothing launched.

Tolerances: a group sum within 1e-5 of the largest value's magnitude (f32
sums of up to 16,896 rows in another order); gathers exact."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import functools
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pamnet_tpu_torch.data.batch import build_perm_np
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset, synthetic_rna_dataset
from pamnet_tpu_torch.ops.gather import row_gather, row_gather_plain
from pamnet_tpu_torch.ops.triplet import (SPLIT_ABOVE, Groups, group_sum, group_sum_plain,
                                          group_sum_route, group_sum_split)

CSR_KEYS = ("z", "eg_src", "eg_dst", "el_src", "el_dst", "t2_kj", "t1_jj", "t2_ji", "t1_ji")


# (atom types, padded rows, embedding width, types that occur)
EMBEDDINGS = {
    "rna 3 types": (3, 16896, 16, (0, 1, 2)),
    "qm9 5 types": (5, 1024, 128, (0, 1, 2, 3, 4)),
    "one group holds every row": (1, 4096, 16, (0,)),
    "one empty group": (4, 2048, 16, (0, 1, 3)),
}


def _embedding_case(name: str):
    """Atom types of the valid rows (a padded tail of z = 0 whose gradient
    the model masks), an embedding table and the lookup's output gradient."""
    types, rows, d, present = EMBEDDINGS[name]
    rng = np.random.default_rng(rows + d + types)
    valid = rows - rows // 16
    z = np.zeros(rows, np.int32)
    z[:valid] = rng.choice(np.array(present, np.int32), valid)
    emb = rng.standard_normal((types, d)).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32)
    return z, emb, g, valid


@pytest.mark.parametrize("order", ["sorted", "permuted"])
@pytest.mark.parametrize("name", list(EMBEDDINGS))
def test_group_sum_plain_matches_embedding_grad(name, order):
    z, emb, g, valid = _embedding_case(name)
    if order == "sorted":
        z[:valid] = np.sort(z[:valid])
    mask = (np.arange(z.shape[0]) < valid).astype(np.float32)[:, None]
    want = np.asarray(jax.grad(
        lambda e: jnp.sum(e[jnp.asarray(z)] * jnp.asarray(g * mask)))(jnp.asarray(emb)))
    types = emb.shape[0]
    if order == "sorted":
        off = np.searchsorted(z[:valid], np.arange(types + 1)).astype(np.int32)
        groups = Groups(torch.from_numpy(off), None, valid)
    else:
        perm, off = build_perm_np(z, valid, types, z.shape[0])
        groups = Groups(torch.from_numpy(off), torch.from_numpy(perm), valid)
    groups = groups._replace(longest=int(np.diff(off).max()))
    assert group_sum_route(groups) == "split"
    x = torch.from_numpy(g)
    got = group_sum_plain(x, groups).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # On CPU tensors both wrappers are the plain version and launch nothing.
    launches = group_sum.launches, group_sum_split.launches
    assert torch.equal(group_sum(x, groups), torch.from_numpy(got))
    assert torch.equal(group_sum_split(x, groups), torch.from_numpy(got))
    assert (group_sum.launches, group_sum_split.launches) == launches


@functools.lru_cache(maxsize=None)
def _batch(kind: str):
    """A training batch with the backward's CSR arrays: 32 QM9 molecules, or
    4 RNA-like chains of 150 atoms."""
    if kind == "qm9":
        mols = synthetic_qm9_dataset(32, seed=4)
        return next(iter(GraphLoader(mols, "qm9", 5.0, 5.0, 32, build_perms=True)))
    mols = synthetic_rna_dataset(4, seed=4, n_atoms=150)
    return next(iter(GraphLoader(mols, "rna", 2.6, 20.0, 4, build_perms=True)))


@pytest.mark.parametrize("key", CSR_KEYS)
@pytest.mark.parametrize("kind", ["qm9", "rna"])
def test_batch_longest_group_of_every_csr(kind, key):
    gb = _batch(kind)
    assert set(gb.longest) == set(CSR_KEYS)
    if key in ("t2_ji", "t1_ji"):  # the triplet sums' CSRs: offsets alone
        groups = Groups(getattr(gb, key + "_off"), None, gb.valid[key[:2]], gb.longest[key])
    else:
        groups = gb.groups(key)
    off = groups.off.numpy()
    assert off[-1] == groups.total
    assert gb.longest[key] == groups.longest == int(np.diff(off).max())
    # The atom types' CSR has the long groups; every other one walks.
    assert group_sum_route(groups) == ("split" if key == "z" else "walk")


@pytest.mark.parametrize("longest,route", [
    (None, "split"), (SPLIT_ABOVE + 1, "split"), (7557, "split"),
    (SPLIT_ABOVE, "walk"), (14, "walk"), (0, "walk"),
])
def test_group_sum_route(longest, route):
    groups = Groups(torch.tensor([0, 3, 3], dtype=torch.int32), None, 3, longest)
    assert group_sum_route(groups) == route


@pytest.mark.parametrize("valid", [False, True], ids=["every row", "valid count"])
@pytest.mark.parametrize("key", ["t2_kj", "t1_jj"])
@pytest.mark.parametrize("kind", ["qm9", "rna"])
def test_row_gather_plain_radial_table_matches_take(kind, key, valid):
    gb = _batch(kind)
    src, idx = gb.sbf_radial, getattr(gb, key)
    assert src.shape[1] == 42
    n = gb.valid[key[:2]] if valid else idx.shape[0]
    want = np.array(jnp.take(jnp.asarray(src.numpy()), jnp.asarray(idx.numpy()), axis=0))
    want[n:] = 0.0
    got = row_gather_plain(src, idx, n if valid else None)
    np.testing.assert_array_equal(got.numpy(), want)
    launches = row_gather.launches
    assert torch.equal(row_gather(src, idx, valid=n if valid else None), got)
    assert row_gather.launches == launches


def test_kernel_totals_counts_every_record():
    """The profiles' launch totals count every record of work on the card
    once, by kernel name: two kernels whose names share a long prefix are
    added together, host records and records with no card time are left
    out, and a user annotation on the card counts, as it always has."""
    import types

    from pamnet_tpu_torch.profiling import NAME_CHARS, is_kernel, kernel_totals

    def ev(key, count, us, device="DeviceType.CUDA"):
        return types.SimpleNamespace(key=key, count=count, device_type=device,
                                     self_device_time_total=us)

    long = "k" * NAME_CHARS
    events = [ev(long + "<1>", 6, 30.0), ev(long + "<2>", 3, 15.0), ev("aten::mul", 9, 0.0),
              ev("aten::add", 3, 12.0, "DeviceType.CPU"), ev("mul_kernel", 12, 24.0),
              ev("Optimizer.step#Adam.step", 3, 60.0)]
    assert [is_kernel(e) for e in events] == [True, True, False, False, True, True]
    got = kernel_totals(events, 3)
    assert got["kernel_launches"] == 8.0
    assert got["device_ms"] == pytest.approx(0.043)
    assert got["by_name"] == {long: [3.0, pytest.approx(0.015)],
                              "Optimizer.step#Adam.step": [1.0, pytest.approx(0.02)],
                              "mul_kernel": [4.0, pytest.approx(0.008)]}


def test_time_ms_on_the_host_clock():
    """The shared timer that ``chip_smoke.py``'s kernel phases and the bench
    call: ``warmup`` calls untimed, then the mean of ``iters`` calls in a
    row, on the host's clock where it is not timing the card."""
    from pamnet_tpu_torch.profiling import time_ms

    calls = []

    def fn():
        calls.append(time.perf_counter())
        time.sleep(0.002)

    ms = time_ms(fn, iters=4, warmup=2, cuda=False)
    assert len(calls) == 6
    assert 2.0 <= ms < 100.0
