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


def test_smoke_compare_reads_the_compared_cases():
    """The two-checkout comparison keeps the group-sum and row-gather cases of
    every kernel phase, kernel A's and the edge message's cases by name
    (the walks on the scoring batch's own CSRs, the summed global message
    with the rows + sum of the same arrays beside it), the steps' times and
    the in-step launches of the group sums and of the walk."""
    import json

    from pamnet_tpu_torch.smoke_compare import summarize

    case = {"case": "sum by z (permuted CSR)", "d": 16, "ms": 0.05, "device_ms": 0.002,
            "route": "split", "rows": 9}
    walk = {"case": "eg_src global sum, scoring batch", "d": 16, "device_ms": 0.03,
            "walk_shape": [4, 8], "rows": 5}
    summed = {"case": "global message summed, scoring batch", "d": 16, "device_ms": 0.09,
              "rows_sum_device_ms": 0.15, "bound_ms": 0.07}
    role = {"case": "d_a by role swap over the t2_kj CSR", "d": 128, "device_ms": 0.003}
    launches = [{"name": "group_sum_cluster_kernel<true>(", "device_us": 7.7},
                {"name": "sbf_modulate_kernel<7, 16>(", "device_us": 76.0},
                {"name": "csr_walk_kernel<SumRow<false, false, false> >(", "device_us": 3.0},
                {"name": "csr_walk_kernel<MessageRow<true, true> >(", "device_us": 60.0}]
    lines = [
        "not json",
        json.dumps({"phase": "device", "nvidia_smi": "card, 700.00 W"}),
        json.dumps({"phase": "walk_kernels", "triplet_aggregate": [walk],
                    "edge_message_sum": [summed]}),
        json.dumps({"phase": "train_kernels", "triplet_aggregate_grad_a": [role]}),
        json.dumps({"phase": "rna_train_kernels", "pads": {"n": 1},
                    "group_sum_split": [case], "sbf_modulate": [{"case": "t2 fused"}]}),
        json.dumps({"phase": "rna_train", "ms_per_step": 20.0, "device_ms_per_step": 4.6}),
        json.dumps({"phase": "profile_rna_train", "device_ms_per_step_total": 4.7,
                    "port_kernel_launches": launches}),
        json.dumps({"ok": True, "device": {}}),
    ]
    got = summarize(lines)
    assert got["nvidia_smi"] == "card, 700.00 W" and got["ok"] is True
    assert got["rna_train_kernels"] == [{"case": case["case"], "d": 16, "ms": 0.05,
                                         "device_ms": 0.002, "route": "split"}]
    assert got["walk_kernels"] == [
        {"case": walk["case"], "d": 16, "device_ms": 0.03, "walk_shape": [4, 8]},
        {"case": summed["case"], "d": 16, "device_ms": 0.09, "bound_ms": 0.07,
         "rows_sum_device_ms": 0.15}]
    assert got["train_kernels"] == [{"case": role["case"], "d": 128, "device_ms": 0.003}]
    assert got["rna_train"]["device_ms_per_step"] == 4.6
    assert got["profile_rna_train"]["group_sum_launches"] == [launches[0], launches[2]]
    assert got["profile_rna_train"]["sbf_launches"] == launches[1:]


def test_smoke_compare_reads_kernel_a_backward_routes():
    """The comparison prints the fused role swap beside the role swap alone
    and the pair it replaces, and the gated backward beside the row gather
    and multiplies it replaces, with the L2 flushed and warm."""
    import json

    from pamnet_tpu_torch.smoke_compare import summarize

    fused = {"case": "d_a and d_b by the fused role swap over the t2_kj CSR", "d": 128,
             "device_ms": 0.0037, "alone_device_ms": 0.003, "pair_device_ms": 0.0048,
             "rows": 3}
    gated = {"case": "gated el_dst sum backward", "d": 16, "device_ms": 0.008,
             "warm_device_ms": 0.005, "rows_mul_device_ms": 0.018,
             "rows_mul_warm_device_ms": 0.016, "valid": 9}
    lines = [json.dumps({"phase": "train_kernels", "triplet_aggregate_grad_ab": [fused],
                         "gather_product": [{"case": "d_b at t2", "d": 128}]}),
             json.dumps({"phase": "rna_train_kernels", "gated_sum_backward": [gated]})]
    got = summarize(lines)
    assert got["train_kernels"] == [{k: v for k, v in fused.items() if k != "rows"},
                                    {"case": "d_b at t2", "d": 128}]
    assert got["rna_train_kernels"] == [{k: v for k, v in gated.items() if k != "valid"}]


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
    """The shared timer that ``chip_smoke.py`` and the bench call: ``warmup``
    calls untimed, then the mean of ``iters`` calls in a row, on the host's
    clock where it is not timing the card."""
    from pamnet_tpu_torch.profiling import time_ms

    calls = []

    def fn():
        calls.append(time.perf_counter())
        time.sleep(0.002)

    ms = time_ms(fn, iters=4, warmup=2, cuda=False)
    assert len(calls) == 6
    assert 2.0 <= ms < 100.0


def test_smoke_compare_reads_profile_totals():
    """The comparison prints a profiled step's and forward's kernel launches
    in total and by name where the checkout prints them, and the device
    time alone where it does not (a parent from before the totals)."""
    import json

    from pamnet_tpu_torch.smoke_compare import summarize

    by_name = {"gated_sum_backward_kernel": [6.0, 0.016], "mul_kernel": [35.0, 0.099]}
    lines = [json.dumps({"phase": "profile_train", "device_ms_per_step_total": 10.9,
                         "kernel_launches_per_step": 2391.0, "kernels_by_name": by_name}),
             json.dumps({"phase": "profile", "device_ms_per_batch_total": 1.93})]
    got = summarize(lines)
    assert got["profile_train"]["kernel_launches_per_step"] == 2391.0
    assert got["profile_train"]["kernels_by_name"] == by_name
    assert got["profile_train"]["device_ms_per_step_total"] == 10.9
    assert got["profile"] == {"device_ms_per_batch_total": 1.93, "sbf_launches": []}
