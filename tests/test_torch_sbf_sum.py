"""Kernel B summed by center edge (``sbf_modulate(..., out_groups=...)``) on
CPU tensors, where the wrapper runs its plain version forward and PyTorch's
autograd backward, against the JAX package's fused sbf gather
(pamnet_tpu/models/layers.py _fused_sbf_gather) followed by the segment sum
at the center edges that its local layer takes (:324-332), and its
``jax.grad``, on the same numpy inputs; and the folded local layer's call.

Tolerances: outputs rtol 1e-5 / atol 1e-5 (the same f32 operations, summed
over up to 60 triplets in another order); each gradient
``max|d| <= 1e-5 * max|g_jax|`` plus 1e-7 absolute; ``gradcheck`` in
float64 at its defaults.
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
from pamnet_tpu_torch.ops.sbf_modulate import sbf_modulate, sbf_modulate_plain
from pamnet_tpu_torch.ops.triplet import Groups

GRAD_NAMES = ("proj", "m", "bias", "w1", "b1", "w2", "b2")
GRAD_AT = (0, 1, 3, 4, 5, 6, 7)  # their places among sbf_modulate's arguments


def _inputs(rng, d, layout, ns=7, edges=120, triplets=1024, padded=100):
    """Numpy inputs with a padded tail (index 0, mask 0, center edge 0) and
    sorted center edges over the valid triplets: ``random`` over 400
    center edges, ``long`` with
    center edge 6 holding 60 triplets; the odd center edges are empty."""
    f32 = np.float32
    bound = 1.0 / np.sqrt(d)
    valid = triplets - padded
    num_out = 400 if layout == "random" else 90
    ids = 2 * rng.integers(0, num_out // 2, valid)  # the odd center edges hold none
    if layout == "long":
        ids[:60] = 6
    ids = np.sort(ids).astype(np.int32)
    idx = rng.integers(0, edges, triplets).astype(np.int32)
    idx[valid:] = 0
    mask = (np.arange(triplets) < valid).astype(f32)
    mask[3:triplets:17] = 0.0  # masked triplets inside the valid ones
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
        idx=idx, mask=mask,
        ids=np.concatenate([ids, np.zeros(padded, np.int32)]),
        off=np.searchsorted(ids, np.arange(num_out + 1)).astype(np.int32),
        cot=rng.standard_normal((num_out, d)).astype(f32),
        valid=valid,
    )


def _port_args(x, dtype=torch.float32):
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return [t(x["proj"]), t(x["m"]), t(x["cbf"]), t(x["bias"]),
            t(np.ascontiguousarray(x["w1"].T)), t(x["b1"]),
            t(np.ascontiguousarray(x["w2"].T)), t(x["b2"]), torch.from_numpy(x["idx"]),
            t(x["mask"])]


def _groups(x) -> Groups:
    perm, poff = build_perm_np(x["idx"], x["valid"], x["m"].shape[0], x["idx"].shape[0])
    return Groups(torch.from_numpy(poff), torch.from_numpy(perm), x["valid"])


def _out_groups(x) -> Groups:
    return Groups(torch.from_numpy(x["off"]), None, x["valid"])


def _jax_summed(j, num_out):
    p = {"mlp_sbf": [{"w": j["w1"], "b": j["b1"]}, {"w": j["w2"], "b": j["b2"]}]}
    rows = _fused_sbf_gather(p, j["m"], FoldedSBF(j["proj"], j["cbf"], j["bias"]),
                             j["idx"], j["mask"])
    return jax.ops.segment_sum(rows, j["ids"], num_segments=num_out)


def _jax(x):
    return {k: jnp.asarray(v) for k, v in x.items() if k not in ("valid", "off")}


@pytest.mark.parametrize("layout", ["random", "long"])
@pytest.mark.parametrize("d", [16, 8])
def test_summed_op_matches_fused_sbf_gather_and_segment_sum(d, layout):
    x = _inputs(np.random.default_rng(d), d, layout)
    num_out = x["off"].shape[0] - 1
    want = np.asarray(_jax_summed(_jax(x), num_out))
    got = sbf_modulate(*_port_args(x), out_groups=_out_groups(x)).numpy()
    assert got.shape == (num_out, d)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    empty = x["off"][1:] == x["off"][:-1]
    assert empty.any() and np.all(got[empty] == 0.0)
    assert np.diff(x["off"]).max() > 32 or layout == "random"


@pytest.mark.parametrize("layout", ["random", "long"])
@pytest.mark.parametrize("d", [16, 8])
def test_summed_gradients_match_jax_grad(d, layout):
    x = _inputs(np.random.default_rng(100 + d), d, layout)
    j = _jax(x)
    num_out = x["off"].shape[0] - 1

    def loss(proj, m, bias, w1, b1, w2, b2):
        out = _jax_summed(dict(j, proj=proj, m=m, bias=bias, w1=w1, b1=b1, w2=w2, b2=b2),
                          num_out)
        return jnp.sum(out * j["cot"])

    want = jax.grad(loss, argnums=tuple(range(7)))(*(j[k] for k in GRAD_NAMES))
    args = _port_args(x)
    for i in GRAD_AT:
        args[i].requires_grad_()
    out = sbf_modulate(*args, groups=_groups(x), out_groups=_out_groups(x),
                       out_ids=torch.from_numpy(x["ids"]))
    (out * torch.from_numpy(x["cot"])).sum().backward()
    for name, i, w in zip(GRAD_NAMES, GRAD_AT, want):
        w = np.asarray(w).T if name in ("w1", "w2") else np.asarray(w)
        err = np.abs(args[i].grad.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-7, f"{name}: {err:.3g}"


@pytest.mark.parametrize("d", [16, 8])
def test_identity_groups_give_the_rows_exactly(d):
    x = _inputs(np.random.default_rng(7 + d), d, "random")
    args = _port_args(x)
    t = x["idx"].shape[0]
    identity = Groups(torch.arange(t + 1, dtype=torch.int32), None, t)
    np.testing.assert_array_equal(sbf_modulate(*args, out_groups=identity).numpy(),
                                  sbf_modulate(*args).numpy())


@pytest.mark.parametrize("ns,d", [(7, 16), (7, 8)])
def test_summed_plain_version_gradcheck(ns, d):
    rng = np.random.default_rng(9)
    x = _inputs(rng, d, "random", ns=ns, edges=4, triplets=12, padded=2)
    x["ids"] = np.array([0, 0, 0, 2, 2, 3, 3, 3, 3, 3, 0, 0], np.int32)
    x["off"] = np.array([0, 3, 3, 5, 10], np.int32)
    args = _port_args(x, torch.float64)
    for i in GRAD_AT:
        args[i].requires_grad_()
    groups, out_groups, ids = _groups(x), _out_groups(x), torch.from_numpy(x["ids"])

    def fn(*a):
        full = list(args)
        for i, v in zip(GRAD_AT, a):
            full[i] = v
        return sbf_modulate(*full, groups=groups, out_groups=out_groups, out_ids=ids)

    assert torch.autograd.gradcheck(fn, tuple(args[i] for i in GRAD_AT))


@pytest.mark.parametrize("fault", ["no groups", "no out_ids", "short out_ids",
                                   "total past the rows", "permuted center CSR"])
def test_summed_wrapper_raises_under_grad(fault):
    x = _inputs(np.random.default_rng(11), 16, "random", edges=10, triplets=40, padded=4)
    args = _port_args(x)
    args[5].requires_grad_()  # one weight is enough
    kw = dict(groups=_groups(x), out_groups=_out_groups(x), out_ids=torch.from_numpy(x["ids"]))
    match = {"no groups": "Groups", "no out_ids": "out_ids", "short out_ids": "out_ids",
             "total past the rows": "sorted CSR", "permuted center CSR": "sorted CSR"}[fault]
    if fault == "no groups":
        kw.pop("groups")
    elif fault == "no out_ids":
        kw.pop("out_ids")
    elif fault == "short out_ids":
        kw["out_ids"] = kw["out_ids"][:-1]
    elif fault == "total past the rows":
        kw["out_groups"] = kw["out_groups"]._replace(total=41)
    else:
        kw["out_groups"] = kw["groups"]
    with pytest.raises(ValueError, match=match):
        sbf_modulate(*args, **kw)


def test_summed_wrapper_without_grad_needs_no_backward_arrays():
    x = _inputs(np.random.default_rng(12), 8, "long", edges=10, triplets=80, padded=4)
    out = sbf_modulate(*_port_args(x), out_groups=_out_groups(x))
    np.testing.assert_array_equal(
        out.numpy(), sbf_modulate_plain(*_port_args(x), out_off=torch.from_numpy(x["off"])).numpy())
    with pytest.raises(ValueError, match="sorted CSR"):
        sbf_modulate(*_port_args(x), out_groups=_out_groups(x)._replace(total=None))


def _rna_batch():
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import synthetic_rna_dataset

    mols = synthetic_rna_dataset(2, seed=3, n_atoms=40)
    return next(iter(GraphLoader(mols, "rna", 2.6, 20.0, 2, build_perms=True)))


def test_batch_carries_the_center_edges_sorted_csr():
    gb = _rna_batch()
    for kind in ("t2", "t1"):
        grp = gb.groups(kind + "_ji")
        ids = getattr(gb, kind + "_ji")[:gb.valid[kind]].numpy()
        assert grp.perm is None and grp.total == gb.valid[kind]
        np.testing.assert_array_equal(
            grp.off.numpy(), np.searchsorted(ids, np.arange(gb.el_src.shape[0] + 1)))
        assert grp.longest == int(np.diff(grp.off.numpy()).max())


def test_local_mp_folded_branch_sums_in_kernel_b(monkeypatch):
    """The folded local layer calls kernel B once per stream with the center
    edges' CSR and ids, and sums no triplets with kernel A: its one
    aggregation is the el_dst sum (the global layer sums its messages at
    eg_src in the edge message itself)."""
    import pamnet_tpu_torch.models.layers as layers
    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.loop import batch_loss

    gb = _rna_batch()
    model = PAMNet(PAMNetConfig(dataset="rna_train", dim=16, n_layer=1, cutoff_l=2.6,
                                cutoff_g=20.0, flow="target_to_source"))
    assert model.fold_sbf()
    calls, sums = [], []
    monkeypatch.setattr(layers, "sbf_modulate",
                        lambda *a, **k: calls.append(k) or sbf_modulate(*a, **k))
    agg = layers.aggregate
    monkeypatch.setattr(layers, "aggregate", lambda v, off, ids, *a, **k: sums.append(ids)
                        or agg(v, off, ids, *a, **k))
    batch_loss(model, gb, "smooth_l1").backward()
    assert len(calls) == 2 and all(k["out_groups"].perm is None for k in calls)
    assert calls[0]["out_ids"] is gb.t2_ji and calls[1]["out_ids"] is gb.t1_ji
    assert [k["out_groups"].total for k in calls] == [gb.valid["t2"], gb.valid["t1"]]
    assert len(sums) == 1 and sums[0] is gb.el_dst
    assert model.mlp_sbf2[0][0].weight.grad is not None


def test_smoke_compare_reads_kernel_b_cases():
    """The two-checkout comparison keeps kernel B's forward and backward
    cases, kernel A's sums over the triplets and their launches in a
    profiled scoring forward, apart from the group sums."""
    import json

    from pamnet_tpu_torch.smoke_compare import summarize

    fwd = {"case": "t2 fused folded gather, summed, batch", "d": 16, "device_ms": 0.07,
           "bound_ms": 0.04, "rows": 3}
    bwd = {"case": "t2 backward summed, d=8", "d": 8, "device_ms": 0.03,
           "worst_err_over_tolerance": 0.01}
    a_sum = {"case": "t2 sum (folded path)", "d": 16, "device_ms": 0.027}
    other = {"case": "sum by z (permuted CSR)", "d": 16, "device_ms": 0.002}
    launches = [{"name": "sbf_modulate_kernel<7, 16, true>(", "device_us": 70.0},
                {"name": "group_sum_cluster_kernel<true>(", "device_us": 7.7}]
    lines = [json.dumps({"phase": "kernels", "triplet_aggregate": [a_sum]}),
             json.dumps({"phase": "sbf_kernels", "sbf_modulate": [fwd]}),
             json.dumps({"phase": "rna_train_kernels", "sbf_modulate_backward": [bwd],
                         "group_sum_split": [other]}),
             json.dumps({"phase": "profile", "device_ms_per_batch_total": 1.8,
                         "port_kernel_launches": launches})]
    got = summarize(lines)
    assert [c["case"] for c in got["kernels_sbf"]] == ["t2 sum (folded path)"]
    assert got["sbf_kernels_sbf"] == [{"case": fwd["case"], "d": 16, "device_ms": 0.07,
                                       "bound_ms": 0.04}]
    assert [c["case"] for c in got["rna_train_kernels_sbf"]] == [bwd["case"]]
    assert [c["case"] for c in got["rna_train_kernels"]] == [other["case"]]
    assert got["profile"] == {"device_ms_per_batch_total": 1.8, "sbf_launches": launches[:1]}


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("value_bytes,per_triplet", [(4, 40), (2, 24)])
def test_backward_bound_counts_the_words_the_kernel_reads(value_bytes, per_triplet):
    """Kernel B's backward reads per triplet its basis row and mask, its
    place in the neighbour edge's CSR and its center edge (NS=7; the rows
    are the sums over identity groups, so it reads a center edge there too):
    40 bytes in float32, 24 in bfloat16, on top of the edge rows, G and the
    weights, each float value at ``value_bytes``."""
    bytes_of = _chip_smoke().sbf_backward_bytes
    args = dict(ns=7, d=16, edges=50, edges_read=30, g_rows_read=20, value_bytes=value_bytes)
    one, one_gathered = bytes_of(valid=100, **args)
    two, two_gathered = bytes_of(valid=101, **args)
    assert two - one == per_triplet
    assert two_gathered - one_gathered == per_triplet + 8 * 16 * value_bytes
    assert one_gathered - one == (100 - 30) * 8 * 16 * value_bytes


def test_kernel_b_compare_cases_compute_one_function():
    """The two-checkout comparison's cases on a small scoring batch: the
    parent's folded path (rows, then kernel A's sum by center edge) and the
    summed op give the same sums; a difference past 1e-4 + 1e-4|x| shows."""
    from pamnet_tpu_torch.kernel_b_compare import cases, export_batch, max_excess

    batch = export_batch(2, 60, 0)
    sums = {}
    for kind in ("t2", "t1"):
        trip = batch[kind]
        assert int(trip["off"][-1]) == trip["valid"] and trip["valid"] > 0
        assert float(trip["mask"][trip["valid"]:].abs().sum()) == 0.0
        fns = cases(batch, kind, torch.Generator().manual_seed(0), "cpu")
        assert list(fns) == ["rows + sum", "summed"]
        for name, fn in fns.items():
            sums[f"{kind} {name}"] = fn()
        assert sums[f"{kind} summed"].shape == (batch["el"], 16)
        torch.testing.assert_close(sums[f"{kind} summed"], sums[f"{kind} rows + sum"],
                                   rtol=1e-5, atol=1e-5)
    assert max_excess(sums, sums) == 0.0
    off = {k: v + 2e-4 if k == "t1 summed" else v for k, v in sums.items()}
    assert max_excess(off, sums) > 1.0
