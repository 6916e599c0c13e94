"""The global message summed by the node it goes to
(``edge_message(..., out_groups=)``) and the host side of the CSR walk that
computes it and every kernel A sum, on CPU tensors, where the port takes its
plain versions: against the JAX package's message and segment sum of
``global_mp`` (``pamnet_tpu/models/layers.py:224-228``) and their
``jax.grad`` on the same numpy inputs, on the sorted CSRs of a small QM9 and
a small RNA batch in both flows; ``GlobalMP``'s fold against the rows +
``aggregate`` it replaces; the team shape at every CSR of a QM9, an RNA
batch-8 and a scoring batch-16 batch; the launches of a training step.

Tolerances: sums rtol 1e-5 / atol 1e-5 (the same f32 operations, summed over
up to ~100 edges a node in another order); each gradient within
1e-5 * max|g_jax| + 1e-6; ``gradcheck`` in float64 at its defaults.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pamnet_tpu import nn as jnn
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset, synthetic_rna_dataset
from pamnet_tpu_torch.models import layers
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.ops import gather as gather_ops
from pamnet_tpu_torch.ops.gather import edge_message, edge_message_plain
from pamnet_tpu_torch.ops.triplet import Groups, walk_shape
from pamnet_tpu_torch.train.loop import batch_loss

FLOWS = ("source_to_target", "target_to_source")
GRAD_NAMES = ("xi", "xj", "base", "gate")


@functools.lru_cache(maxsize=None)
def _batch(kind: str):
    """A small training batch with the backward's CSRs: QM9 (32 molecules)
    or RNA (2 structures of 60 atoms)."""
    if kind == "qm9":
        return next(iter(GraphLoader(synthetic_qm9_dataset(32, seed=4), "qm9", 5.0, 5.0, 32,
                                     build_perms=True)))
    return next(iter(GraphLoader(synthetic_rna_dataset(2, seed=5, n_atoms=60), "rna", 2.6,
                                 20.0, 2, build_perms=True)))


@functools.lru_cache(maxsize=None)
def _scoring_batches():
    """An RNA training batch of 8 and a scoring batch of 16 structures (120
    atoms each, at the loaders' pads)."""
    mols = synthetic_rna_dataset(16, seed=6, n_atoms=120)
    return {"rna batch-8": next(iter(GraphLoader(mols[:8], "rna", 2.6, 20.0, 8,
                                                 build_perms=True))),
            "scoring batch-16": next(iter(GraphLoader(mols, "rna", 2.6, 20.0, 16,
                                                      ladder_pads=True)))}


def _keys(flow):
    return ("eg_dst", "eg_src") if flow == "source_to_target" else ("eg_src", "eg_dst")


def _inputs(kind: str, flow: str, d: int = 16):
    """The batch's global edges sorted by ``i`` (its own order and CSR where
    the batch holds them sorted; else a stable sort of the valid edges,
    padded ones last) and numpy inputs drawn from a seed."""
    gb = _batch(kind)
    i_key, j_key = _keys(flow)
    i, j = getattr(gb, i_key).numpy(), getattr(gb, j_key).numpy()
    mask, valid, n = gb.eg_mask.numpy(), gb.valid["eg"], gb.z.shape[0]
    own = getattr(gb, i_key + "_off")
    order = np.concatenate([np.argsort(i[:valid], kind="stable"), np.arange(valid, len(i))])
    i, j, mask = i[order], j[order], mask[order]
    off = np.searchsorted(i[:valid], np.arange(n + 1)).astype(np.int32)
    if own is not None:
        np.testing.assert_array_equal(order, np.arange(len(order)))
        np.testing.assert_array_equal(own.numpy(), off)
    rng = np.random.default_rng(len(i) + d + len(flow))
    f32 = np.float32
    return dict(xi=rng.standard_normal((n, d)).astype(f32),
                xj=rng.standard_normal((n, d)).astype(f32),
                base=rng.standard_normal((len(i), d)).astype(f32),
                gate=rng.standard_normal((len(i), d)).astype(f32),
                cot=rng.standard_normal((n, d)).astype(f32),
                i=i.astype(np.int32), j=j.astype(np.int32), mask=mask, off=off,
                valid=valid)


def _jax_summed(x, xi, xj, base, gate):
    """global_mp's message and its segment sum at i (layers.py:224-228)."""
    m = jnn.silu(xi[x["i"]] + xj[x["j"]] + base)
    m = m * gate * jnp.asarray(x["mask"])[:, None]
    return jax.ops.segment_sum(m, x["i"], num_segments=x["xi"].shape[0])


def _out_groups(x) -> Groups:
    return Groups(torch.from_numpy(x["off"]), None, x["valid"])


@pytest.mark.parametrize("flow", FLOWS)
@pytest.mark.parametrize("kind", ["qm9", "rna"])
def test_summed_message_matches_global_mp_message_and_segment_sum(kind, flow):
    x = _inputs(kind, flow)
    jx = {k: jnp.asarray(x[k]) for k in GRAD_NAMES}
    want, vjp = jax.vjp(lambda *a: _jax_summed(x, *a), *(jx[k] for k in GRAD_NAMES))
    want_grads = vjp(jnp.asarray(x["cot"]))
    leaves = [torch.from_numpy(x[k]).requires_grad_() for k in GRAD_NAMES]
    got = edge_message(leaves[0], leaves[1], torch.from_numpy(x["i"]), torch.from_numpy(x["j"]),
                       leaves[2], leaves[3], torch.from_numpy(x["mask"]),
                       out_groups=_out_groups(x))
    assert got.shape == x["xi"].shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    (got * torch.from_numpy(x["cot"])).sum().backward()
    for name, leaf, w in zip(GRAD_NAMES, leaves, want_grads):
        w = np.asarray(w)
        err = np.abs(leaf.grad.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-6, f"{name}: {err:.3g}"
    # Rows past the CSR's valid count enter no sum and take no gradient.
    assert not leaves[2].grad[x["valid"]:].any()


def test_both_batches_hold_their_flows_key_sorted():
    """Every loader batch sorts its global edges by the key its dataset's
    flow sums at (QM9: eg_dst, source_to_target; RNA: eg_src,
    target_to_source), so the global layer always takes the fold there."""
    assert _batch("qm9").eg_dst_off is not None
    assert _batch("rna").eg_src_off is not None


@pytest.mark.parametrize("gated", [True, False])
def test_identity_groups_give_the_rows_exactly(gated):
    x = _inputs("rna", "target_to_source")
    rows = x["i"].shape[0]
    args = (torch.from_numpy(x["base"][:300]), torch.from_numpy(x["xj"]),
            torch.arange(300, dtype=torch.int32), torch.from_numpy(x["j"][:300]),
            torch.from_numpy(x["base"][:300]),
            torch.from_numpy(x["gate"][:300]) if gated else None,
            torch.from_numpy(x["mask"][:300]) if gated else None)
    identity = Groups(torch.arange(301, dtype=torch.int32), None, 300)
    assert rows > 300
    np.testing.assert_array_equal(edge_message(*args, out_groups=identity).numpy(),
                                  edge_message(*args).numpy())


def test_summed_plain_version_gradcheck():
    rng = np.random.default_rng(3)
    n, rows, d = 5, 12, 4
    i = np.array([0, 0, 0, 2, 2, 3, 3, 3, 3, 3, 0, 0], np.int32)  # 2 padded rows
    off = torch.tensor([0, 3, 3, 5, 10, 10], dtype=torch.int32)
    j = torch.from_numpy(rng.integers(0, n, rows).astype(np.int32))
    mask = torch.tensor([1.0] * 10 + [0.0] * 2, dtype=torch.float64)
    leaves = [torch.from_numpy(rng.standard_normal(s)).requires_grad_()
              for s in ((n, d), (n, d), (rows, d), (rows, d))]
    groups = Groups(off, None, 10)

    def fn(xi, xj, base, gate):
        return edge_message(xi, xj, torch.from_numpy(i), j, base, gate, mask,
                            out_groups=groups)

    assert torch.autograd.gradcheck(fn, tuple(leaves))


@pytest.mark.parametrize("fault", ["permuted CSR", "no total", "total past the rows",
                                   "group per row of xi"])
def test_summed_message_raises_on_a_csr_it_cannot_walk(fault):
    x = _inputs("rna", "target_to_source")
    groups = _out_groups(x)
    if fault == "permuted CSR":
        groups = groups._replace(perm=torch.arange(x["i"].shape[0], dtype=torch.int32))
    elif fault == "no total":
        groups = groups._replace(total=None)
    elif fault == "total past the rows":
        groups = groups._replace(total=x["i"].shape[0] + 1)
    else:
        groups = groups._replace(off=groups.off[:-1])
    t = {k: torch.from_numpy(x[k]) for k in ("xi", "xj", "i", "j", "base", "gate", "mask")}
    with pytest.raises(ValueError, match="sorted CSR of i"):
        edge_message(t["xi"], t["xj"], t["i"], t["j"], t["base"], t["gate"], t["mask"],
                     out_groups=groups)
    with pytest.raises(ValueError, match="sorted CSR of i"):
        gather_ops.edge_message_sum(t["xi"], t["xj"], t["i"], t["j"], t["base"], t["gate"],
                                    t["mask"], groups)


def _rows_and_aggregate(layer, x, edge_attr, g, flow):
    """GlobalMP's forward as it was without the fold: the (E, D) messages,
    then kernel A's sum at i with its backward arrays."""
    res_x = x
    x = layer.mlp_x1(x)
    i_key, j_key = _keys(flow)
    i_idx, j_idx = getattr(g, i_key), getattr(g, j_key)
    m = layers._edge_message(layer.mlp_m, x, edge_attr, i_idx, j_idx,
                             layer.W_edge_attr(edge_attr), g.eg_mask, False,
                             g.groups(i_key), g.groups(j_key))
    x = x + layers.aggregate(m, getattr(g, i_key + "_off"), i_idx, g.eg_mask, x.shape[0],
                             total=g.valid["eg"])
    x = layer.mlp_x2(x)
    x = layer.res1(x) + res_x
    x = layer.res3(layer.res2(x))
    out = layer.mlp_out(x)
    return x, layer.W_out(out), out @ layer.W


@pytest.mark.parametrize("kind,flow", [("qm9", "source_to_target"),
                                       ("rna", "target_to_source")])
def test_global_mp_fold_matches_rows_and_aggregate(kind, flow):
    """The folded layer against the rows + sum it replaces: outputs and
    every parameter's gradient."""
    gb = _batch(kind)
    d = 16
    torch.manual_seed(0)
    layer = layers.GlobalMP(d)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.3)
    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.standard_normal((gb.z.shape[0], d)).astype(np.float32))
    e0 = torch.from_numpy(rng.standard_normal((gb.eg_src.shape[0], d)).astype(np.float32))
    results = []
    for fn in (lambda: layer(x0, e0, gb, flow), lambda: _rows_and_aggregate(layer, x0, e0, gb,
                                                                             flow)):
        layer.zero_grad()
        outs = fn()
        sum(o.sum() * (k + 1) for k, o in enumerate(outs)).backward()
        results.append(([o.detach() for o in outs],
                        {n: p.grad.clone() for n, p in layer.named_parameters()}))
    (fold, g_fold), (rows, g_rows) = results
    for a, b in zip(fold, rows):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for name, want in g_rows.items():
        err = float((g_fold[name] - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()) + 1e-6, name


def test_global_mp_takes_rows_and_aggregate_where_the_key_is_not_sorted(monkeypatch):
    """Summed where the batch's edges are sorted by i; the argsort route
    (an RNA batch in the source_to_target flow, eg_dst unsorted) keeps the
    rows + aggregate, and both give the same sums."""
    gb = _batch("rna")
    assert gb.eg_dst_off is None
    calls = []
    monkeypatch.setattr(layers, "edge_message",
                        lambda *a, **k: calls.append(k.get("out_groups")) or edge_message(*a, **k))
    layer = layers.GlobalMP(16)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x0 = torch.randn(gb.z.shape[0], 16)
    e0 = torch.randn(gb.eg_src.shape[0], 16)
    with torch.no_grad():
        layer(x0, e0, gb, "target_to_source")
        layer(x0, e0, gb, "source_to_target")
    assert calls[0] is not None and calls[0].perm is None and calls[0].off is gb.eg_src_off
    assert calls[1] is None


@pytest.mark.parametrize("d", [4, 8, 12, 16, 64, 128])
def test_walk_shape_at_every_csr_of_the_batches(d):
    """At every CSR of a QM9, an RNA batch-8 and a scoring batch-16 batch
    (sorted offsets and permuted ones, by each host-known valid count), the
    team fits a warp or whole warps of a block (its size divides 32 or is a
    multiple of 32 dividing 256), lanes and slots are powers of two, the
    lanes cover D/4 columns up to a warp, and the shape is a function of the
    input alone."""
    batches = {"qm9": _batch("qm9"), **_scoring_batches()}
    seen = set()
    for name, gb in batches.items():
        keys = [k[:-4] for k in vars(gb) if k.endswith("_off") and getattr(gb, k) is not None]
        keys += [k[:-5] for k in gb.perms if k.endswith("_poff")]
        assert keys, name
        for key in keys:
            groups = gb.groups(key)
            num_out = groups.off.shape[0] - 1
            lanes, slots = walk_shape(d, num_out, groups.total)
            team = lanes * slots
            assert (32 % team == 0 or team % 32 == 0) and 256 % team == 0, (name, key, team)
            assert lanes & (lanes - 1) == 0 and slots & (slots - 1) == 0
            assert lanes >= min(32, -(-d // 4)) and lanes < 2 * max(1, -(-d // 4))
            assert walk_shape(d, num_out, groups.total) == (lanes, slots)
            seen.add((name, key))
    assert ("scoring batch-16", "eg_src") in seen and ("rna batch-8", "eg_dst") in seen


def test_walk_shape_follows_the_mean_group():
    """Slots give each about 4 rows of the mean group, within two waves of
    the card's threads: 8 (two warps a row) at the RNA batch-8 global sums
    (D=16, ~49 rows a node, 16,896 nodes), 2 at the scoring batch's (34,304
    nodes) and at the el sums (~5 rows); at D=128 (QM9, ~12 rows) 4 warps
    of 32 lanes; an unknown valid count takes one slot."""
    assert walk_shape(16, 16896, 823296) == (4, 8)
    assert walk_shape(16, 34304, 1675136) == (4, 2)
    assert walk_shape(16, 34304, 186368) == (4, 2)
    assert walk_shape(128, 1000, 12000) == (32, 4)
    assert walk_shape(12, 100, 5000) == (4, 16)
    assert walk_shape(16, 100, None) == (4, 1)
    assert walk_shape(256, 10, 100) == (32, 4)
    assert walk_shape(4, 1, 10**6) == (1, 256)


def _count_calls(monkeypatch):
    """Counts, by wrapper, the calls that launch a kernel on the card: kernel
    A's forward sums, the summed and the rows edge message, the row gathers
    and kernel A's backward routes (the fused role swap, the role swap
    alone, ``gather_product`` and the gated sum's backward)."""
    from pamnet_tpu_torch.ops import triplet

    counts = {"triplet_aggregate": 0, "summed": 0, "rows": 0, "row_gather": 0}
    msg = gather_ops.edge_message

    def counted(module, name, key=None):
        fn = getattr(module, name)

        def call(*a, **k):
            counts[key or name] += 1
            return fn(*a, **k)

        counts.setdefault(key or name, 0)
        monkeypatch.setattr(module, name, call)

    def count_msg(*a, **k):
        counts["summed" if k.get("out_groups") is not None else "rows"] += 1
        return msg(*a, **k)

    monkeypatch.setattr(layers, "edge_message", count_msg)
    counted(layers, "triplet_aggregate")
    counted(gather_ops, "row_gather")
    for name in ("triplet_aggregate_grad_ab", "triplet_aggregate_grad_a", "gather_product",
                 "gated_sum_backward"):
        counted(triplet, name)
    return counts


@pytest.mark.parametrize("kind", ["qm9", "rna"])
def test_training_step_sums_the_global_message_in_the_edge_message(kind, monkeypatch):
    """A training step's calls: the global layer's message summed by node
    once a layer and no kernel A sum at the global edges, so kernel A's
    forward sums are the el_dst sum (and, unfolded, the two triplet sums);
    in the backward no row gather (the el_dst sum's two gradients are one
    gated backward a layer) and, unfolded, the fused role swap for each
    triplet sum, never the role swap alone nor ``gather_product``."""
    gb = _batch(kind)
    if kind == "qm9":
        cfg = PAMNetConfig(dataset="QM9", dim=32, n_layer=2, cutoff_l=5.0, cutoff_g=5.0)
        loss_kind, per_layer = "l1", 3
    else:
        cfg = PAMNetConfig(dataset="rna_train", dim=16, n_layer=1, cutoff_l=2.6,
                           cutoff_g=20.0, flow="target_to_source")
        loss_kind, per_layer = "smooth_l1", 1
    model = PAMNet(cfg, torch.Generator().manual_seed(0))
    assert model.fold_sbf() == (kind == "rna")
    counts = _count_calls(monkeypatch)
    loss = batch_loss(model, gb, loss_kind)
    forward = dict(counts)
    loss.backward()
    backward = {k: counts[k] - forward[k] for k in counts}
    assert forward == {"triplet_aggregate": per_layer * cfg.n_layer, "summed": cfg.n_layer,
                       "rows": 2 * cfg.n_layer, "row_gather": forward["row_gather"],
                       "triplet_aggregate_grad_ab": 0, "triplet_aggregate_grad_a": 0,
                       "gather_product": 0, "gated_sum_backward": 0}
    assert backward == {"triplet_aggregate": 0, "summed": 0, "rows": 0, "row_gather": 0,
                        "triplet_aggregate_grad_ab": (per_layer - 1) * cfg.n_layer,
                        "triplet_aggregate_grad_a": 0, "gather_product": 0,
                        "gated_sum_backward": cfg.n_layer}


def test_plain_route_sums_the_same_function():
    """``plain=True`` (the reference route on the card) gives the folded
    layer's output with the plain summed message."""
    gb = _batch("rna")
    layer = layers.GlobalMP(16)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x0 = torch.randn(gb.z.shape[0], 16)
    e0 = torch.randn(gb.eg_src.shape[0], 16)
    with torch.no_grad():
        got = layer(x0, e0, gb, "target_to_source")
        want = layer(x0, e0, gb, "target_to_source", plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_edge_message_plain_sum_is_rows_then_kernel_a_plain_sum():
    x = _inputs("qm9", "source_to_target")
    t = {k: torch.from_numpy(x[k]) for k in ("xi", "xj", "i", "j", "base", "gate", "mask")}
    args = (t["xi"], t["xj"], t["i"], t["j"], t["base"], t["gate"], t["mask"])
    from pamnet_tpu_torch.ops.triplet import triplet_aggregate_plain

    off = torch.from_numpy(x["off"])
    assert torch.equal(edge_message_plain(*args, out_off=off),
                       triplet_aggregate_plain(edge_message_plain(*args), off))
