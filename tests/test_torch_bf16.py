"""The port's bfloat16 mixed precision (``compute_dtype="bfloat16"``) against
the JAX package's on the same inputs, and the float32 accumulation of its
plain sums.

JAX's own bfloat16 drift from its float32 run, on the CPU at the QM9 cases
below: predictions 0.14-0.40% of max|pred| apart, the worst gradient per
tensor 1.5-1.6% of its max|g|.  The port is held to JAX's bfloat16 run at
about 2.5x that: predictions within ``1e-2 * max|pred|``, gradients per
tensor within ``4e-2 * max|g| + 1e-6``; against its own float32 forward
within rtol 3e-2 (``tests/test_bf16.py``'s bound for JAX).

PDBbind's signed pool (E(complex) - E(pocket) - E(ligand) over copies of the
same atoms) cancels: at dim 8, 2 layers JAX's own bfloat16 run lies 9% of
max|pred| and up to 38x the gradient limit from its float32 run (a head's
bias up to ~350x), so per tensor two bfloat16 runs differ by their rounding
noise there.  The signed batch is held to JAX's float32 run as a whole: its
predictions no farther than JAX's bfloat16 ones (or the limit above), its
gradient (every tensor as one vector) no farther than JAX's bfloat16
gradient.  Per tensor, the same complexes are held with their three copies
as graphs of their own (no cancellation): each tensor within
``4e-2 * max|g| + 1e-6`` or twice JAX's own bfloat16 distance on that tensor
of JAX's float32 run; the signed batch's predictions are the copies' in
float32, E(complex) - E(pocket) - E(ligand).

The plain sums accumulate in float32 and round once, so a 100k-row bfloat16
group stays within 8e-3 of the float64 sum (a bfloat16 running sum stalls
past ~256); their gathers' backward sums in float32 too, and on the CPU the
plain route rounds where the kernel route does.
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

from pamnet_tpu.config import PAMNetConfig as JaxConfig
from pamnet_tpu.data.loader import GraphLoader as JaxLoader
from pamnet_tpu.models import apply_pamnet, init_pamnet
from pamnet_tpu.train import loop as jloop
from pamnet_tpu_torch import bench, main_pdbbind, main_qm9, main_rna_puzzles, serve
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data import synthetic as tsyn
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.nn import Linear, cast_parameters
from pamnet_tpu_torch.ops.gather import edge_message_plain, row_gather_plain
from pamnet_tpu_torch.ops.triplet import (Groups, gated_sum_backward_plain, group_sum_plain,
                                          triplet_aggregate_grad_ab_plain,
                                          triplet_aggregate_plain)
from pamnet_tpu_torch.train.checkpoint import load_checkpoint
from pamnet_tpu_torch.train.loop import Optimizer, batch_loss
from pamnet_tpu_torch.weights import from_jax_params

BF16 = torch.bfloat16
N_ROWS = 100_000


def _one_group(rng):
    """(values, f64 sum) of one group of ``N_ROWS`` bfloat16 rows of 4
    columns in [0.5, 1.5]."""
    vals = torch.from_numpy(rng.uniform(0.5, 1.5, size=(N_ROWS, 4)).astype(np.float32)).to(BF16)
    return vals, vals.double().sum(0)


def _sum_of(route: str, vals: torch.Tensor, rng) -> torch.Tensor:
    off = torch.tensor([0, N_ROWS], dtype=torch.int32)
    if route == "triplet_aggregate":
        return triplet_aggregate_plain(vals, off)
    if route == "group_sum":  # rows gathered through a permutation
        perm = torch.from_numpy(rng.permutation(N_ROWS).astype(np.int32))
        return group_sum_plain(vals, Groups(off, perm, N_ROWS))
    if route == "grad_ab":  # the fused role swap's d_a: every row gathers row 0
        perm = torch.arange(N_ROWS, dtype=torch.int32)
        ones = torch.ones(1, 4, dtype=BF16)
        d_a, _ = triplet_aggregate_grad_ab_plain(
            ones, Groups(off, perm, N_ROWS), torch.zeros(N_ROWS, dtype=torch.int32), vals,
            ones)
        return d_a
    # The global message summed by node: silu(base) of one node's rows.
    zeros = torch.zeros(1, 4, dtype=BF16)
    idx = torch.zeros(N_ROWS, dtype=torch.int32)
    return edge_message_plain(zeros, zeros, idx, idx, vals, out_off=off)


def _gathered_100k_times(route: str, src: torch.Tensor) -> torch.Tensor:
    idx = torch.zeros(N_ROWS, dtype=torch.int32)
    if route == "row_gather":
        return row_gather_plain(src, idx)
    if route == "triplet_aggregate":  # every row gathers row 0, one row per group
        return triplet_aggregate_plain(src, torch.arange(N_ROWS + 1, dtype=torch.int32), idx)
    zeros = torch.zeros(1, 4, dtype=BF16)
    return edge_message_plain(src, zeros, idx, idx, torch.zeros(N_ROWS, 4, dtype=BF16))


@pytest.mark.parametrize("route", ["row_gather", "triplet_aggregate", "edge_message"])
def test_plain_gather_backward_sums_in_f32(route):
    """A bfloat16 row gathered 100k times: its gradient, summed over the
    uses, that of 100k uses (rounded once), not the ~256 at which a bfloat16
    running sum stalls (the message's: 100k * silu'(0.5))."""
    src = torch.full((1, 4), 0.5, dtype=BF16, requires_grad=True)
    out = _gathered_100k_times(route, src)
    assert out.dtype == BF16
    out.backward(torch.ones_like(out))
    assert src.grad.dtype == BF16
    s = torch.sigmoid(torch.tensor(0.5, dtype=torch.float64))
    want = N_ROWS * (s * (1 + 0.5 * (1 - s)) if route == "edge_message" else 1.0)
    rel = ((src.grad.double() - want).abs() / want).max()
    assert rel < 8e-3, (src.grad, want)


@pytest.mark.parametrize("route", ["triplet_aggregate", "group_sum", "grad_ab",
                                   "edge_message_sum"])
def test_plain_sums_accumulate_in_f32(route):
    rng = np.random.default_rng(0)
    vals, exact = _one_group(rng)
    if route == "edge_message_sum":
        exact = torch.nn.functional.silu(vals.double()).sum(0)
    got = _sum_of(route, vals, rng)
    assert got.dtype == BF16 and got.shape == (1, 4)
    rel = ((got[0].double() - exact).abs() / exact).max()
    assert rel < 8e-3, rel


def test_gated_backward_plain_rounds_each_product_once():
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32)).to(BF16)
            for _ in range(2))
    g = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32)).to(BF16)
    seg = torch.from_numpy(rng.integers(0, 5, 64).astype(np.int32))
    d_a, d_b = gated_sum_backward_plain(a, b, g, seg, 60)
    assert d_a.dtype == d_b.dtype == BF16
    gs = g.double()[seg.long()]
    assert torch.equal(d_a[:60], (gs * b.double())[:60].to(BF16))
    assert torch.equal(d_b[:60], (a.double() * gs)[:60].to(BF16))
    assert not d_a[60:].any() and not d_b[60:].any()


def test_linear_follows_the_input_type_with_f32_gradients():
    gen = torch.Generator().manual_seed(0)
    lin = Linear(8, 4)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(4, 8, generator=gen))
        lin.bias.copy_(torch.randn(4, generator=gen))
    x = torch.randn(5, 8, generator=gen).to(BF16)
    y = lin(x)
    assert y.dtype == BF16 and lin.weight.dtype == torch.float32
    y.float().square().sum().backward()
    per_use = {n: p.grad.clone() for n, p in lin.named_parameters()}
    assert all(g.dtype == torch.float32 for g in per_use.values())
    want = torch.nn.functional.linear(x, lin.weight.detach().to(BF16), lin.bias.detach().to(BF16))
    assert torch.equal(y, want)
    # One batched cast gives the same values and gradients as a cast a use.
    lin.zero_grad()
    with cast_parameters(list(lin.parameters()), BF16):
        y_batched = lin(x)
    y_batched.float().square().sum().backward()
    assert torch.equal(y_batched, y)
    for n, p in lin.named_parameters():
        assert p.grad.dtype == torch.float32 and torch.equal(p.grad, per_use[n]), n


def test_folded_shape_at_bf16_raises_and_never_unfolds():
    """Kernel B has a bfloat16 version: a bfloat16 model folds exactly where
    a float32 one does, at ``KERNEL_SHAPES`` (7, 16) and (7, 8), as JAX's
    folds in either type, and never changes route on its own: it unfolds on
    request (``fold_sbf=False``) and never folds at an unbuilt width (dim
    32).  A compute type other than float32 and bfloat16 raises."""
    rna = dict(dataset="rna_serve", n_layer=1, cutoff_l=2.6, cutoff_g=20.0)
    for dim in (16, 8):
        cfg = PAMNetConfig(**rna, dim=dim, compute_dtype="bfloat16")
        assert cfg.folds() and PAMNet(cfg).fold_sbf() and cfg.dtype == BF16
        assert PAMNetConfig(**rna, dim=dim).folds()
        cfg = PAMNetConfig(**rna, dim=dim, fold_sbf=False, compute_dtype="bfloat16")
        assert not PAMNet(cfg).fold_sbf() and cfg.dtype == BF16  # unfolded on request
    assert not PAMNet(PAMNetConfig(**rna, dim=32, compute_dtype="bfloat16")).fold_sbf()
    assert PAMNetConfig(dataset="QM9", dim=128, n_layer=1, fold_sbf=True,
                        compute_dtype="bfloat16").folds()  # forced, as in float32
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        PAMNetConfig(compute_dtype="float16")
    assert serve.build_parser().parse_args(
        ["--seed", "0", "--compute_dtype", "bfloat16"]).compute_dtype == "bfloat16"


def test_driver_compute_dtype_defaults_follow_jax():
    """main_qm9.py:80 bfloat16; main_pdbbind.py:58, main_rna_puzzles.py:96
    and serve_rna.py:213 float32; the bench's training lines bfloat16."""
    assert main_qm9.build_parser().parse_args([]).compute_dtype == "bfloat16"
    assert main_pdbbind.build_parser().parse_args([]).compute_dtype == "float32"
    assert main_rna_puzzles.build_parser().parse_args([]).compute_dtype == "float32"
    assert serve.build_parser().parse_args(["--seed", "0"]).compute_dtype == "float32"
    import inspect

    assert '"--dtype", choices=("bfloat16", "float32"), default="bfloat16"' in \
        inspect.getsource(bench.main)


# (branch, layers, dim, variant): the QM9 widths of JAX's drift measurement,
# both variants, and one unfolded RNA case (ns * dim > 128: JAX does not
# fold it either; the folded RNA cases are ``tests/test_torch_sbf_bf16.py``'s).
# The PDBbind case (dim 8) would fold: both packages run it unfolded
# (fold_sbf=False), the route its limits were set on.
CASES = [("qm9", 2, 32, "full"), ("qm9", 1, 128, "full"), ("qm9", 2, 32, "s"),
         ("qm9", 1, 128, "s"), ("rna", 1, 32, "full")]
_BRANCH = {"qm9": (dict(dataset="QM9", cutoff_l=5.0, cutoff_g=5.0), "l1"),
           "pdbbind": (dict(dataset="PDBbind", cutoff_l=2.0, cutoff_g=6.0, fold_sbf=False),
                       "mse"),
           "rna": (dict(dataset="rna_train", cutoff_l=2.6, cutoff_g=20.0,
                        flow="target_to_source"), "smooth_l1")}


def _copies(mol: dict) -> list[dict]:
    """A PDBbind graph's three subgraphs as graphs of their own, each at the
    complex's place (x <= 40 A, where the signed pool adds): the complex, the
    pocket (shifted back by 100 A) and the ligand (by 200 A)."""
    x = mol["pos"][:, 0]
    out = []
    for sel, shift in ((x <= 40.0, 0.0), ((x > 40.0) & (x <= 140.0), 100.0), (x > 140.0, 200.0)):
        pos = mol["pos"][sel].copy()
        pos[:, 0] -= shift
        out.append(dict(pos=pos, feat=mol["feat"][sel], y=mol["y"]))
    return out


def _mols(kind: str, seed: int, copies: bool = False):
    if kind == "qm9":
        return [dict(m, y=m["y"] / 10.0) for m in tsyn.synthetic_qm9_dataset(4, seed=seed)]
    if kind == "pdbbind":
        mols = [tsyn.pdbbind_molecule(g) for g in tsyn.synthetic_pdbbind_dataset(3, seed)]
        return [c for m in mols for c in _copies(m)] if copies else mols
    return tsyn.synthetic_rna_dataset(3, seed=seed, n_atoms=48)


@functools.lru_cache(maxsize=None)
def _reference(kind: str, n_layer: int, dim: int, variant: str, dtype: str = "bfloat16",
               copies: bool = False):
    """JAX params, the port's batch and bfloat16 config, and JAX's
    predictions and loss gradients in ``dtype`` on the same structures
    (``copies``: PDBbind's subgraphs as graphs of their own, one batch)."""
    extra, loss_kind = _BRANCH[kind]
    kw = dict(extra, dim=dim, n_layer=n_layer, variant=variant, compute_dtype=dtype)
    jcfg = JaxConfig(**kw)
    params = init_pamnet(jax.random.PRNGKey(n_layer + dim), jcfg)
    mols = _mols(kind, n_layer + dim, copies)
    loader_kind = "rna" if kind == "rna" else kind
    cut = (kw["cutoff_l"], kw["cutoff_g"])
    bs = max(4, len(mols))
    jb = next(iter(JaxLoader(mols, loader_kind, *cut, batch_size=bs, build_tables=False,
                             build_perms=True, variant=variant)))
    tb = next(iter(GraphLoader(mols, loader_kind, *cut, batch_size=bs, build_perms=True,
                               variant=variant)))

    def loss(p, g):
        pred = apply_pamnet(p, g, jcfg)
        total, count = jloop._loss_terms(pred, g.y, g.graph_mask, loss_kind)
        return total / jnp.maximum(count, 1.0), pred

    (_, pred), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, jb))
    cfg = PAMNetConfig(**{**kw, "compute_dtype": "bfloat16"})
    return params, tb, np.asarray(pred), from_jax_params(grads), cfg, loss_kind


def _model(params, cfg):
    model = PAMNet(cfg)
    model.load_state_dict(from_jax_params(params), strict=True)
    return model


def _port_run(params, tb, cfg, loss_kind):
    """The port's bfloat16 predictions and float32 parameter gradients."""
    model = _model(params, cfg)
    assert not model.fold_sbf()
    with torch.no_grad():
        pred = model(tb)
    assert pred.dtype == torch.float32 and bool(torch.isfinite(pred).all())
    model.zero_grad()
    batch_loss(model, tb, loss_kind).backward()
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in model.named_parameters()}
    assert all(g.dtype == torch.float32 for g in got.values())
    return pred.numpy(), got


@pytest.mark.parametrize("kind,n_layer,dim,variant", CASES)
def test_bf16_forward_and_gradients_match_jax(kind, n_layer, dim, variant):
    params, tb, want_pred, want, cfg, loss_kind = _reference(kind, n_layer, dim, variant)
    pred, got = _port_run(params, tb, cfg, loss_kind)
    np.testing.assert_allclose(pred, want_pred, rtol=0, atol=1e-2 * np.abs(want_pred).max())
    assert set(got) == set(want)
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        bound = 4e-2 * float(w.abs().max()) + 1e-6
        assert err <= bound, f"{name}: max|d| {err:.3g} > {bound:.3g}"


PDBBIND = ("pdbbind", 2, 8, "full")


def test_pdbbind_bf16_no_farther_from_f32_than_jax_bf16():
    """PDBbind's signed batch (dim 8, 2 layers, unfolded): the port's
    bfloat16 predictions and its gradient as one vector against JAX's
    float32 run, no farther from it than JAX's bfloat16 run (module
    docstring; per tensor: ``test_pdbbind_bf16_copies_per_tensor``)."""
    params, tb, b16_pred, b16, cfg, loss_kind = _reference(*PDBBIND)
    _, _, f32_pred, f32, _, _ = _reference(*PDBBIND, dtype="float32")
    pred, got = _port_run(params, tb, cfg, loss_kind)
    drift = np.abs(b16_pred - f32_pred).max()
    assert np.abs(pred - f32_pred).max() <= max(1e-2 * np.abs(f32_pred).max(), drift)

    def distance(grads):
        num = sum(float(((grads[n] - w).double() ** 2).sum()) for n, w in f32.items())
        return (num / sum(float((w.double() ** 2).sum()) for w in f32.values())) ** 0.5

    assert set(got) == set(f32)
    assert distance(got) <= distance(b16), (distance(got), distance(b16))


def test_pdbbind_bf16_copies_per_tensor():
    """The same complexes with their three copies as graphs of their own:
    the port's bfloat16 predictions and each parameter's gradient within
    ``1e-2 * max|pred|`` / ``4e-2 * max|g| + 1e-6`` of JAX's float32 run,
    or within twice JAX's own bfloat16 distance from it on that graph set /
    tensor; the signed batch's predictions are its copies' bfloat16 energies
    pooled in float32."""
    params, tb, b16_pred, b16, cfg, loss_kind = _reference(*PDBBIND, copies=True)
    _, _, f32_pred, f32, _, _ = _reference(*PDBBIND, dtype="float32", copies=True)
    pred, got = _port_run(params, tb, cfg, loss_kind)
    n = 9  # three complexes, three copies each
    assert np.abs(pred[:n] - f32_pred[:n]).max() <= max(
        1e-2 * np.abs(f32_pred[:n]).max(), 2 * np.abs(b16_pred[:n] - f32_pred[:n]).max())
    assert set(got) == set(f32)
    for name, w in f32.items():
        err = float((got[name] - w).abs().max())
        bound = max(4e-2 * float(w.abs().max()) + 1e-6, 2 * float((b16[name] - w).abs().max()))
        assert err <= bound, f"{name}: max|d| {err:.3g} > {bound:.3g}"
    signed_tb = _reference(*PDBBIND)[1]  # the same complexes, parameters from the same key
    with torch.no_grad():
        signed = _model(params, cfg)(signed_tb)[:3].double()
    energies = torch.from_numpy(pred[:n]).double().reshape(3, 3)
    pooled = energies[:, 0] - energies[:, 1] - energies[:, 2]
    assert torch.allclose(signed, pooled, rtol=0, atol=1e-5 * float(energies.abs().max())), (
        signed, pooled)


@pytest.mark.parametrize("kind,variant", [("qm9", "full"), ("qm9", "s"), ("pdbbind", "full"),
                                          ("rna", "full")])
def test_bf16_plain_route_rounds_where_the_kernel_route_does(kind, variant):
    """On the CPU the kernel route (the wrappers' plain forwards and their
    explicit backwards) and the plain route (PyTorch's autograd of the plain
    forwards) round to bfloat16 at the same places: bitwise equal
    predictions, and per tensor gradients within the card's kernel-vs-plain
    limit, ``2e-2 * max|g_plain| + 1e-6`` or twice the tensor's distance
    between the plain bfloat16 and float32 routes (they differ by the
    float32 order of the backward's sums)."""
    extra, loss_kind = _BRANCH[kind]
    extra = {k: v for k, v in extra.items() if k != "fold_sbf"}
    cfg = PAMNetConfig(**extra, dim=8, n_layer=2, variant=variant, fold_sbf=False,
                       compute_dtype="bfloat16")
    mols = _mols(kind, 5)
    loader_kind = "rna" if kind == "rna" else kind
    tb = next(iter(GraphLoader(mols, loader_kind, extra["cutoff_l"], extra["cutoff_g"],
                               batch_size=4, build_perms=True, variant=variant)))
    model = PAMNet(cfg, torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(model(tb), model(tb, plain=True))
    f32 = PAMNet(dataclasses.replace(cfg, compute_dtype="float32"))
    f32.load_state_dict(model.state_dict())
    grads = []
    for m, plain in ((model, False), (model, True), (f32, True)):
        m.zero_grad()
        batch_loss(m, tb, loss_kind, plain=plain).backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None})
    kernel, want, want32 = grads
    assert set(kernel) == set(want)
    for name, w in want.items():
        err = float((kernel[name] - w).abs().max())
        bound = max(2e-2 * float(w.abs().max()) + 1e-6,
                    2 * float((w - want32[name]).abs().max()))
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("variant", ["full", "s"])
def test_bf16_forward_close_to_f32(variant):
    """The port's bfloat16 forward against its float32 one, as
    ``tests/test_bf16.py`` bounds JAX's (dim 32, 2 layers, 6 molecules)."""
    mols = tsyn.synthetic_qm9_dataset(6, seed=99)
    tb = next(iter(GraphLoader(mols, "qm9", 5.0, 5.0, batch_size=6, variant=variant)))
    cfg = PAMNetConfig(dataset="QM9", dim=32, n_layer=2, variant=variant)
    f32 = PAMNet(cfg, torch.Generator().manual_seed(3))
    b16 = PAMNet(dataclasses.replace(cfg, compute_dtype="bfloat16"))
    b16.load_state_dict(f32.state_dict())
    with torch.no_grad():
        want, got = f32(tb)[:6].numpy(), b16(tb)[:6].numpy()
    np.testing.assert_allclose(got, want, rtol=3e-2)


def test_main_qm9_bf16_run_keeps_f32_state(capsys, tmp_path):
    """A run at the driver's default bfloat16 (dim 32, unfolded) checkpoints
    float32 parameters, EMA and Adam
    state, and a step of the restored model trains in bfloat16 into float32
    gradients.  Its resume bit for bit: ``tests/test_torch_checkpoint.py``."""
    main_qm9.main(["--synthetic", "--limit", "64", "--dim", "32", "--n_layer", "1",
                   "--epochs", "1", "--device", "cpu", "--save_dir", str(tmp_path)])
    capsys.readouterr()
    cfg = PAMNetConfig(dataset="QM9", dim=32, n_layer=1, compute_dtype="bfloat16")
    model = PAMNet(cfg)
    opt = Optimizer(model.parameters(), lambda step: 1e-4)
    ema = {k: v.clone() for k, v in model.state_dict().items()}
    load_checkpoint(str(tmp_path / "QM9" / "last.ckpt"), model, opt, ema)
    assert opt.count > 0
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype == torch.float32 for v in ema.values())
    states = list(opt.adam.state_dict()["state"].values())
    assert states and all(t.dtype == torch.float32 for st in states
                          for k, t in st.items() if k != "step")
    tb = next(iter(GraphLoader(tsyn.synthetic_qm9_dataset(8, seed=480), "qm9", 5.0, 5.0,
                               batch_size=8, build_perms=True)))
    opt.zero_grad()
    batch_loss(model, tb, "l1").backward()
    opt.step()
    assert all(p.dtype == torch.float32 == p.grad.dtype for p in model.parameters())
