"""The port's training pieces against the JAX package: the optimizer against
the optax chain of ``make_optimizer`` fed the same gradients, the EMA, the
schedules, a loss that falls, and main_qm9 run in-process.

The optimizer is fed one fixed gradient tree per step rather than compared
over whole trajectories: Adam's first step turns tiny gradient noise into
updates of up to +-lr.  Parameters within 1e-6 and the EMA within 1e-7
(absolute, or relative where values exceed 1: one f32 rounding); schedule
values to float32 precision (JAX evaluates them in float32).
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import math
import os
import re

import numpy as np
import pytest

import jax.numpy as jnp
import optax
import torch

from pamnet_tpu.train import ema_init as jax_ema_init
from pamnet_tpu.train import ema_update as jax_ema_update
from pamnet_tpu.train import loop as jloop
from pamnet_tpu.train import schedules as jsched
from pamnet_tpu_torch import main_qm9
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.train import schedules as tsched
from pamnet_tpu_torch.train.ema import ema_init, ema_update
from pamnet_tpu_torch.train.loop import Optimizer, train_step
from test_train import _mols

SHAPES = {"w": (4, 3), "b": (3,), "unused": (2, 2)}


@pytest.mark.parametrize("clip,wd,schedule", [
    (None, 0.0, "constant"),
    (1000.0, 0.0, "constant"),   # the recipe's clip, not triggered
    (0.5, 0.0, "constant"),      # triggered
    (0.5, 1e-2, "constant"),
    (1000.0, 1e-2, "warmup"),    # 3 steps of warmup_exponential, B = 5
])
def test_optimizer_and_ema_match_optax(clip, wd, schedule):
    rng = np.random.default_rng(7)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    params["w"] *= 3.0  # values past 1, where f32 roundings are coarser
    # "unused" gets no gradient in the port and a zero one in JAX, as the
    # QM9 model's init_linear.
    grads = [{k: (np.zeros(s, np.float32) if k == "unused"
                  else rng.standard_normal(s).astype(np.float32) * 2.0)
              for k, s in SHAPES.items()} for _ in range(3)]
    if schedule == "constant":
        jschedule, tschedule = jsched.constant(1e-3), tsched.constant(1e-3)
    else:
        jschedule = jsched.warmup_exponential(1e-3, 5)
        tschedule = tsched.warmup_exponential(1e-3, 5)

    opt = jloop.make_optimizer(jschedule, weight_decay=wd, clip_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state, shadow = opt.init(jp), jax_ema_init(jp)

    tp = {k: torch.tensor(v) for k, v in params.items()}
    topt = Optimizer(tp.values(), tschedule, weight_decay=wd, clip_norm=clip)
    tshadow = ema_init(tp)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        shadow = jax_ema_update(shadow, jp, 0.999)
        for k, p in tp.items():
            p.grad = None if k == "unused" else torch.tensor(g[k])
        topt.step()
        ema_update(tshadow, tp, 0.999)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(tshadow[k].numpy(), np.asarray(shadow[k]),
                                       rtol=1e-7, atol=1e-7, err_msg=k)
    assert topt.count == 3
    moved = np.abs(tp["w"].numpy() - params["w"]).max()
    assert moved > 0.0 or schedule == "warmup"


@pytest.mark.parametrize("frac", [None, 5.5])
def test_warmup_exponential_matches_jax(frac):
    b = 5
    j = jsched.warmup_exponential(1e-3, b, frac_steps_per_epoch=frac)
    t = tsched.warmup_exponential(1e-3, b, frac_steps_per_epoch=frac)
    steps = range(3 * b + 3)
    want = np.array([float(j(jnp.int32(s))) for s in steps])
    got = np.array([t(s) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0 and got[b + 2] == 1e-3  # update 0 and the flag flip


def test_multistep_and_constant_match_jax():
    j, t = jsched.multistep(1e-3, 4, milestones=(2, 5)), tsched.multistep(1e-3, 4, (2, 5))
    for s in range(30):
        assert math.isclose(t(s), float(j(jnp.int32(s))), rel_tol=1e-6)
    assert tsched.constant(3e-4)(17) == 3e-4


def test_ema_decay_warmup_term():
    """d = min(decay, (1 + n) / (10 + n)) for small update counts."""
    shadow = {"a": torch.tensor([1.0, 2.0])}
    ema_update(shadow, {"a": torch.tensor([3.0, 4.0])}, 0.999, num_updates=0)
    d = 1.0 / 10.0
    np.testing.assert_allclose(shadow["a"].numpy(), [(1 - d) * 3 + d * 1, (1 - d) * 4 + d * 2],
                               rtol=2e-7)  # an f64 reference: one f32 rounding


def test_loss_decreases():
    """Twin of tests/test_train.py::test_loss_decreases on the port: 30
    steps at lr 1e-3 on four small molecules whose label is their size."""
    mols = _mols(np.random.default_rng(480), 4)
    gb = next(iter(GraphLoader(mols, "qm9", 5.0, 5.0, batch_size=4, build_perms=True)))
    model = PAMNet(PAMNetConfig(dataset="QM9", dim=16, n_layer=1))
    opt = Optimizer(model.parameters(), tsched.constant(1e-3), clip_norm=1000.0)
    ema = ema_init(model.state_dict())
    losses = [float(train_step(model, opt, ema, gb, "l1")) for _ in range(30)]
    assert losses[-1] < 0.5 * losses[0], losses[:3] + losses[-3:]
    assert opt.count == 30


_EPOCH = re.compile(r"Epoch: (\d+), Train MAE: (\S+), Val MAE: (\S+), Test MAE: (\S+) ")


def test_main_qm9_runs_in_process(capsys, tmp_path):
    csv = tmp_path / "metrics.csv"
    res = main_qm9.main(["--synthetic", "--limit", "64", "--dim", "16", "--n_layer", "1",
                         "--epochs", "2", "--batch_size", "8", "--device", "cpu",
                         "--compute_dtype", "float32",
                         "--metrics_csv", str(csv), "--save_dir", str(tmp_path / "save")])
    out = capsys.readouterr().out
    assert "Data loaded! train=51 val=6 test=7" in out and "Start training!" in out
    epochs = _EPOCH.findall(out)
    assert [int(e[0]) for e in epochs] == [1, 2]
    assert all(math.isfinite(float(v)) for e in epochs for v in e[1:])
    best = re.search(r"Best Validation MAE: (\S+)", out)
    test = re.search(r"Testing MAE: (\S+)", out)
    assert math.isfinite(float(best.group(1))) and math.isfinite(float(test.group(1)))
    assert res["test_mae"] == float(test.group(1))
    assert csv.read_text().splitlines()[0] == \
        "epoch,train_mae,val_mae,test_mae,seconds,mol_per_sec"
    assert len(csv.read_text().splitlines()) == 3


def test_main_qm9_trains_bf16_by_default_in_process(capsys, tmp_path):
    """bfloat16 is the driver's default, as the JAX ``main_qm9.py``'s, unfolded
    at dim 32 and, at dim 16, with the sbf stage folded into kernel B's
    bfloat16 version, as the JAX model folds in either type: both runs train
    an epoch to finite errors."""
    base = ["--synthetic", "--limit", "64", "--n_layer", "1", "--epochs", "1",
            "--batch_size", "8", "--device", "cpu", "--save_dir", str(tmp_path)]
    for dim in ("32", "16"):
        res = main_qm9.main(base + ["--dim", dim])
        epochs = _EPOCH.findall(capsys.readouterr().out)
        assert [int(e[0]) for e in epochs] == [1]
        assert all(math.isfinite(float(v)) for v in epochs[0][1:])
        assert math.isfinite(res["test_mae"])


def test_main_qm9_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_qm9.main(["--synthetic", "--limit", "16", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_qm9.main(["--model", "PAMNet_s", "--synthetic", "--limit", "16", "--epochs", "1"])


def test_main_qm9_trace_dir_writes_a_chrome_trace(capsys, tmp_path):
    """``--trace_dir`` profiles epoch 0's training (``profiling.trace``; on
    the CPU its CPU activity only) into a Chrome trace JSON with events."""
    import json

    main_qm9.main(["--synthetic", "--limit", "16", "--dim", "16", "--n_layer", "1",
                   "--epochs", "2", "--batch_size", "4", "--device", "cpu",
                   "--save_dir", str(tmp_path / "save"),
                   "--trace_dir", str(tmp_path / "trace")])
    assert len(_EPOCH.findall(capsys.readouterr().out)) == 2
    (name,) = os.listdir(tmp_path / "trace")
    assert name == "epoch0_rank0.json"
    events = json.loads((tmp_path / "trace" / name).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert len(events) > 100 and any("addmm" in n or "linear" in n for n in names)


def test_trace_refuses_a_card_it_cannot_see(monkeypatch, tmp_path):
    """On a card the trace needs the profiler's CUDA activity: without it
    (no CUPTI) it raises and writes nothing, rather than trace the host
    alone."""
    import torch.profiler

    from pamnet_tpu_torch.profiling import trace

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot trace the card"):
        with trace(str(tmp_path / "t"), "cuda"):
            pass
    assert not (tmp_path / "t").exists()
