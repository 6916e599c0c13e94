"""Checkpoints of the port (pamnet_tpu_torch/train/checkpoint.py): the full
training state round-trips and a resumed run continues bit for bit on the
CPU (steps, and both training scripts' epochs); the exported parameters load through
``load_reference_checkpoint`` into the scoring service, which then gives the
training module's own predictions (atol 1e-6: the same f32 forward on
batches padded to another bucket)."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import re

import numpy as np
import pytest
import torch

from pamnet_tpu_torch import main_qm9, main_rna_puzzles
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset, synthetic_rna_dataset
from pamnet_tpu_torch.data.tu import write_tu_split
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.serve import RNAScoringService
from pamnet_tpu_torch.train.checkpoint import (export_state_dict, load_checkpoint,
                                               save_checkpoint)
from pamnet_tpu_torch.train.ema import ema_init
from pamnet_tpu_torch.train.loop import Optimizer, predict, train_step
from pamnet_tpu_torch.train.schedules import constant, warmup_exponential
from pamnet_tpu_torch.weights import load_reference_checkpoint

RNA_CFG = PAMNetConfig(dataset="rna_train", dim=16, n_layer=1, cutoff_l=2.6, cutoff_g=20.0,
                       flow="target_to_source")
QM9_CFG = PAMNetConfig(dataset="QM9", dim=16, n_layer=1)


def _setup(kind):
    """(fresh-run factory, batches, loss kind) of a small RNA (no EMA, constant
    lr) or QM9 (EMA, clip, warmup schedule) training run."""
    if kind == "rna":
        mols = synthetic_rna_dataset(4, seed=3, n_atoms=36)
        loader = GraphLoader(mols, "rna", 2.6, 20.0, batch_size=2, build_perms=True)
        cfg, loss_kind = RNA_CFG, "smooth_l1"
    else:
        mols = synthetic_qm9_dataset(8, seed=3)
        loader = GraphLoader(mols, "qm9", 5.0, 5.0, batch_size=4, build_perms=True)
        cfg, loss_kind = QM9_CFG, "l1"

    def fresh(seed):
        model = PAMNet(cfg, torch.Generator().manual_seed(seed))
        if kind == "rna":
            return model, Optimizer(model.parameters(), constant(1e-3)), None
        opt = Optimizer(model.parameters(), warmup_exponential(1e-3, 2), clip_norm=1000.0)
        return model, opt, ema_init(model.state_dict())

    return fresh, list(loader), loss_kind


def _state(model, opt, ema):
    adam = opt.adam.state_dict()["state"]
    tensors = [p.detach() for p in model.parameters()]
    tensors += [v for k in sorted(adam) for _, v in sorted(adam[k].items())]
    return tensors + ([] if ema is None else [ema[k] for k in sorted(ema)])


@pytest.mark.parametrize("kind", ["rna", "qm9"])
def test_checkpoint_round_trips_and_resumes_bitwise(kind, tmp_path):
    fresh, batches, loss_kind = _setup(kind)
    path = str(tmp_path / "ckpt" / "state.ckpt")
    model, opt, ema = fresh(1)
    losses = []
    for step in range(4):
        if step == 2:
            save_checkpoint(path, model, opt, ema, extra={"epoch": 7, "note": "x"})
        losses.append(train_step(model, opt, ema, batches[step % 2], loss_kind))

    model2, opt2, ema2 = fresh(2)  # other weights, a fresh optimizer
    assert load_checkpoint(path, model2, opt2, ema2) == {"epoch": 7, "note": "x"}
    assert opt2.count == 2
    adam = opt2.adam.state_dict()["state"]
    assert len(adam) == len(list(model2.parameters()))
    assert all(float(s["step"]) == 2.0 for s in adam.values())
    for step in range(2, 4):
        loss = train_step(model2, opt2, ema2, batches[step % 2], loss_kind)
        assert torch.equal(loss, losses[step])
    assert opt2.count == opt.count == 4
    for a, b in zip(_state(model, opt, ema), _state(model2, opt2, ema2)):
        assert torch.equal(a, b)
    assert not (tmp_path / "ckpt" / "state.ckpt.tmp").exists()


def test_checkpoint_refuses_a_mismatched_ema(tmp_path):
    fresh, _, _ = _setup("qm9")
    model, opt, ema = fresh(1)
    save_checkpoint(str(tmp_path / "a.ckpt"), model, opt, ema)
    save_checkpoint(str(tmp_path / "b.ckpt"), model, opt, None)
    with pytest.raises(ValueError, match="EMA"):
        load_checkpoint(str(tmp_path / "a.ckpt"), model, opt, None)
    with pytest.raises(ValueError, match="EMA"):
        load_checkpoint(str(tmp_path / "b.ckpt"), model, opt, ema)
    with pytest.raises(RuntimeError, match="state_dict"):  # another width
        load_checkpoint(str(tmp_path / "b.ckpt"),
                        PAMNet(PAMNetConfig(dataset="QM9", dim=8, n_layer=1)), opt, None)


def test_exported_parameters_serve_the_trained_model(tmp_path):
    fresh, batches, loss_kind = _setup("rna")
    model, opt, _ = fresh(5)
    for gb in batches:
        train_step(model, opt, None, gb, loss_kind)
    path = str(tmp_path / "pamnet_rna_best.pt")
    export_state_dict(model.state_dict(), path)
    state = load_reference_checkpoint(path)
    assert state.keys() == model.state_dict().keys()
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in state.values())
    mols = synthetic_rna_dataset(4, seed=3, n_atoms=36)
    service = RNAScoringService(state, RNA_CFG, batch_size=2, device="cpu")
    want, _ = predict(model, GraphLoader(mols, "rna", 2.6, 20.0, batch_size=2), "cpu")
    np.testing.assert_allclose(service.score_molecules(mols), want, rtol=0, atol=1e-6)


_RNA_LOSS = re.compile(r"Epoch: 003, Train Loss: (\S+), Val Loss: (\S+) ")
_QM9_MAE = re.compile(r"Epoch: 003, Train MAE: (\S+), Val MAE: (\S+), Test MAE: (\S+) ")


@pytest.mark.parametrize("script", ["rna", "qm9", "qm9_bf16"])
def test_resume_reproduces_the_third_epoch(script, capsys, tmp_path):
    """Three epochs straight against two epochs, then ``--resume`` for the
    third: the same printed losses, bit for bit, and the same best file.
    QM9 at dim 16 in float32 (the port folds there, which bfloat16 refuses),
    and at the driver's default bfloat16 at dim 32."""
    if script == "rna":
        main, pattern, last, best = (main_rna_puzzles.main, _RNA_LOSS, "pamnet_rna_last.ckpt",
                                     "pamnet_rna_best.pt")
        mols = synthetic_rna_dataset(8, seed=40, n_atoms=36)
        write_tu_split(str(tmp_path / "data"), "train", mols[:6])
        write_tu_split(str(tmp_path / "data"), "val", mols[6:])
        base = ["--dim", "16", "--n_layer", "1", "--batch_size", "2", "--lr", "1e-3",
                "--data_root", str(tmp_path / "data")]
    else:
        main, pattern, last, best = (main_qm9.main, _QM9_MAE, "QM9/last.ckpt",
                                     "QM9/best_model.pt")
        base = ["--synthetic", "--limit", "40", "--n_layer", "1", "--batch_size", "8"]
        base += (["--dim", "16", "--compute_dtype", "float32"] if script == "qm9"
                 else ["--dim", "32"])
    base += ["--device", "cpu"]
    main(base + ["--epochs", "3", "--save_dir", str(tmp_path / "straight")])
    straight = pattern.search(capsys.readouterr().out).groups()
    main(base + ["--epochs", "2", "--save_dir", str(tmp_path / "cut")])
    assert pattern.search(capsys.readouterr().out) is None
    main(base + ["--epochs", "3", "--save_dir", str(tmp_path / "cut"),
                 "--resume", str(tmp_path / "cut" / last)])
    out = capsys.readouterr().out
    assert "Resumed full train state" in out and "Epoch: 002" not in out
    assert pattern.search(out).groups() == straight
    a = torch.load(tmp_path / "straight" / best, weights_only=True)
    b = torch.load(tmp_path / "cut" / best, weights_only=True)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
