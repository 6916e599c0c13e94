"""Each cell driven on the CPU at a small size: the reference agrees with
the port; a run is correct; a run whose timed path is broken underneath
(a step that leaves its state unchanged, half of each batch left out, an
EMA with the wrong decay, an answer or an evaluation's prediction altered
where it is produced) comes out not correct; and the controls in lower
precision come out not correct (TF32 needs the card)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import check, run, weights
from benchmark.gen import rna as gen_rna
from benchmark.reference import pamnet as ref_pamnet
from benchmark.reference import steps as ref_steps
from benchmark.tests.small import SMALL

CPU = torch.device("cpu")
SEED = 2147483661


def _run(name: str, seconds: float = 3.0, seed: int = SEED) -> dict:
    return run.run_cell(name, seed, seconds, False, CPU, overrides=SMALL[name])


def _port_scores(cfg: dict, mols: list, state: dict) -> np.ndarray:
    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.models.pamnet import PAMNet

    pcfg = PAMNetConfig(dataset=cfg["dataset"], dim=cfg["dim"], n_layer=cfg["n_layer"],
                        cutoff_l=cfg["cutoff_l"], cutoff_g=cfg["cutoff_g"], flow=cfg["flow"],
                        compute_dtype="float32")
    model = PAMNet(pcfg).eval()
    model.load_state_dict(state)
    gb = next(iter(GraphLoader(mols, pcfg.dataset_kind, cfg["cutoff_l"], cfg["cutoff_g"],
                               batch_size=len(mols))))
    with torch.no_grad():
        return model(gb)[:len(mols)].numpy()


@pytest.mark.parametrize("name", ["pamnet_rna_d16_L1_f32", "pamnet_qm9_d128_L6_bf16"])
def test_the_reference_forward_agrees_with_the_ports(name, cpu_threads):
    cfg = run.config_file(name)
    if cfg["kind"] == "qm9":
        from benchmark.gen.qm9 import synthetic_qm9_dataset

        cfg.update(dim=32, n_layer=2)
        mols = synthetic_qm9_dataset(6, seed=SEED)
    else:
        mols = [gen_rna.derived(gen_rna.bases(SEED, 2, 300), SEED, k, 0) for k in range(3)]
    state = weights.seeded_state(ref_pamnet.param_spec(cfg), SEED, CPU)
    want = np.asarray(ref_steps.scores(state, mols, cfg, CPU))
    got = _port_scores(cfg, mols, state)
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


@pytest.mark.parametrize("name", list(SMALL))
def test_a_small_run_is_correct(name, cpu_threads):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["facts"]["attempted"] > 0 and res["facts"]["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in run.cell_metrics(run.benchmark_file(),
                                                                       name, False)}


def _unchanged_state(monkeypatch):
    from pamnet_tpu_torch.train import loop

    monkeypatch.setattr(loop.Optimizer, "step", lambda self: None)


def _half_batch(monkeypatch):
    from pamnet_tpu_torch.train import loop

    terms = loop.loss_terms

    def half(pred, y, graph_mask, kind):
        mask = graph_mask.clone()
        valid = torch.nonzero(mask > 0).flatten()
        mask[valid[len(valid) // 2:]] = 0
        return terms(pred, y, mask, kind)

    monkeypatch.setattr(loop, "loss_terms", half)


def _wrong_ema(monkeypatch):
    from pamnet_tpu_torch.train import loop

    monkeypatch.setattr(loop, "EMA_DECAY", 0.99)


def _altered_evaluation(monkeypatch):
    from pamnet_tpu_torch.train import loop

    predict = loop.StackedEval.predict

    def altered(self, model):
        pred, y = predict(self, model)
        return pred * np.float32(1.05), y

    monkeypatch.setattr(loop.StackedEval, "predict", altered)


def _altered_answer(monkeypatch):
    from pamnet_tpu_torch import serve

    score = serve.RNAScoringService.score_molecules
    monkeypatch.setattr(serve.RNAScoringService, "score_molecules",
                        lambda self, mols: score(self, mols) * np.float32(1.001))


@pytest.mark.parametrize("name,fault", [
    ("qm9_train", _unchanged_state), ("qm9_train", _half_batch),
    ("qm9_train", _wrong_ema), ("qm9_train", _altered_evaluation),
    ("rna_train", _unchanged_state), ("rna_train", _half_batch),
    ("rna_train", _altered_evaluation),
    ("rna_score_c1", _altered_answer), ("rna_score_c4", _altered_answer),
], ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch, cpu_threads):
    fault(monkeypatch)
    res = _run(name)
    assert not res["correct"], res["checks"]


def test_the_fp8_control_of_the_bf16_cell_is_not_correct(cpu_threads):
    """QM9's control (the reference in float8 in the program's place) at a
    small size on the CPU."""
    from benchmark import calibrate

    cfg = run.config_file("pamnet_qm9_d128_L6_bf16")
    cfg.update(SMALL["qm9_train"]["config"])
    cell = run.cell_file("qm9_train")
    driver = run.driver_module("train_epochs").Cell(
        dict(cell, traffic=dict(cell["traffic"], **SMALL["qm9_train"]["traffic"])), cfg,
        SEED, CPU, False)
    driver.setup()
    driver.window(0.1)
    ref = driver.reference()
    ctl = calibrate._as_program(driver, driver.reference(check.control_precision(cfg)), ref)
    assert any(ctl[k] > cell["limits"][k] for k in cell["limits"]), ctl


@pytest.mark.gpu
def test_the_tf32_control_of_the_f32_cells_is_not_correct(card):
    """The RNA cells' control (the reference with TF32 products in the
    program's place) on three structures of 2,100 atoms, on the card."""
    cfg = run.config_file("pamnet_rna_d16_L1_f32")
    limit = run.cell_file("rna_score_c4")["limits"]["score_gap"]
    mols = [gen_rna.derived(gen_rna.bases(SEED, 3, 2100), SEED, k, 0) for k in range(3)]
    state = weights.seeded_state(ref_pamnet.param_spec(cfg), SEED, card)
    with check.precision("float32"):
        want = ref_steps.scores(state, mols, cfg, card)
    with check.precision("tf32"):
        got = ref_steps.scores(state, mols, cfg, card)
    assert check.score_gap(got, want) > limit
