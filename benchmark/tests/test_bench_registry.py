"""The harness finds every cell, configuration, driver and metric by name in
a file of its own, and ``BENCHMARK.json`` keeps to the benchmark's
contract."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import run

BENCH = run.benchmark_file()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


def test_every_cell_config_driver_and_metric_is_a_file():
    for w in BENCH["workloads"]:
        cell = run.cell_file(w["name"])
        assert cell["config"] == w["config"] and cell["traffic_name"] == w["traffic"]
        assert cell["why"] == w["why"] and w["chips"] == 1
        assert hasattr(run.driver_module(cell["driver"]), "Cell")
    for c in BENCH["configs"]:
        cfg = run.config_file(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert hasattr(run.counts_module(cfg["counts"]), "forward_flops")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        reader = run.metric_reader(m["name"])
        assert (reader.UNIT, reader.BETTER, reader.SOURCE) == (m["unit"], m["better"],
                                                              m["source"])
        if "layer" in m:
            assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])


def test_bounds_and_metric_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("roofline") or "mfu" in m["name"] or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:  # every cell: setup_s, another end-to-end metric, a per-layer one
        assert len(run.cell_metrics(BENCH, w, False)) >= 2
        assert run.cell_metrics(BENCH, w, True)


def test_a_dropped_in_cell_config_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """New files in the folders, and entries in BENCHMARK.json, are all a
    new cell, configuration or metric takes: no edit of a file there."""
    copy = tmp_path / "benchmark"
    shutil.copytree(run.HERE, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = run.config_file("pamnet_rna_d16_L1_f32")
    cfg["name"] = "pamnet_rna_d16_L1_f32_copy"
    (copy / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    cell = run.cell_file("rna_score_c1")
    cell.update(name="rna_score_c2", config=cfg["name"], traffic_name="rna_closed_loop_c2")
    cell["traffic"]["clients"] = 2
    (copy / "workloads" / "rna_score_c2.json").write_text(json.dumps(cell))
    (copy / "metrics" / "queue_share.score.py").write_text(
        'LAYER = "service"\nUNIT, BETTER, SOURCE, MOVES = "%", "lower", "host_clock", '
        '"score_p95_s"\n\n\ndef read(facts):\n    return 1.5\n')
    monkeypatch.setattr(run, "HERE", copy)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "rna_score_c2", "config": cfg["name"],
                               "traffic": "rna_closed_loop_c2", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "queue_share.score", "unit": "%", "better": "lower",
                               "source": "host_clock", "layer": "service",
                               "moves": "score_p95_s", "workloads": ["rna_score_c2"]})
    for m in bench["end_to_end"]:
        if "score_p95_s" == m["name"]:
            m["workloads"].append("rna_score_c2")
    assert run.cell_file("rna_score_c2")["traffic"]["clients"] == 2
    assert run.config_file(run.cell_file("rna_score_c2")["config"])["dim"] == 16
    names = [m["name"] for m in run.cell_metrics(bench, "rna_score_c2", True)]
    assert names == ["queue_share.score"]
    assert run.metric_reader("queue_share.score").read({}) == 1.5
    assert [m["name"] for m in run.cell_metrics(bench, "rna_score_c2", False)] == [
        "score_p95_s", "setup_s"]


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_limits_hold_the_numbers_the_driver_compares(name):
    cell = run.cell_file(name)
    if cell["driver"] == "score_service":
        assert set(cell["limits"]) == {"score_gap"}
    else:  # the loss, the first gradient, the change by the worst or the median leaf,
        # the EMA where the recipe keeps one, and the last evaluation
        assert {"loss_gap", "grad_gap"} < set(cell["limits"]) <= {
            "loss_gap", "grad_gap", "grad_gap_median", "change_gap", "change_gap_median",
            "ema_gap", "ema_gap_median", "eval_gap", "eval_gap_median"}
        assert any(k.startswith("eval_gap") for k in cell["limits"])
        assert "change_gap" in cell["limits"] or "change_gap_median" in cell["limits"]
        if run.config_file(cell["config"])["train"]["ema_decay"]:
            assert "ema_gap" in cell["limits"] or "ema_gap_median" in cell["limits"]
    assert all(v > 0 for v in cell["limits"].values())


def test_a_dropped_in_generator_and_reference_are_found_by_name(tmp_path, monkeypatch):
    """A new dataset or model variant arrives as ``gen/<x>.py`` and
    ``reference/<x>.py``, named by the cell's traffic and the configuration."""
    import benchmark.gen
    import benchmark.reference
    from benchmark.reference import steps

    gen_text = ("def molecules(traffic, seed, count, stream):\n"
                "    return [dict(seed=seed, k=k) for k in range(count)]\n")
    ref_text = "from benchmark.reference.pamnet import *  # noqa\nMARK = 1\n"
    for package, name, text in ((benchmark.gen, "dropped_gen", gen_text),
                                (benchmark.reference, "dropped_ref", ref_text)):
        folder = tmp_path / name
        folder.mkdir()
        (folder / f"{name}.py").write_text(text)
        monkeypatch.setattr(package, "__path__", [str(folder)] + list(package.__path__))
    cfg = dict(run.config_file("pamnet_rna_d16_L1_f32"), reference="dropped_ref",
               train_split=3, val_split=2)
    cell = dict(run.cell_file("rna_train"), traffic={"generator": "dropped_gen"})
    driver = run.driver_module("train_epochs").Cell(cell, cfg, 5, "cpu", False)
    splits = driver._splits()
    assert [len(splits[s]) for s in ("train", "val")] == [3, 2] and "test" not in splits
    assert steps.model_of(cfg).MARK == 1
