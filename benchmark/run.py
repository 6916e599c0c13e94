"""One run of one benchmark cell on the card:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell ``workloads/<cell>.json`` names its
configuration ``configs/<config>.json`` and its traffic driver
``drivers/<driver>.py``; the metrics the cell reports are those of
``BENCHMARK.json`` at the checkout's root (its ``end_to_end`` metrics with
``--trace 0``, its ``per_layer`` ones with ``--trace 1``), each read by
``metrics/<metric>.py`` from the run's facts; the configuration's FLOP and
byte counts are ``counts/<counts>.py``.

A run sets up (data and weights from the seed, the program, its warm-up:
``setup_s``), measures for ``--seconds`` (under the device trace with
``--trace 1``), reads the card's memory peak, frees the program's state,
compares what the timed path produced with the plain reference
(``reference/``) and prints each number compared beside its limit on
standard error, then the result as the last line of standard output.  It
exits non-zero with no result where the card is missing, where a step
fails, or where ``jax``, ``jaxlib``, ``flax`` or ``pamnet_tpu`` was
imported.
"""

import time

_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pamnet_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_file() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_file(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config_file(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def driver_module(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def counts_module(name: str):
    return importlib.import_module(f"benchmark.counts.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py`` (a metric's name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The metric entries of ``BENCHMARK.json`` that cell ``workload``
    reports: its end-to-end metrics, or with ``traced`` its per-layer ones
    (a per-layer metric without ``workloads`` in every cell that reports
    the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def forbidden_modules() -> list[str]:
    """Top-level names of ``sys.modules`` that the run may not hold, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def keep_caches_inside() -> None:
    """Every build and kernel cache under the checkout, at fixed paths (the
    port builds its kernels into ``build/torch_ext/`` itself)."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device,
             bench: dict | None = None, overrides: dict | None = None) -> dict:
    """Set up, measure and check cell ``workload``; the result's fields and
    the run's facts.  ``overrides`` replaces entries of the cell's traffic
    and configuration (the tests' small sizes)."""
    import torch

    from benchmark import peaks

    bench = benchmark_file() if bench is None else bench
    cell = cell_file(workload)
    cfg = config_file(cell["config"])
    for key, value in (overrides or {}).get("traffic", {}).items():
        cell["traffic"][key] = value
    for key, value in (overrides or {}).get("config", {}).items():
        cfg[key] = value
    for key, value in (overrides or {}).get("limits", {}).items():
        cell["limits"][key] = value
    driver = driver_module(cell["driver"]).Cell(cell, cfg, seed, device, traced)
    driver.facts["imports_s"] = time.monotonic() - _START
    cuda = torch.device(device).type == "cuda"
    try:
        driver.setup()
        if traced and cuda:
            from benchmark.trace import DeviceTrace

            with DeviceTrace() as tr:
                driver.window(seconds)
        else:
            driver.window(seconds)
        facts = dict(driver.facts, setup_s=driver.window_start - _START)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        breakdown = None
        if traced:
            facts.update(driver.work(counts_module(cfg["counts"])))
            facts["peak_flops"] = peaks.FLOPS[cfg["compute_dtype"]]
            if cuda:
                t0, t1 = driver.t_ns
                dev = tr.reduce(t0, t1, driver.spans, driver.idle_label)
                facts.update(busy_s=dev["busy_s"], trace_window_s=dev["window_s"],
                             port_kernel_s=dev["port_kernel_s"], trace_records=dev["records"])
                breakdown = {"device_ops": dev["device_ops"], "idle_gaps": dev["idle_gaps"]}
                del tr
        driver.free()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        compared = driver.compare(driver.reference())
    finally:
        driver.close()
    limits = cell["limits"]
    checks = {name: {"value": float(compared[name]), "limit": float(limits[name])}
              for name in limits if name in compared}
    checks["failed"] = {"value": float(facts["failed"]), "limit": 0.0}
    missing = sorted(set(limits) - set(compared))
    if missing:
        raise RuntimeError(f"the driver compared no {missing}")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for entry in cell_metrics(bench, workload, traced):
        value = metric_reader(entry["name"]).read(facts)
        if value is None:
            if not traced or entry["name"] in {m["name"] for m in bench["end_to_end"]}:
                raise RuntimeError(f"metric {entry['name']} read nothing")
            continue
        metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    info = {k: v for k, v in compared.items() if k not in checks}
    return dict(correct=correct, facts=facts, checks=checks, metrics=metrics, peak=peak,
                breakdown=breakdown, info=info)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="One run of one benchmark cell on the card.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    keep_caches_inside()
    bench = benchmark_file()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    threads = cell_file(args.workload).get("host_threads")
    if threads:  # the CPU's thread pools, set before torch and numpy load
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
            os.environ[var] = str(threads)

    import torch

    if threads:
        torch.set_num_threads(threads)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no run",
              file=sys.stderr)
        return 2
    try:
        res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), bench)
    except Exception:  # noqa: BLE001 - the run failed: no result line
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"the run imported {found}: no result", file=sys.stderr)
        return 3
    facts = res["facts"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"], "memory_peak_bytes": int(res["peak"]),
              "power": power_limit()}
    if args.trace:
        device.update(busy_s=facts["busy_s"], window_s=facts["trace_window_s"])
    line = {"correct": res["correct"], "attempted": int(facts["attempted"]),
            "failed": int(facts["failed"]), "metrics": res["metrics"], "device": device}
    if res["breakdown"] is not None:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    print(json.dumps({"facts": {k: v for k, v in facts.items() if k != "latencies_s"},
                      "info": res["info"]}, default=str), file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
