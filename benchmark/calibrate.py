"""Readings that a cell's limits are set from, on the card, in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 11,12,... \\
        [--controls 3] [--seconds 8] [--out FILE]

For each seed: the cell's set-up and a window of ``--seconds`` (a cell
that serves: at the cell's own load; a training cell: its epochs and their
evaluations, one at the least), then the numbers of the check
(``check.py``) of the program against the reference.  For the first
``--controls`` seeds also the control's numbers: the reference in the
nearest precision below the configuration's put in the program's place
(``check.control_precision``), and for a training cell the fault of half
of each batch left out, planted in the reference put in the program's
place.  (A step that leaves the state unchanged reads 1 on ``grad_gap``
and ``change_gap`` by their definition and needs no run.)  One JSON line
a reading, to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)

    from benchmark import check, run

    run.keep_caches_inside()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: no readings", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = run.cell_file(args.workload)
    cfg = run.config_file(cell["config"])
    lower = check.control_precision(cfg)
    out = open(args.out, "a") if args.out else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec, default=str)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        driver = run.driver_module(cell["driver"]).Cell(dict(cell), dict(cfg), seed, device,
                                                        False)
        try:
            driver.setup()
            driver.window(args.seconds)
            driver.free()
            gc.collect()
            torch.cuda.empty_cache()
            ref = driver.reference()
            emit({"cell": args.workload, "seed": seed, "side": "program",
                  **driver.compare(ref), "failed": driver.facts.get("failed", 0),
                  "seconds": time.monotonic() - t0})
            if k < args.controls:
                ctl = driver.reference(lower)
                emit({"cell": args.workload, "seed": seed, "side": f"control_{lower}",
                      **_as_program(driver, ctl, ref)})
                if cell["driver"] == "train_epochs":
                    half = driver.reference("float32", drop_half=True)
                    emit({"cell": args.workload, "seed": seed, "side": "fault_half_batch",
                          **_as_program(driver, half, ref)})
        finally:
            driver.close()
            del driver
            gc.collect()
            torch.cuda.empty_cache()
    return 0


def _as_program(driver, got: dict, ref: dict) -> dict:
    """The check's numbers of ``got`` (a reference run put in the program's
    place) against ``ref``."""
    from benchmark import check

    if "scores" in got:
        return {"score_gap": check.score_gap(got["scores"], ref["scores"])}
    return dict(check.train_gaps(got, ref), **check.eval_gaps(got["eval"], ref["eval"]))


if __name__ == "__main__":
    sys.exit(main())
