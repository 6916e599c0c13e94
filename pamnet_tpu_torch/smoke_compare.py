"""Run ``chip_smoke.py`` of two checkouts in turns on one card and print the
numbers that compare them.

    python -m pamnet_tpu_torch.smoke_compare --parent DIR --change DIR \\
        [--order p,c,c,p,c+] [--out build/smoke_compare]

Each entry of ``--order`` runs ``python3 chip_smoke.py`` in the parent's
(``p``) or the change's (``c``) directory, with ``--profile`` where it ends
in ``+``; the runs go one after another, never side by side, and each one's
output is kept whole under ``--out`` (``<i>_<p|c>.out``).  Printed, one JSON
line per run: every kernel case of the group sums and the row gathers (by
the case's name, whichever kernel list holds it), of kernel A (its sums,
role swaps, the fused role swap beside the role swap + ``gather_product``
of the same arrays, the gated sum's backward beside the row gather and
multiplies it replaces, and walks on the batches' own CSRs) and of the edge
message (rows, summed by node with the rows + sum of the same arrays beside
it, and their backward), under ``<phase>_walk_shapes`` the walk's team-shape
trials, under ``<phase>_sbf`` the cases of kernel B forward and backward and
of kernel A's sums over the triplets, the launches per scored batch and per
RNA step, the training steps' times, and with ``--profile``, for the scoring
forward and a QM9 and an RNA training step, the device time, every kernel
launch in total and by kernel name (where the checkout's ``chip_smoke.py``
prints them), and each launch of the group sums, of kernel B, kernel A, the
edge message and the row gathers.  It exits non-zero if a run failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CASE_KEYS = ("ms", "enqueue_ms", "device_ms", "bound_ms", "plain_ms", "library_ms",
              "library_device_ms", "max_abs_err", "route", "walk_shape", "rows_sum_ms",
              "rows_sum_device_ms", "alone_ms", "alone_device_ms", "pair_ms", "pair_device_ms",
              "rows_mul_ms", "rows_mul_device_ms", "warm_device_ms", "rows_mul_warm_device_ms")
# Kernel lists whose every case is printed: kernel A, its backward routes
# and the edge message.
_WALK_LISTS = ("triplet_aggregate", "triplet_aggregate_grad_a", "triplet_aggregate_grad_ab",
               "gather_product", "gated_sum_backward", "edge_message", "edge_message_sum",
               "edge_message_backward")
_STEP_KEYS = ("ms_per_step", "enqueue_ms_per_step", "device_ms_per_step",
              "device_idle_share", "peak_mem_gb", "main_path_launches",
              "launches_per_step_forward", "launches_per_step_backward")
_KERNEL_PHASES = ("kernels", "walk_kernels", "train_kernels", "rna_train_kernels")
_SBF_KEYS = ("ms", "enqueue_ms", "device_ms", "bound_ms", "plain_ms", "max_abs_err",
             "worst_err_over_tolerance", "valid")


def _cases(phase: dict) -> list[dict]:
    """The group-sum, row-gather, kernel A and edge message cases of a
    kernel phase's line."""
    out = []
    for key, value in phase.items():
        if not isinstance(value, list) or key == "walk_shape_trials":
            continue
        for case in value:
            name = case.get("case", "") if isinstance(case, dict) else ""
            if key in _WALK_LISTS or name.startswith(("sum by", "rows by", "radial table",
                                                      "atom-type")):
                out.append({"case": name, "d": case.get("d"),
                            **{k: case[k] for k in _CASE_KEYS if k in case}})
    return out


def _sbf_cases(phase: dict) -> list[dict]:
    """Kernel B's cases (forward, "... fused folded gather ...", and
    backward) and kernel A's sums over the triplets ("t2 sum (folded
    path)"), the work kernel B now does in one launch."""
    out = []
    for value in phase.values():
        for case in value if isinstance(value, list) else ():
            name = case.get("case", "") if isinstance(case, dict) else ""
            if name.startswith(("t2 ", "t1 ")) and any(
                    w in name for w in ("fused", "backward", "sum (folded")):
                out.append({"case": name, "d": case.get("d"),
                            **{k: case[k] for k in _SBF_KEYS if k in case}})
    return out


def _launches(phase: dict) -> list[dict]:
    """A profiled phase's launches of the port's kernels, named without
    their namespace (older checkouts print it on non-template kernels)."""
    return [{**ev, "name": ev["name"].replace("(anonymous namespace)::", "")}
            for ev in phase.get("port_kernel_launches", [])]


def _sbf_launches(phase: dict) -> list[dict]:
    """The launches of kernel B (forward, backward and its reduce), kernel A
    (the walk) and its backward's own kernels, the edge message and the row
    gathers in a profiled forward or step."""
    return [ev for ev in _launches(phase)
            if ev["name"].startswith(("sbf_", "triplet_aggregate_kernel", "row_gather",
                                      "csr_walk", "edge_message", "gather_product",
                                      "gated_sum"))]


def _in_step(phase: dict) -> list[dict]:
    """The launches of the sums by group of a profiled step: kernel A's
    no-modulation launches and the split kernel's."""
    return [ev for ev in _launches(phase)
            if ev["name"].startswith(("group_sum", "triplet_aggregate_kernel<true, false, false>",
                                      "triplet_aggregate_kernel<false, false, false>",
                                      "csr_walk_kernel<SumRow<true, false, false>",
                                      "csr_walk_kernel<SumRow<false, false, false>"))]


def _totals(phase: dict, unit: str) -> dict:
    """A profiled forward's or step's device ms, and its kernel launches in
    total and by kernel name where the checkout prints them."""
    out = {f"device_ms_per_{unit}_total": phase.get(f"device_ms_per_{unit}_total")}
    for key in (f"kernel_launches_per_{unit}", "kernels_by_name"):
        if key in phase:
            out[key] = phase[key]
    return out


def summarize(lines: list[str]) -> dict:
    """The compared numbers of one run's output lines."""
    res: dict = {}
    for line in lines:
        if not line.startswith("{"):
            continue
        obj = json.loads(line)
        phase = obj.get("phase")
        if phase == "device":
            res["nvidia_smi"] = obj["nvidia_smi"]
        elif phase in _KERNEL_PHASES or phase == "sbf_kernels":
            if phase in _KERNEL_PHASES:
                res[phase] = _cases(obj)
                if "walk_shape_trials" in obj:
                    res[phase + "_walk_shapes"] = obj["walk_shape_trials"]
            res[phase + "_sbf"] = _sbf_cases(obj)
        elif phase in ("train", "rna_train"):
            res[phase] = {k: obj.get(k) for k in _STEP_KEYS}
        elif phase == "slice":
            res["slice"] = {k: obj.get(k) for k in (
                "folded_ms_per_batch", "unfolded_ms_per_batch", "launches_per_batch",
                "launches_per_batch_unfolded")}
        elif phase == "profile":
            res["profile"] = {**_totals(obj, "batch"), "sbf_launches": _sbf_launches(obj)}
        elif phase in ("profile_train", "profile_rna_train"):
            res[phase] = {**_totals(obj, "step"), "group_sum_launches": _in_step(obj),
                          "sbf_launches": _sbf_launches(obj)}
        elif "ok" in obj:
            res["ok"] = obj["ok"]
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True)
    parser.add_argument("--change", required=True)
    parser.add_argument("--order", default="p,c,c,p,c+")
    parser.add_argument("--out", default=os.path.join("build", "smoke_compare"))
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    failed = 0
    for i, run in enumerate(args.order.split(",")):
        which, profile = run[0], run.endswith("+")
        cwd = {"p": args.parent, "c": args.change}[which]
        cmd = [sys.executable, "chip_smoke.py"] + (["--profile"] if profile else [])
        proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
        with open(os.path.join(args.out, f"{i}_{which}.out"), "w") as f:
            f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        failed += proc.returncode != 0
        print(json.dumps({"run": i, "tree": which, "profile": profile,
                          "returncode": proc.returncode,
                          **summarize(proc.stdout.splitlines())}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
