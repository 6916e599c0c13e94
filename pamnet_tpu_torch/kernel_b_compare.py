"""Time kernel B's forward work on the scoring batch in two checkouts, in
turns on one card: the parent's folded path (kernel B's (T, D) rows, then
kernel A's sum by center edge) against the change's kernel B summed by
center edge.

    python -m pamnet_tpu_torch.kernel_b_compare --parent DIR --change DIR \\
        [--order p,c,c,p,p,c] [--seed 0] [--structures 16] [--atoms 2100] \\
        [--out build/kernel_b_compare]

It first builds the batch the scoring phase of ``chip_smoke.py`` scores (the
first ``--structures`` synthetic structures of ``--atoms`` atoms from
``--seed``, at the loader's pads) with this checkout's package and keeps the
t2 and t1 triplet arrays of that batch (neighbour edge, basis rows, mask, the
center edges' sorted CSR and the valid count) in ``<out>/batch.pt``.  Then
each entry of ``--order`` runs this file as a worker process in the
parent's (``p``) or the change's (``c``) directory, which imports that
directory's ``pamnet_tpu_torch``; the runs go one after another.  A worker
times per stream, on tables and weights drawn from ``--seed`` (the same in
every run): ``rows + sum`` (``sbf_modulate`` without ``out_groups``, then
``triplet_aggregate`` by the center edges) and, where that directory's
``sbf_modulate`` takes ``out_groups``, ``summed``.  Both are timed by this
checkout's ``chip_smoke.py`` helpers (the profiler's device time of one call
and its event-timed time), so the two directories are timed alike.

Each worker also keeps kernel B's float32 backward on each stream, summed by
center edge and as rows (``backward_outputs``: tables, weights and output
gradients drawn after the timed cases), which no run times.

Printed: the card's name and power limit, then one JSON line per run.  The
sums of every case in every run are the same function of the same inputs;
it exits non-zero if a run failed or a sum differs from the first run's by
more than 1e-4 + 1e-4 |x|.  Each line also says whether every kept tensor,
the sums and the backward's gradients, equals the first run's bit for bit
(``bitwise_equal_to_first_run``): float32 work whose arithmetic a change
kept gives the parent's bits.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

NS, DIM = 7, 16
CUTOFF_L, CUTOFF_G = 2.6, 20.0  # the RNA model's cutoffs (serve.py's config)
KINDS = {"t2": ("t2_kj", "cbf2"), "t1": ("t1_jj", "cbf1")}


def export_batch(structures: int, atoms: int, seed: int) -> dict:
    """The t2/t1 triplet arrays of the scoring batch of ``structures``
    synthetic structures, with the CSR of each neighbour index and the
    triplets' center edges, as CPU tensors."""
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import synthetic_rna_dataset

    mols = synthetic_rna_dataset(structures, seed=seed, n_atoms=atoms)
    gb = next(iter(GraphLoader(mols, "rna", CUTOFF_L, CUTOFF_G, batch_size=structures,
                               ladder_pads=True)))
    import torch

    from pamnet_tpu_torch.data.batch import build_perm_np

    el = gb.el_src.shape[0]
    batch = {"el": el}
    for kind, (idx, cbf) in KINDS.items():
        ids, valid = getattr(gb, idx), gb.valid[kind]
        perm, poff = build_perm_np(ids.numpy(), valid, el, ids.shape[0])
        batch[kind] = {"idx": ids, "cbf": getattr(gb, cbf),
                       "mask": getattr(gb, kind + "_mask"),
                       "off": getattr(gb, kind + "_ji_off"), "valid": valid,
                       "ids": getattr(gb, kind + "_ji"), "perm": torch.from_numpy(perm),
                       "poff": torch.from_numpy(poff)}
    return batch


def cases(batch: dict, kind: str, gen, device: str) -> dict:
    """The calls of stream ``kind`` on ``device``: ``rows + sum`` and, where
    the imported ``sbf_modulate`` takes ``out_groups``, ``summed``; tables
    and weights drawn from ``gen``."""
    import torch

    from pamnet_tpu_torch.ops.sbf_modulate import sbf_modulate
    from pamnet_tpu_torch.ops.triplet import Groups, triplet_aggregate

    a = {k: v.to(device) if torch.is_tensor(v) else v for k, v in batch[kind].items()}
    el, d = batch["el"], DIM
    r = lambda *s: torch.randn(*s, device=device, generator=gen)  # noqa: E731
    args = (r(el, NS * d), r(el, d), a["cbf"], r(d), r(d, d) / d**0.5, r(d),
            r(d, d) / d**0.5, r(d), a["idx"], a["mask"])
    off, valid = a["off"], a["valid"]
    out = {"rows + sum": lambda: triplet_aggregate(sbf_modulate(*args), off, total=valid)}
    if "out_groups" in inspect.signature(sbf_modulate).parameters:
        groups = Groups(off, None, valid)
        out["summed"] = lambda: sbf_modulate(*args, out_groups=groups)
    return out


def backward_outputs(batch: dict, kind: str, gen, device: str) -> dict:
    """Kernel B's float32 backward on stream ``kind``, summed by center edge
    and as rows, on tables, weights and output gradients drawn from
    ``gen``: each of its seven gradients, by name."""
    import torch

    from pamnet_tpu_torch.ops.sbf_modulate import sbf_modulate_backward
    from pamnet_tpu_torch.ops.triplet import Groups

    a = {k: v.to(device) if torch.is_tensor(v) else v for k, v in batch[kind].items()}
    el, d = batch["el"], DIM
    r = lambda *s: torch.randn(*s, device=device, generator=gen)  # noqa: E731
    args = (r(el, NS * d), r(el, d), a["cbf"], r(d), r(d, d) / d**0.5, r(d),
            r(d, d) / d**0.5, r(d), a["idx"], a["mask"])
    groups = Groups(a["poff"], a["perm"], a["valid"])
    out_groups = Groups(a["off"], None, a["valid"])
    runs = {"summed": sbf_modulate_backward(*args, groups, r(el, d), out_groups, a["ids"]),
            "rows": sbf_modulate_backward(*args, groups, r(a["idx"].shape[0], d))}
    return {f"backward {kind} {name} {i}": g for name, grads in runs.items()
            for i, g in enumerate(grads)}


def _smoke_helpers():
    """This checkout's ``chip_smoke.py``, for its timing helpers."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _worker(batch_path: str, seed: int, sums_path: str) -> dict:
    """Times the cases of both streams with the ``pamnet_tpu_torch`` of the
    working directory; keeps their sums in ``sums_path``."""
    import torch

    smoke = _smoke_helpers()
    batch = torch.load(batch_path)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    res, sums = {}, {}
    with torch.inference_mode():
        for kind in KINDS:
            res[kind] = {}
            for name, fn in cases(batch, kind, gen, "cuda").items():
                sums[f"{kind} {name}"] = fn().cpu()
                res[kind][name] = {"device_ms": smoke.device_ms(fn), "ms": smoke.time_ms(fn)}
        for kind in KINDS:
            sums.update({k: v.cpu() for k, v in backward_outputs(batch, kind, gen, "cuda").items()})
    torch.save(sums, sums_path)
    return res


def max_excess(sums: dict, first: dict) -> float:
    """The largest difference of ``sums`` from ``first``'s t2 and t1 sums
    (whichever case each holds) over its limit 1e-4 + 1e-4 |x|."""
    worst = 0.0
    for kind in KINDS:
        ref = next(v for k, v in first.items() if k.startswith(kind))
        for key in (k for k in sums if k.startswith(kind)):
            diff = (sums[key].double() - ref.double()).abs()
            worst = max(worst, float((diff / (1e-4 + 1e-4 * ref.double().abs())).max()))
    return worst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent")
    parser.add_argument("--change")
    parser.add_argument("--order", default="p,c,c,p,p,c")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--structures", type=int, default=16)
    parser.add_argument("--atoms", type=int, default=2100)
    parser.add_argument("--out", default=os.path.join("build", "kernel_b_compare"))
    parser.add_argument("--worker", nargs=2, metavar=("BATCH", "SUMS"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        sys.path.insert(0, os.getcwd())
        print(json.dumps(_worker(args.worker[0], args.seed, args.worker[1])), flush=True)
        return 0
    if not (args.parent and args.change):
        parser.error("--parent and --change are required")

    import torch

    if not torch.cuda.is_available():
        print("kernel_b_compare: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    batch_path = os.path.join(out, "batch.pt")
    torch.save(export_batch(args.structures, args.atoms, args.seed), batch_path)
    failed, first = 0, None
    for i, which in enumerate(args.order.split(",")):
        cwd = {"p": args.parent, "c": args.change}[which]
        sums_path = os.path.join(out, f"{i}_{which}.pt")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--seed",
                               str(args.seed), "--worker", batch_path, sums_path],
                              cwd=cwd, capture_output=True, text=True)
        with open(os.path.join(out, f"{i}_{which}.out"), "w") as f:
            f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        line = {"run": i, "tree": which, "returncode": proc.returncode}
        if proc.returncode == 0:
            sums = torch.load(sums_path)
            first = first or sums
            line.update(json.loads(proc.stdout.strip().splitlines()[-1]))
            line["max_diff_over_limit"] = max_excess(sums, first)
            line["bitwise_equal_to_first_run"] = sums.keys() == first.keys() and all(
                torch.equal(v, first[k]) for k, v in sums.items())
            failed += line["max_diff_over_limit"] > 1.0
        failed += proc.returncode != 0
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
