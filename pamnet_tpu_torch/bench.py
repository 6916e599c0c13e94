"""Throughput bench of the port (JAX counterpart: the repository's
``bench.py``, whose four JSON lines, metric names, units and estimated
baselines it prints in the same order):

    python -m pamnet_tpu_torch.bench [--device cpu] [--small] [--geometry host]
                                     [--dtype float32]

  {"metric": "qm9_pamnet_d128_L6_train_throughput", "value": N,
   "unit": "molecules/sec/chip", "vs_baseline": N, "baseline": 450.0,
   "baseline_estimated": true, ...}
  {"metric": "rna_scoring_throughput", ...}
  {"metric": "qm9_epoch_wall_throughput", ...}
  {"metric": "pdbbind_train_throughput", ...}

``PAMNET_BENCH_TASK=qm9|rna|epoch|pdbbind`` prints one line.

1. QM9 training at the recipe (dim 128, 6 layers, batch 32, L1, Adam + clip
   1000 + EMA 0.999, warmup-exponential) on 8 resident batches of synthetic
   molecules (seed 480) at the loader's worst-case pads.
2. RNA scoring: one batch of 16 synthetic 2,100-atom structures through the
   published RNA model (dim 16, 1 layer, folded) with seeded weights; the
   JAX line reads the RNA-Puzzles candidates and ``pamnet_rna.pt``, which
   are not in the repository.
3. The QM9 epoch wall: JAX's chain (its ``bench.py:134-135``): shuffled
   batches of 4,096 synthetic molecules collated and copied to the card in
   two threads beside the steps (``run_epoch``), and the EMA evaluation of
   a 512-molecule split staged on the card once (``StackedEval``), per
   epoch; the first epoch is not timed.
4. PDBbind training at the README recipe (dim 128, 3 layers, batch 32, MSE,
   the multistep schedule at lr 1e-5 as the JAX line) for 64 steps over
   4 x 32 realistic synthetic complexes (seed 805) resident on the device.

The epoch wall's training batches and the PDBbind batches derive their
geometry on the device, as the JAX bench's do (``wire_geometry="derive"``);
``--geometry host`` ships the host geometry instead.  The QM9 step line and
the RNA scoring line keep host geometry, as the JAX bench does.  Each line
gives the seconds its structures took to build on the host
(``structure_build_s``).

Each value is the median over timed windows (the host's spread is wide);
the windows, the device ms per step (the profiler's kernel time) and the
dtype go to stderr.  The QM9 step line, the epoch wall and the PDBbind line
train in bfloat16 mixed precision and the RNA scoring line runs in float32,
as the JAX bench's lines do (its ``PAMNET_BENCH_DTYPE``); ``--dtype float32``
trains the three in float32 with TF32 off.  Every line names the device it ran on;
``--device cpu`` (and ``--small``: training at dim 32, which no dtype folds,
1 layer, a few small structures) runs the same code on the CPU for the
tests, with no device time.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys
import time

import torch

from pamnet_tpu_torch.config import PAMNetConfig, resolve_device, set_matmul_precision
from pamnet_tpu_torch.profiling import device_ms, time_ms

# The JAX bench's estimated reference-GPU throughputs (bench.py:38-49 there).
REFERENCE_GPU_MOL_PER_SEC = 450.0
REFERENCE_GPU_RNA_GRAPHS_PER_SEC = 60.0
REFERENCE_GPU_PDBBIND_GRAPHS_PER_SEC = 100.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def line(metric: str, value: float, unit: str, baseline: float, device: torch.device,
         **extra) -> dict:
    value = round(value, 1)  # the ratio of the value as printed
    record = {"metric": metric, "value": value, "unit": unit,
              "vs_baseline": round(value / baseline, 2), "baseline": baseline,
              "baseline_estimated": True,
              "device": (torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"),
              **extra}
    print(json.dumps(record), flush=True)
    return record


def windows_ms(fn, device: torch.device, windows: int, calls: int) -> list[float]:
    """ms per call of ``windows`` windows of ``calls`` calls in a row: CUDA
    events on the card, the host's clock on the CPU."""
    return [time_ms(fn, calls, warmup=0, cuda=device.type == "cuda") for _ in range(windows)]


def kernel_ms(fn, device: torch.device, calls: int) -> float | None:
    """The card's kernel time of one call, from the profiler over ``calls``
    calls (None on the CPU: not measured)."""
    return device_ms(fn, calls) if device.type == "cuda" else None


def train_windows(device: torch.device, model, opt, ema, batches, loss_kind: str,
                  windows: int, steps: int) -> tuple[list[float], float | None]:
    """ms per step of ``windows`` windows of ``steps`` training steps cycling
    over resident ``batches`` (after one warm-up pass), and the device ms
    per step over one more pass."""
    from pamnet_tpu_torch.train.loop import train_step

    cycle = itertools.cycle(batches)
    step = lambda: train_step(model, opt, ema, next(cycle), loss_kind)  # noqa: E731
    for _ in batches:
        step()
    times = windows_ms(step, device, windows, steps)
    loss = float(step())
    if loss != loss:
        raise AssertionError("the bench's training loss is not finite")
    return times, kernel_ms(step, device, len(batches))


def report(name: str, times: list[float], device_ms: float | None, unit: str,
           dtype: str) -> None:
    log(f"{name}: ms per {unit} by window {[round(t, 3) for t in times]}, median "
        f"{statistics.median(times):.3f}; device ms per {unit} "
        f"{'not measured' if device_ms is None else f'{device_ms:.3f}'}; {dtype}"
        f"{', TF32 off' if dtype == 'float32' else ' mixed precision'}")


def bench_qm9(args, device: torch.device) -> float:
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.ema import ema_init
    from pamnet_tpu_torch.train.loop import Optimizer
    from pamnet_tpu_torch.train.schedules import warmup_exponential

    bs = 32
    cfg = PAMNetConfig(dataset="QM9", dim=args.dim, n_layer=args.qm9_layers,
                       compute_dtype=args.dtype)
    mols = synthetic_qm9_dataset(16 * bs if not args.small else 2 * bs, seed=480)
    t0 = time.perf_counter()
    loader = GraphLoader(mols, "qm9", cfg.cutoff_l, cfg.cutoff_g, bs, drop_last=True,
                         build_perms=True)
    build_s = time.perf_counter() - t0
    batches = [gb.to(device) for _, gb in zip(range(8), loader)]
    log(f"qm9: pads {loader.pads}, {len(batches)} resident batches")
    model = PAMNet(cfg, torch.Generator().manual_seed(480)).to(device)
    opt = Optimizer(model.parameters(), warmup_exponential(1e-4, len(loader)),
                    clip_norm=1000.0)
    times, dev = train_windows(device, model, opt, ema_init(model.state_dict()), batches,
                               "l1", args.windows, args.steps)
    report("qm9", times, dev, "step", cfg.compute_dtype)
    ms = statistics.median(times)
    line(f"qm9_pamnet_d{cfg.dim}_L{cfg.n_layer}_train_throughput", bs / ms * 1e3,
         "molecules/sec/chip", REFERENCE_GPU_MOL_PER_SEC, device, ms_per_step=round(ms, 3),
         device_ms_per_step=dev, geometry="host", compute_dtype=cfg.compute_dtype,
         structure_build_s=round(build_s, 3))
    return bs / ms * 1e3


def bench_rna(args, device: torch.device) -> None:
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import synthetic_rna_dataset
    from pamnet_tpu_torch.models.pamnet import PAMNet

    cfg = PAMNetConfig(dataset="rna_native", dim=16, n_layer=1, cutoff_l=2.6,
                       cutoff_g=20.0, flow="target_to_source")
    t0 = time.perf_counter()
    mols = synthetic_rna_dataset(4 if args.small else 16, seed=0,
                                 n_atoms=120 if args.small else 2100)
    t1 = time.perf_counter()
    gb = next(iter(GraphLoader(mols, "rna", cfg.cutoff_l, cfg.cutoff_g, batch_size=16,
                               ladder_pads=True))).to(device)
    build_s = time.perf_counter() - t1
    log(f"rna: {len(mols)} synthetic structures, generated and built in "
        f"{time.perf_counter() - t0:.1f}s (built in {build_s:.1f}s); valid {gb.valid}")
    model = PAMNet(cfg, torch.Generator().manual_seed(0)).to(device).eval()
    with torch.inference_mode():
        fwd = lambda: model(gb)  # noqa: E731
        fwd()
        times = windows_ms(fwd, device, args.windows, args.forwards)
        dev = kernel_ms(fwd, device, 3)
        if not bool(torch.isfinite(model(gb)).all()):
            raise AssertionError("non-finite scores")
    report("rna", times, dev, "batch", cfg.compute_dtype)
    ms = statistics.median(times)
    line("rna_scoring_throughput", len(mols) / ms * 1e3, "graphs/sec/chip",
         REFERENCE_GPU_RNA_GRAPHS_PER_SEC, device, ms_per_batch=round(ms, 3),
         device_ms_per_batch=dev, geometry="host", compute_dtype=cfg.compute_dtype,
         structure_build_s=round(build_s, 3))


def bench_epoch(args, device: torch.device, device_step_mol_s: float | None) -> None:
    import numpy as np

    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.ema import ema_init
    from pamnet_tpu_torch.train.loop import Optimizer, StackedEval, mae, run_epoch
    from pamnet_tpu_torch.train.schedules import warmup_exponential

    bs = 32
    n_train = 2 * bs if args.small else 4096
    n_val = max(n_train // 8, bs)
    cfg = PAMNetConfig(dataset="QM9", dim=args.dim, n_layer=args.qm9_layers,
                       compute_dtype=args.dtype)
    mols = synthetic_qm9_dataset(n_train + n_val, seed=481)
    t0 = time.perf_counter()
    common = dict(dataset_kind="qm9", cutoff_l=cfg.cutoff_l, cutoff_g=cfg.cutoff_g,
                  batch_size=bs)
    train_loader = GraphLoader(mols[:n_train], shuffle=True, seed=480, drop_last=True,
                               build_perms=True, wire_geometry=args.geometry, **common)
    val_loader = GraphLoader(mols[n_train:], **common)
    build_s = time.perf_counter() - t0
    log(f"epoch-wall: structure build {build_s:.1f}s (train={n_train} val={n_val}, "
        f"{args.geometry} geometry)")
    val_eval = StackedEval(val_loader, device)
    model = PAMNet(cfg, torch.Generator().manual_seed(480)).to(device)
    opt = Optimizer(model.parameters(), warmup_exponential(1e-4, len(train_loader)),
                    clip_norm=1000.0)
    ema = ema_init(model.state_dict())
    ema_model = PAMNet(cfg).to(device)

    def epoch() -> tuple[float, int, float]:
        t0 = time.perf_counter()
        _, ng, _, _ = run_epoch(model, opt, ema, train_loader, device, "l1")
        ema_model.load_state_dict(ema)
        val_mae = mae(ema_model, val_eval, device)
        return time.perf_counter() - t0, ng, val_mae

    epoch()  # warm-up epoch: allocator and library set-up, not timed
    runs = [epoch() for _ in range(args.epoch_windows)]
    rates = [ng / s for s, ng, _ in runs]
    log(f"epoch-wall: {[round(s, 2) for s, _, _ in runs]} s per epoch, val MAE "
        f"{[round(v, 3) for _, _, v in runs]}; {cfg.compute_dtype}")
    mol_s = float(np.median(rates))
    extra = {"epoch_seconds": round(statistics.median(s for s, _, _ in runs), 2),
             "geometry": args.geometry, "compute_dtype": cfg.compute_dtype,
             "structure_build_s": round(build_s, 3)}
    if device_step_mol_s:
        extra["ratio_to_device_step"] = round(mol_s / device_step_mol_s, 3)
    line("qm9_epoch_wall_throughput", mol_s, "molecules/sec/chip",
         REFERENCE_GPU_MOL_PER_SEC, device, **extra)


def bench_pdbbind(args, device: torch.device) -> None:
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule,
                                                 synthetic_pdbbind_complex_dataset,
                                                 synthetic_pdbbind_dataset)
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.loop import Optimizer
    from pamnet_tpu_torch.train.schedules import multistep

    bs = 32
    cfg = PAMNetConfig(dataset="PDBbind", dim=args.dim, n_layer=args.pdbbind_layers,
                       cutoff_l=2.0, cutoff_g=6.0, compute_dtype=args.dtype)
    t0 = time.perf_counter()
    make = synthetic_pdbbind_dataset if args.small else synthetic_pdbbind_complex_dataset
    mols = [pdbbind_molecule(g) for g in make((1 if args.small else 4) * bs, seed=805)]
    loader = GraphLoader(mols, "pdbbind", cfg.cutoff_l, cfg.cutoff_g, bs, drop_last=True,
                         build_perms=True, wire_geometry=args.geometry)
    batches = [gb.to(device) for gb in loader]
    build_s = time.perf_counter() - t0
    log(f"pdbbind: structure build {build_s:.1f}s, pads {loader.pads}, "
        f"{len(batches)} resident batches, {args.geometry} geometry")
    model = PAMNet(cfg, torch.Generator().manual_seed(480)).to(device)
    opt = Optimizer(model.parameters(), multistep(1e-5, steps_per_epoch=len(loader)))
    times, dev = train_windows(device, model, opt, None, batches, "mse", args.windows,
                               args.pdbbind_steps // args.windows)
    report("pdbbind", times, dev, "step", cfg.compute_dtype)
    ms = statistics.median(times)
    line("pdbbind_train_throughput", bs / ms * 1e3, "graphs/sec/chip",
         REFERENCE_GPU_PDBBIND_GRAPHS_PER_SEC, device, ms_per_step=round(ms, 3),
         device_ms_per_step=dev, geometry=args.geometry, compute_dtype=cfg.compute_dtype,
         structure_build_s=round(build_s, 3))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--small", action="store_true",
                        help="dim 32, 1 layer, a few small structures (tests)")
    parser.add_argument("--geometry", choices=("derive", "host"), default="derive",
                        help="geometry of the epoch wall's training batches and the "
                             "PDBbind batches (derive: computed on the device)")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                        help="compute type of the QM9 step, epoch-wall and PDBbind lines "
                             "(the JAX bench's default, bfloat16); RNA scoring runs float32")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_matmul_precision()
    small = args.small
    args.dim = 32 if small else 128
    args.qm9_layers = 1 if small else 6
    args.pdbbind_layers = 1 if small else 3
    args.windows = 2 if small else 4
    args.steps = 2 if small else 32
    args.forwards = 2 if small else 10
    args.epoch_windows = 1 if small else 3
    args.pdbbind_steps = 4 if small else 64

    task = os.environ.get("PAMNET_BENCH_TASK", "both")
    if task == "rna":
        bench_rna(args, device)
    elif task == "epoch":
        bench_epoch(args, device, None)
    elif task == "pdbbind":
        bench_pdbbind(args, device)
    else:
        mol_s = bench_qm9(args, device)
        if task == "both":
            bench_rna(args, device)
            bench_epoch(args, device, mol_s)
            bench_pdbbind(args, device)


if __name__ == "__main__":
    main()
