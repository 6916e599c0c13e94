"""QM9 property-regression training on the port (JAX counterpart: the
repository's ``main_qm9.py``; reference: main_qm9.py).

    python -m pamnet_tpu_torch.main_qm9 [--synthetic] [--limit N] [--device cpu]

The reference's flags and recipe (README.md:95 of the reference: PAMNet,
target 7, dim 128, 6 layers, batch 32, lr 1e-4; L1 loss, Adam with global
norm clip 1000, EMA 0.999, the warmup-exponential schedule) in bfloat16
mixed precision by default, as the JAX ``main_qm9.py`` trains
(``--compute_dtype float32``: float32 with TF32 off); ``--model PAMNet_s``
trains the one-hop variant at the same recipe.  ``--synthetic`` trains on generated molecules when the QM9 raw
files are not staged under ``./data/<dataset>/raw``; ``--limit`` keeps the
first N molecules.  ``--device`` defaults to ``cuda`` and raises without a
card.  Training batches carry positions and integer tables only and the
step derives distances and the spherical basis on the device, as the JAX
``main_qm9.py`` streams by default; ``--host_geometry`` ships the host geometry
instead, ``--device_basis`` drops the host basis from the evaluation
batches too, and ``--device_graph`` rebuilds the radius graph from the
positions on the device in every forward.  Evaluation runs under the EMA
weights.  Each best validation
MAE writes the EMA weights to ``<save_dir>/<dataset>/best_model.pt`` (the
reference's ``state_dict`` names); every epoch writes the full training state
to ``<save_dir>/<dataset>/last.ckpt``, which ``--resume`` continues from bit
for bit.  Without ``--synthetic`` the molecules come from
``./data/<dataset>``: its raw SDF files or PyG's preprocessed
``processed/data_v2.pt`` / ``raw/qm9_v2.pt`` (``data/qm9.py::load_qm9``),
downloaded where none is there (a host without network raises with staging
instructions).  ``--structure_cache DIR`` serves the built structures from
an on-disk cache (``data/structcache.py``, the JAX package's format;
``--cache_workers N`` builds its missing chunks in N processes);
``--trace_dir DIR`` writes a profiler trace of epoch 0 (``profiling.py::trace``).
An epoch runs JAX's pipeline (``train/loop.py::run_epoch``): batches
collated in one thread and copied to the card in another while the steps
run; the validation and test splits are collated and staged on the card
once (``StackedEval``).
``--dp N`` trains data-parallel on N ranks, one card each
(``parallel/``, ``train/loop.py::dp_train_step``; on the CPU over gloo), N
batches a step; rank 0 alone prints and writes the files.
"""

from __future__ import annotations

import argparse
import contextlib
import os.path as osp
import sys
import time

import numpy as np
import torch

from pamnet_tpu_torch.config import PAMNetConfig, resolve_device, set_matmul_precision
from pamnet_tpu_torch.data.loader import (add_cache_flags, add_geometry_flags, build_note,
                                          cache_options, geometry_options)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=480, help="Random seed.")
    parser.add_argument("--dataset", type=str, default="QM9", help="Dataset to be used")
    parser.add_argument("--model", type=str, default="PAMNet",
                        choices=["PAMNet", "PAMNet_s"], help="Model to be used")
    parser.add_argument("--epochs", type=int, default=300, help="Number of epochs to train.")
    parser.add_argument("--lr", type=float, default=1e-4, help="Initial learning rate.")
    parser.add_argument("--wd", type=float, default=0, help="Weight decay (L2 loss).")
    parser.add_argument("--n_layer", type=int, default=6, help="Number of hidden layers.")
    parser.add_argument("--dim", type=int, default=128, help="Size of input hidden units.")
    parser.add_argument("--batch_size", type=int, default=32, help="batch_size")
    parser.add_argument("--dp", type=int, default=0,
                        help="Data-parallel ranks, one card each (0 = one process)")
    parser.add_argument("--target", type=int, default=7,
                        help="Index of target for prediction")
    parser.add_argument("--cutoff_l", type=float, default=5.0, help="cutoff in local layer")
    parser.add_argument("--cutoff_g", type=float, default=5.0, help="cutoff in global layer")
    parser.add_argument("--synthetic", action="store_true",
                        help="Train on synthetic molecules (no QM9 files needed)")
    parser.add_argument("--limit", type=int, default=0,
                        help="Keep the first N molecules (smoke runs)")
    parser.add_argument("--metrics_csv", type=str, default="",
                        help="Append per-epoch metrics to this CSV file")
    parser.add_argument("--save_dir", type=str, default="save",
                        help="Directory for <dataset>/best_model.pt and last.ckpt")
    parser.add_argument("--resume", type=str, default="",
                        help="Checkpoint to resume the full training state from")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="float32 or bfloat16 (mixed precision: float32 parameters, geometry, "
                             "sums and pool)")
    parser.add_argument("--device_graph", action="store_true",
                        help="Rebuild the radius graph from the positions on the device "
                             "in every forward (the reference's per-forward "
                             "construction, models.py:110)")
    parser.add_argument("--trace_dir", type=str, default="",
                        help="Capture a torch.profiler trace (CPU and CUDA activities, "
                             "Chrome trace JSON) of epoch 0 into this directory")
    add_geometry_flags(parser)
    add_cache_flags(parser, workers=True)
    return parser


def load_molecules(args) -> tuple[list[dict], int, int]:
    """(molecules, train count, val count) with the reference's splits:
    synthetic 80/10/10; QM9 shuffled with the seed, then 110k/10k/rest, or
    80/10/10 of the first ``--limit`` (reference main_qm9.py:71-76)."""
    if args.synthetic:
        from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset

        mols = synthetic_qm9_dataset(args.limit or 2048, seed=args.seed)
        print("Using SYNTHETIC molecules (no QM9 raw files).", file=sys.stderr)
        return mols, int(len(mols) * 0.8), int(len(mols) * 0.1)
    from pamnet_tpu_torch.data.qm9 import load_qm9, select_target

    # allow_download: the reference downloads missing raw files
    # (qm9_dataset.py:156-168); on a host without egress it raises with
    # staging instructions.
    mols = select_target(load_qm9(osp.join(".", "data", args.dataset), allow_download=True),
                         args.target)
    order = np.random.default_rng(args.seed).permutation(len(mols))
    mols = [mols[i] for i in order]
    if args.limit:
        mols = mols[:args.limit]
        return mols, int(len(mols) * 0.8), int(len(mols) * 0.1)
    return mols, 110000, 10000


def main(argv=None) -> dict:
    """Train and evaluate (under ``--dp``, on its ranks); returns the final
    metrics (rank 0's)."""
    from pamnet_tpu_torch.parallel import launch

    args = build_parser().parse_args(argv)
    return launch(train, args, resolve_device(args.device))


def train(args, device, dp: int) -> dict:
    """The training run of ``main`` on ``device``, as one rank of ``dp`` > 1
    (the caller's process group) or alone."""
    if device.type == "cuda":
        set_matmul_precision()

    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.parallel import rank
    from pamnet_tpu_torch.profiling import trace
    from pamnet_tpu_torch.train.checkpoint import (export_state_dict, load_checkpoint,
                                                   save_checkpoint)
    from pamnet_tpu_torch.train.ema import ema_init
    from pamnet_tpu_torch.train.loop import Optimizer, StackedEval, log_csv, mae, run_epoch
    from pamnet_tpu_torch.train.schedules import warmup_exponential

    mols, n_train, n_val = load_molecules(args)
    cfg = PAMNetConfig(dataset="QM9", dim=args.dim, n_layer=args.n_layer,
                       cutoff_l=args.cutoff_l, cutoff_g=args.cutoff_g,
                       variant="s" if args.model == "PAMNet_s" else "full",
                       compute_dtype=args.compute_dtype, device_graph=args.device_graph)
    train_mols = mols[:n_train]
    val_mols = mols[n_train:n_train + n_val]
    test_mols = mols[n_train + n_val:]

    t_load = time.time()
    common = dict(dataset_kind="qm9", cutoff_l=cfg.cutoff_l, cutoff_g=cfg.cutoff_g,
                  batch_size=args.batch_size, variant=cfg.variant, **cache_options(args))
    train_geometry, eval_geometry = geometry_options(args)
    train_loader = GraphLoader(train_mols, shuffle=True, seed=args.seed, drop_last=True,
                               build_perms=True, **common, **train_geometry)
    # Evaluation composition is free: the metric is a mean over molecules.
    val_loader = GraphLoader(val_mols, **common, **eval_geometry)
    test_loader = GraphLoader(test_mols, **common, **eval_geometry)
    note = build_note(time.time() - t_load, (train_loader, val_loader, test_loader))
    # Each evaluation split collated once and staged on the card once (JAX
    # main_qm9.py:352-353); the evaluation loaders' structures and plans are
    # freed here.
    val_eval, test_eval = StackedEval(val_loader, device, dp), StackedEval(test_loader, device, dp)
    del val_loader, test_loader
    print(f"Data loaded! train={len(train_mols)} val={len(val_mols)} "
          f"test={len(test_mols)} pads={train_loader.pads} " + note)

    model = PAMNet(cfg, torch.Generator().manual_seed(args.seed)).to(device)
    print("Number of model parameters:", sum(p.numel() for p in model.parameters()))
    steps_per_epoch = max(len(train_loader) // max(dp, 1), 1)
    # The reference advances the fractional epoch by step/(len(train)/bs)
    # (main_qm9.py:114), a float divisor distinct from the batch count; under
    # DP the step count is divided instead (the JAX main_qm9.py:306-312).
    frac = len(train_mols) / args.batch_size if dp <= 1 else None
    optimizer = Optimizer(
        model.parameters(),
        warmup_exponential(args.lr, steps_per_epoch, frac_steps_per_epoch=frac),
        weight_decay=args.wd, clip_norm=1000.0,
    )
    ema = ema_init(model.state_dict())
    ema_model = PAMNet(cfg).to(device)

    first_epoch, best_val, test_mae, train_maes = 0, None, float("nan"), []
    if args.resume:
        extra = load_checkpoint(args.resume, model, optimizer, ema)
        first_epoch, best_val, test_mae = (extra["epoch"], extra["best_val_mae"],
                                           extra["test_mae"])
        train_loader.set_rng_state(extra["loader_rng"])
        print(f"Resumed full train state from {args.resume} at step {optimizer.count}")
    save_folder = osp.join(".", args.save_dir, args.dataset)
    writes = rank() == 0

    print("Start training!")
    for epoch in range(first_epoch, args.epochs):
        # --trace_dir: a trace of epoch 0's training (the JAX main_qm9.py's span).
        tracing = (trace(args.trace_dir, device, f"epoch0_rank{rank()}")
                   if args.trace_dir and epoch == 0 else contextlib.nullcontext())
        t0 = time.time()
        with tracing:
            loss_sum, ng, _, _ = run_epoch(model, optimizer, ema, train_loader, device, "l1", dp)
        train_mae = loss_sum / max(ng, 1)
        train_maes.append(train_mae)
        # Evaluation under the EMA weights (reference: main_qm9.py:29-37,120).
        ema_model.load_state_dict(ema)
        val_mae = mae(ema_model, val_eval, device, dp)
        if best_val is None or val_mae <= best_val:
            test_mae = mae(ema_model, test_eval, device, dp)
            best_val = val_mae
            if writes:
                export_state_dict(ema, osp.join(save_folder, "best_model.pt"))
        dt = time.time() - t0
        print(f"Epoch: {epoch + 1:03d}, Train MAE: {train_mae:.7f}, "
              f"Val MAE: {val_mae:.7f}, Test MAE: {test_mae:.7f} "
              f"({dt:.1f}s, {ng / dt:.0f} mol/s)", flush=True)
        if args.metrics_csv and writes:
            log_csv(args.metrics_csv, dict(
                epoch=epoch + 1, train_mae=train_mae, val_mae=val_mae,
                test_mae=test_mae, seconds=round(dt, 2), mol_per_sec=round(ng / dt, 1)))
        if writes:
            save_checkpoint(osp.join(save_folder, "last.ckpt"), model, optimizer, ema, extra=dict(
                epoch=epoch + 1, best_val_mae=best_val, test_mae=test_mae,
                loader_rng=train_loader.rng_state()))
    print("Best Validation MAE:", best_val)
    print("Testing MAE:", test_mae)
    return {"train_mae": train_maes, "best_val_mae": best_val, "test_mae": test_mae}


if __name__ == "__main__":
    main()
