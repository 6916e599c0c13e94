"""QM9 property-regression training on the port (JAX counterpart: the
repository's ``main_qm9.py``; reference: main_qm9.py).

    python -m pamnet_tpu_torch.main_qm9 [--synthetic] [--limit N] [--device cpu]

The reference's flags and recipe (README.md:95 of the reference: PAMNet,
target 7, dim 128, 6 layers, batch 32, lr 1e-4; L1 loss, Adam with global
norm clip 1000, EMA 0.999, the warmup-exponential schedule) in float32 with
TF32 off.  ``--synthetic`` trains on generated molecules when the QM9 raw
files are not staged under ``./data/<dataset>/raw``; ``--limit`` keeps the
first N molecules.  ``--device`` defaults to ``cuda`` and raises without a
card.  Batches carry host-computed geometry (distances and the spherical
basis tables); evaluation runs under the EMA weights.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

from pamnet_tpu_torch.config import PAMNetConfig, resolve_device


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
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


def _log_csv(path: str, row: dict) -> None:
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    new = not osp.exists(path)
    with open(path, "a") as f:
        if new:
            f.write(",".join(row) + "\n")
        f.write(",".join(str(v) for v in row.values()) + "\n")


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

    mols = select_target(load_qm9(osp.join(".", "data", args.dataset)), args.target)
    order = np.random.default_rng(args.seed).permutation(len(mols))
    mols = [mols[i] for i in order]
    if args.limit:
        mols = mols[:args.limit]
        return mols, int(len(mols) * 0.8), int(len(mols) * 0.1)
    return mols, 110000, 10000


def main(argv=None) -> dict:
    """Train and evaluate; returns the final metrics."""
    args = build_parser().parse_args(argv)
    if args.model != "PAMNet":
        raise NotImplementedError("the port trains the full PAMNet only")
    device = resolve_device(args.device)
    if device.type == "cuda":
        # f32 products throughout, as main_qm9.py of the JAX package at
        # --compute_dtype float32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.ema import ema_init
    from pamnet_tpu_torch.train.loop import Optimizer, mae, run_epoch
    from pamnet_tpu_torch.train.schedules import warmup_exponential

    mols, n_train, n_val = load_molecules(args)
    cfg = PAMNetConfig(dataset="QM9", dim=args.dim, n_layer=args.n_layer,
                       cutoff_l=args.cutoff_l, cutoff_g=args.cutoff_g)
    train_mols = mols[:n_train]
    val_mols = mols[n_train:n_train + n_val]
    test_mols = mols[n_train + n_val:]

    t_load = time.time()
    common = dict(dataset_kind="qm9", cutoff_l=cfg.cutoff_l, cutoff_g=cfg.cutoff_g,
                  batch_size=args.batch_size)
    train_loader = GraphLoader(train_mols, shuffle=True, seed=args.seed, drop_last=True,
                               build_perms=True, **common)
    # Evaluation composition is free: the metric is a mean over molecules.
    val_batches = list(GraphLoader(val_mols, **common))
    test_batches = list(GraphLoader(test_mols, **common))
    print(f"Data loaded! train={len(train_mols)} val={len(val_mols)} "
          f"test={len(test_mols)} pads={train_loader.pads} "
          f"({time.time() - t_load:.1f}s structure build)")

    model = PAMNet(cfg, torch.Generator().manual_seed(args.seed)).to(device)
    print("Number of model parameters:", sum(p.numel() for p in model.parameters()))
    steps_per_epoch = max(len(train_loader), 1)
    # The reference advances the fractional epoch by step/(len(train)/bs)
    # (main_qm9.py:114), a float divisor distinct from the batch count.
    frac = len(train_mols) / args.batch_size
    optimizer = Optimizer(
        model.parameters(),
        warmup_exponential(args.lr, steps_per_epoch, frac_steps_per_epoch=frac),
        weight_decay=args.wd, clip_norm=1000.0,
    )
    ema = ema_init(model.state_dict())
    ema_model = PAMNet(cfg).to(device)

    print("Start training!")
    best_val, test_mae, train_maes = None, float("nan"), []
    for epoch in range(args.epochs):
        t0 = time.time()
        loss_sum, ng, _ = run_epoch(model, optimizer, ema, train_loader, device)
        train_mae = loss_sum / max(ng, 1)
        train_maes.append(train_mae)
        # Evaluation under the EMA weights (reference: main_qm9.py:29-37,120).
        ema_model.load_state_dict(ema)
        val_mae = mae(ema_model, val_batches, device)
        if best_val is None or val_mae <= best_val:
            test_mae = mae(ema_model, test_batches, device)
            best_val = val_mae
        dt = time.time() - t0
        print(f"Epoch: {epoch + 1:03d}, Train MAE: {train_mae:.7f}, "
              f"Val MAE: {val_mae:.7f}, Test MAE: {test_mae:.7f} "
              f"({dt:.1f}s, {ng / dt:.0f} mol/s)", flush=True)
        if args.metrics_csv:
            _log_csv(args.metrics_csv, dict(
                epoch=epoch + 1, train_mae=train_mae, val_mae=val_mae,
                test_mae=test_mae, seconds=round(dt, 2), mol_per_sec=round(ng / dt, 1)))
    print("Best Validation MAE:", best_val)
    print("Testing MAE:", test_mae)
    return {"train_mae": train_maes, "best_val_mae": best_val, "test_mae": test_mae}


if __name__ == "__main__":
    main()
