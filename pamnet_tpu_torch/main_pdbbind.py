"""PDBbind binding-affinity training on the port (JAX counterpart: the
repository's ``main_pdbbind.py``; reference: main_pdbbind.py).

    python -m pamnet_tpu_torch.main_pdbbind [--synthetic N] [--limit N] [--device cpu]

The reference's flags and defaults (dim 128, 2 layers, batch 32, lr 5e-4,
cutoffs 2.0/6.0 A, seed 805; the README's recipe trains 3 layers): the full
PAMNet on the PDBbind branch (18 atom features through ``init_linear``, the
signed pool E(complex) - E(pocket) - E(ligand)), MSE, Adam with the
MultiStepLR schedule (x0.2 every 50 epochs), no clip, no EMA, in float32 with
TF32 off (``--compute_dtype bfloat16``: mixed precision, as the JAX bench's
PDBbind line trains).  Data: the TU splits ``train_val`` and ``test`` of ``--data_root``
(default ``./data/<dataset>``; ``python -m pamnet_tpu_torch.preprocess_pdbbind``
writes them from PDBbind's mol2 files), or ``--synthetic N`` generated complexes at
the scale of preprocessed PDBbind graphs (260-420 atoms; the last quarter
tests).  ``train_val`` is shuffled with the seed and split 90/10, the
validation share rounded up (reference main_pdbbind.py:62-66).  After each
epoch the line gives the train RMSE/MAE/SD/Pearson and the test ones at the
best validation RMSE.  Each best validation RMSE writes
``<save_dir>/<dataset>/best_model.pt`` (the reference's ``state_dict``
names); every epoch writes the full training state to
``<save_dir>/<dataset>/last.ckpt``, which ``--resume`` continues from bit for
bit.  ``--device`` defaults to ``cuda`` and raises without a card.
Training batches derive their geometry on the device unless
``--host_geometry``; ``--device_basis`` drops the host basis from the
evaluation batches too.  ``--structure_cache DIR`` serves the built
structures of every split from an on-disk cache (``data/structcache.py``,
the JAX package's format).  ``--dp N`` trains data-parallel on N ranks, one
card each (on the CPU over gloo), N batches a step; rank 0 alone prints
and writes the files.  An epoch runs JAX's pipeline
(``train/loop.py::run_epoch``: batches collated and copied to the card in
two threads beside the steps), and each split is collated and staged on
the card once (``StackedEval``); the training split's batches are the
training loader's first permutation, drawn before the first epoch, as the
JAX driver's ``StackedEval(train_loader)`` draws it, so epoch e trains on
the loader's permutation e + 1, as JAX's does.
"""

from __future__ import annotations

import argparse
import math
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
    parser.add_argument("--seed", type=int, default=805, help="Random seed.")
    parser.add_argument("--dataset", type=str, default="PDBbind", help="Dataset to be used")
    parser.add_argument("--epochs", type=int, default=200, help="Number of epochs to train.")
    parser.add_argument("--lr", type=float, default=5e-4, help="Initial learning rate.")
    parser.add_argument("--wd", type=float, default=0, help="Weight decay (L2 loss).")
    parser.add_argument("--n_layer", type=int, default=2, help="Number of hidden layers.")
    parser.add_argument("--dim", type=int, default=128, help="Size of input hidden units.")
    parser.add_argument("--batch_size", type=int, default=32, help="batch_size")
    parser.add_argument("--dp", type=int, default=0,
                        help="Data-parallel ranks, one card each (0 = one process)")
    parser.add_argument("--cutoff_l", type=float, default=2.0, help="cutoff in local layer")
    parser.add_argument("--cutoff_g", type=float, default=6.0, help="cutoff in global layer")
    parser.add_argument("--data_root", type=str, default=None,
                        help="Directory with the TU splits train_val/ and test/ "
                             "(default ./data/<dataset>)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="Train on N generated complexes (the last quarter tests) "
                             "when the TU files are absent")
    parser.add_argument("--limit", type=int, default=0,
                        help="Keep the first N complexes of each split (smoke runs)")
    parser.add_argument("--save_dir", type=str, default="save",
                        help="Directory for <dataset>/best_model.pt and last.ckpt")
    parser.add_argument("--resume", type=str, default="",
                        help="Checkpoint to resume the full training state from")
    parser.add_argument("--metrics_csv", type=str, default="",
                        help="Append per-epoch metrics to this CSV file")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="float32 or bfloat16 (mixed precision: float32 parameters, geometry, "
                             "sums and pool)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    add_geometry_flags(parser)
    add_cache_flags(parser)
    return parser


def load_complexes(args) -> tuple[list[dict], list[dict], list[dict]]:
    """(train, val, test) molecule dicts (``pos``, ``feat``, ``y``): the TU
    directory where it holds both splits, else ``--synthetic N``."""
    from pamnet_tpu_torch.data.tu import TUDataset, has_tu_split

    root = args.data_root or osp.join(".", "data", args.dataset)
    if has_tu_split(root, "train_val") and has_tu_split(root, "test"):
        refined = TUDataset(root, "train_val").molecules()
        core = TUDataset(root, "test").molecules()
    elif args.synthetic:
        from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule,
                                                     synthetic_pdbbind_complex_dataset)

        if args.synthetic < 4:
            raise ValueError("--synthetic needs at least 4 complexes")
        mols = [pdbbind_molecule(g) for g in
                synthetic_pdbbind_complex_dataset(args.synthetic, seed=args.seed)]
        n_test = args.synthetic // 4
        refined, core = mols[:-n_test], mols[-n_test:]
        print("Using SYNTHETIC complexes (no TU files).", file=sys.stderr)
    else:
        raise FileNotFoundError(
            f"no TU splits train_val/ and test/ under {root}: stage the dataset "
            "there (nothing is downloaded) or pass --synthetic N")
    if args.limit:
        refined, core = refined[:args.limit], core[:args.limit]
    perm = np.random.default_rng(args.seed).permutation(len(refined))
    refined = [refined[i] for i in perm]
    n_train = len(refined) - math.ceil(len(refined) * 0.1)
    return refined[:n_train], refined[n_train:], core


def main(argv=None) -> dict:
    """Train and evaluate (under ``--dp``, on its ranks); returns the
    per-epoch train metrics and the test metrics at the best validation
    RMSE (rank 0's)."""
    from pamnet_tpu_torch.parallel import launch

    args = build_parser().parse_args(argv)
    return launch(train, args, resolve_device(args.device))


def train(args, device, dp: int) -> dict:
    """The training run of ``main`` on ``device``, as one rank of ``dp`` > 1
    (the caller's process group) or alone."""
    if device.type == "cuda":
        set_matmul_precision()

    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.metrics import mae, pearson, rmse, sd
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.parallel import rank
    from pamnet_tpu_torch.train.checkpoint import (export_state_dict, load_checkpoint,
                                                   save_checkpoint)
    from pamnet_tpu_torch.train.loop import Optimizer, StackedEval, log_csv, predict, run_epoch
    from pamnet_tpu_torch.train.schedules import multistep

    t_load = time.time()
    train_mols, val_mols, test_mols = load_complexes(args)
    cfg = PAMNetConfig(dataset="PDBbind", dim=args.dim, n_layer=args.n_layer,
                       cutoff_l=args.cutoff_l, cutoff_g=args.cutoff_g,
                       compute_dtype=args.compute_dtype)
    common = dict(dataset_kind="pdbbind", cutoff_l=cfg.cutoff_l, cutoff_g=cfg.cutoff_g,
                  batch_size=args.batch_size, **cache_options(args))
    train_geometry, eval_geometry = geometry_options(args)
    train_loader = GraphLoader(train_mols, shuffle=True, seed=args.seed, build_perms=True,
                               **common, **train_geometry)
    val_loader = GraphLoader(val_mols, **common, **eval_geometry)
    test_loader = GraphLoader(test_mols, **common, **eval_geometry)
    print(f"Data loaded! train={len(train_mols)} val={len(val_mols)} "
          f"test={len(test_mols)} pads={train_loader.pads} "
          + build_note(time.time() - t_load, (train_loader, val_loader, test_loader)))

    model = PAMNet(cfg, torch.Generator().manual_seed(args.seed)).to(device)
    print("Number of model parameters:", sum(p.numel() for p in model.parameters()))
    optimizer = Optimizer(model.parameters(),
                          multistep(args.lr,
                                    steps_per_epoch=max(len(train_loader) // max(dp, 1), 1)),
                          weight_decay=args.wd)

    def quad(split: StackedEval) -> tuple[float, float, float, float]:
        pred, y = predict(model, split, device, dp)
        return rmse(y, pred), mae(y, pred), sd(y, pred), pearson(y, pred)

    # JAX main_pdbbind.py:224-226.  The training split draws the training
    # loader's first permutation here, before a resumed run restores the
    # loader's generator (whose saved state already counts this draw).
    train_eval = StackedEval(train_loader, device, dp, split="train")
    val_eval = StackedEval(val_loader, device, dp, split="val")
    test_eval = StackedEval(test_loader, device, dp, split="test")
    first_epoch, best_val, test_m = 0, None, (float("nan"),) * 4
    if args.resume:
        extra = load_checkpoint(args.resume, model, optimizer)
        first_epoch, best_val = extra["epoch"], extra["best_val_rmse"]
        test_m = tuple(extra["test_metrics"])
        train_loader.set_rng_state(extra["loader_rng"])
        print(f"Resumed full train state from {args.resume} at step {optimizer.count}")
    save_folder = osp.join(".", args.save_dir, args.dataset)
    writes = rank() == 0

    print("Start training!")
    train_hist = []
    for epoch in range(first_epoch, args.epochs):
        t0 = time.time()
        run_epoch(model, optimizer, None, train_loader, device, "mse", dp)
        train_m = quad(train_eval)
        val_m = quad(val_eval)
        if best_val is None or val_m[0] < best_val:
            test_m = quad(test_eval)
            best_val = val_m[0]
            if writes:
                export_state_dict(model.state_dict(), osp.join(save_folder, "best_model.pt"))
        dt = time.time() - t0
        train_hist.append(train_m)
        print(f"Epoch: {epoch + 1:03d}, Train RMSE: {train_m[0]:.7f}, "
              f"Train MAE: {train_m[1]:.7f}, Train SD: {train_m[2]:.7f}, "
              f"Train P: {train_m[3]:.7f}, Test RMSE: {test_m[0]:.7f}, "
              f"Test MAE: {test_m[1]:.7f}, Test SD: {test_m[2]:.7f}, "
              f"Test P: {test_m[3]:.7f} ({dt:.1f}s)", flush=True)
        if args.metrics_csv and writes:
            log_csv(args.metrics_csv, dict(
                epoch=epoch + 1, train_rmse=train_m[0], train_mae=train_m[1],
                train_sd=train_m[2], train_pearson=train_m[3], test_rmse=test_m[0],
                test_mae=test_m[1], test_sd=test_m[2], test_pearson=test_m[3],
                seconds=round(dt, 2)))
        if writes:
            save_checkpoint(osp.join(save_folder, "last.ckpt"), model, optimizer, extra=dict(
                epoch=epoch + 1, best_val_rmse=best_val, test_metrics=list(test_m),
                loader_rng=train_loader.rng_state()))
    print("Testing RMSE:", test_m[0])
    print("Testing MAE:", test_m[1])
    print("Testing SD:", test_m[2])
    print("Testing P:", test_m[3])
    return {"train": train_hist, "best_val_rmse": best_val, "test": test_m,
            "save_folder": save_folder}


if __name__ == "__main__":
    main()
