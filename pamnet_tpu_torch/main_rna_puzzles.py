"""RNA-Puzzles structure-scoring training on the port (JAX counterpart: the
repository's ``main_rna_puzzles.py``; reference: main_rna_puzzles.py:44-111).

    python -m pamnet_tpu_torch.main_rna_puzzles --dim 16 --n_layer 1 \\
        --batch_size 8 --lr 1e-4 --epochs 15 [--synthetic 32] [--device cpu]

SmoothL1 on the per-structure RMSD score, ``flow='target_to_source'``, Adam
at a constant learning rate with no clip and no EMA, in float32 with TF32
off (``--compute_dtype bfloat16``: mixed precision, float32 parameters,
geometry, sums and pool).  At the published width (dim 16) the
spherical-basis MLP trains folded through the triplet gather, in
``sbf_modulate`` and its backward kernel, in either type.
Data: the TU files of ``--data_root`` (default ``./data/<dataset>``, splits
``train`` and ``val``; ``python -m pamnet_tpu_torch.preprocess_rna_puzzles``
writes them from candidate PDB files) where they are there, or ``--synthetic N`` generated
RNA-like structures (the last quarter validates).  Each best validation loss
writes ``<save_dir>/pamnet_rna_best.pt`` under the reference's ``state_dict``
names, which ``python -m pamnet_tpu_torch.serve --saved_model`` loads; every
epoch writes the full training state to ``<save_dir>/pamnet_rna_last.ckpt``,
which ``--resume`` continues from bit for bit.  ``--device`` defaults to
``cuda`` and raises without a card.  Training batches carry positions and
integer tables only and the step derives the geometry on the device (the
folded stage then reads a radial table computed on the card) unless
``--host_geometry``; ``--device_basis`` drops the host basis from the
validation batches too.  ``--structure_cache DIR`` serves the built
structures from an on-disk cache (``data/structcache.py``, the JAX
package's format).  ``--dp N`` trains data-parallel on N ranks, one
card each (on the CPU over gloo), N batches a step; rank 0 alone prints
and writes the files.  An epoch runs JAX's pipeline
(``train/loop.py::run_epoch``: batches collated and copied to the card in
two threads beside the steps), and the train and val splits are collated
and staged on the card once (``StackedEval``); the train split's batches
are the training loader's first permutation, drawn before the first
epoch, as the JAX driver's ``StackedEval(train_loader)`` draws it, so
epoch e trains on the loader's permutation e + 1, as JAX's does.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys
import time

import torch

from pamnet_tpu_torch.config import PAMNetConfig, resolve_device, set_matmul_precision
from pamnet_tpu_torch.data.loader import (add_cache_flags, add_geometry_flags, build_note,
                                          cache_options, geometry_options)

BEST_NAME = "pamnet_rna_best.pt"
LAST_NAME = "pamnet_rna_last.ckpt"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=40, help="Random seed.")
    parser.add_argument("--dataset", type=str, default="RNA-Puzzles", help="Dataset to be used")
    parser.add_argument("--epochs", type=int, default=150, help="Number of epochs to train.")
    parser.add_argument("--lr", type=float, default=5e-4, help="Initial learning rate.")
    parser.add_argument("--wd", type=float, default=0, help="Weight decay (L2 loss).")
    parser.add_argument("--n_layer", type=int, default=2, help="Number of hidden layers.")
    parser.add_argument("--dim", type=int, default=64, help="Size of input hidden units.")
    parser.add_argument("--batch_size", type=int, default=8, help="batch_size")
    parser.add_argument("--dp", type=int, default=0,
                        help="Data-parallel ranks, one card each (0 = one process)")
    parser.add_argument("--cutoff_l", type=float, default=2.6, help="cutoff in local layer")
    parser.add_argument("--cutoff_g", type=float, default=20.0, help="cutoff in global layer")
    parser.add_argument("--flow", type=str, default="target_to_source",
                        help="Flow direction of message passing")
    parser.add_argument("--data_root", type=str, default=None,
                        help="Directory with the TU splits train/ and val/ "
                             "(default ./data/<dataset>)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="Train on N generated RNA-like structures of 2,100 atoms "
                             "(the last quarter validates) when the TU files are absent")
    parser.add_argument("--limit", type=int, default=0,
                        help="Keep the first N structures of each split (smoke runs)")
    parser.add_argument("--save_dir", type=str, default="save",
                        help=f"Directory for {BEST_NAME} and {LAST_NAME}")
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


def load_structures(args) -> tuple[list[dict], list[dict]]:
    """(train, val) molecule dicts: the TU directory where it holds the
    splits, else ``--synthetic N`` generated structures."""
    from pamnet_tpu_torch.data.tu import TUDataset, has_tu_split

    root = args.data_root or osp.join(".", "data", args.dataset)
    if has_tu_split(root, "train") and has_tu_split(root, "val"):
        train = TUDataset(root, "train").molecules()
        val = TUDataset(root, "val").molecules()
    elif args.synthetic:
        from pamnet_tpu_torch.data.synthetic import synthetic_rna_dataset

        if args.synthetic < 4:
            raise ValueError("--synthetic needs at least 4 structures")
        mols = synthetic_rna_dataset(args.synthetic, seed=args.seed)
        n_val = args.synthetic // 4
        train, val = mols[:-n_val], mols[-n_val:]
        print("Using SYNTHETIC structures (no TU files).", file=sys.stderr)
    else:
        raise FileNotFoundError(
            f"no TU splits train/ and val/ under {root}: stage the dataset "
            "there (nothing is downloaded) or pass --synthetic N")
    if args.limit:
        train, val = train[:args.limit], val[:args.limit]
    return train, val


def main(argv=None) -> dict:
    """Train and validate (under ``--dp``, on its ranks); returns the
    per-epoch losses and the best one (rank 0's)."""
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
    from pamnet_tpu_torch.train.checkpoint import (export_state_dict, load_checkpoint,
                                                   save_checkpoint)
    from pamnet_tpu_torch.train.loop import (Optimizer, StackedEval, log_csv, run_epoch,
                                             smooth_l1)
    from pamnet_tpu_torch.train.schedules import constant

    train_mols, val_mols = load_structures(args)
    print(f"Data loaded! train={len(train_mols)} val={len(val_mols)}")
    cfg = PAMNetConfig(dataset=args.dataset if args.dataset[:3].lower() == "rna"
                       else "rna_train",
                       dim=args.dim, n_layer=args.n_layer, cutoff_l=args.cutoff_l,
                       cutoff_g=args.cutoff_g, flow=args.flow,
                       compute_dtype=args.compute_dtype)
    common = dict(dataset_kind="rna", cutoff_l=cfg.cutoff_l, cutoff_g=cfg.cutoff_g,
                  batch_size=args.batch_size, **cache_options(args))
    train_geometry, eval_geometry = geometry_options(args)
    t_load = time.time()
    train_loader = GraphLoader(train_mols, shuffle=True, seed=args.seed,
                               build_perms=True, **common, **train_geometry)
    val_loader = GraphLoader(val_mols, **common, **eval_geometry)
    print("Structures", build_note(time.time() - t_load, (train_loader, val_loader)))

    model = PAMNet(cfg, torch.Generator().manual_seed(args.seed)).to(device)
    print("Number of model parameters:", sum(p.numel() for p in model.parameters()))
    optimizer = Optimizer(model.parameters(), constant(args.lr), weight_decay=args.wd)
    # JAX main_rna_puzzles.py:213-216.  The train split draws the training
    # loader's first permutation here, before a resumed run restores the
    # loader's generator (whose saved state already counts this draw).
    train_eval = StackedEval(train_loader, device, dp)
    val_eval = StackedEval(val_loader, device, dp)
    first_epoch, best_val_loss = 0, None
    if args.resume:
        extra = load_checkpoint(args.resume, model, optimizer)
        first_epoch, best_val_loss = extra["epoch"], extra["best_val_loss"]
        train_loader.set_rng_state(extra["loader_rng"])
        print(f"Resumed full train state from {args.resume} at step {optimizer.count}")

    best_path = osp.join(".", args.save_dir, BEST_NAME)
    last_path = osp.join(".", args.save_dir, LAST_NAME)
    writes = rank() == 0
    print("Start training!")
    train_losses, val_losses = [], []
    for epoch in range(first_epoch, args.epochs):
        t0 = time.time()
        run_epoch(model, optimizer, None, train_loader, device, "smooth_l1", dp)
        # Both losses are evaluated after the epoch, as the JAX package's
        # main_rna_puzzles.py does.
        train_loss = smooth_l1(model, train_eval, device, dp)
        val_loss = smooth_l1(model, val_eval, device, dp)
        dt = time.time() - t0
        print(f"Epoch: {epoch + 1:03d}, Train Loss: {train_loss:.7f}, "
              f"Val Loss: {val_loss:.7f} ({dt:.1f}s)", flush=True)
        train_losses.append(train_loss)
        val_losses.append(val_loss)
        if args.metrics_csv and writes:
            log_csv(args.metrics_csv, dict(epoch=epoch + 1, train_loss=train_loss,
                                            val_loss=val_loss, seconds=round(dt, 2)))
        if best_val_loss is None or val_loss < best_val_loss:
            best_val_loss = val_loss
            if writes:
                export_state_dict(model.state_dict(), best_path)
        if writes:
            save_checkpoint(last_path, model, optimizer, extra=dict(
                epoch=epoch + 1, best_val_loss=best_val_loss,
                loader_rng=train_loader.rng_state()))
    return {"train_loss": train_losses, "val_loss": val_losses,
            "best_val_loss": best_val_loss, "best_path": best_path,
            "last_path": last_path}


if __name__ == "__main__":
    main()
