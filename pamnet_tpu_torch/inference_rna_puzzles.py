"""RNA-Puzzles candidate-structure scoring on the port, the batch CSV driver
(JAX counterpart: the repository's ``inference_rna_puzzles.py``; reference:
inference_rna_puzzles.py:21-86).

    python -m pamnet_tpu_torch.inference_rna_puzzles --batch_size 16 \\
        --dataset rna_native --saved_model pamnet_rna.pt \\
        [--compute_dtype bfloat16] [--device cpu]

Scores every structure of the TU split ``--dataset`` under ``--data_root``
(default ``./data/RNA-Puzzles``) with the model of ``--saved_model``: a
reference ``state_dict`` (``.pt``, ``weights.load_reference_checkpoint``;
also what ``main_rna_puzzles`` exports) or a port training checkpoint (any
other name, ``train.checkpoint.load_model_state``), found as given or under
``./save/``.  Every batch runs at its own counts rounded up to 128 rows
(the JAX driver's ``ladder_pads="exact"``; ``--fixed_pads``: every batch at
the set's worst case), collated and copied to the device in two threads
beside the forwards (``GraphLoader.prefetch``, ``train/loop.py::_staged``);
its scores stay on the device, and one copy brings them all back at the
end.  Writes ``rna_puzzles_predictions/<dataset>.csv``
under the working directory with the reference's columns ``PAMNet, tag,
puzzle_number``: ``tag`` is the structure's file name without its last four
characters, ``puzzle_number`` the dataset name from its sixth character
(``inference_rna_puzzles.py:136-146``).  The published model (dim 16, 1
layer) folds its spherical-basis stage into kernel B, in float32 (the
default) or ``--compute_dtype bfloat16``.  ``--device`` defaults to
``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time

import numpy as np
import torch

from pamnet_tpu_torch.config import PAMNetConfig, resolve_device, set_matmul_precision
from pamnet_tpu_torch.data.batch import PadSizes
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.tu import TUDataset
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.train.loop import _staged

OUT_DIR = "rna_puzzles_predictions"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=40, help="Random seed.")
    parser.add_argument("--dataset", type=str, default="rna_native",
                        help="Dataset to be used")
    parser.add_argument("--n_layer", type=int, default=1, help="Number of hidden layers.")
    parser.add_argument("--dim", type=int, default=16, help="Size of input hidden units.")
    parser.add_argument("--batch_size", type=int, default=8, help="batch_size")
    parser.add_argument("--cutoff_l", type=float, default=2.6, help="cutoff in local layer")
    parser.add_argument("--cutoff_g", type=float, default=20.0, help="cutoff in global layer")
    parser.add_argument("--flow", type=str, default="target_to_source",
                        help="Flow direction of message passing")
    parser.add_argument("--saved_model", type=str, default="pamnet_rna.pt",
                        help="Saved model for inference (as given, or under ./save/)")
    parser.add_argument("--data_root", type=str, default=None,
                        help="Directory of the TU splits (default ./data/RNA-Puzzles)")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="float32, or bfloat16 mixed precision for the "
                             "message-passing stack")
    parser.add_argument("--fixed_pads", action="store_true",
                        help="Pad every batch to the set's worst case instead of its "
                             "own counts")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


def _model_state(saved_model: str) -> tuple[dict, str]:
    """The parameters of ``saved_model`` and the path they came from."""
    from pamnet_tpu_torch.train.checkpoint import load_model_state
    from pamnet_tpu_torch.weights import load_reference_checkpoint

    path = saved_model if osp.exists(saved_model) else osp.join(".", "save", saved_model)
    if saved_model.endswith(".pt"):
        return load_reference_checkpoint(path), path
    return load_model_state(path), path


def batch_pads(gb) -> PadSizes:
    """The pads a batch was collated at, read from its shapes."""
    return PadSizes(n=gb.z.shape[0], eg=gb.eg_src.shape[0], el=gb.el_src.shape[0],
                    t2=gb.t2_ji.shape[0], t1=gb.t1_ji.shape[0], g=gb.y.shape[0])


def main(argv=None) -> dict:
    """Score the split and write its CSV; returns the CSV's path, the scores,
    the tags, each batch's pads and the seconds of the scoring loop."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    torch.manual_seed(args.seed)
    if device.type == "cuda":
        set_matmul_precision()

    data_root = args.data_root or osp.join(".", "data", "RNA-Puzzles")
    ds = TUDataset(data_root, args.dataset)
    print(f"Data loaded! {len(ds)} structures from {data_root}")

    cfg = PAMNetConfig(dataset=args.dataset, dim=args.dim, n_layer=args.n_layer,
                       cutoff_l=args.cutoff_l, cutoff_g=args.cutoff_g, flow=args.flow,
                       compute_dtype=args.compute_dtype)
    state, path = _model_state(args.saved_model)
    model = PAMNet(cfg)
    model.load_state_dict(state, strict=True)
    model = model.to(device).eval()
    print(f"Model loaded from {path}. Start prediction!")

    loader = GraphLoader(ds.molecules(), cfg.dataset_kind, cfg.cutoff_l, cfg.cutoff_g,
                         batch_size=args.batch_size, shuffle=False,
                         ladder_pads=False if args.fixed_pads else "exact",
                         num_spherical=cfg.num_spherical, num_radial=cfg.num_radial,
                         envelope_exponent=cfg.envelope_exponent)
    # Batches collated and copied to the device in two threads beside the
    # forwards; each batch's scores stay on the device and one copy fetches
    # them all (inference_rna_puzzles.py:122-134), not a host round trip a batch.
    pending, pads = [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for gb in _staged(loader.prefetch(), device):
            pads.append(batch_pads(gb))
            pending.append(model(gb)[:gb.num_graphs])
        y_hat = torch.cat(pending).cpu().numpy()
    seconds = time.perf_counter() - t0

    tags = [n[:-4] for n in (ds.names or [])]
    os.makedirs(OUT_DIR, exist_ok=True)
    file_name = osp.join(".", OUT_DIR, args.dataset + ".csv")
    puzzle_number = args.dataset[5:]
    with open(file_name, "w") as f:
        f.write("PAMNet,tag,puzzle_number\n")
        for score, tag in zip(y_hat, tags):
            f.write(f"{score},{tag},{puzzle_number}\n")
    print(f"Prediction saved. ({file_name}, {len(y_hat)} rows)")
    return {"csv": file_name, "scores": y_hat, "tags": tags, "pads": pads,
            "seconds": seconds}


if __name__ == "__main__":
    main()
