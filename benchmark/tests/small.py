"""Sizes of each cell that a run on the CPU holds."""

# Sizes a CPU run holds; the configurations' widths stay as published but
# QM9's, which runs at dim 32, 1 layer (dim 16 would fold).
SMALL = {
    # At this size the warm-up lasts 4 steps, so all three steps move the
    # EMA, and the CPU's bfloat16 reads its median leaf's change at ~1e-4
    # (the card's cell 9e-6-2.6e-5); an EMA with the wrong decay reads ~2.
    "qm9_train": {"traffic": {"eval_block": 8},
                  "config": {"dim": 32, "n_layer": 1, "train_split": 128, "val_split": 32,
                             "test_split": 32},
                  "limits": {"ema_gap_median": 5e-4}},
    "rna_train": {"traffic": {"bases": 2, "n_atoms": 150, "eval_sample": 6},
                  "config": {"train_split": 24, "val_split": 8}},
    "rna_score_c4": {"traffic": {"bases": 2, "n_atoms": 150, "prebuild": 16,
                                 "warmup_requests": 2, "sample": 6}, "config": {}},
    "rna_score_c1": {"traffic": {"bases": 2, "n_atoms": 150, "prebuild": 16,
                                 "warmup_requests": 2, "sample": 6}, "config": {}},
}
