"""Learning-rate schedules of the reference's scripts, as Python functions from
the number of updates done so far to the lr (JAX counterpart:
``pamnet_tpu/train/schedules.py``).

* QM9: one epoch of linear warmup into per-step exponential decay with
  gamma = 0.9961697 per epoch, stepped fractionally every batch
  (reference: main_qm9.py:91-93,114-115 via GradualWarmupScheduler).
* PDBbind: MultiStepLR gamma=0.2 at epochs {50,100,...,500}
  (reference: main_pdbbind.py:83).
* RNA: constant lr (reference: main_rna_puzzles.py:80).

``warmup_exponential`` reproduces the reference's torch sequence element for
element, with the quirks of its scheduler stack:

* the scheduler is stepped AFTER each optimizer update with the PREVIOUS
  batch's fractional epoch (main_qm9.py:112-115), so update ``k`` trains at
  the lr of ``t = (k-1)/N``;
* update 0 trains at lr 0 (GradualWarmupScheduler.__init__ evaluates the
  warmup at last_epoch=0 with multiplier=1.0);
* t = 1.0 exactly still takes the warmup branch (``last_epoch >
  total_epoch`` is strict), giving base_lr;
* the FIRST call with t > 1 flips the scheduler's ``finished`` flag and
  returns the after-scheduler's stored lr = base_lr, so update N+2 trains at
  base_lr instead of base*gamma^(1/N);
* afterwards ExponentialLR.step(t-1) gives the closed form base*gamma^(t-1).

``frac_steps_per_epoch`` is the reference's ``len(train_dataset)/batch_size``
divisor (a float when the batch size does not divide the dataset, while the
in-epoch step counter resets every ``steps_per_epoch`` batches;
main_qm9.py:114).  None treats the two as equal.
"""

from __future__ import annotations

import math


def warmup_exponential(base_lr: float, steps_per_epoch: int, gamma: float = 0.9961697,
                       frac_steps_per_epoch: float | None = None):
    """The QM9 schedule (module docstring)."""
    b = steps_per_epoch
    n = float(frac_steps_per_epoch) if frac_steps_per_epoch else float(b)

    def schedule(step: int) -> float:
        if step == 0:
            return 0.0
        k = step - 1  # the lr of update `step` was set after update `step-1`
        epoch = k // b
        t = epoch + (k - epoch * b) / n  # fractional epoch, per-epoch reset
        if k == b + 1:  # the finished-flag flip returns base_lr
            return base_lr
        return base_lr * t if t <= 1.0 else base_lr * gamma ** (t - 1.0)

    return schedule


def multistep(base_lr: float, steps_per_epoch: int,
              milestones=(50, 100, 150, 200, 250, 300, 350, 400, 450, 500),
              gamma: float = 0.2):
    """The PDBbind schedule (per-epoch milestones, evaluated per step)."""

    def schedule(step: int) -> float:
        epoch = math.floor(step / steps_per_epoch)
        return base_lr * gamma ** sum(epoch >= m for m in milestones)

    return schedule


def constant(base_lr: float):
    def schedule(step: int) -> float:
        return base_lr

    return schedule
