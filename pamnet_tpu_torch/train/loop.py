"""Training and evaluation steps (JAX counterpart: ``pamnet_tpu/train/
loop.py:37-97`` and its ``EpochRunner``).

One step: forward, masked mean loss, ``backward`` through the kernels'
backward Functions, the optimizer and the EMA.  Nothing in a step reads a
value back from the card: the lr comes from the host's update count, the
clip decision stays on the card, and an epoch's loss sum is accumulated
there and read once at the end.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from pamnet_tpu_torch.data.batch import GraphBatch
from pamnet_tpu_torch.train.ema import ema_update

EMA_DECAY = 0.999  # main_qm9.py's EMA


def loss_terms(pred: torch.Tensor, y: torch.Tensor, graph_mask: torch.Tensor,
               kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked per-graph error sum and count (the reference's losses: l1 for QM9
    main_qm9.py:108, mse for PDBbind main_pdbbind.py:95, smooth_l1 for RNA
    main_rna_puzzles.py:92)."""
    err = pred - y
    if kind == "l1":
        e = err.abs()
    elif kind == "mse":
        e = err * err
    elif kind == "smooth_l1":
        a = err.abs()
        e = torch.where(a < 1.0, 0.5 * err * err, a - 0.5)
    else:
        raise ValueError(kind)
    return (e * graph_mask).sum(), graph_mask.sum()


def batch_loss(model, batch: GraphBatch, plain: bool = False):
    """Mean L1 loss over the batch's valid graphs (QM9's, main_qm9.py:108)."""
    total, count = loss_terms(model(batch, plain=plain), batch.y, batch.graph_mask, "l1")
    return total / count.clamp_min(1.0)


class Optimizer:
    """The optax chain of ``pamnet_tpu/train/loop.py::make_optimizer`` over
    ``torch.optim.Adam`` (fused; b1 0.9, b2 0.999, eps 1e-8, the weight
    decay added to the gradient as optax's ``add_decayed_weights`` does):
    global-norm clip first, and the lr of ``schedule`` at the number of
    updates done so far (update 0 takes ``schedule(0)``).  A parameter that
    got no gradient (``init_linear`` on QM9) takes a zero one, as in JAX.
    Nothing in a step is read back from the card."""

    def __init__(self, params, schedule, weight_decay: float = 0.0,
                 clip_norm: float | None = None):
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=schedule(0),
                                     weight_decay=weight_decay, fused=True)
        self.schedule, self.clip_norm, self.count = schedule, clip_norm, 0

    def zero_grad(self) -> None:
        self.adam.zero_grad()

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_norm is not None:
            # optax.clip_by_global_norm up to the 1e-6 PyTorch adds to the norm.
            torch.nn.utils.clip_grad_norm_(self.params, self.clip_norm, foreach=True)
        self.adam.param_groups[0]["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1

    # Copies both ways: torch.optim's state dicts share the live tensors.
    def state_dict(self) -> dict:
        return copy.deepcopy({"count": self.count, "adam": self.adam.state_dict()})

    def load_state_dict(self, state: dict) -> None:
        self.count = state["count"]
        self.adam.load_state_dict(copy.deepcopy(state["adam"]))


def train_step(model, optimizer: Optimizer, ema: dict | None,
               batch: GraphBatch) -> torch.Tensor:
    """One optimizer step on ``batch`` (on the model's device) and the EMA
    at decay 0.999; returns the batch's mean loss as a device tensor."""
    optimizer.zero_grad()
    loss = batch_loss(model, batch)
    loss.backward()
    optimizer.step()
    if ema is not None:
        ema_update(ema, dict(model.named_parameters()), EMA_DECAY)
    return loss.detach()


def run_epoch(model, optimizer: Optimizer, ema: dict | None, batches,
              device) -> tuple[float, int, list]:
    """Train over ``batches`` (host ``GraphBatch``es).  Returns the sum of
    the batches' mean losses weighted by their valid graphs (the
    reference's accounting, main_qm9.py:109,119), the graph count and the
    per-step losses (device tensors)."""
    loss_sum = torch.zeros((), dtype=torch.float64, device=device)
    graphs, losses = 0, []
    for gb in batches:
        loss = train_step(model, optimizer, ema, gb.to(device))
        loss_sum += loss.double() * gb.num_graphs
        graphs += gb.num_graphs
        losses.append(loss)
    return float(loss_sum), graphs, losses


@torch.inference_mode()
def predict(model, batches, device) -> tuple[np.ndarray, np.ndarray]:
    """(predictions, targets) of the valid graphs of ``batches``."""
    preds, ys = [], []
    for gb in batches:
        preds.append(model(gb.to(device))[:gb.num_graphs].cpu().numpy())
        ys.append(gb.y[:gb.num_graphs].numpy())
    return np.concatenate(preds), np.concatenate(ys)


def mae(model, batches, device) -> float:
    """Mean absolute error over the valid graphs (reference: main_qm9.py:29-37)."""
    pred, y = predict(model, batches, device)
    return float(np.abs(pred - y).mean())
