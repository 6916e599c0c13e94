"""Training and evaluation steps (JAX counterpart: ``pamnet_tpu/train/
loop.py:37-97``, ``make_dp_train_step`` and its ``EpochRunner``).

One step: forward, masked mean loss of the caller's kind, ``backward``
through the kernels' backward Functions, the optimizer and, where the caller
keeps one (QM9), the EMA.  Nothing in a step reads a
value back from the card: the lr comes from the host's update count, the
clip decision stays on the card, and an epoch's loss sum is accumulated
there and read once at the end.

Data parallelism (``dp`` > 1 ranks of a ``torch.distributed`` group,
``parallel/``): ``dp_train_step`` computes what JAX's
``make_dp_train_step`` computes, not what ``DistributedDataParallel``
does: each rank's loss is its batch's loss total over the valid graphs of
every rank's batch, the gradients are summed over the ranks by one
``all_reduce`` of one flat float32 buffer, and every rank then clips,
steps and averages alike, so the replicas stay bit for bit equal.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch
import torch.distributed as dist

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


def batch_loss(model, batch: GraphBatch, kind: str, plain: bool = False):
    """Mean loss of ``kind`` over the batch's valid graphs (QM9 trains on
    "l1", main_qm9.py:108; RNA on "smooth_l1", main_rna_puzzles.py:92)."""
    total, count = loss_terms(model(batch, plain=plain), batch.y, batch.graph_mask, kind)
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
               batch: GraphBatch, loss_kind: str) -> torch.Tensor:
    """One optimizer step on ``batch`` (on the model's device) and, with an
    ``ema``, its update at decay 0.999; returns the batch's mean loss as a
    device tensor."""
    optimizer.zero_grad()
    loss = batch_loss(model, batch, loss_kind)
    loss.backward()
    optimizer.step()
    if ema is not None:
        ema_update(ema, dict(model.named_parameters()), EMA_DECAY)
    return loss.detach()


def reduce_gradients(params: list[torch.Tensor], extra: torch.Tensor) -> torch.Tensor:
    """Sum every gradient of ``params`` (float32; zeros for a parameter that
    took none, as ``Optimizer.step`` gives it) and the scalar ``extra`` over
    the ranks with one ``all_reduce(SUM)`` of one flat float32 buffer, in
    the order of ``params``; each gradient is then a view of the buffer.
    Returns the summed ``extra``."""
    if any(p.dtype != torch.float32 for p in params):
        raise ValueError("reduce_gradients: the parameters must be float32")
    flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                      for p in params] + [extra.reshape(1).to(torch.float32)])
    dist.all_reduce(flat)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat[offset]


def dp_train_step(model, optimizer, ema: dict | None, batch: GraphBatch, loss_kind: str,
                  global_count: int) -> torch.Tensor:
    """One data-parallel step on this rank's ``batch`` (JAX
    ``make_dp_train_step``, ``pamnet_tpu/train/loop.py:542-576``): the loss
    total over ``global_count``, the valid graphs of every rank's batch
    (which every rank knows from the loader's index lists: no collective
    and no read from the card), ``backward``, the gradients and the loss
    summed by ``reduce_gradients``, then the optimizer and the EMA on every
    rank alike.  Returns the group's mean loss as a device tensor.  With one
    rank it is ``train_step`` bit for bit."""
    optimizer.zero_grad()
    total, _ = loss_terms(model(batch), batch.y, batch.graph_mask, loss_kind)
    local = total / torch.full((), float(max(global_count, 1)), dtype=total.dtype,
                               device=total.device)
    local.backward()
    loss = reduce_gradients(list(model.parameters()), local.detach())
    optimizer.step()
    if ema is not None:
        ema_update(ema, dict(model.named_parameters()), EMA_DECAY)
    return loss


def run_epoch(model, optimizer: Optimizer, ema: dict | None, batches,
              device, loss_kind: str, dp: int = 0) -> tuple[float, int, list]:
    """Train over ``batches`` (host ``GraphBatch``es).  Returns the sum of
    the batches' mean losses weighted by their valid graphs (the
    reference's accounting, main_qm9.py:109,119), the graph count and the
    per-step losses (device tensors).

    With ``dp`` > 1 ranks, ``batches`` is the ``GraphLoader`` and the epoch
    runs as JAX's ``EpochRunner.run`` (``loop.py:736-753``): groups of
    ``dp`` consecutive batches of the loader's order, rank r collating and
    stepping batch g * dp + r of group g through ``dp_train_step``, each
    group's mean loss weighted by its graphs; a trailing partial group is
    stepped a batch at a time, the same batch on every rank."""
    loss_sum = torch.zeros((), dtype=torch.float64, device=device)
    graphs, losses = 0, []

    def account(loss, count):
        nonlocal loss_sum, graphs
        loss_sum += loss.double() * count
        graphs += count
        losses.append(loss)

    if dp > 1:
        loader, r = batches, dist.get_rank()
        order = loader.batches()
        whole = len(order) - len(order) % dp
        for g in range(0, whole, dp):
            count = sum(len(idxs) for idxs in order[g:g + dp])
            gb = loader.collate(order[g + r]).to(device)
            account(dp_train_step(model, optimizer, ema, gb, loss_kind, count), count)
        batches = (loader.collate(idxs) for idxs in order[whole:])
    for gb in batches:
        account(train_step(model, optimizer, ema, gb.to(device), loss_kind), gb.num_graphs)
    return float(loss_sum), graphs, losses


@torch.inference_mode()
def predict(model, batches, device, dp: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(predictions, targets) of the valid graphs of ``batches``.  With
    ``dp`` > 1 ranks (JAX ``StackedEval(dp=)``), rank r predicts batches r,
    r + dp, ... (the list as if padded to a multiple of ``dp``: a rank
    without a batch in the last round predicts none), and the predictions
    are gathered in batch order, so every rank gets the one-process result
    bit for bit."""
    if dp <= 1:
        preds, ys = [], []
        for gb in batches:
            preds.append(model(gb.to(device))[:gb.num_graphs].cpu().numpy())
            ys.append(gb.y[:gb.num_graphs].numpy())
        return np.concatenate(preds), np.concatenate(ys)
    batches = list(batches)
    ys = [gb.y[:gb.num_graphs].numpy() for gb in batches]
    rounds = -(-len(batches) // dp)
    width = max(gb.graph_mask.shape[0] for gb in batches)
    local = torch.zeros(rounds, width, device=device)
    for s, gb in enumerate(batches[dist.get_rank()::dp]):
        out = model(gb.to(device))
        local[s, :out.shape[0]] = out
    gathered = [torch.empty_like(local) for _ in range(dp)]
    dist.all_gather(gathered, local)
    by_batch = torch.stack(gathered, 1).reshape(rounds * dp, width).cpu().numpy()
    return (np.concatenate([by_batch[i, :gb.num_graphs] for i, gb in enumerate(batches)]),
            np.concatenate(ys))


def mae(model, batches, device, dp: int = 0) -> float:
    """Mean absolute error over the valid graphs (reference: main_qm9.py:29-37)."""
    pred, y = predict(model, batches, device, dp)
    return float(np.abs(pred - y).mean())


def smooth_l1(model, batches, device, dp: int = 0) -> float:
    """SmoothL1 (beta 1) over the valid graphs, a mean over structures
    (reference: main_rna_puzzles.py:23-42)."""
    pred, y = predict(model, batches, device, dp)
    a = np.abs(pred - y)
    return float(np.where(a < 1.0, 0.5 * a * a, a - 0.5).mean())


def log_csv(path: str, row: dict) -> None:
    """Append ``row`` to the CSV file ``path``, its keys as the header of a
    new file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    new = not os.path.exists(path)
    with open(path, "a") as f:
        if new:
            f.write(",".join(row) + "\n")
        f.write(",".join(str(v) for v in row.values()) + "\n")
