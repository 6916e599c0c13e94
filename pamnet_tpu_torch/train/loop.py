"""Training and evaluation steps (JAX counterpart: ``pamnet_tpu/train/
loop.py:37-97``, ``make_dp_train_step``, ``_staged``, ``EpochRunner`` and
``StackedEval``).

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

The epoch pipeline: ``run_epoch`` steps batches that a thread collates
(``GraphLoader.prefetch``) and a second thread copies to the card
(``_staged``) while the steps run; ``StackedEval`` collates an evaluation
split once and keeps it on the card for every epoch.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from pamnet_tpu_torch.data.batch import GraphBatch
from pamnet_tpu_torch.data.loader import GraphLoader, background
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


@functools.cache
def _copy_stream(index: int) -> torch.cuda.Stream:
    """The stream ``_staged`` copies on: one per card for the process.  The
    caching allocator keeps each stream's freed blocks apart, so a stream
    of its own for every epoch would allocate each epoch's batches anew."""
    return torch.cuda.Stream(index)


def _staged(batches, device, depth: int = 2):
    """The host ``GraphBatch``es of ``batches`` as batches on ``device``,
    copied in a background thread ``depth`` batches ahead of the caller, so
    the copies overlap the steps (JAX ``_staged``, ``pamnet_tpu/train/
    loop.py:626-654``).  On the card the thread copies each tensor to pinned
    memory and from there with ``non_blocking`` copies on a stream of its
    own (``_copy_stream``), records an event after them and waits for it before it hands the
    batch over (so no pinned buffer is freed or reused while its copy
    runs); every device tensor is recorded on the caller's stream
    (``record_stream``), and the caller's stream waits on the event before
    a step reads the batch.  Elsewhere (the CPU) the thread calls
    ``GraphBatch.to``.  An error of the thread, pinning, the stream and the
    event included, is raised in the caller: nothing falls back."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from background((gb.to(device) for gb in batches), depth)
        return
    compute = torch.cuda.current_stream(device)
    copies = _copy_stream(compute.device_index)

    def stage(gb: GraphBatch):
        with torch.cuda.stream(copies):
            moved = gb.map(lambda t: t.pin_memory().to(device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(copies)
        done.synchronize()
        for t in moved.tensors():
            t.record_stream(compute)
        return moved, done

    with contextlib.closing(background((stage(gb) for gb in batches), depth)) as staged:
        for moved, done in staged:
            compute.wait_event(done)
            yield moved


def _timed(items, stats: dict, key: str):
    """``items``, adding the seconds the caller waits for each to
    ``stats[key]``."""
    it = iter(items)
    with contextlib.closing(it) if hasattr(it, "close") else contextlib.nullcontext():
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            stats[key] = stats.get(key, 0.0) + time.perf_counter() - t0
            if item is None:
                return
            yield item


def _timed_to(gb: GraphBatch, device, stats: dict) -> GraphBatch:
    """``gb.to(device)``, its seconds added to ``stats["h2d_s"]``."""
    t0 = time.perf_counter()
    moved = gb.to(device)
    stats["h2d_s"] = stats.get("h2d_s", 0.0) + time.perf_counter() - t0
    return moved


def run_epoch(model, optimizer: Optimizer, ema: dict | None, batches,
              device, loss_kind: str, dp: int = 0, *, pipelined: bool = True,
              depth: int = 2, stats: dict | None = None) -> tuple[float, int, list, int]:
    """Train one epoch over ``batches`` (a ``GraphLoader``, or any iterable
    of host ``GraphBatch``es) as JAX's ``EpochRunner.run``
    (``pamnet_tpu/train/loop.py:657-792``) in its single-step and
    data-parallel modes.  Returns the sum of the batches' mean losses
    weighted by their valid graphs (the reference's accounting,
    main_qm9.py:109,119), the graph count, the per-step losses (device
    tensors, read once, at the epoch's end, by the caller) and the
    dispatch (step) count.

    Pipelined (the default): a loader's batches come from
    ``loader.prefetch(depth)`` and every batch reaches the device through
    ``_staged``, so collation and the copies run in two threads beside the
    steps.  ``pipelined=False`` collates and copies each batch on the
    calling thread before its step (pageable copies; the route the epoch
    pipeline is timed against, as JAX's ``defer_fetch=False``); both
    routes give the same steps bit for bit.  ``stats``, where given,
    receives the seconds the calling thread waited for its batches:
    ``queue_wait_s`` pipelined, ``collate_s`` and ``h2d_s`` serial.

    With ``dp`` > 1 ranks, ``batches`` is the ``GraphLoader``: groups of
    ``dp`` consecutive batches of the loader's order, rank r collating,
    staging and stepping batch g * dp + r of group g through
    ``dp_train_step`` (the group's graph count from the index lists), each
    group's mean loss weighted by its graphs; a trailing partial group is
    stepped a batch at a time, the same batch on every rank."""
    stats = {} if stats is None else stats
    loss_sum = torch.zeros((), dtype=torch.float64, device=device)
    graphs, losses, group_counts = 0, [], []
    if dp > 1:
        order, r = batches.batches(), dist.get_rank()
        whole = len(order) - len(order) % dp
        group_counts = [sum(len(idxs) for idxs in order[g:g + dp]) for g in range(0, whole, dp)]
        mine = [order[g + r] for g in range(0, whole, dp)] + order[whole:]
        host = (batches.prefetch(depth, order=mine) if pipelined
                else (batches.collate(idxs) for idxs in mine))
    elif isinstance(batches, GraphLoader) and pipelined:
        host = batches.prefetch(depth)
    else:
        host = batches
    if pipelined:
        stream = _timed(_staged(host, device, depth), stats, "queue_wait_s")
    else:
        stream = (_timed_to(gb, device, stats) for gb in _timed(host, stats, "collate_s"))
    with contextlib.closing(stream):
        for k, gb in enumerate(stream):
            if k < len(group_counts):
                count = group_counts[k]
                loss = dp_train_step(model, optimizer, ema, gb, loss_kind, count)
            else:
                count = gb.num_graphs
                loss = train_step(model, optimizer, ema, gb, loss_kind)
            loss_sum += loss.double() * count
            graphs += count
            losses.append(loss)
    return float(loss_sum), graphs, losses, len(losses)


def _gathered(outs, widths: list[int], dp: int, device) -> list[np.ndarray]:
    """Every batch's outputs on the host, in batch order, from ``dp`` ranks
    of which rank r computed ``outs`` of batches r, r + dp, ... (the list
    as if padded to a multiple of ``dp``: a rank without a batch in the
    last round computes none): one ``all_gather`` of one padded buffer."""
    rounds = -(-len(widths) // dp)
    width = max(widths)
    local = torch.zeros(rounds, width, device=device)
    for s, out in enumerate(outs):
        local[s, :out.shape[0]] = out
    gathered = [torch.empty_like(local) for _ in range(dp)]
    dist.all_gather(gathered, local)
    by_batch = torch.stack(gathered, 1).reshape(rounds * dp, width).cpu().numpy()
    return [by_batch[i, :w] for i, w in enumerate(widths)]


class StackedEval:
    """An evaluation split collated once and staged on the device once,
    then predicted in every epoch from the resident batches (JAX
    ``StackedEval``, ``pamnet_tpu/train/loop.py:444-541``, without its
    stacking for a scan).  The split is ``loader``'s batches as iterating
    it gives them: a shuffled (training) loader draws its next permutation
    here, as JAX's ``list(loader)`` does; the batches carry no backward
    arrays.  The valid-graph mask and the targets stay on the host
    (``mask``, ``y``).  With ``dp`` > 1 ranks each rank stages only its
    share (batches r, r + dp, ...) and ``predict`` gathers the predictions
    in batch order.  Prints JAX's line to stderr (``verbose``): batches, MB
    staged (this rank's), and the collate and transfer seconds
    (``collate_s``, ``transfer_s``, ``staged_bytes``)."""

    def __init__(self, loader: GraphLoader, device, dp: int = 0, verbose: bool = True):
        t0 = time.perf_counter()
        host = [loader.collate(idxs, build_perms=False) for idxs in loader.batches()]
        t1 = time.perf_counter()
        self.device, self.dp = torch.device(device), dp
        self.widths = [gb.graph_mask.shape[0] for gb in host]
        self.mask = np.concatenate([gb.graph_mask.numpy() for gb in host]) > 0
        self.y = np.concatenate([gb.y.numpy() for gb in host])[self.mask]
        mine = host if dp <= 1 else host[dist.get_rank()::dp]
        self.batches = list(_staged(mine, self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.collate_s, self.transfer_s = t1 - t0, time.perf_counter() - t1
        self.staged_bytes = sum(t.nbytes for gb in self.batches for t in gb.tensors())
        if verbose:
            print(f"StackedEval: {len(host)} batches, {self.staged_bytes / 1e6:.0f} MB "
                  f"(collate {self.collate_s:.1f}s, transfer {self.transfer_s:.1f}s)",
                  file=sys.stderr)

    @torch.inference_mode()
    def predict(self, model) -> tuple[np.ndarray, np.ndarray]:
        """(predictions, targets) of the split's valid graphs; bit for bit
        ``predict`` over the same batches collated anew."""
        outs = (model(gb) for gb in self.batches)
        if self.dp <= 1:
            host = torch.cat(list(outs)).cpu().numpy()
        else:
            host = np.concatenate(_gathered(outs, self.widths, self.dp, self.device))
        return host[self.mask], self.y


@torch.inference_mode()
def predict(model, batches, device, dp: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(predictions, targets) of the valid graphs of ``batches`` (host
    ``GraphBatch``es, each copied to ``device`` here, or a ``StackedEval``,
    whose resident batches it predicts).  With ``dp`` > 1 ranks (JAX
    ``StackedEval(dp=)``), rank r predicts batches r, r + dp, ... and the
    predictions are gathered in batch order, so every rank gets the
    one-process result bit for bit."""
    if isinstance(batches, StackedEval):
        return batches.predict(model)
    if dp <= 1:
        preds, ys = [], []
        for gb in batches:
            preds.append(model(gb.to(device))[:gb.num_graphs].cpu().numpy())
            ys.append(gb.y[:gb.num_graphs].numpy())
        return np.concatenate(preds), np.concatenate(ys)
    batches = list(batches)
    outs = (model(gb.to(device)) for gb in batches[dist.get_rank()::dp])
    by_batch = _gathered(outs, [gb.graph_mask.shape[0] for gb in batches], dp, device)
    return (np.concatenate([out[:gb.num_graphs] for out, gb in zip(by_batch, batches)]),
            np.concatenate([gb.y[:gb.num_graphs].numpy() for gb in batches]))


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
