"""The reference's runs that the checks compare: a configuration's first
training steps from given weights on given molecules, and the predictions
(scores) of given structures, in blocks small enough to fit beside nothing
else.  The model's reference is the module of ``reference/`` that the
configuration names (``reference``), which gives ``build``, ``forward``,
``loss``, ``Adam`` and the schedules."""

from __future__ import annotations

import importlib

import torch

EMA_UPDATES = 99999  # the training scripts' n: the decay is min(decay, (1 + n) / (10 + n))


def model_of(cfg: dict):
    """The reference module ``reference/<cfg["reference"]>.py``."""
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def _lr(ref, cfg: dict, update: int) -> float:
    t = cfg["train"]
    if t["schedule"] == "constant":
        return t["lr"]
    if t["schedule"] == "warmup_exponential":
        return ref.warmup_exponential_lr(t["lr"], t["steps_per_epoch"], t["frac_steps"], update)
    raise ValueError(t["schedule"])


def train_steps(state: dict, steps: list[list[dict]], cfg: dict, device,
                quant=None, drop_half: bool = False) -> dict:
    """``losses`` of each step on the molecules ``steps[k]``, the first
    step's gradients as the optimizer applies them (``grads``), each
    leaf's ``change`` over the steps and, where the recipe keeps an EMA of
    the parameters, each leaf's ``ema_change`` over the steps, from
    ``state``.  ``drop_half`` plants a fault: each step's loss is the mean
    over the first half of its molecules."""
    ref, t = model_of(cfg), cfg["train"]
    P = {k: v.detach().clone().float().requires_grad_(True) for k, v in state.items()}
    start = {k: v.detach().clone() for k, v in P.items()}
    shadow = {k: v.clone() for k, v in start.items()} if t.get("ema_decay") else None
    adam = ref.Adam(P, t.get("clip_norm"))
    losses, first = [], None
    for k, mols in enumerate(steps):
        b = ref.build(mols, cfg, device)
        pred = ref.forward(P, b, cfg, quant)
        y = b["y"]
        if drop_half:
            pred, y = pred[: len(mols) // 2], y[: len(mols) // 2]
        loss = ref.loss(pred, y, t["loss"])
        grads = torch.autograd.grad(loss, list(P.values()), allow_unused=True)
        grads = {name: torch.zeros_like(P[name]) if g is None else g
                 for name, g in zip(P, grads)}
        applied = adam.step(P, grads, _lr(ref, cfg, k))
        if shadow is not None:
            d = min(t["ema_decay"], (1.0 + EMA_UPDATES) / (10.0 + EMA_UPDATES))
            for name, v in shadow.items():
                v.mul_(d).add_(P[name].detach() * (1.0 - d))
        if first is None:
            first = {name: g.detach().clone() for name, g in applied.items()}
        losses.append(float(loss.detach()))
        del b, pred, loss, grads
    out = {"losses": losses, "grads": first,
           "change": {k: (P[k].detach() - start[k]) for k in P}}
    if shadow is not None:
        out["ema_change"] = {k: shadow[k] - start[k] for k in shadow}
    return out


@torch.no_grad()
def scores(state: dict, mols: list[dict], cfg: dict, device, quant=None,
           block: int = 4) -> list[float]:
    """The reference's prediction of each structure of ``mols``, ``block`` at a time."""
    ref = model_of(cfg)
    P = {k: v.detach().float() for k, v in state.items()}
    out = []
    for s in range(0, len(mols), block):
        b = ref.build(mols[s:s + block], cfg, device)
        out += [float(v) for v in ref.forward(P, b, cfg, quant)]
        del b
    return out
