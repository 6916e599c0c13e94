"""Checkpoints of the port (JAX counterpart: ``pamnet_tpu/train/checkpoint.py``).

``save_checkpoint`` / ``load_checkpoint`` hold the full training state (the
model's ``state_dict``, the optimizer's Adam moments and update count, the EMA
where there is one, and what the entry point adds: epochs done, best validation
loss, the shuffling generator's state), so a resumed run continues bit for
bit.  ``export_state_dict`` writes the parameters alone under the reference's
``state_dict`` names, which ``weights.load_reference_checkpoint`` and the
scoring service (``--saved_model``) read.  Files are written to a temporary
name and renamed, so a killed run leaves the previous file whole.
"""

from __future__ import annotations

import os

import torch


def _save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(state: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


def save_checkpoint(path: str, model, optimizer, ema: dict | None = None,
                    extra: dict | None = None) -> None:
    """Write the full training state: ``model`` and ``optimizer``
    (``train.loop.Optimizer``), the EMA shadow and ``extra`` (plain numbers,
    strings and containers of them)."""
    _save({"model": _cpu(model.state_dict()), "optimizer": optimizer.state_dict(),
           "ema": None if ema is None else _cpu(ema), "extra": dict(extra or {})}, path)


def load_checkpoint(path: str, model, optimizer, ema: dict | None = None) -> dict:
    """Restore a ``save_checkpoint`` file into ``model``, ``optimizer`` and
    ``ema`` in place (on their devices); returns its ``extra``.  Raises when
    the file and the run disagree on whether there is an EMA."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if (state["ema"] is None) != (ema is None):
        raise ValueError(f"{path}: the checkpoint {'has no' if state['ema'] is None else 'has an'} "
                         f"EMA, the run {'has none' if ema is None else 'has one'}")
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    if ema is not None:
        if ema.keys() != state["ema"].keys():
            raise ValueError(f"{path}: EMA keys differ from the model's")
        with torch.no_grad():
            for k, v in ema.items():
                v.copy_(state["ema"][k])
    return state["extra"]


def load_model_state(path: str) -> dict:
    """The model's ``state_dict`` of a ``save_checkpoint`` file, as CPU
    tensors (the scoring entry points' port checkpoints)."""
    return torch.load(path, map_location="cpu", weights_only=True)["model"]


def export_state_dict(state_dict: dict, path: str) -> None:
    """Write parameters (a model's ``state_dict()`` or an EMA shadow) as a
    reference-style ``.pt`` of float32 CPU tensors."""
    _save({k: v.to(torch.float32) for k, v in _cpu(state_dict).items()}, path)
