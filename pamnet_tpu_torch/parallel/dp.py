"""Process groups and the entry points' launch under ``--dp``.

One rank a card over NCCL (``cuda:<local rank>``), or ranks on the CPU over
gloo.  An entry point's ``--dp N`` (N > 1) spawns N ranks (start method
spawn: CUDA cannot fork) that rendezvous through a file in a temporary
directory, so parallel runs never race for a port; a process that
``torchrun`` started joins the group its environment describes instead
(the JAX package's ``initialize_distributed``).  Every rank builds the same
model from the same seed and shuffles with the same generator, so the
replicas start equal and ``train/loop.py``'s data-parallel step keeps them
so.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
import torch.distributed as dist


def world_from_env() -> tuple[int, int, int] | None:
    """(world size, rank, local rank) of a process that ``torchrun``
    started (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``; the group's address
    in ``MASTER_ADDR`` / ``MASTER_PORT``), else None."""
    if "WORLD_SIZE" not in os.environ:
        return None
    r = int(os.environ["RANK"])
    return int(os.environ["WORLD_SIZE"]), r, int(os.environ.get("LOCAL_RANK", r))


def check_devices(n: int) -> None:
    """Raise unless the host has ``n`` cards, one for each rank (JAX's
    ``make_mesh`` raises alike; NCCL refuses two ranks on one card)."""
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"--dp {n} needs {n} devices, have {have} (one card a rank)")


def init_dp(world_size: int, rank: int, device: str | torch.device = "cuda",
            backend: str | None = None, init_method: str | None = None,
            local_rank: int | None = None) -> torch.device:
    """Join the process group as ``rank`` of ``world_size``; returns the
    rank's device: ``cuda:<local rank>`` for "cuda" (one card a rank), the
    CPU for "cpu", or the device named with its index.  ``backend``
    defaults to NCCL on a card and gloo on the CPU; ``init_method`` to
    ``env://`` (torchrun's variables)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank if local_rank is None else local_rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return dev


def rank() -> int:
    """This process's rank, 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def teardown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(r: int, fn, world_size: int, init_method: str, out: str, args: tuple) -> None:
    result = fn(r, world_size, init_method, *args)
    if r == 0:
        torch.save(result, out)


def spawn(fn, world_size: int, *args):
    """Run ``fn(rank, world_size, init_method, *args)`` in ``world_size``
    new processes (``fn`` importable by name, ``args`` picklable) that
    rendezvous at ``init_method``, a file in a temporary directory; returns
    rank 0's return value (plain numbers, strings, containers and tensors).
    Raises when a rank raises."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, world_size, f"file://{tmp}/rendezvous", out, args),
            nprocs=world_size, join=True, start_method="spawn")
        return torch.load(out, weights_only=True)


def _run_rank(train, args, device: torch.device, world_size: int, r: int):
    """``train(args, device, world_size)`` as rank ``r``, quiet past rank 0,
    then leave the group."""
    try:
        if r == 0:
            return train(args, device, world_size)
        with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
            return train(args, device, world_size)
    finally:
        teardown()


def _spawned(r: int, world_size: int, init_method: str, train, args, device_type: str):
    return _run_rank(train, args, init_dp(world_size, r, device_type, init_method=init_method),
                     world_size, r)


def launch(train, args, device: torch.device):
    """Run an entry point's ``train(args, device, dp)`` as its ``--dp``
    (``args.dp``) asks: in this process with ``dp`` 0 for 0 or 1; as this
    process's rank of the group under ``torchrun`` (whose world ``--dp``
    must match or leave 0); else in ``args.dp`` spawned ranks, one card
    each (``check_devices``) or on the CPU over gloo, the native library
    and the CUDA kernels built here first, so the ranks do not build them
    at once.  Ranks past 0 print nothing.  Returns rank 0's result (under
    torchrun, this rank's)."""
    env = world_from_env()
    if env is not None and env[0] > 1:
        world, r, local = env
        if args.dp not in (0, world):
            raise ValueError(f"--dp {args.dp} under torchrun with {world} processes")
        return _run_rank(train, args, init_dp(world, r, device.type, local_rank=local),
                         world, r)
    if args.dp <= 1:
        return train(args, device, 0)
    if device.type == "cuda":
        check_devices(args.dp)
        from pamnet_tpu_torch.ops import _build

        _build.build()
    from pamnet_tpu_torch.data import native

    native.build()
    return spawn(_spawned, args.dp, train, args, device.type)
