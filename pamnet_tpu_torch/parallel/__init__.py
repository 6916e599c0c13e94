"""Data parallelism over ``torch.distributed`` (JAX counterpart:
``pamnet_tpu/parallel/mesh.py`` and ``make_mesh`` /
``initialize_distributed``): process groups, one rank a card, and the
entry points' launch under ``--dp``.  The data-parallel step and epoch are
in ``train/loop.py``."""

from pamnet_tpu_torch.parallel.dp import (
    check_devices,
    init_dp,
    launch,
    rank,
    spawn,
    teardown,
    world_from_env,
)

__all__ = ["check_devices", "init_dp", "launch", "rank", "spawn", "teardown",
           "world_from_env"]
