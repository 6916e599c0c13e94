"""PyTorch/CUDA port of PAMNet-TPU for NVIDIA Hopper (H100).

The JAX package ``pamnet_tpu`` stays the reference; this package computes the
same RNA scoring path with PyTorch around hand-written CUDA kernels
(``ops/triplet.py``, ``ops/sbf_modulate.py`` and ``ops/gather.py``).  Entry
points run on the card (``device="cuda"``) unless the caller asks for the
CPU, where every kernel wrapper takes its plain PyTorch version.
"""

from pamnet_tpu_torch.config import PAMNetConfig, resolve_device

__all__ = ["PAMNetConfig", "resolve_device"]
