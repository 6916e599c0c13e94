"""Parameters of the port: reference checkpoints, JAX parameter trees and
seeded initialization, all as ``PAMNet`` state dicts keyed by the
reference's names (reference: models.py:22-56,
global_message_passing.py:14-26, local_message_passing.py:14-29).

The JAX tree stores Linear weights (in, out); the reference and the port
store them (out, in), so they transpose on the way in, as
``pamnet_tpu/train/checkpoint.py::params_to_torch`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from pamnet_tpu_torch.config import PAMNetConfig

# Sequential-of-Sequential MLPs and bare Linear modules, by attribute name.
_MLP_NAMES = {
    "mlp_rbf_g", "mlp_rbf_l", "mlp_sbf1", "mlp_sbf2", "mlp_sbf",
    "mlp_x1", "mlp_x2", "mlp_m", "mlp_m_ji", "mlp_m_kj", "mlp_m_jj", "mlp_out",
}
_LINEAR_NAMES = {"W_edge_attr", "W_out", "lin_rbf", "lin_rbf_out", "init_linear"}


def from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    """JAX parameter pytree (nested dicts/lists of arrays, as from
    ``pamnet_tpu.models.init_pamnet``) -> the port's state dict."""
    out: dict[str, torch.Tensor] = {}

    def emit(key: str, value, transpose: bool = False):
        arr = np.asarray(value, dtype=np.float32)
        out[key] = torch.tensor(arr.T if transpose else arr)

    def emit_linear(prefix: str, lin: dict):
        emit(prefix + ".weight", lin["w"], transpose=True)
        if "b" in lin:
            emit(prefix + ".bias", lin["b"])

    def walk(container: dict, prefix: str):
        for name, value in container.items():
            key = prefix + name
            if name in ("embeddings", "W"):
                emit(key, value)
            elif name in ("rbf_g", "rbf_l"):
                emit(key + ".freq", value["freq"])
            elif name in _LINEAR_NAMES:
                emit_linear(key, value)
            elif name in _MLP_NAMES:
                for i, lin in enumerate(value):
                    emit_linear(f"{key}.{i}.0", lin)
            elif name in ("res1", "res2", "res3"):
                for i, lin in enumerate(value["mlp"]):
                    emit_linear(f"{key}.mlp.{i}.0", lin)
            elif name in ("global_layers", "local_layers"):
                for i, layer in enumerate(value):
                    walk(layer, f"{name[:-1]}.{i}.")
            else:
                raise KeyError(f"unrecognized JAX parameter: {key}")

    walk(tree, "")
    return out


def load_reference_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pt`` state dict (e.g. ``pamnet_rna.pt``) as float32
    CPU tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().to(torch.float32).contiguous() for k, v in sd.items()}


def init_params(cfg: PAMNetConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random state dict with the init distributions of ``pamnet_tpu/nn.py``
    and ``init_pamnet``, drawn from ``generator``."""
    from pamnet_tpu_torch.models.pamnet import PAMNet

    return PAMNet(cfg, generator).state_dict()
