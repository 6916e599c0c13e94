"""The folded spherical-basis modulate stage of the local layer (kernel B).

For each triplet t with neighbour edge e = idx[t]:

    acc = bias + sum_l cbf[t, l] * proj[e, l*D:(l+1)*D]
    h   = silu(silu(silu(acc) @ w1.T + b1) @ w2.T + b2) * mask[t]
    out[t] = m_neighbor[e] * h

which is ``pamnet_tpu/models/layers.py::_fused_sbf_gather`` with the
layer's 2-stage ``mlp_sbf`` given as torch (out, in) weights.
``sbf_modulate`` runs the plain version on CPU tensors and launches
``csrc/sbf_modulate.cu`` on CUDA tensors.  It replaces the Pallas kernel of
``tools/fused_sbf_kernel_probe.py:42``.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from pamnet_tpu_torch.ops import _build

# (num_spherical, dim) pairs the CUDA source is compiled for.
KERNEL_SHAPES = ((7, 16), (7, 8))


def sbf_modulate_plain(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask):
    """Reference version: one gather of concat(proj, m_neighbor), slice
    multiply-adds, the 2-stage MLP, mask and modulation."""
    d = m_neighbor.shape[1]
    ns = proj.shape[1] // d
    rows = torch.cat([proj, m_neighbor], dim=1)[idx.long()]
    acc = bias
    for l in range(ns):
        acc = acc + cbf[:, l:l + 1] * rows[:, l * d:(l + 1) * d]
    h = F.silu(F.linear(F.silu(acc), w1, b1))
    h = F.silu(F.linear(h, w2, b2)) * mask[:, None]
    return rows[:, ns * d:] * h


def sbf_modulate(proj: torch.Tensor, m_neighbor: torch.Tensor,
                 cbf: torch.Tensor, bias: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                 idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(T, D) modulated triplet messages; the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors.  Counts its kernel launches in
    ``sbf_modulate.launches``."""
    if m_neighbor.device.type == "cpu":
        return sbf_modulate_plain(proj, m_neighbor, cbf, bias, w1, b1, w2, b2,
                                  idx, mask)
    dev = m_neighbor.device
    t_count, d = idx.shape[0], m_neighbor.shape[1]
    ns = cbf.shape[1]
    shapes = {
        "proj": (proj, (m_neighbor.shape[0], ns * d)),
        "m_neighbor": (m_neighbor, (m_neighbor.shape[0], d)),
        "cbf": (cbf, (t_count, ns)),
        "bias": (bias, (d,)), "b1": (b1, (d,)), "b2": (b2, (d,)),
        "w1": (w1, (d, d)), "w2": (w2, (d, d)),
        "idx": (idx, (t_count,)), "mask": (mask, (t_count,)),
    }
    for name, (t, shape) in shapes.items():
        dtype = torch.int32 if name == "idx" else torch.float32
        _build.check_operand("sbf_modulate", name, t, dtype, dev, shape)
    if (ns, d) not in KERNEL_SHAPES:
        raise ValueError(
            f"sbf_modulate: no kernel for num_spherical={ns}, dim={d} "
            f"(compiled for {KERNEL_SHAPES})"
        )
    out = torch.empty((t_count, d), dtype=torch.float32, device=dev)
    if t_count == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_sbf_modulate(
            proj.data_ptr(), m_neighbor.data_ptr(), cbf.data_ptr(),
            bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), idx.data_ptr(), mask.data_ptr(), out.data_ptr(),
            t_count, ns, d, stream,
        )
    _build.check(code, "sbf_modulate")
    sbf_modulate.launches += 1
    return out


sbf_modulate.launches = 0
