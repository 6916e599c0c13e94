"""A model's weights from the run's seed, made on the device: one draw of
U(0, 1) for every parameter at once from a ``torch.Generator`` on that
device, scaled to each parameter's init bound (the published
initialization's distributions, ``reference/pamnet.py::param_spec``), and
the Bessel frequencies n * pi.  Both the program and the reference are
handed these same tensors."""

from __future__ import annotations

import math

import torch


def seeded_state(spec: list, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for ``spec``'s (name, shape, init)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    drawn = [(name, shape, init) for name, shape, init in spec if init != "freq"]
    sizes = [math.prod(shape) for _, shape, _ in drawn]
    bounds = torch.repeat_interleave(
        torch.tensor([init for _, _, init in drawn], dtype=torch.float32),
        torch.tensor(sizes)).to(device)
    flat = (torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0) * bounds
    state, offset = {}, 0
    for (name, shape, _), size in zip(drawn, sizes):
        state[name] = flat[offset:offset + size].view(shape)
        offset += size
    for name, shape, init in spec:
        if init == "freq":
            state[name] = torch.arange(1, shape[0] + 1, dtype=torch.float32,
                                       device=device) * math.pi
    return {name: state[name] for name, _, _ in spec}
