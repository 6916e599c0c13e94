"""Plain PyTorch reference of PAMNet (the published model: models.py,
global_message_passing.py, local_message_passing.py and layers/basic.py of
XieResearchGroup/Physics-aware-Multiplex-GNN), its losses, its optimizer
steps and the QM9 learning-rate schedule, in float32 with TF32 off.

It reads a state dict under the published code's parameter names and a
batch of ``graph.build``; it imports nothing of the program.  Every sum is
an ``index_add_``; every MLP is (Linear, SiLU) stages; every concat is
computed as a concat.  ``quant``, where given, rounds the inputs and
weights of every product of the message-passing stack (the sbf MLPs and
the layers) and the stack's input, as a control in a lower precision does;
the geometry, the embedding, the fusion and the pool stay float32.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from benchmark.reference.graph import build  # noqa: F401  (the module's batches)


def _linear_spec(name: str, d_in: int, d_out: int, bias: bool = True) -> list:
    out = [(name + ".weight", (d_out, d_in), 1.0 / math.sqrt(d_in))]
    if bias:
        out.append((name + ".bias", (d_out,), 1.0 / math.sqrt(d_in)))
    return out


def _mlp_spec(name: str, channels: list[int]) -> list:
    return [s for i in range(len(channels) - 1)
            for s in _linear_spec(f"{name}.{i}.0", channels[i], channels[i + 1])]


def param_spec(cfg: dict) -> list[tuple[str, tuple, float | str]]:
    """(name, shape, init) of every parameter, in the published state
    dict's order: init is the bound b of U(-b, b), or "freq" for the Bessel
    frequencies n * pi (the published initialization's distributions)."""
    d, ns, nr, nrbf = cfg["dim"], cfg["num_spherical"], cfg["num_radial"], cfg["num_rbf"]
    types = 3 if cfg["kind"] == "rna" else 5
    spec = [("embeddings", (types, d), math.sqrt(3.0)),
            ("rbf_g.freq", (nrbf,), "freq"), ("rbf_l.freq", (nrbf,), "freq")]
    spec += _mlp_spec("mlp_rbf_g", [nrbf, d]) + _mlp_spec("mlp_rbf_l", [nrbf, d])
    if cfg["kind"] != "rna":
        spec += _linear_spec("init_linear", cfg["num_node_features"], d, bias=False)
    spec += _mlp_spec("mlp_sbf1", [ns * nr, d]) + _mlp_spec("mlp_sbf2", [ns * nr, d])
    att = math.sqrt(6.0 / (d + 1))
    for i in range(cfg["n_layer"]):
        p = f"global_layer.{i}."
        spec += _mlp_spec(p + "mlp_x1", [d, d]) + _mlp_spec(p + "mlp_x2", [d, d])
        for r in ("res1", "res2", "res3"):
            spec += _mlp_spec(p + r + ".mlp", [d, d, d])
        spec += _mlp_spec(p + "mlp_m", [3 * d, d]) + _linear_spec(p + "W_edge_attr", d, d, False)
        spec += _mlp_spec(p + "mlp_out", [d, d, d, d]) + _linear_spec(p + "W_out", d, 1)
        spec.append((p + "W", (d, 1), att))
    for i in range(cfg["n_layer"]):
        p = f"local_layer.{i}."
        spec += _mlp_spec(p + "mlp_x1", [d, d]) + _mlp_spec(p + "mlp_m_ji", [3 * d, d])
        spec += _mlp_spec(p + "mlp_m_kj", [3 * d, d]) + _mlp_spec(p + "mlp_sbf", [d, d, d])
        spec += _linear_spec(p + "lin_rbf", d, d, False)
        for r in ("res1", "res2", "res3"):
            spec += _mlp_spec(p + r + ".mlp", [d, d, d])
        spec += _linear_spec(p + "lin_rbf_out", d, d, False) + _mlp_spec(p + "mlp_x2", [d, d])
        spec += _mlp_spec(p + "mlp_out", [d, d, d, d]) + _linear_spec(p + "W_out", d, 1)
        spec.append((p + "W", (d, 1), att))
    return spec


class _Net:
    """The forward's helpers over one state dict ``P``."""

    def __init__(self, P: dict, quant=None):
        self.P, self.quant = P, quant

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.quant is None else self.quant(t)

    def lin(self, name: str, x: torch.Tensor, stack: bool = True) -> torch.Tensor:
        w, b = self.P[name + ".weight"], self.P.get(name + ".bias")
        if stack:
            x, w, b = self.q(x), self.q(w), None if b is None else self.q(b)
        return F.linear(x, w, b)

    def mlp(self, name: str, x: torch.Tensor, stages: int, stack: bool = True) -> torch.Tensor:
        for i in range(stages):
            x = F.silu(self.lin(f"{name}.{i}.0", x, stack))
        return x

    def res(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(name + ".mlp", x, 2) + x

    def tail(self, p: str, x: torch.Tensor, res_x: torch.Tensor):
        x = self.mlp(p + "mlp_x2", x, 1)
        x = self.res(p + "res1", x) + res_x
        x = self.res(p + "res3", self.res(p + "res2", x))
        out = self.mlp(p + "mlp_out", x, 3)
        return x, self.lin(p + "W_out", out), self.q(out) @ self.q(self.P[p + "W"])

    def message(self, name: str, x, e, i, j):
        return F.silu(self.lin(name + ".0.0", torch.cat([x[i], x[j], e], dim=1)))


def _scatter(values: torch.Tensor, index: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.zeros((rows,) + values.shape[1:], dtype=values.dtype,
                       device=values.device).index_add_(0, index, values)


def forward(P: dict, b: dict, cfg: dict, quant=None) -> torch.Tensor:
    """(G,) predictions of the batch ``b`` (``graph.build``)."""
    net = _Net(P, quant)
    nr, cl, cg, p = cfg["num_radial"], cfg["cutoff_l"], cfg["cutoff_g"], cfg["envelope_exponent"]
    n = b["z"].shape[0]

    def bessel(dist, freq, cutoff):
        x = dist[:, None] / cutoff
        a, bb, c = -(p + 1) * (p + 2) / 2.0, p * (p + 2), -p * (p + 1) / 2.0
        env = torch.where(x < 1.0, 1.0 / x + a * x**p + bb * x ** (p + 1) + c * x ** (p + 2),
                          torch.zeros_like(x))
        return env * torch.sin(freq * x)

    x = P["embeddings"][b["z"]]
    rbf_l = net.mlp("mlp_rbf_l", bessel(b["dist_l"], P["rbf_l.freq"], cl), 1, stack=False)
    rbf_g = net.mlp("mlp_rbf_g", bessel(b["dist_g"], P["rbf_g.freq"], cg), 1, stack=False)
    t2, t1, table = b["t2"], b["t1"], b["sbf_radial"]
    sbf2 = net.mlp("mlp_sbf2", table[t2["kj"]] * torch.repeat_interleave(b["cbf2"], nr, 1), 1)
    sbf1 = net.mlp("mlp_sbf1", table[t1["jj"]] * torch.repeat_interleave(b["cbf1"], nr, 1), 1)
    x, rbf_g, rbf_l = net.q(x), net.q(rbf_g), net.q(rbf_l)
    to_source = cfg["flow"] == "target_to_source"
    gi, gj = (b["eg_src"], b["eg_dst"]) if to_source else (b["eg_dst"], b["eg_src"])
    li, lj = b["el_dst"], b["el_src"]
    n_el = li.shape[0]
    outs, atts = [], []
    for layer in range(cfg["n_layer"]):
        pg = f"global_layer.{layer}."
        res_x = x
        h = net.mlp(pg + "mlp_x1", x, 1)
        m = net.message(pg + "mlp_m", h, rbf_g, gi, gj) * net.lin(pg + "W_edge_attr", rbf_g)
        x, out_g, att_g = net.tail(pg, h + _scatter(m, gi, n), res_x)

        pl = f"local_layer.{layer}."
        res_x = x
        h = net.mlp(pl + "mlp_x1", x, 1)
        m_ji = net.message(pl + "mlp_m_ji", h, rbf_l, li, lj)
        m_kj = net.message(pl + "mlp_m_kj", h, rbf_l, li, lj) * net.lin(pl + "lin_rbf", rbf_l)
        m2 = m_kj[t2["kj"]] * net.mlp(pl + "mlp_sbf", sbf2, 2)
        m1 = m_kj[t1["jj"]] * net.mlp(pl + "mlp_sbf", sbf1, 2)
        m = m_ji + _scatter(m2, t2["ji"], n_el) + _scatter(m1, t1["ji"], n_el)
        s = _scatter(net.lin(pl + "lin_rbf_out", rbf_l) * m, li, n)
        x, out_l, att_l = net.tail(pl, h + s, res_x)
        outs.append(torch.cat([out_g, out_l], 1))
        atts.append(torch.cat([att_g, att_l], 1))
    att = torch.softmax(F.leaky_relu(torch.stack(atts).float(), 0.2), dim=-1)
    node_out = (torch.stack(outs).float() * att).sum(-1).sum(0)
    pooled = _scatter(node_out, b["node_graph"], b["num_graphs"])
    if cfg["kind"] == "rna":
        pooled = pooled / _scatter(torch.ones_like(node_out), b["node_graph"], b["num_graphs"])
    return pooled


def loss(pred: torch.Tensor, y: torch.Tensor, kind: str) -> torch.Tensor:
    """Mean over the graphs of the published losses: l1 (QM9), smooth_l1
    with beta 1 (RNA)."""
    err = pred - y
    if kind == "l1":
        return err.abs().mean()
    if kind == "smooth_l1":
        a = err.abs()
        return torch.where(a < 1.0, 0.5 * err * err, a - 0.5).mean()
    raise ValueError(kind)


def warmup_exponential_lr(base_lr: float, steps_per_epoch: int, frac_steps: float,
                          update: int, gamma: float = 0.9961697) -> float:
    """The published QM9 schedule's lr of update ``update``: a frozen copy
    of ``pamnet_tpu_torch/train/schedules.py::warmup_exponential`` at commit
    3e9441f (GradualWarmupScheduler into ExponentialLR, stepped after each
    update with the previous batch's fractional epoch)."""
    if update == 0:
        return 0.0
    k = update - 1
    epoch = k // steps_per_epoch
    t = epoch + (k - epoch * steps_per_epoch) / frac_steps
    if k == steps_per_epoch + 1:
        return base_lr
    return base_lr * t if t <= 1.0 else base_lr * gamma ** (t - 1.0)


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, no weight decay) with an optional
    global-norm clip of the gradients first, in float32."""

    def __init__(self, params: dict, clip_norm: float | None = None):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t, self.clip_norm = 0, clip_norm

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> dict:
        """Update ``params`` in place; returns the gradients as applied."""
        if self.clip_norm is not None:
            total = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
            scale = min(1.0, self.clip_norm / (float(total) + 1e-6))
            grads = {k: g * scale for k, g in grads.items()}
        self.t += 1
        c1, c2 = 1.0 - 0.9**self.t, 1.0 - 0.999**self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = self.v[k].sqrt() / math.sqrt(c2) + 1e-8
            p.addcdiv_(self.m[k], denom, value=-lr / c1)
        return grads
