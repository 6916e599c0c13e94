"""FLOPs and bytes of PAMNet's work, counted from a configuration and the
valid row counts of a batch (``n`` nodes, ``eg`` global edges, ``el``
local edges, ``t2`` two-hop triplets, ``t1`` one-hop pairs), never from
which kernel carries the work, so a later fusion does not change them.

* ``forward_flops``: 2 * rows * in * out of every dense layer of the
  published model, each over the rows it is defined on (the sbf MLPs over
  the triplets, the messages over concat(x_i, x_j, e) of each edge); a
  training step is 3x its forward (``STEP_FACTOR``).
* ``mp_bytes``: the least bytes the message-passing operations move:
  the embedding's row gather, the edge messages (the global one summed by
  node), the radial table's row gathers and kernel A's gathered, modulated
  sums where the sbf stage is unfolded, kernel B's folded stage where it
  folds, and the gated sum at the local edges' targets; with ``backward``,
  the backward of each.  Each input is read once and each output written
  once, at the stack's value size (2 bytes in bfloat16, else 4; the
  embedding is float32) and 4 bytes an index or CSR offset.
"""

from __future__ import annotations

STEP_FACTOR = 3
INDEX = 4


def _c(counts: dict) -> tuple[int, int, int, int, int]:
    return counts["n"], counts["eg"], counts["el"], counts["t2"], counts["t1"]


def forward_flops(cfg: dict, counts: dict) -> float:
    """Dense-layer FLOPs of one forward over ``counts``."""
    n, eg, el, t2, t1 = _c(counts)
    d, layers = cfg["dim"], cfg["n_layer"]
    sbf = cfg["num_spherical"] * cfg["num_radial"]
    macs = (eg + el) * cfg["num_rbf"] * d + (t2 + t1) * sbf * d
    node = n * (d * d * 2 + 6 * d * d + 3 * d * d + 2 * d)  # x1, x2, res1-3, out, W_out, W
    glob = node + eg * (3 * d * d + d * d)  # mlp_m, W_edge_attr
    local = node + el * (2 * 3 * d * d + 2 * d * d) + (t2 + t1) * 2 * d * d
    return 2.0 * (macs + layers * (glob + local))


def folds(cfg: dict) -> bool:
    """Whether the configuration runs the sbf stage folded (kernel B)."""
    return bool(cfg.get("folded", False))


def mp_bytes(cfg: dict, counts: dict, backward: bool = False) -> float:
    """Least bytes of the message-passing operations of one forward over
    ``counts`` and, with ``backward``, of their backward too."""
    n, eg, el, t2, t1 = _c(counts)
    d, ns, nr = cfg["dim"], cfg["num_spherical"], cfg["num_radial"]
    b = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    types = 3 if cfg["kind"] == "rna" else 5
    fwd = types * d * 4 + n * INDEX + n * d * 4  # embedding gather
    bwd = n * d * 4 + n * INDEX + (types + 1) * INDEX + types * d * 4  # its group sum
    per_fwd = per_bwd = 0
    # Global message summed by node: xi, xj, base, gate, mask, i, j, CSR; out.
    per_fwd += (2 * n * d * b + 2 * eg * d * b + eg * b + 2 * eg * INDEX + (n + 1) * INDEX
                + n * d * b)
    # Backward: g, xi, xj, base, gate, mask, i, j, two CSRs; d_xi, d_xj, d_base, d_gate.
    per_bwd += (3 * n * d * b + 2 * eg * d * b + eg * b + 3 * eg * INDEX + 2 * (n + 1) * INDEX
                + 2 * n * d * b + 2 * eg * d * b)
    for gated in (False, True):  # m_ji and the neighbour message (gated by lin_rbf)
        per_fwd += 2 * n * d * b + (1 + gated) * el * d * b + 2 * el * INDEX + el * d * b
        per_bwd += (el * d * b + 2 * n * d * b + (1 + gated) * el * d * b + 3 * el * INDEX
                    + 2 * (n + 1) * INDEX + 2 * n * d * b + (1 + gated) * el * d * b)
    for t in (t2, t1):
        if folds(cfg):
            weights = (2 * d * d + 3 * d) * b
            # Kernel B: proj, m, cbf, mask, idx, centre CSR, weights; out.
            per_fwd += (el * ns * d * b + el * d * b + t * ns * b + t * b + t * INDEX
                        + (el + 1) * INDEX + weights + el * d * b)
            # Backward: those inputs, g, the centre of each triplet; d_proj,
            # d_m, the weights' gradients.
            per_bwd += (el * ns * d * b + el * d * b + t * ns * b + t * b + 2 * t * INDEX
                        + (el + 1) * INDEX + weights + el * d * b
                        + el * ns * d * b + el * d * b + weights)
        else:
            # Radial table at the triplets: table, idx; rows out.
            per_fwd += el * ns * nr * b + t * INDEX + t * ns * nr * b
            # Kernel A: values, b, idx, CSR; out.
            per_fwd += el * d * b + t * d * b + t * INDEX + (el + 1) * INDEX + el * d * b
            # Backward: g, a, b, idx, centre, CSR of idx; d_a, d_b.
            per_bwd += (el * d * b + el * d * b + t * d * b + 3 * t * INDEX + (el + 1) * INDEX
                        + el * d * b + t * d * b)
    # Gated sum at el_dst: m, gate, CSR; out.  Backward: g, m, gate, idx; d_m, d_gate.
    per_fwd += 2 * el * d * b + (n + 1) * INDEX + n * d * b
    per_bwd += n * d * b + 2 * el * d * b + el * INDEX + 2 * el * d * b
    layers = cfg["n_layer"]
    total = fwd + layers * per_fwd
    if backward:
        total += bwd + layers * per_bwd
    return float(total)
