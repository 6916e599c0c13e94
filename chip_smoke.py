#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (pamnet_tpu_torch) on one card.

    python3 chip_smoke.py [--seed 0] [--structures 16] [--atoms 2100]
                          [--qm9_molecules 512] [--profile]

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi) and the kernel
     build time (nvcc, sm_90a, from the sources in the checkout);
  2. kernels: each CUDA kernel against its plain PyTorch version on the card
     at the RNA batch-16 shapes, with kernel, plain, library and bound times;
  3. slice: RNAScoringService(device="cuda") scores a batch of synthetic
     RNA-scale structures with seeded weights (the serving main path; every
     forward kernel's launch count must rise), then the folded, unfolded and
     plain paths score the same batch and are compared; graphs/s and ms per
     batch;
  4. service: the HTTP server on an ephemeral port answers JSON and raw-PDB
     requests, compared with direct scoring;
  5. train_kernels: each backward kernel against its plain version at the
     QM9 batch-32 pads (D=128), on the CSR arrays of a real training batch;
  6. train: QM9 training at the recipe (dim 128, 6 layers, batch 32, f32,
     L1, Adam + clip 1000 + EMA 0.999, warmup-exponential at lr 1e-4) on
     synthetic molecules: the first step's gradients through the kernels
     against the plain route, a repeated step bitwise, launches per step of
     every forward and backward kernel, an epoch (the training main path;
     every kernel of the path must launch), ms per step and molecules/s on a
     resident batch, host enqueue time and peak memory; then
     ``python -m pamnet_tpu_torch.main_qm9`` in-process for one epoch;
  7. kernels: one line listing every kernel with its numbers.
Then the nvidia-smi line and, last, {"ok": true, "device": {...}}.
Any mismatch raises and the script exits non-zero.  It exits non-zero with no
result when CUDA is absent.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 flop/s outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Pads of a 16-structure RNA-Puzzles batch printed by bench.py (shape facts).
BENCH_PADS = {"n": 34304, "eg": 1675136, "el": 186368, "t2": 935296, "t1": 1121664}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rna_like_structure(rng: np.random.Generator, n_atoms: int) -> dict:
    """A compact folded chain of C/N/O atoms: 1.5 A steps at a 115 degree
    bond angle with random torsions, kept inside a sphere at heavy-atom
    density (0.05 per A^3), no atom closer than 2.1 A to any but its two chain predecessors."""
    radius = (3.0 * n_atoms / (4.0 * np.pi * 0.05)) ** (1.0 / 3.0)
    step, cos_a = 1.5, np.cos(np.deg2rad(180.0 - 115.0))
    pos = np.zeros((n_atoms, 3))
    pos[1] = pos[0] + [step, 0.0, 0.0]
    for i in range(2, n_atoms):
        u = pos[i - 1] - pos[i - 2]
        u /= np.linalg.norm(u)
        # Candidate directions at the bond angle to the previous bond.
        ref = np.array([0.0, 0.0, 1.0]) if abs(u[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
        v = np.cross(u, ref)
        v /= np.linalg.norm(v)
        w = np.cross(u, v)
        tors = rng.uniform(0.0, 2.0 * np.pi, 16)
        sin_a = np.sqrt(1.0 - cos_a**2)
        dirs = (cos_a * u[None] + sin_a * (np.cos(tors)[:, None] * v[None]
                                           + np.sin(tors)[:, None] * w[None]))
        cand = pos[i - 1] + step * dirs
        r = np.linalg.norm(cand, axis=1)
        if i > 2:
            d = np.sqrt(((cand[:, None] - pos[None, : i - 2]) ** 2).sum(-1).min(1))
        else:
            d = np.full(len(cand), np.inf)
        free = d >= 2.1
        if (free & (r <= radius)).any():
            pick = np.argmax(free & (r <= radius))
        elif free.any():  # outside the sphere: step back towards the centre
            pick = np.argmin(np.where(free, r, np.inf))
        else:  # crowded: the least crowded candidate
            pick = np.argmax(d)
        pos[i] = cand[pick]
    z = rng.choice(3, size=n_atoms, p=[0.45, 0.35, 0.20]).astype(np.int32)
    return dict(z=z, pos=pos.astype(np.float32), y=0.0)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def enqueue_ms(fn, iters: int = 50) -> float:
    """Host time to issue one call (no synchronize inside the loop): where it
    exceeds the device time, a run of calls is bound by the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def device_ms(fn, iters: int = 20, tries: int = 3) -> float | None:
    """Mean device time of the kernels one call launches, from the profiler's
    kernel records over ``iters`` calls: the card's own time, where an
    event-timed run of small calls measures the host's issue rate.  A
    profile that recorded no kernel is taken again; None ("not measured")
    after ``tries`` such profiles."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(_device_us(ev) for ev in prof.key_averages() if _is_kernel(ev))
        if us > 0:
            return us / iters / 1e3
    return None


def _device_us(ev) -> float:
    return getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))


def _is_kernel(ev) -> bool:
    """A record of work on the card (not a host op or an autograd node that
    the card's time is also attributed to)."""
    return str(getattr(ev, "device_type", "")).endswith("CUDA") and _device_us(ev) > 0


def compare(name: str, got, want, atol: float, rtol: float) -> dict:
    """Max errors of ``got`` against ``want``; raises beyond atol + rtol|want|."""
    import torch

    diff = (got.double() - want.double()).abs()
    allowed = atol + rtol * want.double().abs()
    res = {"max_abs_err": float(diff.max()) if diff.numel() else 0.0,
           "max_rel_err": float((diff / want.double().abs().clamp_min(1e-30)).max())
           if diff.numel() else 0.0,
           "tolerance": f"atol {atol} + rtol {rtol}"}
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    if bool((diff > allowed).any()):
        raise AssertionError(f"{name}: mismatch {res}")
    return res


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_a_case(name, num_out, rows, d, gather, modulate, gen):
    """Kernel A on random CSR data at one main-path shape, against its plain
    version; ``library_ms`` times index_add_ of the product computed before."""
    import torch

    from pamnet_tpu_torch.ops.triplet import triplet_aggregate, triplet_aggregate_plain

    dev = torch.device("cuda")
    valid = rows - rows // 16  # a padded tail, as in batches
    seg = torch.sort(torch.randint(0, num_out, (valid,), device=dev, generator=gen))[0]
    off = torch.searchsorted(seg, torch.arange(num_out + 1, device=dev)).to(torch.int32)
    a_rows = num_out if gather else rows
    a = torch.randn(a_rows, d, device=dev, generator=gen)
    idx = (torch.randint(0, a_rows, (rows,), device=dev, generator=gen).to(torch.int32)
           if gather else None)
    b = torch.randn(rows, d, device=dev, generator=gen) if modulate else None

    got = triplet_aggregate(a, off, idx, b)
    want = triplet_aggregate_plain(a, off, idx, b)
    torch.cuda.synchronize()
    err = compare(f"triplet_aggregate[{name}]", got, want, atol=1e-4, rtol=1e-5)

    vals = a[idx[:valid].long()] if gather else a[:valid]
    if modulate:
        vals = vals * b[:valid]
    seg_long = seg.long()
    acc = torch.zeros(num_out, d, device=dev)
    # Kernel timed before and after the others, to show its spread.
    ms_first = time_ms(lambda: triplet_aggregate(a, off, idx, b))
    plain = time_ms(lambda: triplet_aggregate_plain(a, off, idx, b))
    lib = time_ms(lambda: acc.index_add_(0, seg_long, vals))
    ms = time_ms(lambda: triplet_aggregate(a, off, idx, b))
    enq = enqueue_ms(lambda: triplet_aggregate(a, off, idx, b))
    dev = device_ms(lambda: triplet_aggregate(a, off, idx, b))
    lib_dev = device_ms(lambda: acc.index_add_(0, seg_long, vals))
    a_read = (torch.unique(idx[:valid]).numel() if gather else valid) * d * 4
    nbytes = (a_read + (valid * d * 4 if modulate else 0) + (valid * 4 if gather else 0)
              + (num_out + 1) * 4 + num_out * d * 4)
    flops = valid * d * (2 if modulate else 1)
    bms, by = bound_ms(nbytes, flops)
    return {"case": name, "num_out": num_out, "rows": rows, "d": d,
            "gather": gather, "modulate": modulate, **err, "ms": ms, "ms_first": ms_first,
            "device_ms": dev, "library_device_ms": lib_dev,
            "enqueue_ms": enq,
            "plain_ms": plain, "library_ms": lib, "bound_ms": bms, "bound_by": by}


def kernel_b_case(num_edges, triplets, ns, d, gen):
    import torch

    from pamnet_tpu_torch.ops.sbf_modulate import sbf_modulate, sbf_modulate_plain

    dev = torch.device("cuda")
    r = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    valid = triplets - triplets // 16
    args = (r(num_edges, ns * d), r(num_edges, d), r(triplets, ns), r(d),
            r(d, d) / d**0.5, r(d), r(d, d) / d**0.5, r(d),
            torch.randint(0, num_edges, (triplets,), device=dev, generator=gen).to(torch.int32),
            (torch.arange(triplets, device=dev) < valid).float())
    got = sbf_modulate(*args)
    want = sbf_modulate_plain(*args)
    torch.cuda.synchronize()
    err = compare("sbf_modulate", got, want, atol=1e-4, rtol=1e-4)
    ms_first = time_ms(lambda: sbf_modulate(*args))
    plain = time_ms(lambda: sbf_modulate_plain(*args))
    ms = time_ms(lambda: sbf_modulate(*args))
    enq = enqueue_ms(lambda: sbf_modulate(*args))
    dev = device_ms(lambda: sbf_modulate(*args))
    edges_read = torch.unique(args[8]).numel()
    nbytes = (edges_read * (ns + 1) * d * 4 + triplets * (ns + 2) * 4
              + (2 * d * d + 3 * d) * 4 + triplets * d * 4)
    # Per triplet: ns*d multiply-adds, two d x d products, 3*d silu (4 ops
    # each), the mask and the modulation.
    flops = triplets * (2 * ns * d + 4 * d * d + 12 * d + 2 * d)
    bms, by = bound_ms(nbytes, flops)
    return {"case": "t2 fused folded gather", "edges": num_edges,
            "triplets": triplets, "ns": ns, "d": d, **err, "ms": ms, "ms_first": ms_first,
            "device_ms": dev, "library_device_ms": None,
            "enqueue_ms": enq,
            "plain_ms": plain, "library_ms": None, "bound_ms": bms, "bound_by": by}


def row_gather_case(name, table_rows, rows, d, gen):
    """The row gather against its plain version; ``library_ms`` times
    ``torch.index_select``, the same function in one call."""
    import torch

    from pamnet_tpu_torch.ops.gather import row_gather, row_gather_plain

    dev = torch.device("cuda")
    src = torch.randn(table_rows, d, device=dev, generator=gen)
    idx = torch.randint(0, table_rows, (rows,), device=dev, generator=gen).to(torch.int32)
    got = row_gather(src, idx)
    want = row_gather_plain(src, idx)
    torch.cuda.synchronize()
    err = compare(f"row_gather[{name}]", got, want, atol=0.0, rtol=0.0)
    idx_long = idx.long()
    ms_first = time_ms(lambda: row_gather(src, idx))
    plain = time_ms(lambda: row_gather_plain(src, idx))
    lib = time_ms(lambda: torch.index_select(src, 0, idx_long))
    ms = time_ms(lambda: row_gather(src, idx))
    enq = enqueue_ms(lambda: row_gather(src, idx))
    dev = device_ms(lambda: row_gather(src, idx))
    lib_dev = device_ms(lambda: torch.index_select(src, 0, idx_long))
    nbytes = torch.unique(idx).numel() * d * 4 + rows * 4 + rows * d * 4
    bms, by = bound_ms(nbytes, 0.0)
    return {"case": name, "table_rows": table_rows, "rows": rows, "d": d, **err,
            "ms": ms, "ms_first": ms_first, "enqueue_ms": enq, "plain_ms": plain,
            "device_ms": dev, "library_device_ms": lib_dev,
            "library_ms": lib, "bound_ms": bms, "bound_by": by}


def edge_message_case(name, nodes, rows, d, gated, masked, gen):
    """The fused edge message against its plain version; no single PyTorch
    call computes it, so ``library_ms`` is None."""
    import torch

    from pamnet_tpu_torch.ops.gather import edge_message, edge_message_plain

    dev = torch.device("cuda")
    r = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    idx = lambda: torch.randint(0, nodes, (rows,), device=dev,  # noqa: E731
                                generator=gen).to(torch.int32)
    valid = rows - rows // 16
    args = (r(nodes, d), r(nodes, d), idx(), idx(), r(rows, d),
            r(rows, d) if gated else None,
            (torch.arange(rows, device=dev) < valid).float() if masked else None)
    got = edge_message(*args)
    want = edge_message_plain(*args)
    torch.cuda.synchronize()
    err = compare(f"edge_message[{name}]", got, want, atol=1e-6, rtol=1e-5)
    ms_first = time_ms(lambda: edge_message(*args))
    plain = time_ms(lambda: edge_message_plain(*args))
    ms = time_ms(lambda: edge_message(*args))
    enq = enqueue_ms(lambda: edge_message(*args))
    dev = device_ms(lambda: edge_message(*args))
    nbytes = ((torch.unique(args[2]).numel() + torch.unique(args[3]).numel()) * d * 4
              + rows * 8 + rows * d * 4 * (3 if gated else 2) + (rows * 4 if masked else 0))
    # Per element: two adds, silu (exp, add, divide: 4 ops), the factors.
    flops = rows * d * (6 + int(gated) + int(masked))
    bms, by = bound_ms(nbytes, flops)
    return {"case": name, "nodes": nodes, "rows": rows, "d": d, "gated": gated,
            "masked": masked, **err, "ms": ms, "ms_first": ms_first, "enqueue_ms": enq,
            "device_ms": dev, "library_device_ms": None,
            "plain_ms": plain,
            "library_ms": None, "bound_ms": bms, "bound_by": by}


def _unique(idx, valid: int) -> int:
    import torch

    return torch.unique(idx[:valid]).numel()


def _timed_case(name, fn, plain_fn, lib_fn, got, want, atol, rtol, nbytes, flops,
                **extra) -> dict:
    """Compare ``got`` with ``want`` (tensors or tuples of them), then time
    the kernel (before and after the others, to show its spread), its plain
    version and the library call, and compute the bound."""
    import torch

    torch.cuda.synchronize()
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    errs = [compare(name, g, w, atol=atol, rtol=rtol) for g, w in pairs if g is not None]
    err = max(errs, key=lambda e: e["max_abs_err"])
    ms_first = time_ms(fn)
    plain = time_ms(plain_fn)
    lib = time_ms(lib_fn) if lib_fn is not None else None
    ms = time_ms(fn)
    enq = enqueue_ms(fn)
    dev = device_ms(fn)
    lib_dev = device_ms(lib_fn) if lib_fn is not None else None
    bms, by = bound_ms(nbytes, flops)
    return {"case": name, **extra, **err, "ms": ms, "ms_first": ms_first, "enqueue_ms": enq,
            "device_ms": dev, "library_device_ms": lib_dev,
            "plain_ms": plain, "library_ms": lib, "bound_ms": bms, "bound_by": by}


def grad_a_case(gb, kind: str, d: int, gen) -> dict:
    """Kernel A's role swap, the d_a of the gathered triplet sum ``kind``,
    over the training batch's CSR of t2_kj / t1_jj; ``library_ms`` times
    index_add_ of the product computed beforehand."""
    import torch

    from pamnet_tpu_torch.ops.triplet import (triplet_aggregate_grad_a,
                                              triplet_aggregate_grad_a_plain)

    key = "t2_kj" if kind == "t2" else "t1_jj"
    by_idx, idx, seg = gb.groups(key), getattr(gb, key), getattr(gb, kind + "_ji")
    seg_by_idx = gb.perms["t2_ji_by_kj" if kind == "t2" else "t1_ji_by_jj"]
    valid, e = gb.valid[kind], gb.el_src.shape[0]
    g = torch.randn(e, d, device="cuda", generator=gen)
    b = torch.randn(idx.shape[0], d, device="cuda", generator=gen)
    vals = g[seg[:valid].long()] * b[:valid]
    idx_long, acc = idx[:valid].long(), torch.zeros(e, d, device="cuda")
    nbytes = (_unique(seg, valid) * d * 4 + valid * d * 4 + valid * 8 + (e + 1) * 4
              + e * d * 4)
    return _timed_case(
        f"d_a by role swap over the {key} CSR",
        lambda: triplet_aggregate_grad_a(g, by_idx, seg_by_idx, b),
        lambda: triplet_aggregate_grad_a_plain(g, by_idx, seg_by_idx, b),
        lambda: acc.index_add_(0, idx_long, vals),
        triplet_aggregate_grad_a(g, by_idx, seg_by_idx, b),
        triplet_aggregate_grad_a_plain(g, by_idx, seg_by_idx, b),
        1e-4, 1e-5, nbytes, 2 * valid * d, rows=idx.shape[0], valid=valid, d=d)


def gather_product_case(gb, kind: str, d: int, gen) -> dict:
    """d_b of the gathered triplet sum ``kind``: a[t2_kj] * g[t2_ji]; no one
    PyTorch call computes it."""
    import torch

    from pamnet_tpu_torch.ops.triplet import gather_product, gather_product_plain

    idx = gb.t2_kj if kind == "t2" else gb.t1_jj
    seg = getattr(gb, kind + "_ji")
    valid, e = gb.valid[kind], gb.el_src.shape[0]
    a = torch.randn(e, d, device="cuda", generator=gen)
    g = torch.randn(e, d, device="cuda", generator=gen)
    args = (a, idx, g, seg, valid)
    nbytes = ((_unique(idx, valid) + _unique(seg, valid)) * d * 4 + valid * 8
              + idx.shape[0] * d * 4)
    return _timed_case(
        f"d_b at {kind}", lambda: gather_product(*args), lambda: gather_product_plain(*args),
        None, gather_product(*args), gather_product_plain(*args), 0.0, 0.0, nbytes,
        valid * d, rows=idx.shape[0], valid=valid, d=d)


def edge_backward_case(gb, which: str, d: int, gen) -> dict:
    """The edge message's backward (d_pre, d_gate) for the global message
    (gate, mask) or a local one (m_kj: gate; m_ji: none)."""
    import torch

    from pamnet_tpu_torch.ops.gather import edge_message_backward, edge_message_backward_plain

    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    nodes = gb.z.shape[0]
    if which == "global":
        i, j, mask, valid = gb.eg_dst, gb.eg_src, gb.eg_mask, gb.valid["eg"]
    else:
        i, j, mask, valid = gb.el_dst, gb.el_src, None, gb.valid["el"]
    gated = which != "local m_ji"
    rows = i.shape[0]
    args = (r(nodes, d), r(nodes, d), i, j, r(rows, d), r(rows, d) if gated else None,
            mask, r(rows, d))
    nbytes = ((_unique(i, rows) + _unique(j, rows)) * d * 4 + rows * 8
              + rows * d * 4 * (2 + gated) + (rows * 4 if mask is not None else 0)
              + rows * d * 4 * (1 + gated))
    # Per element: the pre-activation (2 adds), sigmoid (exp, add, divide),
    # silu' (4), silu (1), the mask and the gate products.
    flops = rows * d * (10 + int(mask is not None) + 2 * int(gated))
    return _timed_case(
        f"edge message backward, {which}", lambda: edge_message_backward(*args),
        lambda: edge_message_backward_plain(*args), None, edge_message_backward(*args),
        edge_message_backward_plain(*args), 1e-6, 1e-5, nbytes, flops, nodes=nodes,
        rows=rows, valid=valid, d=d, gated=gated, masked=mask is not None)


def group_sum_case(gb, key: str, d: int, gen) -> dict:
    """A row gather's backward, sum of row gradients by the index ``key``,
    over the batch's CSR of it; ``library_ms`` times index_add_."""
    import torch

    from pamnet_tpu_torch.ops.triplet import group_sum, group_sum_plain

    groups, ids = gb.groups(key), getattr(gb, key)
    valid, num = groups.total, groups.off.shape[0] - 1
    x = torch.randn(ids.shape[0], d, device="cuda", generator=gen)
    ids_long, xs, acc = ids[:valid].long(), x[:valid], torch.zeros(num, d, device="cuda")
    nbytes = (valid * d * 4 + (valid * 4 if groups.perm is not None else 0)
              + (num + 1) * 4 + num * d * 4)
    return _timed_case(
        f"sum by {key} ({'permuted' if groups.perm is not None else 'sorted'} CSR)",
        lambda: group_sum(x, groups), lambda: group_sum_plain(x, groups),
        lambda: acc.index_add_(0, ids_long, xs), group_sum(x, groups),
        group_sum_plain(x, groups), 1e-4, 1e-5, nbytes, valid * d, groups=num,
        rows=ids.shape[0], valid=valid, d=d)


def post(url: str, data: bytes, ctype: str) -> dict:
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def pdb_text(z, pos) -> str:
    elem = "CNO"
    lines = [
        f"ATOM  {i % 99999:5d}  {elem[zi]:<3s}  G A{i % 9999:4d}    "
        f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}  1.00  0.00           {elem[zi]}"
        for i, (zi, p) in enumerate(zip(z, pos))
    ]
    return "\n".join(lines) + "\nTER\n"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--structures", type=int, default=16)
    parser.add_argument("--atoms", type=int, default=2100)
    parser.add_argument("--qm9_molecules", type=int, default=512,
                        help="synthetic QM9 molecules of the training phase")
    parser.add_argument("--profile", action="store_true",
                        help="also print the device-time breakdown of one forward "
                             "and of three training steps")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.ops import _build
    from pamnet_tpu_torch.ops.gather import edge_message, edge_message_backward, row_gather
    from pamnet_tpu_torch.ops.sbf_modulate import sbf_modulate
    from pamnet_tpu_torch.ops.triplet import (gather_product, group_sum, triplet_aggregate,
                                              triplet_aggregate_grad_a)
    from pamnet_tpu_torch.serve import RNAScoringService, make_server
    from pamnet_tpu_torch.weights import init_params

    # ---- 1. device and build ----
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    lib_path = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "build_s": build_s, "library": os.path.relpath(lib_path)})

    # ---- 2. kernels against their plain versions, at the slice's shapes ----
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    p = BENCH_PADS
    a_cases = [
        kernel_a_case("t2 sum (folded path)", p["el"], p["t2"], 16, False, False, gen),
        kernel_a_case("t1 sum (folded path)", p["el"], p["t1"], 16, False, False, gen),
        kernel_a_case("t2 gather+modulate (unfolded path)", p["el"], p["t2"], 16, True, True, gen),
        kernel_a_case("t1 gather+modulate (unfolded path)", p["el"], p["t1"], 16, True, True, gen),
        kernel_a_case("t2 gather only", p["el"], p["t2"], 16, True, False, gen),
        kernel_a_case("t2 modulate only", p["el"], p["t2"], 16, False, True, gen),
        kernel_a_case("el_dst edge->node sum", p["n"], p["el"], 16, False, False, gen),
        kernel_a_case("eg_src global sum", p["n"], p["eg"], 16, False, False, gen),
        kernel_a_case("t2 gather+modulate D=128", p["el"], p["t2"], 128, True, True, gen),
    ]
    b_case = kernel_b_case(p["el"], p["t2"], 7, 16, gen)
    e_cases = [
        edge_message_case("global message (gate, mask)", p["n"], p["eg"], 16, True, True, gen),
        edge_message_case("local m_kj (gate)", p["n"], p["el"], 16, True, False, gen),
        edge_message_case("local m_ji", p["n"], p["el"], 16, False, False, gen),
    ]
    g_cases = [
        row_gather_case("atom-type embedding", 3, p["n"], 16, gen),
        row_gather_case("radial table at t2 (unfolded path)", p["el"], p["t2"], 42, gen),
    ]
    emit({"phase": "kernels", "triplet_aggregate": a_cases, "sbf_modulate": [b_case],
          "edge_message": e_cases, "row_gather": g_cases})

    # ---- 3. the slice: scoring service on the card ----
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    mols = [rna_like_structure(rng, args.atoms) for _ in range(args.structures)]
    gen_s = time.perf_counter() - t0
    cfg = PAMNetConfig(dataset="rna_serve", dim=16, n_layer=1, cutoff_l=2.6,
                       cutoff_g=20.0, flow="target_to_source")
    state = init_params(cfg, torch.Generator().manual_seed(args.seed))
    service = RNAScoringService(state, cfg, batch_size=16, device="cuda")

    wrappers = {"triplet_aggregate": triplet_aggregate, "sbf_modulate": sbf_modulate,
                "edge_message": edge_message, "row_gather": row_gather,
                "triplet_aggregate_grad_a": triplet_aggregate_grad_a,
                "gather_product": gather_product, "group_sum": group_sum,
                "edge_message_backward": edge_message_backward}
    serve_kernels = ("triplet_aggregate", "sbf_modulate", "edge_message", "row_gather")

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    reset_counts()
    t0 = time.perf_counter()
    scores = service.score_molecules(mols)  # the serving main path
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = read_counts()
    if min(launches[k] for k in serve_kernels) < 1:
        raise AssertionError(f"serving path skipped a kernel: {launches}")
    if scores.shape != (len(mols),) or not np.all(np.isfinite(scores)):
        raise AssertionError(f"bad scores {scores}")

    t0 = time.perf_counter()
    loader = GraphLoader(mols, "rna", cfg.cutoff_l, cfg.cutoff_g, batch_size=16,
                         ladder_pads=True)
    gb_host = next(iter(loader))
    host_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gb = gb_host.to("cuda")
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    counts = dict(zip(("n", "eg", "el", "t2", "t1"),
                      (int(c) for c in loader._counts.sum(axis=0))))
    pads = {"n": gb.z.shape[0], "eg": gb.eg_src.shape[0], "el": gb.el_src.shape[0],
            "t2": gb.t2_ji.shape[0], "t1": gb.t1_ji.shape[0]}

    unfold_cfg = PAMNetConfig(**{**cfg.__dict__, "fold_sbf": False})
    unfolded = PAMNet(unfold_cfg)
    unfolded.load_state_dict(state, strict=True)
    unfolded = unfolded.to("cuda").eval()
    folded = service.model
    ng = gb.num_graphs
    with torch.inference_mode():
        s_fold = folded(gb)[:ng]
        s_fold_plain = folded(gb, plain=True)[:ng]
        s_unfold = unfolded(gb)[:ng]
        s_unfold_plain = unfolded(gb, plain=True)[:ng]
        torch.cuda.synchronize()
        tol = dict(atol=5e-5, rtol=1e-4)
        checks = {
            "folded_vs_plain": compare("folded vs plain", s_fold, s_fold_plain, **tol),
            "unfolded_vs_plain": compare("unfolded vs plain", s_unfold, s_unfold_plain, **tol),
            "folded_vs_unfolded": compare("folded vs unfolded", s_fold, s_unfold, **tol),
            "service_vs_direct": compare("service vs direct", torch.from_numpy(scores),
                                         s_fold.cpu(), **tol),
        }
        reset_counts()
        folded(gb)
        per_batch = read_counts()
        reset_counts()
        unfolded(gb)
        per_batch_unfolded = read_counts()
        fold_ms = time_ms(lambda: folded(gb), iters=10)
        fold_enqueue_ms = enqueue_ms(lambda: folded(gb), iters=10)
        plain_ms = time_ms(lambda: folded(gb, plain=True), iters=10)
        unfold_ms = time_ms(lambda: unfolded(gb), iters=10)
    emit({"phase": "slice", "structures": len(mols), "atoms": args.atoms,
          "structure_gen_s": gen_s, "counts": counts, "pads": pads,
          "bench_pads": BENCH_PADS, "main_path_launches": launches,
          "main_path_e2e_s": e2e_s, "host_build_s": host_build_s, "h2d_s": h2d_s,
          "scores_head": [float(s) for s in s_fold[:4].cpu()],
          "checks": checks, "launches_per_batch": per_batch,
          "launches_per_batch_unfolded": per_batch_unfolded,
          "folded_ms_per_batch": fold_ms, "folded_graphs_per_s": ng / fold_ms * 1e3,
          "folded_enqueue_ms_per_batch": fold_enqueue_ms,
          "unfolded_ms_per_batch": unfold_ms,
          "unfolded_graphs_per_s": ng / unfold_ms * 1e3,
          "plain_ms_per_batch": plain_ms, "plain_graphs_per_s": ng / plain_ms * 1e3,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                folded(gb)
            torch.cuda.synchronize()
        rows, host = profile_rows(prof, 3)
        emit({"phase": "profile", "folded_forward_top": rows[:15],
              "device_ms_per_batch_total": sum(r["device_ms_per_call"] for r in rows),
              "host_top": host})

    # ---- 4. the HTTP service ----
    server = make_server(service, "127.0.0.1", 0, f"random weights, seed {args.seed}")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health.get("ok") is not True:
            raise AssertionError(f"healthz: {health}")
        http = []
        cuts = sorted({0, min(2, len(mols)), min(5, len(mols)), min(6, len(mols))})
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            body = json.dumps({"molecules": [
                {"name": f"s{i}", "z": mols[i]["z"].tolist(),
                 "pos": mols[i]["pos"].tolist()} for i in range(lo, hi)
            ]}).encode()
            t0 = time.perf_counter()
            res = _check_names(post(f"{base}/score", body, "application/json"),
                               [f"s{i}" for i in range(lo, hi)])
            http.append({"route": "json", "molecules": hi - lo,
                         "s": time.perf_counter() - t0,
                         **compare("http json", torch.tensor(res["scores"]),
                                   torch.from_numpy(scores[lo:hi]), **tol)})
        z, pos = mols[0]["z"], np.round(mols[0]["pos"].astype(np.float64), 3)
        t0 = time.perf_counter()
        res = _check_names(post(f"{base}/score?name=pdb0", pdb_text(z, pos).encode(),
                                "chemical/x-pdb"), ["pdb0"])
        pdb_s = time.perf_counter() - t0
        direct = service.score_molecules([dict(z=z, pos=pos)])
        http.append({"route": "pdb", "molecules": 1, "s": pdb_s,
                     **compare("http pdb", torch.tensor(res["scores"]),
                               torch.from_numpy(direct), **tol)})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    emit({"phase": "service", "requests": http})

    # ---- 5-6. QM9 training: backward kernels and the training path ----
    bwd_cases, train_launches = train_phase(args, gen, reset_counts, read_counts, emit)

    # ---- 7. every kernel of the paths, with its numbers ----
    # Each kernel's numbers are those of its main-path case: the folded t2
    # triplet sum, the global message and the embedding lookup (RNA shapes);
    # the t2 role swap and product, the global message's backward and the
    # embedding's backward sum (QM9 shapes).  Launches add the serving and
    # the training main paths.
    table = [
        ("triplet_aggregate", "triplet_aggregate.cu", "pamnet_tpu/ops/pallas_triplet.py:47",
         a_cases, a_cases[0]),
        ("sbf_modulate", "sbf_modulate.cu", "tools/fused_sbf_kernel_probe.py:42",
         [b_case], b_case),
        ("edge_message", "row_gather.cu", "tools/vmem_gather_probe.py:86",
         e_cases, e_cases[0]),
        ("row_gather", "row_gather.cu", "tools/vmem_gather_probe.py:42",
         g_cases, g_cases[0]),
        ("triplet_aggregate_grad_a", "triplet_aggregate.cu",
         "pamnet_tpu/ops/pallas_triplet.py:122", bwd_cases["triplet_aggregate_grad_a"],
         bwd_cases["triplet_aggregate_grad_a"][0]),
        ("gather_product", "gather_backward.cu", "pamnet_tpu/ops/pallas_triplet.py:129",
         bwd_cases["gather_product"], bwd_cases["gather_product"][0]),
        ("edge_message_backward", "gather_backward.cu", "tools/vmem_gather_probe.py:86",
         bwd_cases["edge_message_backward"], bwd_cases["edge_message_backward"][0]),
        ("group_sum", "triplet_aggregate.cu", "tools/vmem_gather_probe.py:42",
         bwd_cases["group_sum"], bwd_cases["group_sum"][0]),
    ]
    kernels = [
        {"name": name, "route": "cuda", "source": f"pamnet_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[name] + train_launches[name],
         "launches_by_path": {"serve": launches[name], "train": train_launches[name]},
         "max_abs_err": max(c["max_abs_err"] for c in cases),
         **{k: rep[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                "device_ms", "library_device_ms", "enqueue_ms")},
         "timed_case": rep["case"]}
        for name, src, replaces, cases, rep in table
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def profile_rows(prof, calls: int) -> tuple[list[dict], list[dict]]:
    """Kernel rows (device ms per call, launches per call) and the top host
    rows of a profile over ``calls`` calls."""
    rows = [{"name": ev.key[:80], "device_ms_per_call": _device_us(ev) / calls / 1e3,
             "launches_per_call": ev.count / calls}
            for ev in prof.key_averages() if _is_kernel(ev)]
    rows.sort(key=lambda r: -r["device_ms_per_call"])
    host = sorted(prof.key_averages(), key=lambda ev: -ev.self_cpu_time_total)
    return rows, [{"name": ev.key[:80], "host_ms_per_call": ev.self_cpu_time_total / calls / 1e3,
                   "calls_per_call": ev.count / calls} for ev in host[:12]]


def train_phase(args, gen, reset_counts, read_counts, emit_kernels) -> tuple[dict, dict]:
    """Phases 5 and 6: backward kernel cases and QM9 training at the recipe.
    Returns (kernel cases by kernel, launches of the training main path)."""
    import torch

    from pamnet_tpu_torch import main_qm9
    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.ema import ema_init
    from pamnet_tpu_torch.train.loop import Optimizer, batch_loss, run_epoch, train_step
    from pamnet_tpu_torch.train.schedules import warmup_exponential

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bs, d = 32, 128
    t0 = time.perf_counter()
    qmols = synthetic_qm9_dataset(args.qm9_molecules, seed=args.seed)
    loader = GraphLoader(qmols, "qm9", 5.0, 5.0, bs, shuffle=True, seed=args.seed,
                         drop_last=True, build_perms=True)
    host_build_s = time.perf_counter() - t0
    gb = loader.collate(list(range(bs))).to("cuda")  # a resident batch at the pads

    # ---- 5. backward kernels at the QM9 pads ----
    cases = {
        "triplet_aggregate_grad_a": [grad_a_case(gb, "t2", d, gen), grad_a_case(gb, "t1", d, gen)],
        "gather_product": [gather_product_case(gb, "t2", d, gen),
                           gather_product_case(gb, "t1", d, gen)],
        "edge_message_backward": [edge_backward_case(gb, w, d, gen)
                                  for w in ("global", "local m_kj", "local m_ji")],
        "group_sum": [group_sum_case(gb, k, d, gen)
                      for k in ("z", "el_src", "eg_src", "el_dst", "eg_dst")],
    }
    emit_kernels({"phase": "train_kernels", "pads": dataclasses.asdict(loader.pads),
                  "valid": gb.valid, **cases})

    # ---- 6. training at the recipe ----
    cfg = PAMNetConfig(dataset="QM9", dim=d, n_layer=6, cutoff_l=5.0, cutoff_g=5.0)
    model = PAMNet(cfg, torch.Generator().manual_seed(args.seed)).to("cuda")
    opt = Optimizer(model.parameters(),
                    warmup_exponential(1e-4, len(loader), frac_steps_per_epoch=len(qmols) / bs),
                    clip_norm=1000.0)
    ema = ema_init(model.state_dict())

    # The first step's gradients: kernels against PyTorch's autograd of the
    # plain versions, per tensor within 1e-4 * max|g| + 1e-6.
    grads = {}
    for plain in (False, True):
        opt.zero_grad()
        batch_loss(model, gb, plain=plain).backward()
        grads[plain] = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                        for n, p in model.named_parameters()}
    ratios = {n: float((grads[False][n] - w).abs().max())
              / (1e-4 * float(w.abs().max()) + 1e-6) for n, w in grads[True].items()}
    worst = max(ratios, key=ratios.get)
    if ratios[worst] > 1.0:
        raise AssertionError(f"kernel gradients off the plain route: {worst} {ratios[worst]}")

    # Launches of one step, forward and backward apart.
    opt.zero_grad()
    reset_counts()
    loss = batch_loss(model, gb)
    fwd = read_counts()
    reset_counts()
    loss.backward()
    torch.cuda.synchronize()
    bwd = read_counts()
    need_fwd = ("triplet_aggregate", "edge_message", "row_gather")
    need_bwd = ("triplet_aggregate_grad_a", "gather_product", "group_sum",
                "edge_message_backward", "row_gather")
    if min(fwd[k] for k in need_fwd) < 1 or min(bwd[k] for k in need_bwd) < 1:
        raise AssertionError(f"a step skipped a kernel: forward {fwd}, backward {bwd}")

    # One step from the same state, twice: bitwise equal.
    params = list(model.parameters())
    snap = ([p.detach().clone() for p in params], opt.state_dict(),
            {k: v.clone() for k, v in ema.items()})
    runs = []
    for _ in range(2):
        with torch.no_grad():
            torch._foreach_copy_(params, snap[0])
        opt.load_state_dict(snap[1])
        torch._foreach_copy_(list(ema.values()), list(snap[2].values()))
        loss = train_step(model, opt, ema, gb)
        runs.append([loss] + [p.detach().clone() for p in params]
                    + [v.clone() for v in ema.values()])
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("a repeated step is not bitwise equal")

    # The training main path: one epoch of shuffled batches.
    reset_counts()
    t0 = time.perf_counter()
    loss_sum, ng, losses = run_epoch(model, opt, ema, loader, "cuda")
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = read_counts()
    if min(launches[k] for k in set(need_fwd + need_bwd)) < 1:
        raise AssertionError(f"the training path skipped a kernel: {launches}")
    step_losses = [float(v) for v in torch.stack(losses).cpu()]
    if not all(math.isfinite(v) for v in step_losses):
        raise AssertionError(f"non-finite loss: {step_losses}")

    # Steps on the resident batch.
    torch.cuda.reset_peak_memory_stats()
    step = lambda: train_step(model, opt, ema, gb)  # noqa: E731
    step_ms = time_ms(step, iters=10, warmup=2)
    step_enqueue_ms = enqueue_ms(step, iters=10)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    last = float(step())
    if not math.isfinite(last):
        raise AssertionError(f"non-finite loss after the timed steps: {last}")
    res = {"phase": "train", "molecules": len(qmols), "batch_size": bs, "dim": d,
           "n_layer": cfg.n_layer, "host_build_s": host_build_s,
           "pads": dataclasses.asdict(loader.pads), "resident_batch_valid": gb.valid,
           "gradient_check": {"tensors": len(ratios), "worst": worst,
                              "worst_err_over_tolerance": ratios[worst],
                              "tolerance": "1e-4 * max|g_plain| + 1e-6 per tensor"},
           "bitwise_repeat": True, "launches_per_step_forward": fwd,
           "launches_per_step_backward": bwd, "epoch_steps": len(losses),
           "epoch_s": epoch_s, "epoch_mol_per_s": ng / epoch_s,
           "epoch_train_mae": loss_sum / ng, "step_losses": step_losses,
           "main_path_launches": launches, "ms_per_step": step_ms,
           "mol_per_s": gb.num_graphs / step_ms * 1e3,
           "enqueue_ms_per_step": step_enqueue_ms, "peak_mem_gb": peak_gb,
           "loss_after": last}
    emit_kernels(res)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
        rows, host = profile_rows(prof, 3)
        device_ms = sum(r["device_ms_per_call"] for r in rows)
        # Python's own profile of the host side of three steps.
        import cProfile
        import pstats

        pr = cProfile.Profile()
        pr.enable()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        pr.disable()
        st = pstats.Stats(pr)
        py_rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:20]
        emit_kernels({"phase": "profile_train", "train_step_top": rows[:25],
                      "device_ms_per_step_total": device_ms,
                      "device_idle_share_vs_event_ms": 1.0 - device_ms / step_ms,
                      "host_top": host,
                      "python_self_top": [
                          {"function": f"{os.path.basename(k[0])}:{k[1]}:{k[2]}",
                           "self_ms_per_step": v[2] / 3 * 1e3, "calls_per_step": v[1] / 3}
                          for k, v in py_rows]})

    # main_qm9, in-process, one epoch at the recipe.
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        main_qm9.main(["--synthetic", "--limit", "320", "--epochs", "1",
                       "--seed", str(args.seed), "--device", "cuda"])
    main_s = time.perf_counter() - t0
    text = out.getvalue()
    maes = re.findall(r"(Train|Val|Test) MAE: (\S+?),? ", text)
    maes += re.findall(r"(Best Validation|Testing) MAE: (\S+)", text)
    if len(maes) != 5 or not all(math.isfinite(float(v)) for _, v in maes):
        raise AssertionError(f"main_qm9 output: {text}")
    emit_kernels({"phase": "main_qm9", "seconds": main_s,
                  "lines": [ln for ln in text.splitlines() if "MAE" in ln]})
    return cases, launches


def _check_names(res: dict, names: list[str]) -> dict:
    if res.get("names") != names:
        raise AssertionError(f"service answered {res}")
    return res


if __name__ == "__main__":
    sys.exit(main())
