#!/usr/bin/env python3
"""The port's CUDA kernels (pamnet_tpu_torch) against their plain versions on
one card.

    python3 chip_smoke.py [--seed 0] [--structures 16] [--atoms 2100] [--profile]

Phases, each printing one JSON line:
  device: the card's name and power limit (nvidia-smi), the kernel build time
     (nvcc, sm_90a, from the sources in the checkout) and each kernel's
     registers, stack, shared and local memory;
  kernels: each CUDA kernel against its plain PyTorch version on random data
     at the RNA batch-16 scoring pads (kernel B on random triplets summed by
     center edge and as (T, D) rows, which are its sums over identity
     groups: the kernel has one form);
  sbf_kernels: kernel B on the scoring batch's own t2/t1 arrays (``--structures``
     synthetic RNA structures of ``--atoms`` atoms, collated as the scoring
     service collates them), summed by center edge and as rows, and with
     every triplet on edge 0 (its rows always cached);
  walk_kernels: kernel A's global and el_dst sums on that batch's own CSRs,
     and the global message summed by node against its plain version, timed
     beside the rows + kernel A sum of the same arrays, and
     ``walk_shape_trials`` (each team shape of the walk timed at those CSRs;
     the training kernel phases carry the same trials at theirs);
  train_kernels: each backward kernel on the CSR arrays of a QM9 training
     batch of 32 at the recipe's pads (D=128), and the unfolded path's gather
     of the radial table (D=42); the fused role swap (d_a and d_b in one walk)
     bitwise equal to the role swap and gather_product of the same arrays and
     timed beside them, and the gated el_dst sum's backward beside the row
     gather and three multiplies it replaces;
  rna_train_kernels: kernel B's backward, summed by center edge and over
     identity groups, against PyTorch's autograd of its plain version at an
     RNA training batch of 8, for (7, 16) and (7, 8); kernel B forward on the
     same arrays and on random ones; then every other wrapper an RNA training
     step launches, on that batch's arrays (D=16);
  pdbbind_kernels: every wrapper a PDBbind training step launches, on the
     arrays of a batch of 32 realistic synthetic complexes (D=128; n ~10.7k,
     eg ~334k, up to 80 rows a global group);
  bf16_kernels: every kernel with a bfloat16 version against its plain
     bfloat16 version, which computes in f32 and rounds once, within one
     bfloat16 ulp (2^-7 |want| + 1e-5 max|want|), on the QM9 and PDBbind
     batches; bounds count 2 bytes a value;
  sbf_bf16_kernels: kernel B forward and backward in bfloat16 on the t2 and
     t1 arrays of the scoring batch, of the RNA batch of 8 and of the scoring
     batch with every triplet on edge 0, each within one bfloat16 ulp of its
     plain bfloat16 version and timed beside the float32 kernel;
  launches: one eager forward and backward of each path of ``LAUNCHES`` at
     its recipe (the scored batch's forward, folded and unfolded; QM9 in
     float32 and bfloat16, with geometry derived on the card and with the
     graph rebuilt there; PAMNet_s; RNA in float32 and bfloat16 and derived;
     PDBbind in float32 and bfloat16), each wrapper's launches held to the
     table, the bfloat16 paths' to their float32 paths' own;
  kernels: one line listing every kernel with its numbers and its launches
     by path (the role swap alone and gather_product launch on no path).
Each case reports the kernel's event-timed, device and host-enqueue ms, its
plain version's ms, one PyTorch call's where one computes the same function
(``library_ms``) and the bound: the larger of its bytes at 3.35 TB/s and its
operations at 67 TFLOP/s.  Every batch comes straight from a loader's
``collate``: nothing here trains or serves.  Whole paths are measured by
``python3 -m benchmark.run`` and checked by ``python -m pytest --noconftest
-m gpu tests/test_torch_cuda.py tests/test_torch_card_paths.py``.
With ``--profile`` the launches phase also prints, for each path, the device
time of three forwards or training steps by kernel, every kernel launch in
total and by name (``kernels_by_name``) and each launch of the port's
kernels with its device time (``port_kernel_launches``).
Then the nvidia-smi line and, last, {"ok": true, "device": {...}}.
Any mismatch raises and the script exits non-zero.  It exits 2 with no
result when CUDA is absent.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

from pamnet_tpu_torch.profiling import device_ms, device_us, is_kernel, kernel_totals, time_ms

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 flop/s outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Pads of a 16-structure RNA-Puzzles batch printed by bench.py (shape facts).
BENCH_PADS = {"n": 34304, "eg": 1675136, "el": 186368, "t2": 935296, "t1": 1121664}
# The training batches' sources: synthetic QM9 molecules and realistic
# PDBbind complexes, whose worst-case batch of 32 sets each loader's pads
# (PDBbind: n ~10.7k, eg ~334k).
QM9_MOLECULES = 512
PDBBIND_COMPLEXES = 64


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_resources(library: str) -> dict[str, dict[str, int]]:
    """Registers, stack (spills and local arrays), shared and local memory of
    every kernel in the built ``library``, as ``cuobjdump -res-usage`` of the
    toolkit whose ``nvcc`` built it reports them; raises without that tool."""
    from pamnet_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-res-usage", library], check=True, capture_output=True,
                         text=True, timeout=120).stdout
    pattern = r"Function (\S+):\s*\n\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)"
    found = re.findall(pattern, out)
    if not found:
        raise AssertionError(f"cuobjdump -res-usage named no kernel: {out[:400]}")
    return {re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "", name)[:64]:
            {"registers": int(reg), "stack": int(stack), "shared": int(shared),
             "local": int(local)}
            for name, reg, stack, shared, local in found}


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


def cold_device_ms(fn, iters: int = 10, flush_bytes: int = 128 << 20,
                   tries: int = 3) -> float | None:
    """Mean device time of the kernels one call of ``fn`` launches with the
    L2 cache flushed before each call (``flush_bytes`` read between calls,
    so the cache holds clean lines that a miss evicts without a write-back):
    what a caller whose operands were evicted since they were written sees.
    Only the kernels of ``fn`` count, named from a profile of ``fn`` alone
    (the profiler can drop every record of a short run, so a profile that
    recorded none is taken again).  None ("not measured") after ``tries``
    such profiles."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    buf = torch.ones(flush_bytes // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        names = {ev.key for ev in prof.key_averages() if is_kernel(ev)}
        if not names:
            continue
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                buf.sum()
                fn()
            torch.cuda.synchronize()
        us = sum(device_us(ev) / ev.count * max(1, round(ev.count / iters))
                 for ev in prof.key_averages() if is_kernel(ev) and ev.key in names)
        if us > 0:
            return us / 1e3
    return None


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


BF16_RULE = "one bf16 ulp: |got - want| <= 2^-7 |want| + 1e-5 max|want|"


def bf16_tolerance(wants) -> tuple[float, float]:
    """(atol, rtol) of one bfloat16 ulp against the plain bfloat16 version
    (which computes in f32 and rounds once): the two f32 results differ by
    their sums' order, so their roundings differ by at most one ulp, 2^-7
    of the value, with 1e-5 of the largest value for sums that cancel."""
    return 1e-5 * max(float(w.double().abs().max()) for w in wants), 2.0 ** -7


def _stream(dtype):
    """(dtype, bytes a value) of a case's rows: float32 unless given."""
    import torch

    dtype = dtype or torch.float32
    return dtype, (2 if dtype == torch.bfloat16 else 4)


def kernel_a_case(name, num_out, rows, d, gather, modulate, gen):
    """Kernel A on random CSR data at one main-path shape, against its plain
    version; ``library_ms`` times index_add_ of the product computed before."""
    import torch

    from pamnet_tpu_torch.ops.triplet import (triplet_aggregate, triplet_aggregate_plain,
                                              walk_shape)

    dev = torch.device("cuda")
    valid = rows - rows // 16  # a padded tail, as in batches
    seg = torch.sort(torch.randint(0, num_out, (valid,), device=dev, generator=gen))[0]
    off = torch.searchsorted(seg, torch.arange(num_out + 1, device=dev)).to(torch.int32)
    a_rows = num_out if gather else rows
    a = torch.randn(a_rows, d, device=dev, generator=gen)
    idx = (torch.randint(0, a_rows, (rows,), device=dev, generator=gen).to(torch.int32)
           if gather else None)
    b = torch.randn(rows, d, device=dev, generator=gen) if modulate else None

    # The valid row count goes with the CSR, as the main path passes it (the
    # walk's team shape follows it).
    fn = lambda: triplet_aggregate(a, off, idx, b, total=valid)  # noqa: E731
    got = fn()
    want = triplet_aggregate_plain(a, off, idx, b)
    torch.cuda.synchronize()
    err = compare(f"triplet_aggregate[{name}]", got, want, atol=1e-4, rtol=1e-5)

    vals = a[idx[:valid].long()] if gather else a[:valid]
    if modulate:
        vals = vals * b[:valid]
    seg_long = seg.long()
    acc = torch.zeros(num_out, d, device=dev)
    # Kernel timed before and after the others, to show its spread.
    ms_first = time_ms(fn)
    plain = time_ms(lambda: triplet_aggregate_plain(a, off, idx, b))
    lib = time_ms(lambda: acc.index_add_(0, seg_long, vals))
    ms = time_ms(fn)
    enq = enqueue_ms(fn)
    dev = device_ms(fn)
    lib_dev = device_ms(lambda: acc.index_add_(0, seg_long, vals))
    a_read = (torch.unique(idx[:valid]).numel() if gather else valid) * d * 4
    nbytes = (a_read + (valid * d * 4 if modulate else 0) + (valid * 4 if gather else 0)
              + (num_out + 1) * 4 + num_out * d * 4)
    flops = valid * d * (2 if modulate else 1)
    bms, by = bound_ms(nbytes, flops)
    return {"case": name, "num_out": num_out, "rows": rows, "d": d,
            "gather": gather, "modulate": modulate,
            "walk_shape": walk_shape(d, num_out, valid), **err, "ms": ms, "ms_first": ms_first,
            "device_ms": dev, "library_device_ms": lib_dev,
            "enqueue_ms": enq,
            "plain_ms": plain, "library_ms": lib, "bound_ms": bms, "bound_by": by}


def random_triplets(num_edges, triplets, ns, gen) -> dict:
    """Triplet arrays of random data at a main-path shape, as a batch lays
    them out: neighbour edges, basis rows, a padded tail (mask 0, index 0)
    and the sorted CSR of random center edges over the valid triplets."""
    import torch

    from pamnet_tpu_torch.ops.triplet import Groups

    dev = torch.device("cuda")
    valid = triplets - triplets // 16
    idx = torch.randint(0, num_edges, (triplets,), device=dev, generator=gen).to(torch.int32)
    idx[valid:] = 0
    seg = torch.sort(torch.randint(0, num_edges, (valid,), device=dev, generator=gen))[0]
    off = torch.searchsorted(seg, torch.arange(num_edges + 1, device=dev)).to(torch.int32)
    return {"idx": idx, "cbf": torch.randn(triplets, ns, device=dev, generator=gen),
            "mask": (torch.arange(triplets, device=dev) < valid).float(), "valid": valid,
            "out_groups": Groups(off, None, valid)}


def batch_triplets(gb, kind: str) -> dict:
    """The triplet arrays of stream ``kind`` ("t2" or "t1") of batch ``gb``."""
    return {"idx": gb.t2_kj if kind == "t2" else gb.t1_jj,
            "cbf": gb.cbf2 if kind == "t2" else gb.cbf1, "mask": getattr(gb, kind + "_mask"),
            "valid": gb.valid[kind], "out_groups": gb.groups(kind + "_ji")}


def kernel_b_case(name, num_edges, ns, d, gen, trip: dict, summed: bool,
                  dtype=None) -> dict:
    """Kernel B on the triplet arrays ``trip`` with random tables and
    weights: summed by center edge (over ``trip["out_groups"]``) or the
    (T, D) rows, which are its sums over identity groups; against its plain
    version (kernel A's plain sum of the plain rows) within atol 1e-4 + rtol
    1e-4, or in bfloat16 (``dtype``: every float operand) within one ulp
    (``bf16_tolerance``), and then the float32 kernel on the same values
    timed beside it (``f32_ms``, ``f32_device_ms``); two calls bitwise
    equal.  No one PyTorch call computes the function."""
    import torch

    from pamnet_tpu_torch.ops.sbf_modulate import (identity_groups, sbf_modulate,
                                                   sbf_modulate_plain)

    dtype, vb = _stream(dtype)
    dev = torch.device("cuda")
    r = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    idx, triplets = trip["idx"], trip["idx"].shape[0]
    args = (r(num_edges, ns * d), r(num_edges, d), trip["cbf"], r(d),
            r(d, d) / d**0.5, r(d), r(d, d) / d**0.5, r(d), idx, trip["mask"])
    args = tuple(a.to(dtype) if a.is_floating_point() else a for a in args)
    out_groups = trip["out_groups"] if summed else identity_groups(triplets, dev)
    fn = lambda: sbf_modulate(*args, out_groups=out_groups)  # noqa: E731
    off = out_groups.off
    got, want = fn(), sbf_modulate_plain(*args, out_off=off)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        err = compare(f"sbf_modulate[{name}]", got, want, atol=1e-4, rtol=1e-4)
    else:
        atol, rtol = bf16_tolerance([want])
        err = {**compare(f"sbf_modulate[{name}]", got, want, atol=atol, rtol=rtol),
               "tolerance_rule": BF16_RULE}
    if not torch.equal(got, fn()):
        raise AssertionError(f"sbf_modulate[{name}] is not bitwise repeatable")
    ms_first = time_ms(fn)
    plain = time_ms(lambda: sbf_modulate_plain(*args, out_off=off))
    ms = time_ms(fn)
    enq = enqueue_ms(fn)
    dev_ms = device_ms(fn)
    # The triplets the kernel reads: the valid ones where summed, every row
    # of the (T, D) output otherwise.
    rows = trip["valid"] if summed else triplets
    edges_read = _unique(idx, rows)

    def nbytes_at(v: int) -> int:
        """Each neighbour edge's rows once, per triplet its index (4 bytes),
        basis row and mask, the weights, the sums (and the CSR where
        summed), at ``v`` bytes a value."""
        out_bytes = ((off.shape[0] * 4 + (off.shape[0] - 1) * d * v) if summed
                     else triplets * d * v)
        return (edges_read * (ns + 1) * d * v + rows * (4 + (ns + 1) * v)
                + (2 * d * d + 3 * d) * v + out_bytes)

    nbytes = nbytes_at(vb)
    # Per triplet: ns*d multiply-adds, two d x d products, 3*d silu (4 ops
    # each), the mask and the modulation, and the sum where summed.
    flops = rows * (2 * ns * d + 4 * d * d + 12 * d + 2 * d + (d if summed else 0))
    bms, by = bound_ms(nbytes, flops)
    res = {"case": name, "summed": summed, "groups": "center edges" if summed else "identity",
           "dtype": str(dtype)[6:], "edges": num_edges, "triplets": triplets,
           "valid": trip["valid"], "ns": ns, "d": d, **err, "bitwise_repeat": True,
           "ms": ms, "ms_first": ms_first, "device_ms": dev_ms, "library_device_ms": None,
           "enqueue_ms": enq, "plain_ms": plain, "library_ms": None, "bound_ms": bms,
           "bound_by": by}
    if dtype != torch.float32:
        a32 = tuple(a.float() if a.is_floating_point() else a for a in args)
        f32_fn = lambda: sbf_modulate(*a32, out_groups=out_groups)  # noqa: E731
        res.update(f32_ms=time_ms(f32_fn), f32_device_ms=device_ms(f32_fn),
                   f32_bound_ms=bound_ms(nbytes_at(4), flops)[0])
    return res


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
    version and the library call, and compute the bound.  ``atol`` None:
    one bfloat16 ulp (``bf16_tolerance``)."""
    import torch

    torch.cuda.synchronize()
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    pairs = [(g, w) for g, w in pairs if g is not None]
    if atol is None:
        atol, rtol = bf16_tolerance([w for _, w in pairs])
        extra["tolerance_rule"] = BF16_RULE
    errs = [compare(name, g, w, atol=atol, rtol=rtol) for g, w in pairs]
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


def fused_role_swap_case(gb, kind: str, d: int, gen, dtype=None) -> dict:
    """Kernel A's role swap with the gathered triplet sum's d_b in one walk
    (``triplet_aggregate_grad_ab``) over the training batch's CSR of t2_kj /
    t1_jj, b zero on the padded rows as the model masks it: d_a bitwise
    the role swap alone's and d_b bitwise ``gather_product``'s on the same
    arrays, against the plain version.  Timed alike beside it: the role
    swap alone (``alone_*``) and the role swap + ``gather_product``
    (``pair_*``), what the backward launched before the fusion.  In
    bfloat16 (``dtype``; those two take float32 only) against the plain
    version within one ulp, the padded rows zero.  No one PyTorch call
    computes it."""
    import torch

    from pamnet_tpu_torch.ops.triplet import (gather_product, triplet_aggregate_grad_a,
                                              triplet_aggregate_grad_ab,
                                              triplet_aggregate_grad_ab_plain)

    dtype, es = _stream(dtype)
    key = "t2_kj" if kind == "t2" else "t1_jj"
    by_idx, idx, seg = gb.groups(key), getattr(gb, key), getattr(gb, kind + "_ji")
    seg_by_idx = gb.perms["t2_ji_by_kj" if kind == "t2" else "t1_ji_by_jj"]
    valid, e, rows = gb.valid[kind], gb.el_src.shape[0], idx.shape[0]
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    g, a, b = r(e, d), r(e, d), r(rows, d) * getattr(gb, kind + "_mask")[:, None]
    g, a, b = g.to(dtype), a.to(dtype), b.to(dtype)
    args = (g, by_idx, seg_by_idx, b, a)
    fn = lambda: triplet_aggregate_grad_ab(*args)  # noqa: E731
    alone = lambda: triplet_aggregate_grad_a(*args[:4])  # noqa: E731
    pair = lambda: (alone(), gather_product(a, idx, g, seg, valid))  # noqa: E731
    got = fn()
    f32 = dtype == torch.float32
    if f32:
        want = pair()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"fused role swap at {kind}: not the bits of the role swap "
                                 f"and gather_product")
    if not torch.equal(got[1][valid:], torch.zeros_like(got[1][valid:])):
        raise AssertionError(f"fused role swap at {kind}: padded d_b rows not zero")
    # The role swap's bytes (the used g rows, b's valid rows, the two keys a
    # row, the offsets, d_a), the non-empty groups' a rows, every d_b row
    # and the tail's perm entries.
    nbytes = (_unique(seg, valid) * d * es + valid * d * es + valid * 8 + (e + 1) * 4
              + e * d * es + _unique(idx, valid) * d * es + rows * d * es + (rows - valid) * 4)
    res = _timed_case(
        f"d_a and d_b by the fused role swap over the {key} CSR", fn,
        lambda: triplet_aggregate_grad_ab_plain(*args), None, got,
        triplet_aggregate_grad_ab_plain(*args), 1e-4 if f32 else None, 1e-5, nbytes,
        3 * valid * d, rows=rows, valid=valid, d=d, dtype=str(dtype)[6:],
        bitwise_vs_pair=f32)
    if f32:
        res.update(alone_ms=time_ms(alone), alone_device_ms=device_ms(alone),
                   pair_ms=time_ms(pair), pair_device_ms=device_ms(pair))
    return res


def gated_backward_case(gb, d: int, gen, dtype=None) -> dict:
    """The backward of the local layer's gated el_dst sum,
    ``gated_sum_backward``, on batch ``gb``'s own el_dst index and valid
    count with random rows: both gradients in one launch against the plain
    version within 1e-4 * max|g_plain| + 1e-6 (bfloat16 ``dtype``: one ulp),
    rows past the valid count zero.  Timed alike beside it in float32
    (``rows_mul_*``): what the backward
    launched before, on the same arrays: the node gradient gathered by
    el_dst (``row_gather`` with the valid count), times the edge mask, then
    times each operand.  ``device_ms`` and ``rows_mul_device_ms`` are read
    with the L2 cache flushed before each call (``cold_device_ms``), as the
    HBM byte bound counts and as a step sees them: at the RNA pads the
    operands (~25 MB) fit the 50 MB L2, so a warm loop reads them from there,
    faster than that bound; the warm readings are ``warm_device_ms`` and
    ``rows_mul_warm_device_ms``.  No one PyTorch call computes it."""
    import torch

    from pamnet_tpu_torch.ops.gather import row_gather
    from pamnet_tpu_torch.ops.triplet import gated_sum_backward, gated_sum_backward_plain

    dtype, es = _stream(dtype)
    seg, valid, mask = gb.el_dst, gb.valid["el"], gb.el_mask
    rows, nodes = seg.shape[0], gb.z.shape[0]
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    a, b, g = r(rows, d).to(dtype), r(rows, d).to(dtype), r(nodes, d).to(dtype)
    fn = lambda: gated_sum_backward(a, b, g, seg, valid)  # noqa: E731

    def rows_mul():
        gm = row_gather(g, seg, valid=valid) * mask[:, None]
        return gm * b, gm * a

    got, want = fn(), gated_sum_backward_plain(a, b, g, seg, valid)
    if any(not torch.equal(t[valid:], torch.zeros_like(t[valid:])) for t in got):
        raise AssertionError("gated_sum_backward: rows past the valid count not zero")
    f32 = dtype == torch.float32
    atol = 1e-4 * max(float(w.abs().max()) for w in want) + 1e-6 if f32 else None
    res = _timed_case(
        "gated el_dst sum backward", fn, lambda: gated_sum_backward_plain(a, b, g, seg, valid),
        None, got, want, atol, 0.0,
        2 * valid * d * es + valid * 4 + _unique(seg, valid) * d * es + 2 * rows * d * es,
        2 * valid * d, rows=rows, valid=valid, nodes=nodes, d=d, dtype=str(dtype)[6:],
        **({"tolerance_rule": "1e-4 * max|g_plain| + 1e-6"} if f32 else {}))
    res.update(warm_device_ms=res["device_ms"], device_ms=cold_device_ms(fn))
    if f32:
        res.update(rows_mul_ms=time_ms(rows_mul), rows_mul_warm_device_ms=device_ms(rows_mul),
                   rows_mul_device_ms=cold_device_ms(rows_mul),
                   rows_mul_max_abs_err=max(float((x - y).abs().max())
                                            for x, y in zip(rows_mul(), got)))
    return res


def edge_backward_case(gb, which: str, d: int, gen, flow: str = "source_to_target",
                       summed: bool = False, dtype=None) -> dict:
    """The edge message's backward (d_pre, d_gate) for the global message
    (gate, mask; ``flow`` picks which endpoint is ``i``, as the global layer
    does) or a local one (m_kj: gate; m_ji: none).  ``summed``: the backward
    of the global message summed by node, the (N, D) gradient read at each
    row's ``i`` and rows past the valid count zero (the global layer's).
    In bfloat16 (``dtype``, the mask too) within one ulp of the plain
    version."""
    import torch

    from pamnet_tpu_torch.ops.gather import edge_message_backward, edge_message_backward_plain

    dtype, es = _stream(dtype)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(dtype)  # noqa: E731
    nodes = gb.z.shape[0]
    if which == "global":
        i, j, mask, valid = gb.eg_dst, gb.eg_src, gb.eg_mask.to(dtype), gb.valid["eg"]
        if flow == "target_to_source":
            i, j = j, i
    else:
        i, j, mask, valid = gb.el_dst, gb.el_src, None, gb.valid["el"]
    gated = which != "local m_ji"
    rows = i.shape[0]
    args = (r(nodes, d), r(nodes, d), i, j, r(rows, d), r(rows, d) if gated else None,
            mask, r(nodes if summed else rows, d))
    kw = dict(at_i=True, valid=valid) if summed else {}
    g_bytes = _unique(i, valid) * d * es if summed else rows * d * es
    nbytes = ((_unique(i, rows) + _unique(j, rows)) * d * es + rows * 8
              + rows * d * es * (1 + gated) + g_bytes + (rows * es if mask is not None else 0)
              + rows * d * es * (1 + gated))
    # Per element: the pre-activation (2 adds), sigmoid (exp, add, divide),
    # silu' (4), silu (1), the mask and the gate products.
    flops = rows * d * (10 + int(mask is not None) + 2 * int(gated))
    f32 = dtype == torch.float32
    return _timed_case(
        f"edge message backward, {which}{', summed' if summed else ''}",
        lambda: edge_message_backward(*args, **kw),
        lambda: edge_message_backward_plain(*args, **kw), None,
        edge_message_backward(*args, **kw), edge_message_backward_plain(*args, **kw),
        1e-6 if f32 else None, 1e-5, nbytes, flops, nodes=nodes, rows=rows, valid=valid, d=d,
        gated=gated, masked=mask is not None, summed=summed, dtype=str(dtype)[6:])


def batch_sum_case(gb, key: str, name: str, d: int, gen) -> dict:
    """Kernel A's sum by the sorted index ``key`` over batch ``gb``'s own CSR
    (its offsets, valid count and group lengths) of random rows, as the
    forward's edge->node sums call it; ``library_ms`` times index_add_."""
    import torch

    from pamnet_tpu_torch.ops.triplet import (triplet_aggregate, triplet_aggregate_plain,
                                              walk_shape)

    groups, ids = gb.groups(key), getattr(gb, key)
    if groups is None or groups.perm is not None:
        raise AssertionError(f"the batch's rows are not sorted by {key}")
    off, valid, num = groups.off, groups.total, groups.off.shape[0] - 1
    x = torch.randn(ids.shape[0], d, device="cuda", generator=gen)
    fn = lambda: triplet_aggregate(x, off, total=valid)  # noqa: E731
    if not torch.equal(fn(), fn()):
        raise AssertionError(f"kernel A's sum by {key} is not bitwise repeatable")
    ids_long, xs, acc = ids[:valid].long(), x[:valid], torch.zeros(num, d, device="cuda")
    nbytes = valid * d * 4 + (num + 1) * 4 + num * d * 4
    return _timed_case(
        name, fn, lambda: triplet_aggregate_plain(x, off),
        lambda: acc.index_add_(0, ids_long, xs), fn(), triplet_aggregate_plain(x, off),
        1e-4 * max(1.0, groups.longest / 512), 1e-5, nbytes, valid * d, num_out=num,
        rows=ids.shape[0], valid=valid, longest_group=groups.longest, d=d,
        walk_shape=walk_shape(d, num, valid), bitwise_repeat=True)


def batch_gathered_sum_case(gb, kind: str, d: int, gen, dtype=None) -> dict:
    """Kernel A as a training step's forward calls it on batch ``gb``'s own
    arrays, random rows: the unfolded triplet sum of ``kind`` ("t2" or
    "t1"; its center edges' CSR, the neighbour edge ``idx`` gathered, ``b``
    the masked modulation) or the gated el_dst sum ("el_dst": the edges'
    CSR by el_dst, ``b`` the rbf gate, no gather); against its plain
    version (bfloat16 ``dtype``: within one ulp); ``library_ms`` times
    index_add_ of the product computed beforehand."""
    import torch

    from pamnet_tpu_torch.ops.triplet import (triplet_aggregate, triplet_aggregate_plain,
                                              walk_shape)

    dtype, es = _stream(dtype)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    if kind == "el_dst":
        groups, ids, idx = gb.groups("el_dst"), gb.el_dst, None
        a = r(ids.shape[0], d)
        b = r(ids.shape[0], d)
        name = "gated el_dst edge->node sum"
    else:
        groups, ids = gb.groups(kind + "_ji"), getattr(gb, kind + "_ji")
        idx = gb.t2_kj if kind == "t2" else gb.t1_jj
        a = r(gb.el_src.shape[0], d)
        b = r(ids.shape[0], d) * getattr(gb, kind + "_mask")[:, None]
        name = f"{kind} gathered and modulated sum (unfolded path)"
    a, b = a.to(dtype), b.to(dtype)
    off, valid, num = groups.off, groups.total, groups.off.shape[0] - 1
    fn = lambda: triplet_aggregate(a, off, idx, b, total=valid)  # noqa: E731
    if not torch.equal(fn(), fn()):
        raise AssertionError(f"kernel A's {name} is not bitwise repeatable")
    vals = (a[idx[:valid].long()] if idx is not None else a[:valid]) * b[:valid]
    ids_long, acc = ids[:valid].long(), torch.zeros(num, d, device="cuda", dtype=dtype)
    a_read = _unique(idx, valid) if idx is not None else valid
    nbytes = (a_read * d * es + valid * d * es + (valid * 4 if idx is not None else 0)
              + (num + 1) * 4 + num * d * es)
    return _timed_case(
        name, fn, lambda: triplet_aggregate_plain(a, off, idx, b),
        lambda: acc.index_add_(0, ids_long, vals), fn(),
        triplet_aggregate_plain(a, off, idx, b), 1e-4 if dtype == torch.float32 else None,
        1e-5, nbytes, 2 * valid * d,
        num_out=num, rows=ids.shape[0], valid=valid, longest_group=groups.longest, d=d,
        walk_shape=walk_shape(d, num, valid, dtype), bitwise_repeat=True, dtype=str(dtype)[6:])


def batch_edge_message_case(gb, which: str, d: int, gen, dtype=None) -> dict:
    """A local edge message (rows, no sum) on batch ``gb``'s own el_dst /
    el_src arrays with random node projections, base and (``m_kj``) gate,
    against its plain version (bfloat16 ``dtype``: within one ulp); no one
    PyTorch call computes it."""
    import torch

    from pamnet_tpu_torch.ops.gather import edge_message, edge_message_plain

    dtype, es = _stream(dtype)
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(dtype)  # noqa: E731
    i, j, nodes = gb.el_dst, gb.el_src, gb.z.shape[0]
    rows, gated = i.shape[0], which == "local m_kj"
    args = (r(nodes, d), r(nodes, d), i, j, r(rows, d), r(rows, d) if gated else None, None)
    nbytes = ((_unique(i, rows) + _unique(j, rows)) * d * es + rows * 8
              + rows * d * es * (3 if gated else 2))
    return _timed_case(
        f"{which}, batch", lambda: edge_message(*args), lambda: edge_message_plain(*args),
        None, edge_message(*args), edge_message_plain(*args),
        1e-6 if dtype == torch.float32 else None, 1e-5, nbytes,
        rows * d * (6 + int(gated)), nodes=nodes, rows=rows, d=d, gated=gated,
        dtype=str(dtype)[6:])


def walk_shape_trial(name: str, fn, d: int, num_out: int, total: int) -> dict:
    """Design trial of the CSR walk's team shape: the device time of one
    call of ``fn`` (a walk route at D=``d`` over ``num_out`` groups of
    ``total`` rows) under each team shape the walk takes at that D (the
    lanes ``walk_shape`` gives, 1 to a block's worth of slots), beside the
    shape ``walk_shape`` picks.  The shapes are timed in two passes, up and
    down, each after a warm-up run of the same shape (clocks and the L2
    settle), and each shape keeps the lower reading.  The wrappers' shape is
    swapped in for the trial and put back after it."""
    from pamnet_tpu_torch.ops import gather, triplet

    real = triplet.walk_shape
    picked = real(d, num_out, total)
    lanes = picked[0]
    slots = [s for s in (1, 2, 4, 8, 16, 32, 64) if lanes * s <= 256]
    shapes: dict[str, list] = {f"{lanes}x{s}": [] for s in slots}
    try:
        for s in slots + slots[::-1]:
            triplet.walk_shape = gather.walk_shape = lambda *a, _s=(lanes, s): _s
            time_ms(fn, iters=10)
            shapes[f"{lanes}x{s}"].append(device_ms(fn))
    finally:
        triplet.walk_shape = gather.walk_shape = real
    return {"case": name, "d": d, "groups": num_out, "rows": total,
            "mean_group": total / max(1, num_out), "picked": f"{picked[0]}x{picked[1]}",
            "device_ms_by_shape": {k: min((x for x in v if x is not None), default=None)
                                   for k, v in shapes.items()},
            "device_ms_passes": shapes}


def walk_trials(gb, d: int, gen, keys: tuple, message_flow: str | None) -> list[dict]:
    """``walk_shape_trial`` for kernel A's sum over each CSR of ``keys`` of
    batch ``gb`` (sorted offsets or a permutation) on random rows, and for
    the global message summed by node in ``message_flow``."""
    import torch

    from pamnet_tpu_torch.ops.gather import edge_message
    from pamnet_tpu_torch.ops.triplet import group_sum, triplet_aggregate

    out = []
    for key in keys:
        groups = gb.groups(key)
        x = torch.randn(getattr(gb, key).shape[0], d, device="cuda", generator=gen)
        fn = ((lambda g=groups, x=x: triplet_aggregate(x, g.off, total=g.total))
              if groups.perm is None else (lambda g=groups, x=x: group_sum(x, g)))
        out.append(walk_shape_trial(f"sum by {key}", fn, d, groups.off.shape[0] - 1,
                                    groups.total))
    if message_flow is not None:
        i_key, j_key = (("eg_dst", "eg_src") if message_flow == "source_to_target"
                        else ("eg_src", "eg_dst"))
        groups, n, rows = gb.groups(i_key), gb.z.shape[0], gb.eg_src.shape[0]
        r = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
        args = (r(n, d), r(n, d), getattr(gb, i_key), getattr(gb, j_key), r(rows, d),
                r(rows, d), gb.eg_mask)
        out.append(walk_shape_trial("global message summed", lambda: edge_message(
            *args, out_groups=groups), d, n, groups.total))
    return out


def message_sum_case(gb, name: str, d: int, gen, flow: str, dtype=None) -> dict:
    """The global message summed by the node it goes to
    (``edge_message(..., out_groups=)``) on batch ``gb``'s own arrays: its
    sorted CSR of ``i`` (``flow`` picks the endpoint, as the global layer
    does), ``j`` and edge mask, with random node projections, base and gate;
    against its plain version (the rows, then kernel A's plain sum) within
    atol 1e-4 + rtol 1e-5 (bfloat16 ``dtype``: one ulp of the plain
    version's f32 sum, rounded once), two calls bitwise equal.  Timed alike
    beside it in float32: ``rows_sum_*``, the same arrays through the rows
    kernel and kernel A's sum (the global layer's forward without the
    fold).  No one PyTorch call computes it."""
    import torch

    from pamnet_tpu_torch.ops.gather import edge_message, edge_message_plain
    from pamnet_tpu_torch.ops.triplet import triplet_aggregate, walk_shape

    dtype, es = _stream(dtype)
    f32 = dtype == torch.float32
    i_key, j_key = (("eg_dst", "eg_src") if flow == "source_to_target"
                    else ("eg_src", "eg_dst"))
    groups = gb.groups(i_key)
    if groups is None or groups.perm is not None:
        raise AssertionError(f"the batch's global edges are not sorted by {i_key}")
    i, j, mask = getattr(gb, i_key), getattr(gb, j_key), gb.eg_mask.to(dtype)
    nodes, rows, valid = gb.z.shape[0], i.shape[0], groups.total
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen).to(dtype)  # noqa: E731
    args = (r(nodes, d), r(nodes, d), i, j, r(rows, d), r(rows, d), mask)
    fn = lambda: edge_message(*args, out_groups=groups)  # noqa: E731
    rows_sum = lambda: triplet_aggregate(edge_message(*args), groups.off, total=valid)  # noqa: E731
    got = fn()
    if not torch.equal(got, fn()):
        raise AssertionError(f"edge_message_sum[{name}] is not bitwise repeatable")
    if f32:
        rows_sum_err = compare(f"rows + sum[{name}]", rows_sum(), got, atol=1e-4, rtol=1e-5)
    # Each input read once: per valid row j, the mask and the base and gate
    # rows; the j rows of xj and the non-empty groups' rows of xi; the
    # offsets; the (N, D) output written once.
    filled = int((groups.off[1:] > groups.off[:-1]).sum())
    nbytes = (valid * (4 + es + 2 * d * es) + (_unique(j, valid) + filled) * d * es
              + (nodes + 1) * 4 + nodes * d * es)
    # Per element of a row: two adds, silu (4), gate and mask, the sum.
    flops = valid * d * 9
    res = _timed_case(name, fn, lambda: edge_message_plain(*args, out_off=groups.off), None,
                      got, edge_message_plain(*args, out_off=groups.off),
                      1e-4 if f32 else None, 1e-5, nbytes,
                      flops, nodes=nodes, rows=rows, valid=valid, longest_group=groups.longest,
                      d=d, walk_shape=walk_shape(d, nodes, valid, dtype), bitwise_repeat=True,
                      dtype=str(dtype)[6:])
    if f32:
        res.update(rows_sum_ms=time_ms(rows_sum), rows_sum_device_ms=device_ms(rows_sum),
                   rows_sum_max_abs_err=rows_sum_err["max_abs_err"])
    return res


def group_sum_case(gb, key: str, d: int, gen, dtype=None) -> dict:
    """A row gather's backward, sum of row gradients by the index ``key``,
    over the batch's CSR of it, by the kernel ``group_sum`` routes it to
    (``route``); ``library_ms`` times index_add_.  Held to atol + 1e-5 |want|
    per element, atol = 1e-4 for groups of up to 512 rows and growing with
    the longest group beyond that: an f32 running sum's rounding grows with
    its length, and the two versions add in different orders (bfloat16
    ``dtype``: one ulp of the plain version's f32 sum, rounded once).  Two
    calls must be bitwise equal."""
    import torch

    from pamnet_tpu_torch.ops.triplet import group_sum, group_sum_plain, group_sum_route

    dtype, es = _stream(dtype)
    groups, ids = gb.groups(key), getattr(gb, key)
    valid, num = groups.total, groups.off.shape[0] - 1
    longest = int((groups.off[1:] - groups.off[:-1]).max())
    if groups.longest != longest:
        raise AssertionError(f"the batch's longest group of {key}: {groups.longest}, "
                             f"its offsets say {longest}")
    x = torch.randn(ids.shape[0], d, device="cuda", generator=gen).to(dtype)
    if not torch.equal(group_sum(x, groups), group_sum(x, groups)):
        raise AssertionError(f"group_sum by {key} is not bitwise repeatable")
    atol = 1e-4 * max(1.0, longest / 512) if dtype == torch.float32 else None
    ids_long, xs = ids[:valid].long(), x[:valid]
    acc = torch.zeros(num, d, device="cuda", dtype=dtype)
    nbytes = (valid * d * es + (valid * 4 if groups.perm is not None else 0)
              + (num + 1) * 4 + num * d * es)
    return _timed_case(
        f"sum by {key} ({'permuted' if groups.perm is not None else 'sorted'} CSR)",
        lambda: group_sum(x, groups), lambda: group_sum_plain(x, groups),
        lambda: acc.index_add_(0, ids_long, xs), group_sum(x, groups),
        group_sum_plain(x, groups), atol, 1e-5, nbytes, valid * d, groups=num,
        longest_group=longest, route=group_sum_route(groups), bitwise_repeat=True,
        rows=ids.shape[0], valid=valid, d=d, dtype=str(dtype)[6:])


def row_gather_batch_case(gb, key: str, d: int, gen, dtype=None) -> dict:
    """The row gather by the batch's index ``key``: the embedding lookup
    (``z``, every row) or the backward of a plain sum by ``key`` (the sum's
    output gradient gathered back to its rows; rows past the batch's valid
    count are written as zeros), of ``dtype`` rows (a copy: exact).
    ``library_ms`` times ``torch.index_select`` of the valid rows."""
    import torch

    from pamnet_tpu_torch.ops.gather import row_gather, row_gather_plain

    dtype, es = _stream(dtype)
    idx = getattr(gb, key)
    rows = idx.shape[0]
    if key == "z":
        table_rows, valid = gb.groups("z").off.shape[0] - 1, None
    else:
        table_rows = getattr(gb, key + "_off").shape[0] - 1
        valid = gb.valid["eg" if key[:2] == "eg" else key[:2]]
    src = torch.randn(table_rows, d, device="cuda", generator=gen).to(dtype)
    used = rows if valid is None else valid
    idx_long = idx[:used].long()
    nbytes = _unique(idx, used) * d * es + used * 4 + rows * d * es
    return _timed_case(
        f"rows by {key}" + ("" if valid is None else " (valid count)"),
        lambda: row_gather(src, idx, valid=valid), lambda: row_gather_plain(src, idx, valid),
        lambda: torch.index_select(src, 0, idx_long), row_gather(src, idx, valid=valid),
        row_gather_plain(src, idx, valid), 0.0, 0.0, nbytes, 0.0, table_rows=table_rows,
        rows=rows, valid=used, d=d, dtype=str(dtype)[6:])


def radial_gather_case(gb, kind: str, dtype=None) -> dict:
    """The unfolded path's gather of the batch's radial table (``sbf_radial``,
    D=42, cast to ``dtype`` first as the model does) by ``t2_kj`` /
    ``t1_jj``, every row as the model gathers it: exact against the plain
    version; ``library_ms`` times ``torch.index_select``."""
    import torch

    from pamnet_tpu_torch.ops.gather import row_gather, row_gather_plain

    dtype, es = _stream(dtype)
    src, idx = gb.sbf_radial.to(dtype), gb.t2_kj if kind == "t2" else gb.t1_jj
    rows, d = idx.shape[0], src.shape[1]
    idx_long = idx.long()
    nbytes = _unique(idx, rows) * d * es + rows * 4 + rows * d * es
    return _timed_case(
        f"radial table at {kind} (unfolded path)", lambda: row_gather(src, idx),
        lambda: row_gather_plain(src, idx), lambda: torch.index_select(src, 0, idx_long),
        row_gather(src, idx), row_gather_plain(src, idx), 0.0, 0.0, nbytes, 0.0,
        table_rows=src.shape[0], rows=rows, d=d, dtype=str(dtype)[6:])


def sbf_backward_bytes(ns: int, d: int, edges: int, valid: int, edges_read: int,
                       g_rows_read: int, value_bytes: int = 4) -> tuple[int, int]:
    """Bytes kernel B's backward must move at ``value_bytes`` a float value:
    each input read once (the ``edges_read`` edges' rows once however many
    triplets share them, the ``g_rows_read`` rows of G once however many
    triplets read them), each output written once; and the same with the
    edge rows read per triplet, what a cold cache with no reuse would move.
    Per triplet it reads its place in the neighbour edge's CSR and its
    center edge (4 bytes each), its basis row and mask."""
    vb = value_bytes
    per_triplet = 8 + (ns + 1) * vb
    fixed = ((2 * d * d + 3 * d) * vb * 2 + (edges + 1) * 4 + edges * (ns + 1) * d * vb
             + g_rows_read * d * vb)
    return (edges_read * (ns + 1) * d * vb + valid * per_triplet + fixed,
            valid * ((ns + 1) * d * vb + per_triplet) + fixed)


def sbf_backward_case(gb, kind: str, d: int, gen, summed: bool = True, dtype=None,
                      trip: dict | None = None, calls: int | None = None) -> dict:
    """Kernel B's backward on the ``kind`` ("t2" or "t1") arrays of the RNA
    batch ``gb`` (index and its CSR, mask, cbf and, ``summed``, the center
    edges' CSR and ids, else identity groups; random tables, weights and
    output gradient; ``trip`` replaces the index and its CSR), each of its
    seven outputs against PyTorch's autograd of the plain version within
    1e-4 * max|g_plain| + 1e-6, or in bfloat16 (``dtype``: every float
    operand and the output gradient) within one ulp (``bf16_tolerance``),
    and then the float32 kernel on the same values timed beside it; two
    calls bitwise equal; each time a mean over the timing helpers' default
    calls, or over ``calls`` where given (a slow case).
    ``plain_ms`` times that autograd backward alone; no one PyTorch call
    computes the function."""
    import torch

    from pamnet_tpu_torch.ops.sbf_modulate import (identity_groups, sbf_modulate_backward,
                                                   sbf_modulate_plain)

    dtype, vb = _stream(dtype)
    ns = 7
    key, cbf = ("t2_kj", gb.cbf2) if kind == "t2" else ("t1_jj", gb.cbf1)
    idx, groups, mask = getattr(gb, key), gb.groups(key), getattr(gb, kind + "_mask")
    if trip is not None:
        idx, groups = trip["idx"], trip["groups"]
    edges, rows, valid = gb.el_src.shape[0], idx.shape[0], gb.valid[kind]
    if summed:
        out_groups, out_ids = gb.groups(kind + "_ji"), getattr(gb, kind + "_ji")
    else:
        out_groups = identity_groups(rows, idx.device)
        out_ids = out_groups.off[:-1]
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
    args = [r(edges, ns * d), r(edges, d), cbf, r(d), r(d, d) / d**0.5, r(d),
            r(d, d) / d**0.5, r(d), idx, mask]
    g_rows = out_groups.off.shape[0] - 1
    cot = r(g_rows, d).to(dtype)
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    grad_at = (0, 1, 3, 4, 5, 6, 7)  # proj, m_neighbor, bias, w1, b1, w2, b2
    leaves = [a.clone().requires_grad_() if i in grad_at else a for i, a in enumerate(args)]
    out = sbf_modulate_plain(*leaves, out_off=out_groups.off)
    wanted = [leaves[i] for i in grad_at]
    plain_fn = lambda: torch.autograd.grad(out, wanted, cot, retain_graph=True)  # noqa: E731
    fn = lambda: sbf_modulate_backward(*args, groups, cot, out_groups, out_ids)  # noqa: E731
    got, want = fn(), plain_fn()
    torch.cuda.synchronize()
    what = f"sbf_modulate_backward[{kind}, d={d}{', summed' if summed else ''}, {dtype}]"
    names = ("d_proj", "d_m_neighbor", "d_bias", "d_w1", "d_b1", "d_w2", "d_b2")
    errs = {}
    for name, g, w in zip(names, got, want):
        if not bool(torch.isfinite(g).all()) or g.dtype != dtype:
            raise AssertionError(f"{what} {name}: non-finite or {g.dtype}")
        diff = (g.double() - w.double()).abs()
        if dtype == torch.float32:
            allowed = 1e-4 * float(w.abs().max()) + 1e-6
        else:  # one ulp of each value
            atol, rtol = bf16_tolerance([w])
            allowed = atol + rtol * w.double().abs()
        errs[name] = {"max_abs_err": float(diff.max()),
                      "err_over_tolerance": float((diff / allowed).max())}
        if errs[name]["err_over_tolerance"] > 1.0:
            raise AssertionError(f"{what} {name}: {errs[name]}")
    again = fn()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what} is not bitwise repeatable")
    reps = {} if calls is None else {"iters": calls}
    ms_first = time_ms(fn, **reps, warmup=1 if calls else 3)
    plain = time_ms(plain_fn, **reps)
    ms = time_ms(fn, **reps, warmup=1 if calls else 3)
    enq = enqueue_ms(fn, **reps)
    dev = device_ms(fn, **reps)
    edges_read = _unique(idx, valid)
    g_read = _unique(out_ids, valid) if summed else valid
    nbytes, gathered = sbf_backward_bytes(ns, d, edges, valid, edges_read, g_read, vb)
    # Per triplet: the slice multiply-adds and their transpose, two products
    # recomputed and two transposed, two outer products, silu and silu' on
    # three vectors (about 10 operations each).
    flops = valid * (4 * ns * d + 8 * d * d + 4 * d * d + 30 * d)
    bms, by = bound_ms(nbytes, flops)
    worst = max(errs.values(), key=lambda e: e["err_over_tolerance"])
    res = {"case": f"{kind} backward{' summed' if summed else ''}, d={d}", "summed": summed,
           "groups": "center edges" if summed else "identity", "dtype": str(dtype)[6:],
           "edges": edges, "rows": rows, "valid": valid,
           "ns": ns, "d": d, "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "worst_err_over_tolerance": worst["err_over_tolerance"], "errors": errs,
           "tolerance": ("1e-4 * max|g_plain| + 1e-6 per output" if dtype == torch.float32
                         else BF16_RULE + " per output"), "bitwise_repeat": True,
           "ms": ms, "ms_first": ms_first, "enqueue_ms": enq, "device_ms": dev,
           "library_device_ms": None, "plain_ms": plain, "library_ms": None,
           "bound_ms": bms, "bound_by": by,
           "bound_ms_rows_gathered_per_triplet": gathered / HBM_BYTES_PER_S * 1e3}
    if dtype != torch.float32:
        a32 = [a.float() if a.is_floating_point() else a for a in args]
        f32_fn = lambda: sbf_modulate_backward(*a32, groups, cot.float(), out_groups,  # noqa: E731
                                               out_ids)
        nbytes32, _ = sbf_backward_bytes(ns, d, edges, valid, edges_read, g_read, 4)
        res.update(f32_ms=time_ms(f32_fn, **reps, warmup=1 if calls else 3),
                   f32_device_ms=device_ms(f32_fn, **reps),
                   f32_bound_ms=bound_ms(nbytes32, flops)[0])
    return res


def _cached_triplets(gb, kind: str) -> dict:
    """Stream ``kind`` of ``gb`` with every triplet on neighbour edge 0 (its
    rows always cached) and that index's CSR: edge 0 holds the valid
    triplets in order, the other edges none."""
    import torch

    from pamnet_tpu_torch.ops.triplet import Groups

    trip = batch_triplets(gb, kind)
    idx, valid = torch.zeros_like(trip["idx"]), trip["valid"]
    off = torch.full((gb.el_src.shape[0] + 1,), valid, dtype=torch.int32, device=idx.device)
    off[0] = 0
    perm = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    return {**trip, "idx": idx, "groups": Groups(off, perm, valid)}


def qm9_kernel_cases(gb, d: int, gen) -> dict:
    """train_kernels: each backward kernel a QM9 step launches (and the
    one-gradient routes beside the fused role swap), the summed global
    message, the group sums and the radial table's gathers, on the QM9
    batch ``gb``'s own arrays.  Returns the cases by kernel."""
    return {
        "triplet_aggregate_grad_a": [grad_a_case(gb, "t2", d, gen),
                                     grad_a_case(gb, "t1", d, gen)],
        "triplet_aggregate_grad_ab": [fused_role_swap_case(gb, "t2", d, gen),
                                      fused_role_swap_case(gb, "t1", d, gen)],
        "gather_product": [gather_product_case(gb, "t2", d, gen),
                           gather_product_case(gb, "t1", d, gen)],
        "gated_sum_backward": [gated_backward_case(gb, d, gen)],
        "edge_message_backward": [edge_backward_case(gb, w, d, gen)
                                  for w in ("global", "local m_kj", "local m_ji")]
        + [edge_backward_case(gb, "global", d, gen, summed=True)],
        "edge_message_sum": [message_sum_case(gb, "global message summed, batch", d, gen,
                                              "source_to_target")],
        "group_sum": [group_sum_case(gb, k, d, gen)
                      for k in ("el_src", "eg_src", "el_dst", "eg_dst")],
        "group_sum_split": [group_sum_case(gb, "z", d, gen)],
        "row_gather": [radial_gather_case(gb, k) for k in ("t2", "t1")],
    }


def rna_kernel_cases(gb, pads, d: int, gen) -> dict:
    """rna_train_kernels: kernel B's backward, then each other wrapper an RNA
    step launches at the shapes the RNA batch ``gb`` (at ``pads``) gives it:
    the forward kernels on random data at the pads, the backward ones on the
    batch's own index arrays.  Returns the cases by kernel."""
    flow, i_key = "target_to_source", "eg_src"  # the RNA model sums its messages at eg_src
    rand = {k: random_triplets(pads.el, rows, 7, gen) for k, rows in (("t2", pads.t2),
                                                                        ("t1", pads.t1))}
    return {
        "sbf_modulate_backward": [sbf_backward_case(gb, k, dd, gen, summed)
                                  for summed in (True, False) for dd in (16, 8)
                                  for k in ("t2", "t1")],
        "sbf_modulate": [
            kernel_b_case(f"{k} fused folded gather, "
                          f"{'summed' if summed else 'rows (identity groups)'}, batch",
                          pads.el, 7, d, gen, batch_triplets(gb, k), summed)
            for summed in (True, False) for k in ("t2", "t1")] + [
            kernel_b_case(f"{k} fused folded gather"
                          f"{', summed' if summed else ', rows (identity groups)'}", pads.el,
                          7, d, gen, rand[k], summed)
            for summed in (False, True) for k in ("t2", "t1")],
        "triplet_aggregate": [
            kernel_a_case(name, num_out, rows, d, False, False, gen)
            for name, num_out, rows in (
                ("t2 sum (folded path)", pads.el, pads.t2),
                ("t1 sum (folded path)", pads.el, pads.t1),
                ("el_dst edge->node sum", pads.n, pads.el),
                ("global edge->node sum", pads.n, pads.eg))],
        "edge_message": [
            edge_message_case("global message (gate, mask)", pads.n, pads.eg, d, True, True, gen),
            edge_message_case("local m_kj (gate)", pads.n, pads.el, d, True, False, gen),
            edge_message_case("local m_ji", pads.n, pads.el, d, False, False, gen)],
        "row_gather": [row_gather_batch_case(gb, k, d, gen)
                       for k in ("z", "t2_ji", "t1_ji", "el_dst", i_key)],
        "edge_message_backward": [edge_backward_case(gb, w, d, gen, flow)
                                  for w in ("global", "local m_kj", "local m_ji")]
        + [edge_backward_case(gb, "global", d, gen, flow, summed=True)],
        "edge_message_sum": [message_sum_case(gb, "global message summed, batch", d, gen,
                                              flow)],
        "gated_sum_backward": [gated_backward_case(gb, d, gen)],
        "group_sum": [group_sum_case(gb, k, d, gen)
                      for k in ("el_src", "eg_dst", "el_dst", "eg_src")],
        "group_sum_split": [group_sum_case(gb, "z", d, gen)],
    }


def pdbbind_kernel_cases(gb, d: int, gen) -> dict:
    """pdbbind_kernels: every wrapper a PDBbind step launches, on the PDBbind
    batch ``gb``'s own arrays.  Returns the cases by kernel."""
    return {
        "triplet_aggregate": [batch_gathered_sum_case(gb, k, d, gen)
                              for k in ("t2", "t1", "el_dst")],
        "edge_message": [batch_edge_message_case(gb, w, d, gen)
                         for w in ("local m_kj", "local m_ji")],
        "edge_message_sum": [message_sum_case(gb, "global message summed, PDBbind batch", d,
                                              gen, "source_to_target")],
        "row_gather": [radial_gather_case(gb, k) for k in ("t2", "t1")],
        "triplet_aggregate_grad_ab": [fused_role_swap_case(gb, k, d, gen) for k in ("t2", "t1")],
        "gated_sum_backward": [gated_backward_case(gb, d, gen)],
        "edge_message_backward": [edge_backward_case(gb, "global", d, gen, summed=True)]
        + [edge_backward_case(gb, w, d, gen) for w in ("local m_kj", "local m_ji")],
        "group_sum": [group_sum_case(gb, k, d, gen)
                      for k in ("eg_src", "eg_dst", "el_src", "el_dst")],
    }


def bf16_kernel_cases(qgb, pgb, d: int, gen) -> dict:
    """bf16_kernels: every kernel with a bfloat16 version against its plain
    bfloat16 version within one ulp (``bf16_tolerance``), on the QM9 batch
    ``qgb`` and then on the PDBbind batch ``pgb`` (D=``d``; the radial table
    at D=42).  Returns the cases by kernel."""
    import torch

    bf16 = torch.bfloat16

    def on_both(make):
        """``make(batch)``'s cases on the QM9 batch, then on the PDBbind one."""
        return [dict(case, batch=name) for name, batch in (("QM9", qgb), ("PDBbind", pgb))
                for case in make(batch)]

    return {
        "triplet_aggregate": on_both(lambda b: [batch_gathered_sum_case(b, k, d, gen, bf16)
                                                for k in ("t2", "t1", "el_dst")]),
        "triplet_aggregate_grad_ab": on_both(lambda b: [fused_role_swap_case(b, k, d, gen, bf16)
                                                        for k in ("t2", "t1")]),
        "gated_sum_backward": on_both(lambda b: [gated_backward_case(b, d, gen, bf16)]),
        "edge_message": on_both(lambda b: [batch_edge_message_case(b, w, d, gen, bf16)
                                           for w in ("local m_kj", "local m_ji")]),
        "edge_message_sum": on_both(lambda b: [message_sum_case(
            b, "global message summed", d, gen, "source_to_target", bf16)]),
        "edge_message_backward": on_both(
            lambda b: [edge_backward_case(b, "global", d, gen, summed=True, dtype=bf16)]
            + [edge_backward_case(b, w, d, gen, dtype=bf16) for w in ("local m_kj",
                                                                        "local m_ji")]),
        "group_sum": on_both(lambda b: [group_sum_case(b, k, d, gen, bf16)
                                        for k in ("el_src", "eg_src", "el_dst", "eg_dst")]),
        "row_gather": on_both(lambda b: [radial_gather_case(b, k, bf16) for k in ("t2", "t1")]
                              + [row_gather_batch_case(b, "el_dst", d, gen, bf16)]),
    }


def sbf_bf16_cases(gen, scoring_gb, rna_gb) -> dict:
    """sbf_bf16_kernels: kernel B forward and backward in bfloat16 on the t2
    and t1 arrays of the scoring batch (``scoring_gb``, with the backward's
    permutations), of the RNA batch of 8 (``rna_gb``) and of the scoring
    batch with every triplet on edge 0 (``_cached_triplets``), summed by
    center edge.  The backward walks each neighbour edge's triplets with one
    group of lanes, so with every triplet on edge 0 it is one serial walk of
    ~0.4 s, timed over 2 calls.  Returns the cases by kernel."""
    import torch

    bf16, d = torch.bfloat16, 16
    batches = (("scoring", scoring_gb, False), ("RNA training batch of 8", rna_gb, False),
               ("scoring, every triplet on edge 0", scoring_gb, True))
    cases = {"sbf_modulate": [], "sbf_modulate_backward": []}
    for name, b, cached in batches:
        for kind in ("t2", "t1"):
            trip = _cached_triplets(b, kind) if cached else batch_triplets(b, kind)
            cases["sbf_modulate"].append(dict(kernel_b_case(
                f"{kind} fused folded gather, summed, {name}", b.el_src.shape[0], 7, d, gen,
                trip, True, bf16), batch=name))
            cases["sbf_modulate_backward"].append(dict(sbf_backward_case(
                b, kind, d, gen, True, bf16, trip if cached else None, 2 if cached else None),
                batch=name))
    return cases


# Launches of one eager forward and backward on each path that ``launch_phase``
# checks, read from the ops' counters (``<wrapper>.launches``): an exact count,
# or None for at least one; a wrapper that a path does not name is not checked
# on it.  Kernel B sums the t2/t1 streams by center edge itself and the global
# message sums itself by node (``edge_message`` counts that launch too), so
# kernel A's forward launches are the unfolded triplet sums and the el_dst sum.
# In the backward a gathered triplet sum's d_a and d_b are one fused role swap
# (the role swap alone and gather_product are the routes for one gradient,
# which no path wants) and the el_dst sum's two gradients one gated backward:
# no row gather.  QM9: full PAMNet at the recipe, 6 layers, unfolded (D=128).
QM9 = ({"triplet_aggregate": 18, "edge_message_sum": 6, "edge_message": None,
        "row_gather": None},
       {"triplet_aggregate_grad_ab": 12, "gated_sum_backward": 6, "row_gather": 0,
        "gather_product": 0, "triplet_aggregate_grad_a": 0, "group_sum": None,
        "group_sum_split": None, "edge_message_backward": None})
# PAMNet_s has no two-hop stream: kernel A's t1 sum and the el_dst sum a layer,
# one fused role swap a layer, the radial table gathered at t1 beside the
# embedding, and the embedding's backward by the split kernel.
PAMNET_S = ({"triplet_aggregate": 12, "edge_message_sum": 6, "edge_message": 18,
             "row_gather": 2, "sbf_modulate": 0},
            {"triplet_aggregate_grad_ab": 6, "gated_sum_backward": 6, "row_gather": 0,
             "group_sum_split": 1, "gather_product": 0, "triplet_aggregate_grad_a": 0,
             "group_sum": None, "edge_message_backward": None})
# RNA at the published recipe (1 layer, folded): kernel B 2 + 2, kernel A once
# (the el_dst sum) and its gated backward once.
RNA = ({"sbf_modulate": 2, "triplet_aggregate": 1, "edge_message_sum": 1, "edge_message": None,
        "row_gather": None},
       {"sbf_modulate_backward": 2, "gated_sum_backward": 1, "row_gather": 0, "group_sum": None,
        "group_sum_split": None, "edge_message_backward": None})
# PDBbind at the README recipe (3 layers, unfolded at D=128): the two local
# messages and the summed global one a layer, the radial table gathered at t2
# and t1 once; no embedding gather (the features go through init_linear), no
# kernel B, and no split group sum (no CSR of z; the global CSR's longest
# group is short).
PDBBIND = ({"triplet_aggregate": 9, "edge_message_sum": 3, "edge_message": 9, "row_gather": 2,
            "sbf_modulate": 0},
           {"triplet_aggregate_grad_ab": 6, "gated_sum_backward": 3, "row_gather": 0,
            "group_sum_split": 0, "gather_product": 0, "triplet_aggregate_grad_a": 0,
            "sbf_modulate_backward": 0, "group_sum": None, "edge_message_backward": None})
LAUNCHES = {
    # The scoring model's forward (RNA, 1 layer; no backward), folded, and
    # unfolded, where kernel A also takes the two triplet sums.
    "score": ({"sbf_modulate": 2, "triplet_aggregate": 1, "edge_message_sum": 1,
               "edge_message": 3, "row_gather": None}, {}),
    "score_unfolded": ({"sbf_modulate": 0, "triplet_aggregate": 3}, {}),
    "qm9": QM9, "qm9_bf16": QM9, "qm9_derive": QM9, "qm9_device_graph": QM9,
    "pamnet_s": PAMNET_S,
    "rna": RNA, "rna_bf16": RNA, "rna_derive": RNA,
    "pdbbind": PDBBIND, "pdbbind_bf16": PDBBIND,
}


def wrappers() -> dict:
    """The ops' wrappers that count their kernel launches, by name."""
    from pamnet_tpu_torch.ops import gather, triplet
    from pamnet_tpu_torch.ops import sbf_modulate as sbf

    names = {gather: ("edge_message", "edge_message_sum", "row_gather",
                      "edge_message_backward"),
             sbf: ("sbf_modulate", "sbf_modulate_backward"),
             triplet: ("triplet_aggregate", "triplet_aggregate_grad_a",
                       "triplet_aggregate_grad_ab", "gather_product", "gated_sum_backward",
                       "group_sum", "group_sum_split")}
    return {name: getattr(module, name) for module, group in names.items() for name in group}


def launches_during(fn) -> dict[str, int]:
    """Each counted wrapper's launches during ``fn()``."""
    counted = wrappers()
    before = {name: w.launches for name, w in counted.items()}
    fn()
    return {name: w.launches - before[name] for name, w in counted.items()}


def _held(counts: dict, want: dict) -> bool:
    """Each count that ``want`` names is exact, or at least one where it
    names None; and not every group sum went by the split kernel."""
    return (all(counts[k] >= 1 if v is None else counts[k] == v for k, v in want.items())
            and ("group_sum" not in want or counts["group_sum"] > counts["group_sum_split"]))


def _step_launches(model, gb, kind: str | None) -> tuple[dict, dict]:
    """The wrappers' launches in one eager forward of ``model`` on ``gb`` and,
    with a loss ``kind``, in its backward (none where ``kind`` is None)."""
    import torch

    from pamnet_tpu_torch.train.loop import batch_loss

    if kind is None:
        with torch.inference_mode():
            fwd = launches_during(lambda: model(gb))
        return fwd, dict.fromkeys(fwd, 0)
    model.zero_grad()
    out = {}
    fwd = launches_during(lambda: out.update(loss=batch_loss(model, gb, kind)))
    bwd = launches_during(out["loss"].backward)
    torch.cuda.synchronize()
    return fwd, bwd


def _profile_path(name: str, model, gb, kind: str | None) -> dict:
    """``--profile``: three forwards (``kind`` None) or three training steps
    of the path by the profiler: the device ms per call, every kernel launch
    in total and by name, and the port's own launches in order."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pamnet_tpu_torch.train.loop import Optimizer, train_step
    from pamnet_tpu_torch.train.schedules import constant

    if kind is None:
        def call():
            with torch.inference_mode():
                model(gb)
    else:
        opt = Optimizer(model.parameters(), constant(1e-4))

        def call():
            train_step(model, opt, None, gb, kind)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    totals = kernel_totals(prof.key_averages(), 3)
    return {"phase": "profile", "path": name, "per": "forward" if kind is None else "step",
            "device_ms": totals["device_ms"], "kernel_launches": totals["kernel_launches"],
            "kernels_by_name": totals["by_name"],
            "port_kernel_launches": port_kernel_launches(prof, 3)}


def port_kernel_launches(prof, calls: int) -> list[dict]:
    """Each launch of the port's own kernels (they live in an anonymous
    namespace) during the first of ``calls`` profiled calls, in order, with
    its device time: tells launches of one kernel apart, which the rows
    summed by name do not."""
    evs = sorted((ev for ev in prof.events()
                  if str(getattr(ev, "device_type", "")).endswith("CUDA")
                  and "anonymous namespace" in ev.name),
                 key=lambda ev: ev.time_range.start)
    evs = evs[:len(evs) // calls]
    return [{"name": re.sub(r"^void |\(anonymous namespace\)::", "", ev.name)[:60],
             "device_us": ev.time_range.end - ev.time_range.start} for ev in evs]


def launch_phase(paths: dict, profile: bool) -> dict:
    """One eager forward and backward of each path (``paths``: name ->
    (model, batch, loss or None)) held to ``LAUNCHES``, and the bfloat16
    paths' launches equal to their float32 paths'.  Returns each path's
    launches, forward and backward added."""
    counts = {}
    for name, (model, gb, kind) in paths.items():
        fwd, bwd = _step_launches(model, gb, kind)
        want_fwd, want_bwd = LAUNCHES[name]
        if not (_held(fwd, want_fwd) and _held(bwd, want_bwd)):
            raise AssertionError(f"{name} launches: forward {fwd}, backward {bwd}")
        counts[name] = (fwd, bwd)
        if profile:
            emit(_profile_path(name, model, gb, kind))
    for name in ("qm9", "rna", "pdbbind"):
        if counts[name + "_bf16"] != counts[name]:
            raise AssertionError(f"{name} launches: bfloat16 {counts[name + '_bf16']}, "
                                 f"float32 {counts[name]}")
    emit({"phase": "launches", "paths": {
        name: {"forward": fwd, "backward": bwd} for name, (fwd, bwd) in counts.items()}})
    return {name: {k: fwd[k] + bwd[k] for k in fwd} for name, (fwd, bwd) in counts.items()}


def recipe_paths(seed: int, service, score_gb, qm9: dict, rna: dict, pdbbind_gb) -> dict:
    """Each path of ``LAUNCHES`` as (model, batch, loss or None), the models
    at their recipes with seeded weights: the scoring service's model and
    that model unfolded on the scoring batch ``score_gb``; QM9 on the batches
    of ``qm9`` (by geometry: "host", "derive", and "s" for PAMNet_s), RNA on
    those of ``rna`` ("host", "derive") and PDBbind on ``pdbbind_gb``."""
    import dataclasses

    import torch

    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.models.pamnet import PAMNet

    def model(**kw):
        return PAMNet(PAMNetConfig(**kw), torch.Generator().manual_seed(seed)).to("cuda")

    unfolded = PAMNet(dataclasses.replace(service.cfg, fold_sbf=False))
    unfolded.load_state_dict(service.model.state_dict(), strict=True)
    q = dict(dataset="QM9", dim=128, n_layer=6, cutoff_l=5.0, cutoff_g=5.0)
    r = dict(dataset="RNA-Puzzles", dim=16, n_layer=1, cutoff_l=2.6, cutoff_g=20.0,
             flow="target_to_source")
    p = dict(dataset="PDBbind", dim=128, n_layer=3, cutoff_l=2.0, cutoff_g=6.0)
    return {
        "score": (service.model, score_gb, None),
        "score_unfolded": (unfolded.to("cuda").eval(), score_gb, None),
        "qm9": (model(**q), qm9["host"], "l1"),
        "qm9_bf16": (model(**q, compute_dtype="bfloat16"), qm9["host"], "l1"),
        "qm9_derive": (model(**q), qm9["derive"], "l1"),
        "qm9_device_graph": (model(**q, device_graph=True), qm9["derive"], "l1"),
        "pamnet_s": (model(**q, variant="s"), qm9["s"], "l1"),
        "rna": (model(**r), rna["host"], "smooth_l1"),
        "rna_bf16": (model(**r, compute_dtype="bfloat16"), rna["host"], "smooth_l1"),
        "rna_derive": (model(**r), rna["derive"], "smooth_l1"),
        "pdbbind": (model(**p), pdbbind_gb, "mse"),
        "pdbbind_bf16": (model(**p, compute_dtype="bfloat16"), pdbbind_gb, "mse"),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--structures", type=int, default=16,
                        help="synthetic RNA structures of the scoring batch")
    parser.add_argument("--atoms", type=int, default=2100,
                        help="atoms of each synthetic RNA structure")
    parser.add_argument("--profile", action="store_true",
                        help="also print each path's device time by kernel")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule,
                                                 synthetic_pdbbind_complex_dataset,
                                                 synthetic_qm9_dataset, synthetic_rna_dataset)
    from pamnet_tpu_torch.ops import _build
    from pamnet_tpu_torch.serve import RNAScoringService
    from pamnet_tpu_torch.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- device and build ----
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    lib_path = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "build_s": build_s, "library": os.path.relpath(lib_path),
          "kernel_resources": kernel_resources(str(lib_path))})

    # ---- kernels against their plain versions on random data at the scoring pads ----
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
    # Kernel B on random triplets at the t2 pads: the (T, D) rows (its sums
    # over identity groups) and their sum by center edge (kernel B and
    # kernel A's t2 sum in one launch).
    rand_t2 = random_triplets(p["el"], p["t2"], 7, gen)
    b_cases = [kernel_b_case("t2 fused folded gather, rows (identity groups)", p["el"], 7, 16,
                             gen, rand_t2, False),
               kernel_b_case("t2 fused folded gather, summed", p["el"], 7, 16, gen, rand_t2,
                             True)]
    e_cases = [
        edge_message_case("global message (gate, mask)", p["n"], p["eg"], 16, True, True, gen),
        edge_message_case("local m_kj (gate)", p["n"], p["el"], 16, True, False, gen),
        edge_message_case("local m_ji", p["n"], p["el"], 16, False, False, gen),
    ]
    g_cases = [
        row_gather_case("atom-type embedding", 3, p["n"], 16, gen),
        row_gather_case("radial table at t2 (unfolded path)", p["el"], p["t2"], 42, gen),
    ]
    emit({"phase": "kernels", "triplet_aggregate": a_cases, "sbf_modulate": b_cases,
          "edge_message": e_cases, "row_gather": g_cases})

    # ---- the scoring batch, collated as the service collates it ----
    t0 = time.perf_counter()
    mols = synthetic_rna_dataset(args.structures, seed=args.seed, n_atoms=args.atoms)
    gen_s = time.perf_counter() - t0
    cfg = PAMNetConfig(dataset="rna_serve", dim=16, n_layer=1, cutoff_l=2.6,
                       cutoff_g=20.0, flow="target_to_source")
    service = RNAScoringService(init_params(cfg, torch.Generator().manual_seed(args.seed)), cfg,
                                batch_size=16, device="cuda")
    loader = GraphLoader(mols, "rna", cfg.cutoff_l, cfg.cutoff_g, batch_size=16,
                         ladder_pads=True)
    gb = next(iter(loader)).to("cuda")
    pads = {"n": gb.z.shape[0], "eg": gb.eg_src.shape[0], "el": gb.el_src.shape[0],
            "t2": gb.t2_ji.shape[0], "t1": gb.t1_ji.shape[0]}
    ng = gb.num_graphs
    # The service's own call launches what one forward of its model does.
    served = launches_during(lambda: service.score_molecules(mols))
    forward = _step_launches(service.model, gb, None)[0]
    if served != forward:
        raise AssertionError(f"the service launched {served}, its model's forward {forward}")

    # Kernel B on the scoring batch's own triplet arrays, both modes; then
    # with every triplet on edge 0 (its rows always cached), which shows
    # how much of the time the row gather takes.
    sbf_batch = [kernel_b_case(f"{k} fused folded gather, "
                               f"{'summed' if summed else 'rows (identity groups)'}, batch",
                               pads["el"], 7, cfg.dim, gen, batch_triplets(gb, k), summed)
                 for summed in (True, False) for k in ("t2", "t1")]
    cached = {**batch_triplets(gb, "t2"), "idx": torch.zeros_like(gb.t2_kj)}
    sbf_cached = kernel_b_case("t2 fused folded gather, summed, batch, every triplet on edge 0",
                               pads["el"], 7, cfg.dim, gen, cached, True)
    emit({"phase": "sbf_kernels", "batch": f"scoring, {ng} structures of {args.atoms} atoms",
          "structure_gen_s": gen_s, "pads": pads, "bench_pads": BENCH_PADS,
          "sbf_modulate": sbf_batch, "sbf_modulate_rows_cached": sbf_cached})

    # The CSR walk on the scoring batch's own CSRs: kernel A's global and
    # el_dst sums, and the global message summed by node against the rows +
    # kernel A's sum of the same arrays.
    walk_batch = [batch_sum_case(gb, "eg_src", "eg_src global sum, scoring batch", cfg.dim, gen),
                  batch_sum_case(gb, "el_dst", "el_dst edge->node sum, scoring batch", cfg.dim,
                                 gen)]
    msg_batch = [message_sum_case(gb, "global message summed, scoring batch", cfg.dim, gen,
                                  cfg.flow)]
    emit({"phase": "walk_kernels", "batch": f"scoring, {ng} structures", "pads": pads,
          "triplet_aggregate": walk_batch, "edge_message_sum": msg_batch,
          "walk_shape_trials": walk_trials(gb, cfg.dim, gen, ("eg_src", "el_dst"), cfg.flow)})

    # ---- QM9: a training batch of 32 at the recipe's pads (D=128) ----
    qmols = synthetic_qm9_dataset(QM9_MOLECULES, seed=args.seed)
    qloaders = {g: GraphLoader(qmols, "qm9", 5.0, 5.0, 32, shuffle=True, seed=args.seed,
                               drop_last=True, build_perms=True,
                               variant="s" if g == "s" else "full",
                               wire_geometry="derive" if g == "derive" else "host")
                for g in ("host", "derive", "s")}
    qm9 = {g: ld.collate(list(range(32))).to("cuda") for g, ld in qloaders.items()}
    qm9_pads = qloaders["host"].pads
    bwd_cases = qm9_kernel_cases(qm9["host"], 128, gen)
    emit({"phase": "train_kernels", "pads": dataclasses.asdict(qm9_pads),
          "valid": qm9["host"].valid, **bwd_cases,
          "walk_shape_trials": walk_trials(qm9["host"], 128, gen,
                                           ("eg_dst", "eg_src", "el_src"), "source_to_target")})

    # ---- RNA: a training batch of 8 of the scoring structures (D=16) ----
    rloaders = {g: GraphLoader(mols, "rna", 2.6, 20.0, 8, shuffle=True, seed=args.seed,
                               build_perms=True, wire_geometry=g) for g in ("host", "derive")}
    rna = {g: ld.collate(list(range(min(8, len(mols))))).to("cuda") for g, ld in rloaders.items()}
    rna_pads = rloaders["host"].pads
    rna_cases = rna_kernel_cases(rna["host"], rna_pads, 16, gen)
    emit({"phase": "rna_train_kernels", "pads": dataclasses.asdict(rna_pads),
          "valid": rna["host"].valid, **rna_cases,
          "walk_shape_trials": walk_trials(rna["host"], 16, gen, ("eg_src", "eg_dst", "el_src"),
                                           "target_to_source")})

    # ---- PDBbind: a batch of 32 realistic complexes (D=128) ----
    pmols = [pdbbind_molecule(g)
             for g in synthetic_pdbbind_complex_dataset(PDBBIND_COMPLEXES, seed=805)]
    ploader = GraphLoader(pmols, "pdbbind", 2.0, 6.0, 32, shuffle=True, seed=args.seed,
                          build_perms=True)
    pgb = ploader.collate(list(range(32))).to("cuda")
    pdb_cases = pdbbind_kernel_cases(pgb, 128, gen)
    emit({"phase": "pdbbind_kernels", "pads": dataclasses.asdict(ploader.pads),
          "valid": pgb.valid, "longest": pgb.longest, **pdb_cases,
          "walk_shape_trials": walk_trials(pgb, 128, gen, ("eg_dst", "eg_src", "el_src"),
                                           "source_to_target")})

    # ---- bfloat16 ----
    bf16_cases = bf16_kernel_cases(qm9["host"], pgb, 128, gen)
    emit({"phase": "bf16_kernels", "qm9_pads": dataclasses.asdict(qm9_pads),
          "pdbbind_pads": dataclasses.asdict(ploader.pads), "qm9_valid": qm9["host"].valid,
          "pdbbind_valid": pgb.valid, "tolerance": BF16_RULE, **bf16_cases})
    scoring_perms = loader.collate(list(range(len(mols))), build_perms=True).to("cuda")
    sbf16 = sbf_bf16_cases(gen, scoring_perms, rna["host"])
    emit({"phase": "sbf_bf16_kernels", "tolerance": BF16_RULE,
          "scoring_valid": scoring_perms.valid, "rna_train_valid": rna["host"].valid, **sbf16})
    bf16_cases.update(sbf16)

    # ---- each path's launches against the table ----
    by_path = launch_phase(recipe_paths(args.seed, service, gb, qm9, rna, pgb), args.profile)

    # ---- every kernel, with its numbers ----
    # Each kernel's top-level numbers are those of one main-path case: the
    # folded t2 triplet sum (kernel A's, on random data), kernel B's t2 sum
    # by center edge on the scoring batch, the global message, its sum by
    # node on the scoring batch and the embedding lookup (RNA batch-16
    # scoring shapes); the t2 role swap and product, the global message's
    # backward, the sum by el_src and the embedding's backward sum by the
    # split kernel, the fused role swap at t2 and the gated el_dst sum's
    # backward (QM9 training shapes); kernel B's summed backward at t2 and
    # dim 16 (RNA batch-8 training shapes).  "rna_train" holds the same
    # numbers of the kernel's first case at the RNA training shapes (null for
    # the kernels that path does not run), "pdbbind" those at the PDBbind
    # training shapes, "bf16" those of its first bfloat16 case (null for the
    # kernels without a bfloat16 version).  Launches are the launch phase's,
    # by path; group_sum counts its calls, of either kernel, and
    # group_sum_split the split kernel's.
    table = [
        ("triplet_aggregate", "triplet_aggregate.cu", "pamnet_tpu/ops/pallas_triplet.py:47",
         a_cases + walk_batch, a_cases[0]),
        ("sbf_modulate", "sbf_modulate.cu", "tools/fused_sbf_kernel_probe.py:42",
         b_cases + sbf_batch, sbf_batch[0]),
        ("edge_message", "row_gather.cu", "tools/vmem_gather_probe.py:86",
         e_cases, e_cases[0]),
        ("edge_message_sum", "row_gather.cu", "tools/vmem_gather_probe.py:86",
         msg_batch, msg_batch[0]),
        ("row_gather", "row_gather.cu", "tools/vmem_gather_probe.py:42",
         g_cases, g_cases[0]),
        ("triplet_aggregate_grad_a", "triplet_aggregate.cu",
         "pamnet_tpu/ops/pallas_triplet.py:122", bwd_cases["triplet_aggregate_grad_a"],
         bwd_cases["triplet_aggregate_grad_a"][0]),
        ("triplet_aggregate_grad_ab", "triplet_aggregate.cu",
         "pamnet_tpu/ops/pallas_triplet.py:122", bwd_cases["triplet_aggregate_grad_ab"],
         bwd_cases["triplet_aggregate_grad_ab"][0]),
        ("gather_product", "gather_backward.cu", "pamnet_tpu/ops/pallas_triplet.py:129",
         bwd_cases["gather_product"], bwd_cases["gather_product"][0]),
        ("gated_sum_backward", "gather_backward.cu", "pamnet_tpu/ops/pallas_triplet.py:122",
         bwd_cases["gated_sum_backward"], bwd_cases["gated_sum_backward"][0]),
        ("edge_message_backward", "gather_backward.cu", "tools/vmem_gather_probe.py:86",
         bwd_cases["edge_message_backward"], bwd_cases["edge_message_backward"][0]),
        ("group_sum", "triplet_aggregate.cu", "tools/vmem_gather_probe.py:42",
         bwd_cases["group_sum"], bwd_cases["group_sum"][0]),
        ("group_sum_split", "group_sum.cu", "tools/vmem_gather_probe.py:42",
         bwd_cases["group_sum_split"], bwd_cases["group_sum_split"][0]),
        ("sbf_modulate_backward", "sbf_modulate_backward.cu",
         "tools/fused_sbf_kernel_probe.py:42", [], rna_cases["sbf_modulate_backward"][0]),
    ]
    numbers = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
               "library_device_ms", "enqueue_ms")

    def first_case(path_cases, name):
        if name not in path_cases:
            return None
        return {"timed_case": path_cases[name][0]["case"],
                **{k: path_cases[name][0][k] for k in numbers}}

    # A kernel that no path of the table wants (no exact count above 0, no
    # None) is off the main paths, and must launch on none.
    wanted = {k for pair in LAUNCHES.values() for want in pair for k, v in want.items()
              if v != 0}
    kernels = [
        {"name": name, "route": "cuda", "source": f"pamnet_tpu_torch/csrc/{src}",
         "replaces": replaces, "on_main_path": name in wanted,
         "launches": sum(counts[name] for counts in by_path.values()),
         "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
         "max_abs_err": max(c["max_abs_err"] for c in
                            cases + bwd_cases.get(name, []) + rna_cases.get(name, [])
                            + pdb_cases.get(name, []) + bf16_cases.get(name, [])),
         **{k: rep[k] for k in numbers}, "timed_case": rep["case"],
         "rna_train": first_case(rna_cases, name), "pdbbind": first_case(pdb_cases, name),
         "bf16": first_case(bf16_cases, name)}
        for name, src, replaces, cases, rep in table
    ]
    if any((k["launches"] > 0) != k["on_main_path"] for k in kernels):
        raise AssertionError("kernels off the main paths launched, or on them did not: "
                             f"{[(k['name'], k['launches']) for k in kernels]}")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
