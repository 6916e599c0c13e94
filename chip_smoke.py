#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (pamnet_tpu_torch) on one card.

    python3 chip_smoke.py [--seed 0] [--structures 16] [--atoms 2100]
                          [--qm9_molecules 512] [--rna_structures 32]
                          [--pdbbind_complexes 64] [--profile]

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi) and the kernel
     build time (nvcc, sm_90a, from the sources in the checkout);
  2. kernels: each CUDA kernel against its plain PyTorch version on the card
     at the RNA batch-16 shapes, with kernel, plain, library and bound times
     (kernel B on random triplets summed by center edge and as (T, D) rows,
     which are its sums over identity groups: the kernel has one form);
  3. slice: RNAScoringService(device="cuda") scores a batch of synthetic
     RNA-scale structures with seeded weights (the serving main path; every
     forward kernel's launch count must rise), then the folded, unfolded and
     plain paths score the same batch and are compared; graphs/s and ms per
     batch; the folded forward must launch kernel B twice, the global
     message summed by node once and kernel A once (the el_dst sum; the
     unfolded one adds its two triplet sums); then
     sbf_kernels: kernel B on that batch's own t2/t1 arrays, summed by
     center edge and as rows (identity groups), against its plain version,
     two calls bitwise;
     walk_kernels: kernel A's global and el_dst sums on that batch's own
     CSRs, and the global message summed by node on them against its plain
     version, timed beside the rows + kernel A sum of the same arrays, and
     ``walk_shape_trials`` (each team shape of the walk timed at those CSRs;
     the training kernel phases carry the same trials at theirs);
     host_build: where the host's time goes on the scoring batch and on the
     QM9 epoch wall's 4,608 molecules, with the numpy builders and the
     native ones (``data/native.py``): seconds by part (neighbours, edge
     sort, triplets, pairs, distances, the f64 basis, collation, the
     backward's permutations), the two builders' arrays bit for bit equal,
     and the service call on each; collation by field, numpy against the
     collate plan (``data/batch.py::CollatePlan``) in turns, on the QM9
     recipe's training batches (derived and host geometry, with the
     backward's arrays) and the scoring batch, bit for bit equal, and a
     loader's batches seen to come from the plan;
  4. service: the HTTP server on an ephemeral port answers JSON and raw-PDB
     requests, compared with direct scoring;
  5. train_kernels: each backward kernel against its plain version at the
     QM9 batch-32 pads (D=128), on the CSR arrays of a real training batch,
     and the unfolded path's gather of the radial table (D=42) at its pads;
     the fused role swap (d_a and d_b in one walk) bitwise equal to the
     role swap and gather_product of the same arrays and timed beside
     them, and the gated el_dst sum's backward beside the row gather and
     three multiplies it replaces;
  6. train: QM9 training at the recipe (dim 128, 6 layers, batch 32, f32,
     L1, Adam + clip 1000 + EMA 0.999, warmup-exponential at lr 1e-4) on
     synthetic molecules: the first step's gradients and loss through the
     kernels against the plain route, a repeated step bitwise, launches per step of
     every forward and backward kernel (kernel A 3 a layer, the summed
     global message 1; in the backward the fused role swap 2 a layer, the
     gated backward 1, no row gather and no gather_product), an epoch (the training main path;
     every kernel of the path must launch), ms per step, molecules/s and
     device ms per step on a resident batch, host enqueue time and peak
     memory; then
     ``python -m pamnet_tpu_torch.main_qm9`` in-process for one epoch;
  7. rna_train_kernels: kernel B's backward, summed by center edge and over
     identity groups,
     against PyTorch's autograd of its plain version at the pads of an RNA
     training batch of 8, for (7, 16) and (7, 8), on the t2 and t1 arrays of
     that batch, two calls bitwise; kernel B forward on the same arrays and
     on random ones in both modes; the summed global message and its
     backward on the batch's own arrays; then every other wrapper
     an RNA training step launches, against its plain version at that
     batch's shapes (D=16): kernels A and B and the edge messages forward,
     the row gathers with a valid count, the edge messages' backward, the
     gated el_dst sum's backward and the group sums on the batch's own
     index arrays;
  8. rna_train: RNA training at the published recipe (dim 16, 1 layer, batch
     8, lr 1e-4 constant, SmoothL1, Adam, no clip, no EMA, f32) on synthetic
     structures written to and read from a TU directory: the first step's
     gradients through the kernels against the plain route and against the
     unfolded path, a repeated step bitwise, launches per step (kernel B 2
     forward + 2 backward; kernel A 1 forward, the el_dst sum, and its
     gated backward 1, no row gather in the backward; the global message
     summed by node 1), an epoch (the RNA
     training main path), ms per
     step, structures/s, device time per step, peak memory; then
     ``python -m pamnet_tpu_torch.main_rna_puzzles`` in-process: three epochs
     straight, two epochs and a ``--resume`` for the third, which must give
     the same losses bit for bit, and ``RNAScoringService`` scoring the
     validation structures with the exported ``pamnet_rna_best.pt``
     (every in-process entry point of phases 6-11 runs with
     ``--host_geometry``, the geometry its batches carried before training
     batches derived theirs by default).
     The group sums of both training phases are bitwise equal across two
     calls; the embedding's (the sum by ``z``) takes the split kernel
     (``group_sum_split``) on both training paths;
  9. pdbbind_kernels: every wrapper a PDBbind training step launches, on
     the arrays of a batch of 32 realistic synthetic complexes (D=128; n
     ~10.7k, eg ~334k, up to 80 rows a global group) against its plain
     version and timed against its bound: kernel A's unfolded t2/t1 sums and
     gated el_dst sum, the local messages, the global message summed by
     node, the radial table's gathers, the fused role swap, the gated
     backward, the messages' backward and the group sums, with the walk's
     team shapes timed at those CSRs;
 10. pdbbind_train: PDBbind training at the README recipe (full PAMNet, dim
     128, 3 layers, batch 32, lr 1e-3, MSE, Adam, the multistep schedule, no
     EMA, f32) on those complexes at the loader's worst-case pads: the
     step's loss and gradients through the kernels against the plain route
     (every tensor within 1e-4 * max|g| + 1e-6, as on the other paths), a
     repeated step bitwise, launches per step (no embedding gather, no
     split group sum, no kernel B), an epoch, ms per step, device ms;
     then ``python -m pamnet_tpu_torch.main_pdbbind --synthetic 48`` at its
     defaults in-process for one epoch;
 11. qm9_s_train: PAMNet_s at the QM9 recipe, the same checks, no t2
     launch (kernel A 2 a layer, the fused role swap 1), then ``main_qm9
     --model PAMNet_s`` in-process for one epoch;
 12. derive_train: the QM9 recipe step and the RNA recipe step (folded:
     kernel B on a radial table computed on the card) on derive batches
     (positions and integer tables; the geometry computed in the step):
     gradients against the plain route of the same batch, a repeated step
     bitwise, predictions, loss and the parameters after one step against
     the host-geometry step of the same molecules, the host step's kernel
     launches, an epoch, and ms per step, device ms, idle share, every
     kernel launch and the host syncs of a step beside the host step's;
 13. device_graph_train: the graph rebuilt from the positions on the card
     (``device_graph=True``): the rebuilt QM9 and PDBbind batches equal to
     the host's field by field (edges, CSRs, the backward's permutations,
     counts) with one host sync a rebuild; the QM9 recipe step checked as
     in 12 (predictions and loss within 2e-5 + 2e-4 of the host step's); a
     PDBbind forward on the smoke batch against its host forward and its
     plain route; ``main_qm9 --device_graph`` in-process for one epoch;
 14. bf16_kernels: every kernel with a bfloat16 version (kernel A's sums,
     the fused role swap, the gated backward, the edge messages, the summed
     global message and its backward, the group sums' walk, the row gather
     of the radial table at D=42 and of 16-byte rows) against its plain
     bfloat16 version, which computes in f32 and rounds once, within one
     bfloat16 ulp (2^-7 |want| + 1e-5 max|want|), at the QM9 recipe's batch
     and, for the summed global message and its backward, the PDBbind
     batch's arrays; bounds count 2 bytes a value;
 15. qm9_bf16_train: the QM9 recipe in bfloat16 (``compute_dtype``): the
     gradients through the kernels against the plain bfloat16 route (per
     tensor 2e-2 * max|g_plain| + 1e-6, or twice the tensor's distance
     between the bfloat16 and float32 plain routes), loss and predictions
     against the plain route (1e-2) and the float32 step (3e-2), a repeated
     step bitwise, ten steps whose loss falls, the same launches of every
     port kernel as the float32 step, an epoch (the main path), and ms per
     step, device ms, idle share, launches and peak memory beside the
     float32 step's;
 16. pdbbind_bf16_train: the same at the PDBbind README recipe, but for
     the gradients and predictions, which the signed pool's cancellation
     leaves to rounding noise in bfloat16 on either route: the kernels'
     whole gradient within 2e-2 of the float32 route's norm or twice the
     plain bfloat16 route's distance from it, their predictions within
     3e-2 * max|pred_f32| or twice that route's (per-tensor ratios
     reported);
 17. sbf_bf16_kernels: kernel B forward and backward in bfloat16 on the t2
     and t1 arrays of the scoring batch, of the RNA training batch of 8 and
     of the scoring batch with every triplet on edge 0, each within one
     bfloat16 ulp of its plain bfloat16 version, bitwise repeatable, timed
     beside its bound at 2 bytes a value and the float32 kernel on the same
     values;
 18. rna_bf16: the published RNA model in bfloat16, folded through kernel
     B's bfloat16 version, beside the float32 model in turns: the scoring
     batch's scores (1e-2 * max of the plain bfloat16 route, 3e-2 * max of
     float32), launches and ms a batch; the training step as phases 15-16
     check theirs (``_bf16_step``, RNA's mean pool in the pool's terms);
     ``main_rna_puzzles --compute_dtype bfloat16`` for an epoch and the
     bfloat16 service over HTTP, kernel B seen on bfloat16 operands;
 19. rna_csv: ``python -m pamnet_tpu_torch.inference_rna_puzzles`` in
     float32 and bfloat16 on TU files of the scoring structures: the CSV's
     header, tags and puzzle number, the scores against the scoring
     service's on the same structures and bit for bit those of the
     driver's loop before the pipeline (each batch collated and copied on
     the calling thread), one device-to-host copy a run, and seconds per
     structure;
 21. qm9_preprocessed: a PyG-layout ``data_v2.pt`` of synthetic QM9
     molecules (written through a stand-in ``torch_geometric.data.data.
     Data``) read back bit for bit, and ``main_qm9`` trained from it for an
     epoch at the recipe's width through ``load_qm9``;
 22. dp: data parallelism at the QM9 recipe: one rank over NCCL, three
     ``dp_train_step``s bit for bit ``train_step``'s in float32 and
     bfloat16 (the float32 run is this slice's main path: every kernel of
     the QM9 step launches), ms per step of both in turns; two ranks
     spawned on the one card over gloo, the replicas bit for bit equal and
     the summed gradients within the per-tensor rule of one process on the
     union batch; ``main_qm9 --dp 2`` on a one-card machine raises;
 23. raw_data: the data-preparation path into training, each driver
     in-process: a raw PDBbind tree (mol2 files and the index, written by
     ``data/synthetic.py::write_raw_pdbbind``) through ``python -m
     pamnet_tpu_torch.preprocess_pdbbind``, then ``main_pdbbind`` at the
     README recipe (dim 128, 3 layers, batch 32) for an epoch without the
     structure cache, with it cold and warm: the warm run builds no chunk,
     the three runs' step losses and parameters are bit for bit equal, a
     step launches what phase 10's step launches; RNA-Puzzles candidate
     PDB files through ``preprocess_rna_puzzles`` into ``main_rna_puzzles``
     at the published recipe (folded) cold and warm, alike, and
     ``inference_rna_puzzles`` on the preprocessed ``val`` split; ``main_qm9
     --synthetic`` at the recipe with ``--structure_cache --cache_workers 2``
     cold and warm, alike, and a ``--trace_dir`` run whose Chrome trace
     names the port's kernels; seconds a complex and a structure of the
     preprocessors, the loaders' seconds and chunks built of every run;
 24. epoch_pipeline: the training drivers' epoch, JAX's pipeline
     (``train/loop.py::run_epoch`` over ``GraphLoader.prefetch`` and
     ``_staged``, the evaluation splits resident in ``StackedEval``)
     against the parent's serial epoch (collation and pageable copies on
     the main thread, the evaluation splits collated again), in turns
     (serial, pipelined, ...: ``PIPELINE_PAIRS`` pairs) from the same
     parameters and loader order, for the QM9 recipe in bfloat16 (1,280 synthetic
     molecules, ``main_qm9 --synthetic``'s split), the RNA recipe (folded;
     24 + 8 structures of 2,100 atoms, batch 8) and the PDBbind README
     recipe (the 64 realistic complexes of phase 9): per-step losses,
     parameters after the epoch, every split's predictions and launches
     per step bit for bit equal between the ways; ``epoch_s`` of each run,
     the serial runs' ``collate_s`` and ``h2d_s``, the pipelined runs'
     ``queue_wait_s``, the card's new allocations (``cudaMalloc`` segments)
     of each run, the MB ``StackedEval`` staged and its seconds, and
     the device's idle share over each way's epoch (device time from one
     more profiled epoch of each way: the union of the card's kernel and
     copy intervals, ``profiling.py::device_busy_s``);
 25. kernels: one line listing every kernel with its numbers (the role
     swap alone and gather_product are off the main paths since the fused
     role swap: 0 launches, asserted; they and the split group sum have no
     bfloat16 version).
With ``--profile`` each phase also lists its device time by kernel and, for
the scoring forward and a QM9, an RNA, a PDBbind and a PAMNet_s training
step, every kernel launch
in total and by kernel name with its device time (``kernels_by_name``) and
each launch of the port's kernels with its device time
(``port_kernel_launches``).
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
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

from pamnet_tpu_torch.profiling import (device_busy_s, device_ms, device_us, is_kernel,
                                        kernel_totals, time_ms)

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
    parser.add_argument("--rna_structures", type=int, default=32,
                        help="synthetic structures of the RNA training phase "
                             "(the last quarter validates)")
    parser.add_argument("--pdbbind_complexes", type=int, default=64,
                        help="synthetic realistic complexes of the PDBbind training phase")
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
    from pamnet_tpu_torch.data.synthetic import synthetic_rna_dataset
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.ops import _build
    from pamnet_tpu_torch.ops.gather import (edge_message, edge_message_backward,
                                             edge_message_sum, row_gather)
    from pamnet_tpu_torch.ops.sbf_modulate import sbf_modulate, sbf_modulate_backward
    from pamnet_tpu_torch.ops.triplet import (gated_sum_backward, gather_product, group_sum,
                                              group_sum_split, triplet_aggregate,
                                              triplet_aggregate_grad_a,
                                              triplet_aggregate_grad_ab)
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
          "build_s": build_s, "library": os.path.relpath(lib_path),
          "kernel_resources": kernel_resources(str(lib_path))})

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

    # ---- 3. the slice: scoring service on the card ----
    # One seeded set serves scoring (its first structures) and RNA training.
    t0 = time.perf_counter()
    rna_mols = synthetic_rna_dataset(max(args.structures, args.rna_structures),
                                     seed=args.seed, n_atoms=args.atoms)
    gen_s = time.perf_counter() - t0
    mols = rna_mols[:args.structures]
    cfg = PAMNetConfig(dataset="rna_serve", dim=16, n_layer=1, cutoff_l=2.6,
                       cutoff_g=20.0, flow="target_to_source")
    state = init_params(cfg, torch.Generator().manual_seed(args.seed))
    service = RNAScoringService(state, cfg, batch_size=16, device="cuda")

    wrappers = {"triplet_aggregate": triplet_aggregate, "sbf_modulate": sbf_modulate,
                "edge_message": edge_message, "edge_message_sum": edge_message_sum,
                "row_gather": row_gather,
                "triplet_aggregate_grad_a": triplet_aggregate_grad_a,
                "triplet_aggregate_grad_ab": triplet_aggregate_grad_ab,
                "gather_product": gather_product, "gated_sum_backward": gated_sum_backward,
                "group_sum": group_sum,
                "group_sum_split": group_sum_split,
                "edge_message_backward": edge_message_backward,
                "sbf_modulate_backward": sbf_modulate_backward}
    serve_kernels = ("triplet_aggregate", "sbf_modulate", "edge_message", "edge_message_sum",
                     "row_gather")

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
        # Kernel B sums each stream by center edge itself: two launches and
        # no kernel A sum over the triplets (the unfolded path's two
        # gathered sums are those launches).  The global message sums itself
        # by node: kernel A's one launch a layer is the el_dst sum.
        if (per_batch["sbf_modulate"] != 2 * cfg.n_layer or per_batch_unfolded["sbf_modulate"]
                or per_batch["triplet_aggregate"] != cfg.n_layer
                or per_batch_unfolded["triplet_aggregate"] != 3 * cfg.n_layer
                or per_batch["edge_message_sum"] != cfg.n_layer
                or per_batch["edge_message"] != 3 * cfg.n_layer):
            raise AssertionError(f"folded forward launches {per_batch}, "
                                 f"unfolded {per_batch_unfolded}")
        fold_ms = time_ms(lambda: folded(gb), iters=10)
        fold_enqueue_ms = enqueue_ms(lambda: folded(gb), iters=10)
        plain_ms = time_ms(lambda: folded(gb, plain=True), iters=10)
        unfold_ms = time_ms(lambda: unfolded(gb), iters=10)
    emit({"phase": "slice", "structures": len(mols), "atoms": args.atoms,
          "structures_generated": len(rna_mols), "structure_gen_s": gen_s, "counts": counts, "pads": pads,
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

    # ---- 3b. where the host's time goes: numpy and native builders ----
    host_build_phase(args, mols, service, emit)

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
    emit({"phase": "sbf_kernels", "batch": f"scoring, {ng} structures", "pads": pads,
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
              **launch_totals(prof, 3, "batch"),
              "port_kernel_launches": port_kernel_launches(prof, 3),
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
    bwd_cases, train_launches, qm9_data = train_phase(args, gen, reset_counts, read_counts,
                                                      emit)

    # ---- 7-8. RNA training: the kernels at its shapes and the folded training path ----
    rna_cases, rna_launches, rna_data = rna_train_phase(
        args, rna_mols[:args.rna_structures], gen, reset_counts, read_counts, emit)

    # ---- 9-10. PDBbind training: the kernels at its shapes and its training path ----
    pdb_cases, pdb_launches, pdbbind_data = pdbbind_phase(args, gen, reset_counts, read_counts,
                                                          emit)

    # ---- 11. PAMNet_s training at the QM9 recipe ----
    _, s_launches, _ = train_phase(args, gen, reset_counts, read_counts, emit, variant="s")

    # ---- 12-13. geometry derived on the card, and the graph rebuilt there ----
    derive_launches = derive_phase(args, rna_mols, reset_counts, read_counts, emit)
    graph_launches = device_graph_phase(args, reset_counts, read_counts, emit)

    # ---- 14-16. bfloat16: its kernels, QM9 and PDBbind training ----
    bf16_cases, qm9_bf16_launches, pdb_bf16_launches = bf16_phase(
        args, gen, qm9_data, pdbbind_data, reset_counts, read_counts, emit)

    # ---- 17-19. kernel B in bfloat16, the folded RNA model in bfloat16 and
    # the RNA-Puzzles CSV driver ----
    scoring_perms = loader.collate(list(range(len(mols))), build_perms=True).to("cuda")
    bf16_cases.update(sbf_bf16_phase(gen, scoring_perms, rna_data[1], emit))
    rna_bf16_launches = rna_bf16_phase(args, mols, gb, rna_data, reset_counts, read_counts,
                                       emit)
    csv_launches = rna_csv_phase(args, mols, state, reset_counts, read_counts, emit)

    # ---- 21-22. the QM9 preprocessed artifact; data parallelism ----
    qm9_preprocessed_phase(args, emit)
    dp_launches = dp_phase(args, qm9_data, train_launches, reset_counts, read_counts, emit)

    # ---- 23. raw files through the preprocessors and the structure cache ----
    pdb_steps = len(pdbbind_data[0])
    raw_launches = raw_data_phase(args, rna_mols, {k: v / pdb_steps for k, v in
                                                   pdb_launches.items()},
                                  reset_counts, read_counts, emit)

    # ---- 24. the epoch pipeline against the serial epoch ----
    pipeline_launches = epoch_pipeline_phase(args, rna_mols[:args.rna_structures],
                                             pdbbind_data[2], reset_counts, read_counts, emit)

    # ---- 25. every kernel of the paths, with its numbers ----
    # Each kernel's top-level numbers are those of one main-path case: the
    # folded t2 triplet sum (kernel A's, on random data), kernel B's t2 sum
    # by center edge on the scoring batch, the global message, its sum by
    # node on the scoring batch and the
    # embedding lookup (RNA batch-16 scoring shapes); the t2 role swap and product, the global
    # message's backward, the sum by el_src and the embedding's backward sum
    # by the split kernel, the fused role swap at t2 and the gated el_dst
    # sum's backward (QM9 training shapes); kernel B's summed backward
    # at t2 and dim 16 (RNA batch-8 training shapes).  "rna_train" holds the same
    # numbers of the kernel's first case at the RNA training shapes (null for
    # the kernels that path does not run), "pdbbind" those at the PDBbind
    # training shapes, "bf16" those of its first bfloat16 case (null for the
    # kernels without a bfloat16 version; kernel B's: its t2 sum on the
    # scoring batch).  Launches add the serving, the QM9, RNA, PDBbind and
    # PAMNet_s training main paths, the derive and device_graph steps, the
    # QM9, PDBbind and RNA bfloat16 training paths, the CSV driver's runs,
    # the one-rank data-parallel steps, the first run of each raw-data
    # path (raw_pdbbind, raw_rna, raw_qm9) and the first pipelined epoch of
    # each epoch_pipeline recipe (epoch_pipeline_qm9, _rna, _pdbbind);
    # group_sum counts its calls, of either kernel, and group_sum_split the
    # split kernel's.
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
    by_path = {"serve": launches, "train": train_launches, "rna_train": rna_launches,
               "pdbbind_train": pdb_launches, "qm9_s_train": s_launches,
               "derive_train": derive_launches, "device_graph_train": graph_launches,
               "qm9_bf16_train": qm9_bf16_launches, "pdbbind_bf16_train": pdb_bf16_launches,
               "rna_bf16": rna_bf16_launches, "rna_csv": csv_launches, "dp_train": dp_launches,
               **raw_launches, **pipeline_launches}

    def first_case(path_cases, name):
        if name not in path_cases:
            return None
        return {"timed_case": path_cases[name][0]["case"],
                **{k: path_cases[name][0][k] for k in numbers}}

    kernels = [
        {"name": name, "route": "cuda", "source": f"pamnet_tpu_torch/csrc/{src}",
         "replaces": replaces,
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
    # The role swap alone and gather_product are routes for one gradient
    # wanted; every main path wants both, which the fused role swap gives.
    off_path = {k["name"] for k in kernels if k["launches"] == 0}
    if off_path != {"triplet_aggregate_grad_a", "gather_product"}:
        raise AssertionError(f"kernels off the main paths: {sorted(off_path)}")
    for k in kernels:
        k["on_main_path"] = k["name"] not in off_path
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def profile_rows(prof, calls: int) -> tuple[list[dict], list[dict]]:
    """Kernel rows (device ms per call, launches per call) and the top host
    rows of a profile over ``calls`` calls."""
    rows = [{"name": ev.key[:80], "device_ms_per_call": device_us(ev) / calls / 1e3,
             "launches_per_call": ev.count / calls}
            for ev in prof.key_averages() if is_kernel(ev)]
    rows.sort(key=lambda r: -r["device_ms_per_call"])
    host = sorted(prof.key_averages(), key=lambda ev: -ev.self_cpu_time_total)
    return rows, [{"name": ev.key[:80], "host_ms_per_call": ev.self_cpu_time_total / calls / 1e3,
                   "calls_per_call": ev.count / calls} for ev in host[:12]]


def launch_totals(prof, calls: int, unit: str) -> dict:
    """Every kernel launch per ``unit`` (a batch, a step) of a profile over
    ``calls`` calls, in total and by kernel name with its device ms: the
    launches one commit drops show by name."""
    totals = kernel_totals(prof.key_averages(), calls)
    return {f"kernel_launches_per_{unit}": totals["kernel_launches"],
            "kernels_by_name": totals["by_name"]}


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


def train_phase(args, gen, reset_counts, read_counts, emit_line,
                variant: str = "full") -> tuple[dict, dict, tuple]:
    """QM9 training at the recipe (dim 128, 6 layers, batch 32, L1, Adam +
    clip 1000 + EMA 0.999, warmup-exponential).  ``variant="full"``: phases 5
    and 6, the backward kernel cases at the QM9 pads and PAMNet's training;
    ``variant="s"``: phase 11, PAMNet_s's training, the one-hop stream alone.
    Returns (kernel cases by kernel, none for PAMNet_s; launches of the
    training main path; its loader and resident batch)."""
    import torch

    from pamnet_tpu_torch import main_qm9
    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.ema import ema_init
    from pamnet_tpu_torch.train.loop import Optimizer, train_step
    from pamnet_tpu_torch.train.schedules import warmup_exponential

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bs, d, n_layer, kind = 32, 128, 6, "l1"
    t0 = time.perf_counter()
    qmols = synthetic_qm9_dataset(args.qm9_molecules, seed=args.seed)
    loader = GraphLoader(qmols, "qm9", 5.0, 5.0, bs, shuffle=True, seed=args.seed,
                         drop_last=True, build_perms=True, variant=variant)
    host_build_s = time.perf_counter() - t0
    gb = loader.collate(list(range(bs))).to("cuda")  # a resident batch at the pads

    cases: dict = {}
    if variant == "full":
        # ---- 5. backward kernels at the QM9 pads ----
        cases = {
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
        emit_line({"phase": "train_kernels", "pads": dataclasses.asdict(loader.pads),
                   "valid": gb.valid, **cases,
                   "walk_shape_trials": walk_trials(gb, d, gen, ("eg_dst", "eg_src", "el_src"),
                                                    "source_to_target")})

    # ---- 6 / 11. training at the recipe ----
    cfg = PAMNetConfig(dataset="QM9", dim=d, n_layer=n_layer, cutoff_l=5.0, cutoff_g=5.0,
                       variant=variant)
    model = PAMNet(cfg, torch.Generator().manual_seed(args.seed)).to("cuda")
    opt = Optimizer(model.parameters(),
                    warmup_exponential(1e-4, len(loader), frac_steps_per_epoch=len(qmols) / bs),
                    clip_norm=1000.0)
    ema = ema_init(model.state_dict())
    checks = _step_checks(model, opt, ema, gb, kind)
    # Launches per step (None: at least one).  The global message sums
    # itself by node.  PAMNet: per layer kernel A's forward launches are the
    # t2/t1 gathered sums and the el_dst sum; in the backward each triplet
    # sum's d_a and d_b are one fused role swap (no role swap alone, no
    # gather_product) and the el_dst sum's two gradients one gated backward
    # (no row gather).  PAMNet_s has no two-hop stream: kernel A's t1 sum and
    # the el_dst sum a layer, one fused role swap, the radial table gathered
    # at t1 alone beside the embedding, and the embedding's backward by the
    # split kernel.
    if variant == "full":
        want_fwd = {"triplet_aggregate": 3 * n_layer, "edge_message_sum": n_layer,
                    "edge_message": None, "row_gather": None}
        want_bwd = {"triplet_aggregate_grad_ab": 2 * n_layer, "gated_sum_backward": n_layer,
                    "row_gather": 0, "gather_product": 0, "triplet_aggregate_grad_a": 0,
                    "group_sum": None, "group_sum_split": None, "edge_message_backward": None}
    else:
        want_fwd = {"triplet_aggregate": 2 * n_layer, "edge_message_sum": n_layer,
                    "edge_message": 3 * n_layer, "row_gather": 2, "sbf_modulate": 0}
        want_bwd = {"triplet_aggregate_grad_ab": n_layer, "gated_sum_backward": n_layer,
                    "row_gather": 0, "group_sum_split": 1, "gather_product": 0,
                    "triplet_aggregate_grad_a": 0, "group_sum": None,
                    "edge_message_backward": None}
    what = "QM9" if variant == "full" else "PAMNet_s"
    fwd, bwd = _step_launches(model, gb, kind, reset_counts, read_counts, want_fwd, want_bwd,
                              what)
    launches, epoch = _epoch(model, opt, ema, loader, kind, reset_counts, read_counts,
                             want_fwd, want_bwd, what)
    step = lambda: train_step(model, opt, ema, gb, kind)  # noqa: E731
    res = {"phase": "train" if variant == "full" else "qm9_s_train",
           "molecules": len(qmols), "batch_size": bs, "dim": d, "n_layer": n_layer,
           "host_build_s": host_build_s, "pads": dataclasses.asdict(loader.pads),
           "resident_batch_valid": gb.valid, "gradient_check": checks,
           "bitwise_repeat": True, "launches_per_step_forward": fwd,
           "launches_per_step_backward": bwd, **epoch, "main_path_launches": launches,
           **_step_numbers(step, gb.num_graphs)}
    emit_line(res)
    if args.profile:
        _profile_step(step, "profile_train" if variant == "full" else "profile_qm9_s_train",
                      res["ms_per_step"], emit_line)

    # main_qm9, in-process, one epoch at the recipe.
    model_flag = [] if variant == "full" else ["--model", "PAMNet_s"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), tempfile.TemporaryDirectory() as tmp:
        main_qm9.main(["--synthetic", "--limit", "320", "--epochs", "1", *model_flag,
                       "--host_geometry", "--seed", str(args.seed), "--device", "cuda",
                       "--save_dir", tmp])
    main_s = time.perf_counter() - t0
    text = out.getvalue()
    maes = re.findall(r"(Train|Val|Test) MAE: (\S+?),? ", text)
    maes += re.findall(r"(Best Validation|Testing) MAE: (\S+)", text)
    if len(maes) != 5 or not all(math.isfinite(float(v)) for _, v in maes):
        raise AssertionError(f"main_qm9 {' '.join(model_flag)} output: {text}")
    emit_line({"phase": "main_qm9" if variant == "full" else "main_qm9_pamnet_s",
               "seconds": main_s, "lines": [ln for ln in text.splitlines() if "MAE" in ln]})
    return cases, launches, (loader, gb)


def _parameter_grads(model, loss_fn) -> dict:
    """Every parameter's gradient of ``loss_fn()`` (zeros where it got none)."""
    import torch

    model.zero_grad()
    loss_fn().backward()
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in model.named_parameters()}


def _worst_gradient(got: dict, want: dict, what: str) -> dict:
    """The tensor of ``got`` furthest from ``want`` relative to the tolerance
    1e-4 * max|want| + 1e-6; raises beyond it."""
    ratios = {n: float((got[n] - w).abs().max()) / (1e-4 * float(w.abs().max()) + 1e-6)
              for n, w in want.items()}
    worst = max(ratios, key=ratios.get)
    if not ratios[worst] <= 1.0:
        raise AssertionError(f"{what}: {worst} at {ratios[worst]} of the tolerance")
    return {"tensors": len(ratios), "worst": worst, "worst_err_over_tolerance": ratios[worst],
            "worst_five": dict(sorted(ratios.items(), key=lambda kv: -kv[1])[:5]),
            "tolerance": "1e-4 * max|g| + 1e-6 per tensor"}


# Launches of an RNA step at the recipe (None: at least one).  Kernel B
# sums the t2/t1 streams by center edge itself and the global message sums
# itself by node: the forward's kernel A launch is the el_dst sum alone (the
# unfolded forward adds its two gathered sums), and its two gradients are one
# gated backward: no row gather in the backward (none by t2_ji/t1_ji, eg_src
# or el_dst).
RNA_WANT = ({"sbf_modulate": 2, "triplet_aggregate": 1, "edge_message_sum": 1,
             "edge_message": None, "row_gather": None},
            {"sbf_modulate_backward": 2, "gated_sum_backward": 1, "row_gather": 0,
             "group_sum": None, "group_sum_split": None, "edge_message_backward": None})


def rna_train_phase(args, mols, gen, reset_counts, read_counts,
                    emit_line) -> tuple[list, dict, tuple]:
    """Phases 7 and 8: the kernel cases at the RNA training shapes and RNA
    training at the published recipe.  Returns (kernel cases by kernel,
    launches of the RNA training main path, (its loader, its resident batch
    of 8))."""
    import torch

    from pamnet_tpu_torch import main_rna_puzzles
    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.tu import TUDataset, write_tu_split
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.serve import RNAScoringService
    from pamnet_tpu_torch.train.loop import Optimizer, batch_loss, predict, train_step
    from pamnet_tpu_torch.train.schedules import constant
    from pamnet_tpu_torch.weights import load_reference_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bs, d, lr, kind = 8, 16, 1e-4, "smooth_l1"
    n_val = len(mols) // 4
    with tempfile.TemporaryDirectory() as tmp:
        # The structures go through the TU files, as RNA-Puzzles does.
        root = os.path.join(tmp, "data")
        write_tu_split(root, "train", mols[:-n_val])
        write_tu_split(root, "val", mols[-n_val:])
        train_mols = TUDataset(root, "train").molecules()
        val_mols = TUDataset(root, "val").molecules()

        t0 = time.perf_counter()
        loader = GraphLoader(train_mols, "rna", 2.6, 20.0, bs, shuffle=True, seed=args.seed,
                             build_perms=True)
        host_build_s = time.perf_counter() - t0
        gb = loader.collate(list(range(min(bs, len(train_mols))))).to("cuda")

        # ---- 7. every kernel of the path at the RNA batch-8 pads ----
        # Kernel B's backward, then each other wrapper a step launches, at the
        # shapes this batch gives it: the forward kernels on random data at
        # the pads, the backward ones on the batch's own index arrays.
        pd, flow = loader.pads, "target_to_source"
        i_key = "eg_src" if flow == "target_to_source" else "eg_dst"
        rand = {k: random_triplets(pd.el, rows, 7, gen) for k, rows in (("t2", pd.t2),
                                                                          ("t1", pd.t1))}
        cases = {
            "sbf_modulate_backward": [sbf_backward_case(gb, k, dd, gen, summed)
                                      for summed in (True, False) for dd in (16, 8)
                                      for k in ("t2", "t1")],
            "sbf_modulate": [
                kernel_b_case(f"{k} fused folded gather, "
                              f"{'summed' if summed else 'rows (identity groups)'}, batch",
                              pd.el, 7, d, gen, batch_triplets(gb, k), summed)
                for summed in (True, False) for k in ("t2", "t1")] + [
                kernel_b_case(f"{k} fused folded gather"
                              f"{', summed' if summed else ', rows (identity groups)'}", pd.el,
                              7, d, gen, rand[k], summed)
                for summed in (False, True) for k in ("t2", "t1")],
            "triplet_aggregate": [
                kernel_a_case(name, num_out, rows, d, False, False, gen)
                for name, num_out, rows in (
                    ("t2 sum (folded path)", pd.el, pd.t2), ("t1 sum (folded path)", pd.el, pd.t1),
                    ("el_dst edge->node sum", pd.n, pd.el), ("global edge->node sum", pd.n, pd.eg))],
            "edge_message": [
                edge_message_case("global message (gate, mask)", pd.n, pd.eg, d, True, True, gen),
                edge_message_case("local m_kj (gate)", pd.n, pd.el, d, True, False, gen),
                edge_message_case("local m_ji", pd.n, pd.el, d, False, False, gen)],
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
        emit_line({"phase": "rna_train_kernels", "pads": dataclasses.asdict(pd),
                   "valid": gb.valid, **cases,
                   "walk_shape_trials": walk_trials(gb, d, gen, ("eg_src", "eg_dst", "el_src"),
                                                    flow)})

        # ---- 8. training at the recipe ----
        kw = dict(dataset="RNA-Puzzles", dim=d, n_layer=1, cutoff_l=2.6, cutoff_g=20.0,
                  flow=flow)
        model = PAMNet(PAMNetConfig(**kw), torch.Generator().manual_seed(args.seed)).to("cuda")
        if not model.fold_sbf():
            raise AssertionError("the RNA recipe must train folded")
        unfolded = PAMNet(PAMNetConfig(**kw, fold_sbf=False)).to("cuda")
        unfolded.load_state_dict(model.state_dict())
        opt = Optimizer(model.parameters(), constant(lr))

        # The first step's gradients: the folded against the unfolded path,
        # then (with its loss and a repeated step bitwise) the kernels
        # against PyTorch's autograd of the plain versions.
        folded_vs_unfolded = _worst_gradient(
            _parameter_grads(model, lambda: batch_loss(model, gb, kind)),
            _parameter_grads(unfolded, lambda: batch_loss(unfolded, gb, kind)),
            "folded vs unfolded gradients")
        grad_checks = {"kernels_vs_plain": _step_checks(model, opt, None, gb, kind),
                       "folded_vs_unfolded": folded_vs_unfolded}

        want_fwd, want_bwd = RNA_WANT
        fwd, bwd = _step_launches(model, gb, kind, reset_counts, read_counts, want_fwd,
                                  want_bwd, "RNA")
        reset_counts()
        with torch.no_grad():
            batch_loss(unfolded, gb, kind)
        fwd_unfolded = read_counts()
        if fwd_unfolded["triplet_aggregate"] != 3:
            raise AssertionError(f"kernel A launches of the unfolded forward: {fwd_unfolded}")
        launches, epoch = _epoch(model, opt, None, loader, kind, reset_counts, read_counts,
                                 want_fwd, want_bwd, "RNA")
        step = lambda: train_step(model, opt, None, gb, kind)  # noqa: E731
        res = {
            "phase": "rna_train", "structures": len(train_mols), "val_structures": len(val_mols),
            "atoms": args.atoms, "batch_size": bs, "dim": d, "n_layer": 1, "lr": lr,
            "host_build_s": host_build_s, "pads": dataclasses.asdict(loader.pads),
            "resident_batch_valid": gb.valid, "gradient_checks": grad_checks,
            "bitwise_repeat": True, "launches_per_step_forward": fwd,
            "launches_per_step_backward": bwd, "launches_unfolded_forward": fwd_unfolded,
            **epoch, "main_path_launches": launches, **_step_numbers(step, gb.num_graphs)}
        emit_line(res)
        if args.profile:
            _profile_step(step, "profile_rna_train", res["ms_per_step"], emit_line)

        # main_rna_puzzles, in-process: three epochs straight, then two
        # epochs and a resume for the third, which must repeat it bit for bit.
        recipe = ["--dim", str(d), "--n_layer", "1", "--batch_size", str(bs), "--lr", str(lr),
                  "--seed", str(args.seed), "--data_root", root, "--device", "cuda",
                  "--host_geometry"]

        def drive(*extra):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                res = main_rna_puzzles.main([*recipe, *extra])
            lines = [ln for ln in out.getvalue().splitlines() if "Loss" in ln or "Resumed" in ln]
            return res, lines, time.perf_counter() - t0

        straight, lines_a, s_a = drive("--epochs", "3", "--save_dir", os.path.join(tmp, "a"))
        cut, lines_b, s_b = drive("--epochs", "2", "--save_dir", os.path.join(tmp, "b"))
        resumed, lines_c, s_c = drive("--epochs", "3", "--save_dir", os.path.join(tmp, "b"),
                                      "--resume", cut["last_path"])
        losses_ok = (len(straight["val_loss"]) == 3 and len(resumed["val_loss"]) == 1
                     and all(math.isfinite(v) for v in straight["train_loss"] + straight["val_loss"])
                     and straight["train_loss"][:2] == cut["train_loss"]
                     and straight["train_loss"][2] == resumed["train_loss"][0]
                     and straight["val_loss"][2] == resumed["val_loss"][0])
        best_a = load_reference_checkpoint(straight["best_path"])
        best_b = load_reference_checkpoint(resumed["best_path"])
        if not (losses_ok and best_a.keys() == best_b.keys()
                and all(torch.equal(best_a[k], best_b[k]) for k in best_a)):
            raise AssertionError(f"resume differs: {lines_a} against {lines_b} then {lines_c}")

        # The scoring service on the checkpoint that training wrote.
        cfg = PAMNetConfig(**{**kw, "dataset": "rna_serve"})
        service = RNAScoringService(best_b, cfg, batch_size=bs, device="cuda")
        scores = service.score_molecules(val_mols)
        trained = PAMNet(cfg)
        trained.load_state_dict(best_b, strict=True)
        want, _ = predict(trained.to("cuda"), GraphLoader(val_mols, "rna", 2.6, 20.0, bs), "cuda")
        served = compare("served vs predict", torch.from_numpy(scores), torch.from_numpy(want),
                         atol=5e-5, rtol=1e-4)
        emit_line({"phase": "main_rna_puzzles", "straight_s": s_a, "two_epochs_s": s_b,
                   "resume_s": s_c, "lines_straight": lines_a, "lines_resumed": lines_c,
                   "resume_bitwise": True, "best_val_loss": resumed["best_val_loss"],
                   "served_structures": len(val_mols),
                   "served_scores_head": [float(v) for v in scores[:4]],
                   "served_vs_predict": served})
    return cases, launches, (loader, gb)


def _step_checks(model, opt, ema, gb, kind: str) -> dict:
    """The first step's gradients through the kernels against PyTorch's
    autograd of the plain versions, per tensor within 1e-4 * max|g| + 1e-6,
    and its loss; then one step from the same state twice, bitwise equal."""
    import torch

    from pamnet_tpu_torch.train.loop import batch_loss, train_step

    check = _worst_gradient(
        _parameter_grads(model, lambda: batch_loss(model, gb, kind)),
        _parameter_grads(model, lambda: batch_loss(model, gb, kind, plain=True)),
        "kernel gradients off the plain route")
    with torch.no_grad():
        losses = [float(batch_loss(model, gb, kind, plain=p)) for p in (False, True)]
    check["loss"], check["plain_loss"] = losses
    compare("step loss vs plain", torch.tensor(losses[:1]), torch.tensor(losses[1:]),
            atol=1e-5, rtol=1e-4)
    _repeat_step_bitwise(model, opt, ema, gb, kind)
    return check


def _held(counts: dict, want: dict) -> bool:
    """Each count that ``want`` names is exact, or at least one where it
    names None; and not every group sum went by the split kernel."""
    return (all(counts[k] >= 1 if v is None else counts[k] == v for k, v in want.items())
            and ("group_sum" not in want or counts["group_sum"] > counts["group_sum_split"]))


def _step_launches(model, gb, kind: str, reset_counts, read_counts, want_fwd: dict,
                   want_bwd: dict, what: str) -> tuple[dict, dict]:
    """The launches of each wrapper in one step's forward and backward, held
    to ``want_fwd`` and ``want_bwd``."""
    import torch

    from pamnet_tpu_torch.train.loop import batch_loss

    model.zero_grad()
    reset_counts()
    loss = batch_loss(model, gb, kind)
    fwd = read_counts()
    reset_counts()
    loss.backward()
    torch.cuda.synchronize()
    bwd = read_counts()
    if not (_held(fwd, want_fwd) and _held(bwd, want_bwd)):
        raise AssertionError(f"{what} step launches: forward {fwd}, backward {bwd}")
    return fwd, bwd


def _epoch(model, opt, ema, loader, kind: str, reset_counts, read_counts, want_fwd: dict,
           want_bwd: dict, what: str) -> tuple[dict, dict]:
    """The training main path: one epoch of shuffled batches.  Every kernel
    that a step launches (``want_fwd``, ``want_bwd``) launched, and none that
    a step does not.  Returns (its launches, its numbers)."""
    import torch

    from pamnet_tpu_torch.train.loop import run_epoch

    want = {k: None for k in {**want_fwd, **want_bwd}
            if want_fwd.get(k, 0) != 0 or want_bwd.get(k, 0) != 0}
    want.update({k: 0 for k in {**want_fwd, **want_bwd} if k not in want})
    reset_counts()
    t0 = time.perf_counter()
    loss_sum, ng, losses, _ = run_epoch(model, opt, ema, loader, "cuda", kind)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = read_counts()
    if not _held(launches, want):
        raise AssertionError(f"the {what} training path skipped a kernel: {launches}")
    step_losses = [float(v) for v in torch.stack(losses).cpu()]
    if not all(math.isfinite(v) for v in step_losses):
        raise AssertionError(f"non-finite loss: {step_losses}")
    return launches, {"epoch_steps": len(losses), "epoch_s": epoch_s,
                      "epoch_graphs_per_s": ng / epoch_s, "epoch_train_loss": loss_sum / ng,
                      "step_losses": step_losses}


def _step_numbers(step, num_graphs: int) -> dict:
    """ms per step event-timed on a resident batch, the host's enqueue time,
    the profiler's device time, the card's idle share and peak memory."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(step, iters=10, warmup=2)
    dev = device_ms(step, iters=5)
    last = float(step())
    if not math.isfinite(last):
        raise AssertionError(f"non-finite loss after the timed steps: {last}")
    return {"ms_per_step": ms, "graphs_per_s": num_graphs / ms * 1e3,
            "enqueue_ms_per_step": enqueue_ms(step, iters=10), "device_ms_per_step": dev,
            "device_idle_share": None if dev is None else 1.0 - dev / ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "loss_after": last}


def _profile_step(step, name: str, step_ms: float, emit_line) -> None:
    """``--profile``: device time by kernel of three steps, every launch by
    name, the port's launches in order, the host's top rows and Python's own
    profile of the host side of three more steps."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    rows, host = profile_rows(prof, 3)
    dev = sum(r["device_ms_per_call"] for r in rows)
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    pr.disable()
    py_rows = sorted(pstats.Stats(pr).stats.items(), key=lambda kv: -kv[1][2])[:20]
    emit_line({"phase": name, "train_step_top": rows[:25], "device_ms_per_step_total": dev,
               **launch_totals(prof, 3, "step"),
               "device_idle_share_vs_event_ms": 1.0 - dev / step_ms,
               "port_kernel_launches": port_kernel_launches(prof, 3), "host_top": host,
               "python_self_top": [
                   {"function": f"{os.path.basename(k[0])}:{k[1]}:{k[2]}",
                    "self_ms_per_step": v[2] / 3 * 1e3, "calls_per_step": v[1] / 3}
                   for k, v in py_rows]})


def pdbbind_phase(args, gen, reset_counts, read_counts,
                  emit_line) -> tuple[dict, dict, tuple]:
    """Phases 9 and 10: every wrapper a PDBbind training step launches, on a
    batch of 32 realistic complexes (D=128), and PDBbind training at the
    README recipe.  Returns (kernel cases by kernel, launches of the PDBbind
    training main path, its loader, resident batch and complexes)."""
    import torch

    from pamnet_tpu_torch import main_pdbbind
    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule,
                                                 synthetic_pdbbind_complex_dataset)
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.loop import Optimizer, train_step
    from pamnet_tpu_torch.train.schedules import multistep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bs, d, n_layer, kind = 32, 128, 3, "mse"
    t0 = time.perf_counter()
    mols = [pdbbind_molecule(g)
            for g in synthetic_pdbbind_complex_dataset(args.pdbbind_complexes, seed=805)]
    loader = GraphLoader(mols, "pdbbind", 2.0, 6.0, bs, shuffle=True, seed=args.seed,
                         build_perms=True)
    host_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gb = loader.collate(list(range(bs)))
    collate_s = time.perf_counter() - t0
    gb = gb.to("cuda")

    # ---- 9. every wrapper of the step on the batch's own arrays ----
    pd = loader.pads
    cases = {
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
    emit_line({"phase": "pdbbind_kernels", "pads": dataclasses.asdict(pd), "valid": gb.valid,
               "longest": gb.longest, **cases,
               "walk_shape_trials": walk_trials(gb, d, gen, ("eg_dst", "eg_src", "el_src"),
                                                "source_to_target")})

    # ---- 10. training at the README recipe ----
    cfg = PAMNetConfig(dataset="PDBbind", dim=d, n_layer=n_layer, cutoff_l=2.0, cutoff_g=6.0)
    model = PAMNet(cfg, torch.Generator().manual_seed(args.seed)).to("cuda")
    opt = Optimizer(model.parameters(), multistep(1e-3, steps_per_epoch=len(loader)))
    checks = _step_checks(model, opt, None, gb, kind)
    want_fwd, want_bwd = _pdbbind_want(n_layer)
    fwd, bwd = _step_launches(model, gb, kind, reset_counts, read_counts, want_fwd, want_bwd,
                              "PDBbind")
    launches, epoch = _epoch(model, opt, None, loader, kind, reset_counts, read_counts,
                             want_fwd, want_bwd, "PDBbind")
    step = lambda: train_step(model, opt, None, gb, kind)  # noqa: E731
    res = {"phase": "pdbbind_train", "complexes": len(mols), "batch_size": bs, "dim": d,
           "n_layer": n_layer, "lr": 1e-3, "host_build_s": host_build_s,
           "collate_s": collate_s, "pads": dataclasses.asdict(pd),
           "resident_batch_valid": gb.valid, "longest": gb.longest,
           "gradient_check": checks, "bitwise_repeat": True,
           "launches_per_step_forward": fwd, "launches_per_step_backward": bwd,
           **epoch, "main_path_launches": launches, **_step_numbers(step, gb.num_graphs)}
    emit_line(res)
    if args.profile:
        _profile_step(step, "profile_pdbbind_train", res["ms_per_step"], emit_line)

    # main_pdbbind, in-process, one epoch at its own defaults.
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), tempfile.TemporaryDirectory() as tmp:
        res = main_pdbbind.main(["--synthetic", "48", "--epochs", "1", "--device", "cuda",
                                 "--host_geometry", "--save_dir", tmp])
    text = out.getvalue()
    quads = re.findall(r"(Train|Test) (RMSE|MAE|SD|P): (\S+?),? ", text)
    finals = re.findall(r"Testing (RMSE|MAE|SD|P): (\S+)", text)
    if (len(quads) != 8 or len(finals) != 4
            or not all(math.isfinite(float(v)) for *_, v in quads + finals)):
        raise AssertionError(f"main_pdbbind output: {text}")
    emit_line({"phase": "main_pdbbind", "seconds": time.perf_counter() - t0,
               "lines": [ln for ln in text.splitlines() if "RMSE" in ln or "Testing" in ln
                         or "Data loaded" in ln], "test": list(res["test"])})
    return cases, launches, (loader, gb, mols)


@contextlib.contextmanager
def _builders(which: str):
    """Run the host graph build on ``which`` builders: "numpy" (the plain
    versions everywhere), "native" (the C++ library everywhere) or
    "dispatch" (the library above its thresholds, as the loaders run)."""
    from pamnet_tpu_torch.data import native

    saved = native.NATIVE_MIN_NODES, native.NATIVE_MIN_EDGES
    if which != "dispatch":
        limit = sys.maxsize if which == "numpy" else -1
        native.NATIVE_MIN_NODES = native.NATIVE_MIN_EDGES = limit
    try:
        yield
    finally:
        native.NATIVE_MIN_NODES, native.NATIVE_MIN_EDGES = saved


def _timed_host_build(mols, kind: str, cutoff_l: float, cutoff_g: float, bs: int,
                      builders: str, perms: bool) -> tuple[list, dict]:
    """(structures, seconds by part): the structures' neighbour search,
    edge sort, triplets, pairs and distances, the f64 basis, the batches'
    collation and, with ``perms``, their collation with the backward's CSR
    permutations."""
    from pamnet_tpu_torch.config import atom_type_count
    from pamnet_tpu_torch.data.batch import attach_basis, collate_structures, precompute_structure

    parts: dict = {}
    t0 = time.perf_counter()
    with _builders(builders):
        structs = [precompute_structure(m, kind, cutoff_l, cutoff_g, timings=parts)
                   for m in mols]
    parts["structures"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for st in structs:
        attach_basis(st, cutoff_l)
    parts["f64_basis"] = time.perf_counter() - t0
    chunks = [structs[i:i + bs] for i in range(0, len(structs), bs)]
    t0 = time.perf_counter()
    for c in chunks:
        collate_structures(c)
    parts["collation"] = time.perf_counter() - t0
    if perms:
        t0 = time.perf_counter()
        for c in chunks:
            collate_structures(c, build_perms=True, num_atom_types=atom_type_count(kind))
        parts["collation_with_perms"] = time.perf_counter() - t0
    return structs, parts


def _same_structures(a: list, b: list) -> bool:
    return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in ("eg", "el")) and all(
        np.array_equal(x[t][k], y[t][k]) for x, y in zip(a, b) for t in ("t2", "t1")
        for k in x[t])


def _batches_equal(a, b) -> bool:
    """Every field of two ``GraphBatch``es equal, tensors bit for bit."""
    import torch

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            if not (x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)):
                return False
        elif f.name == "perms":
            if x.keys() != y.keys() or not all(torch.equal(x[k], y[k]) for k in x):
                return False
        elif x != y:
            return False
    return True


def _collation_split(structs, bs: int, pads, **kw) -> dict:
    """Collation of ``structs`` in batches of ``bs`` at ``pads``, numpy
    against the collate plan in turns (numpy, plan, plan, numpy): seconds of
    each by field (the concatenated fields, the CSR offsets, the backward's
    arrays, the tensors) and in all, each batch bit for bit equal."""
    from pamnet_tpu_torch.data.batch import CollatePlan, collate_structures

    chunks = [list(range(i, min(i + bs, len(structs)))) for i in range(0, len(structs), bs)]
    t0 = time.perf_counter()
    plan = CollatePlan(structs)
    res = {"batches": len(chunks), "plan_build_s": time.perf_counter() - t0}
    for run, route in enumerate(("numpy", "plan", "plan", "numpy")):
        parts: dict = {}
        t0 = time.perf_counter()
        out = [collate_structures(None, pads, plan=plan, idxs=c, timings=parts, **kw)
               if route == "plan" else
               collate_structures([structs[i] for i in c], pads, timings=parts, **kw)
               for c in chunks]
        total = time.perf_counter() - t0
        key = f"{route}_{'first' if run < 2 else 'second'}"
        res[key] = {"s": total, "by_field_s": parts}
        if run == 0:
            want = out
        elif not all(_batches_equal(g, w) for g, w in zip(out, want)):
            raise AssertionError(f"plan and numpy collation differ ({kw})")
    res["bit_equal"] = True
    return res


def _loader_uses_plan(mols) -> dict:
    """A ``GraphLoader``'s batches come from the plan: the native
    concatenations run 15 times a batch (the integer fields), and the
    batches equal the numpy collation of the same molecules."""
    from pamnet_tpu_torch.config import atom_type_count
    from pamnet_tpu_torch.data import native
    from pamnet_tpu_torch.data.batch import collate_structures
    from pamnet_tpu_torch.data.loader import GraphLoader

    calls = [0]
    real = native.concat_offset_i32

    def counted(*a):
        calls[0] += 1
        return real(*a)

    loader = GraphLoader(mols, "qm9", 5.0, 5.0, 32, shuffle=True, seed=1, drop_last=True,
                         build_perms=True, wire_geometry="derive", precompute_basis=False)
    native.concat_offset_i32 = counted
    try:
        batches = list(loader)
    finally:
        native.concat_offset_i32 = real
    again = GraphLoader(mols, "qm9", 5.0, 5.0, 32, shuffle=True, seed=1, drop_last=True,
                        build_perms=True, wire_geometry="derive", precompute_basis=False)
    same = all(_batches_equal(b, collate_structures(
        [again.structs[i] for i in idxs], again.pads, build_perms=True,
        num_atom_types=atom_type_count("qm9"), wire_geometry="derive"))
        for idxs, b in zip(again.batches(), batches))
    if calls[0] != 15 * len(batches) or not same:
        raise AssertionError(f"loader batches not from the plan: {calls[0]} native calls "
                             f"for {len(batches)} batches, equal to numpy: {same}")
    return {"batches": len(batches), "native_int_concats": calls[0], "bit_equal": True}


def host_build_phase(args, mols, service, emit_line) -> None:
    """Phase 3b, host_build: where the host's time goes, with the numpy
    builders and with the native ones (``data/native.py``), on the scoring
    batch and on the QM9 epoch wall's 4,608 molecules; the two builders'
    edge lists and triplet tables bit for bit equal; and the service call
    on each."""
    import torch

    from pamnet_tpu_torch.data import native
    from pamnet_tpu_torch.data.graphbuild import knn_graph, knn_graph_np
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset

    t0 = time.perf_counter()
    native.library()
    lib_s = time.perf_counter() - t0
    cfg = service.cfg
    res: dict = {"phase": "host_build", "native_library_s": lib_s}
    # The scoring batch: knn(50) over 2,100 atoms and triplets over
    # ~25k local edges a structure, above the thresholds.
    scoring: dict = {"structures": len(mols)}
    built = {}
    for which in ("numpy", "dispatch"):
        built[which], scoring[which] = _timed_host_build(mols, "rna", cfg.cutoff_l, cfg.cutoff_g,
                                                         16, which, perms=False)
    if not _same_structures(built["numpy"], built["dispatch"]):
        raise AssertionError("native and numpy structures differ on the scoring batch")
    built["dispatch_scoring"] = built["dispatch"]
    knn_same = all(np.array_equal(knn_graph(m["pos"], 50), knn_graph_np(m["pos"], 50))
                   for m in mols[:2])
    if not knn_same:
        raise AssertionError("native and numpy knn differ")
    # The service call, host build included, on each builder.
    for which in ("numpy", "dispatch"):
        with _builders(which):
            t0 = time.perf_counter()
            loader = GraphLoader(mols, "rna", cfg.cutoff_l, cfg.cutoff_g, batch_size=16,
                                 ladder_pads=True)
            next(iter(loader))
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            service.score_molecules(mols)
            torch.cuda.synchronize()
            scoring[which].update(host_build_s=build_s, service_call_s=time.perf_counter() - t0)
    res["scoring"] = scoring
    # The QM9 epoch wall's molecules (bench.py: 4,096 + 512, seed 481):
    # ~18 atoms each, under the thresholds, so the loaders run numpy; the
    # native builders forced on every molecule show the call's cost there.
    qmols = synthetic_qm9_dataset(4608, seed=481)
    qm9: dict = {"molecules": len(qmols)}
    for which in ("dispatch", "native"):
        built[which], qm9[which] = _timed_host_build(qmols, "qm9", 5.0, 5.0, 32, which,
                                                     perms=True)
    if not _same_structures(built["dispatch"], built["native"]):
        raise AssertionError("native and numpy structures differ on QM9")
    res["qm9_epoch_wall"] = qm9
    # Collation by field, numpy against the collate plan: the QM9 recipe's
    # training batches (32 molecules, with the backward's arrays, at the
    # loader's worst-case pads) derived (main_qm9's default) and with host
    # geometry, and the scoring batch (16 structures, host geometry).
    from pamnet_tpu_torch.data.batch import PadSizes, structure_counts

    qs = built["dispatch"]
    worst = np.sort(np.array([structure_counts(st) for st in qs]), axis=0)[-32:].sum(axis=0)
    pads = PadSizes.for_counts(*(int(c) for c in worst), 32)
    train_kw = dict(build_perms=True, num_atom_types=5)
    res["collation"] = {
        "qm9_train_derive": _collation_split(qs, 32, pads, wire_geometry="derive", **train_kw),
        "qm9_train_host": _collation_split(qs, 32, pads, **train_kw),
        "scoring": _collation_split(built["dispatch_scoring"], 16, None),
        "loader": _loader_uses_plan(qmols[:512]),
        "qm9_pads": dataclasses.asdict(pads),
    }
    res["bit_equal"] = True
    emit_line(res)


def _kernel_launches_per_step(step) -> dict:
    """Every kernel launch of one step and its device ms, by the profiler
    over three steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    totals = kernel_totals(prof.key_averages(), 3)
    return {"kernel_launches_per_step": totals["kernel_launches"],
            "profile_device_ms_per_step": totals["device_ms"]}


def _syncs(fn) -> int:
    """Host syncs in one call of ``fn``: CUDA's synchronizing operations
    that ``torch.cuda.set_sync_debug_mode("warn")`` reports (and not the
    mode's own warning, once a process, that it is a prototype)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def _against_host(model, host_model, gb, gb_host, kind: str, make_opt, use_ema: bool,
                  rtol: float, atol: float) -> dict:
    """``model`` on ``gb`` against ``host_model`` on the host-geometry batch
    of the same molecules, from the same parameters: the predictions and
    the loss within ``rtol``/``atol``, and the parameters after one step of
    a fresh optimizer within rtol 5e-3, atol 5e-4 (the JAX package's
    f32-geometry tolerance, tests/test_wire_geometry.py:75-107)."""
    import torch

    from pamnet_tpu_torch.train.ema import ema_init
    from pamnet_tpu_torch.train.loop import train_step

    start = {k: v.clone() for k, v in model.state_dict().items()}
    host_model.load_state_dict(start)
    with torch.no_grad():
        preds = {"host": host_model(gb_host), "card": model(gb)}
    pred = compare("predictions vs host geometry", preds["card"], preds["host"], atol=atol,
                   rtol=rtol)
    out = {}
    for name, m, b in (("host", host_model, gb_host), ("card", model, gb)):
        m.load_state_dict(start)
        loss = float(train_step(m, make_opt(m), ema_init(m.state_dict()) if use_ema else None,
                                b, kind))
        out[name] = (loss, {k: v.clone() for k, v in m.state_dict().items()})
    model.load_state_dict(start)
    (loss_h, after_h), (loss_c, after_c) = out["host"], out["card"]
    if not abs(loss_c - loss_h) <= atol + rtol * abs(loss_h):
        raise AssertionError(f"step loss {loss_c} against the host step's {loss_h}")
    worst = 0.0
    for k, v in after_h.items():
        if not torch.allclose(after_c[k], v, rtol=5e-3, atol=5e-4):
            raise AssertionError(f"{k} after one step differs from the host step's")
        worst = max(worst, float((after_c[k] - v).abs().max()))
    moved = max(float((after_c[k] - start[k]).abs().max()) for k in start)
    if not moved > 0.0:
        raise AssertionError("the comparison step moved no parameter")
    return {"predictions": pred, "loss": loss_c, "host_loss": loss_h,
            "params_after_step_max_abs_diff": worst, "params_moved_max": moved,
            "tolerance": f"predictions and loss atol {atol} + rtol {rtol}; parameters "
                         "after one step rtol 5e-3, atol 5e-4"}


def _card_geometry_step(what: str, model, host_model, gb, gb_host, loader, kind: str,
                        make_opt, opt, ema, want_fwd: dict, want_bwd: dict, rtol: float,
                        atol: float, extra_syncs: int, reset_counts,
                        read_counts) -> tuple[dict, dict]:
    """The checks and numbers of a step whose geometry (or graph) the card
    computes: its gradients against the plain route of the same batch and a
    repeated step bitwise (``_step_checks``), the host-geometry step of the
    same molecules (``_against_host``), the same kernel launches as the
    host step, an epoch, and beside the host step's own: ms per step,
    device ms, the card's idle share, every kernel launch and the host
    syncs of a step, exactly ``extra_syncs`` more than the host step's.
    Returns (its numbers, the epoch's launches)."""
    from pamnet_tpu_torch.train.loop import train_step

    use_ema = ema is not None
    checks = _step_checks(model, opt, ema, gb, kind)
    host = _against_host(model, host_model, gb, gb_host, kind, make_opt, use_ema, rtol, atol)
    fwd, bwd = _step_launches(model, gb, kind, reset_counts, read_counts, want_fwd, want_bwd,
                              what)
    launches, epoch = _epoch(model, opt, ema, loader, kind, reset_counts, read_counts,
                             want_fwd, want_bwd, what)
    host_model.load_state_dict(model.state_dict())
    host_opt = make_opt(host_model)
    steps = {"card": lambda: train_step(model, opt, ema, gb, kind),
             "host": lambda: train_step(host_model, host_opt, ema, gb_host, kind)}
    numbers = {}
    for name in ("card", "host", "card"):  # in turns; the second card reading is kept
        numbers[name] = {**_step_numbers(steps[name], gb.num_graphs),
                         **_kernel_launches_per_step(steps[name]),
                         "syncs_per_step": _syncs(steps[name])}
    if numbers["card"]["syncs_per_step"] != numbers["host"]["syncs_per_step"] + extra_syncs:
        raise AssertionError(f"{what}: host syncs a step {numbers}")
    return {"gradient_check": checks, "against_host_geometry": host, "bitwise_repeat": True,
            "launches_per_step_forward": fwd, "launches_per_step_backward": bwd, **epoch,
            "main_path_launches": launches, **numbers["card"], "host_geometry_step": numbers["host"]}, launches


def _add_counts(*counts: dict) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


QM9_WANT = (
    {"triplet_aggregate": 18, "edge_message_sum": 6, "edge_message": None, "row_gather": None},
    {"triplet_aggregate_grad_ab": 12, "gated_sum_backward": 6, "row_gather": 0,
     "gather_product": 0, "triplet_aggregate_grad_a": 0, "group_sum": None,
     "group_sum_split": None, "edge_message_backward": None})
RNA_WANT = (
    {"sbf_modulate": 2, "triplet_aggregate": 1, "edge_message_sum": 1, "edge_message": None,
     "row_gather": None},
    {"sbf_modulate_backward": 2, "gated_sum_backward": 1, "row_gather": 0, "group_sum": None,
     "group_sum_split": None, "edge_message_backward": None})


def _qm9_recipe(args, cfg, loader):
    """A QM9 recipe model, its optimizer and EMA, and the fresh optimizer of
    a comparison step (constant lr 1e-4, the recipe's peak, clip 1000)."""
    import torch

    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.ema import ema_init
    from pamnet_tpu_torch.train.loop import Optimizer
    from pamnet_tpu_torch.train.schedules import constant, warmup_exponential

    model = PAMNet(cfg, torch.Generator().manual_seed(args.seed)).to("cuda")
    opt = Optimizer(model.parameters(),
                    warmup_exponential(1e-4, len(loader),
                                       frac_steps_per_epoch=len(loader.structs) / 32),
                    clip_norm=1000.0)

    def make_opt(m):
        return Optimizer(m.parameters(), constant(1e-4), clip_norm=1000.0)

    return model, opt, ema_init(model.state_dict()), make_opt


def derive_phase(args, rna_mols, reset_counts, read_counts, emit_line) -> dict:
    """Phase 12, derive_train: the QM9 recipe step (full PAMNet, dim 128, 6
    layers, batch 32, f32, TF32 off) and the RNA recipe step (dim 16, 1
    layer, batch 8, folded: kernel B forward and backward on a radial table
    computed on the card) on derive batches, which carry positions and
    integer tables only.  Returns the launches of their epochs."""
    import torch

    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.loop import Optimizer
    from pamnet_tpu_torch.train.schedules import constant

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res: dict = {"phase": "derive_train"}
    qmols = synthetic_qm9_dataset(args.qm9_molecules, seed=args.seed)
    loaders = {}
    for geometry in ("host", "derive"):
        t0 = time.perf_counter()
        loaders[geometry] = GraphLoader(qmols, "qm9", 5.0, 5.0, 32, shuffle=True,
                                        seed=args.seed, drop_last=True, build_perms=True,
                                        wire_geometry=geometry)
        res[f"qm9_{geometry}_host_build_s"] = time.perf_counter() - t0
    gb_h = loaders["host"].collate(list(range(32))).to("cuda")
    gb = loaders["derive"].collate(list(range(32))).to("cuda")
    if gb.sbf_radial is not None or gb.dist_g is not None:
        raise AssertionError("a derive batch carries float geometry")
    cfg = PAMNetConfig(dataset="QM9", dim=128, n_layer=6, cutoff_l=5.0, cutoff_g=5.0)
    model, opt, ema, make_opt = _qm9_recipe(args, cfg, loaders["derive"])
    res["qm9"], qm9_launches = _card_geometry_step(
        "QM9 derive", model, PAMNet(cfg).to("cuda"), gb, gb_h, loaders["derive"], "l1",
        make_opt, opt, ema, *QM9_WANT, 1e-4, 1e-5, 0, reset_counts, read_counts)

    bs = 8
    train_mols = rna_mols[:args.rna_structures - args.rna_structures // 4]
    rloaders = {g: GraphLoader(train_mols, "rna", 2.6, 20.0, bs, shuffle=True, seed=args.seed,
                               build_perms=True, wire_geometry=g) for g in ("host", "derive")}
    first = list(range(min(bs, len(train_mols))))
    rgb_h = rloaders["host"].collate(first).to("cuda")
    rgb = rloaders["derive"].collate(first).to("cuda")
    rcfg = PAMNetConfig(dataset="RNA-Puzzles", dim=16, n_layer=1, cutoff_l=2.6,
                        cutoff_g=20.0, flow="target_to_source")
    rmodel = PAMNet(rcfg, torch.Generator().manual_seed(args.seed)).to("cuda")
    if not rmodel.fold_sbf():
        raise AssertionError("the RNA recipe must train folded")

    def rna_opt(m):
        return Optimizer(m.parameters(), constant(1e-4))

    res["rna"], rna_launches = _card_geometry_step(
        "RNA derive", rmodel, PAMNet(rcfg).to("cuda"), rgb, rgb_h, rloaders["derive"],
        "smooth_l1", rna_opt, rna_opt(rmodel), None, *RNA_WANT, 1e-4, 1e-5, 0,
        reset_counts, read_counts)
    res["rna"]["pads"] = dataclasses.asdict(rloaders["derive"].pads)
    emit_line(res)
    return _add_counts(qm9_launches, rna_launches)


def _rebuilt_equals_host(rebuilt, host) -> dict:
    """Every integer field, mask, CSR, permutation, valid count and longest
    group of the batch rebuilt on the card against the host batch."""
    import torch

    from pamnet_tpu_torch.data.batch import GEOMETRY_FIELDS

    bad = []
    for f in dataclasses.fields(host):
        a, b = getattr(host, f.name), getattr(rebuilt, f.name)
        if f.name in GEOMETRY_FIELDS:
            continue
        if isinstance(a, torch.Tensor):
            if b is None or a.dtype != b.dtype or not torch.equal(a, b):
                bad.append(f.name)
        elif f.name == "perms":
            bad += [k for k in a if k not in b or not torch.equal(a[k], b[k])]
        elif a != b:
            bad.append(f.name)
    if bad:
        raise AssertionError(f"the graph rebuilt on the card differs from the host's: {bad}")
    return {"fields_equal": True, "valid": rebuilt.valid, "perms": sorted(rebuilt.perms)}


def device_graph_phase(args, reset_counts, read_counts, emit_line) -> dict:
    """Phase 13, device_graph_train: the QM9 recipe step with the graph
    rebuilt from the positions on the card in every forward
    (``device_graph=True``); a PDBbind forward on the smoke batch (32
    realistic complexes at the worst-case pads of 64) rebuilt alike; and
    ``main_qm9 --device_graph`` in-process.  Returns the QM9 epoch's
    launches."""
    import torch

    from pamnet_tpu_torch import main_qm9
    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule,
                                                 synthetic_pdbbind_complex_dataset,
                                                 synthetic_qm9_dataset)
    from pamnet_tpu_torch.models.device_graph import rebuild_structure
    from pamnet_tpu_torch.models.pamnet import PAMNet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res: dict = {"phase": "device_graph_train"}
    qmols = synthetic_qm9_dataset(args.qm9_molecules, seed=args.seed)
    loaders = {g: GraphLoader(qmols, "qm9", 5.0, 5.0, 32, shuffle=True, seed=args.seed,
                              drop_last=True, build_perms=True, wire_geometry=g)
               for g in ("host", "derive")}
    gb_h = loaders["host"].collate(list(range(32))).to("cuda")
    gb = loaders["derive"].collate(list(range(32))).to("cuda")
    cfg = PAMNetConfig(dataset="QM9", dim=128, n_layer=6, cutoff_l=5.0, cutoff_g=5.0,
                       device_graph=True)
    rebuilt = rebuild_structure(gb, cfg)  # also the first launch of each kernel
    res["qm9_rebuild"] = {**_rebuilt_equals_host(rebuilt, gb_h),
                          "syncs": _syncs(lambda: rebuild_structure(gb, cfg)),
                          "ms": time_ms(lambda: rebuild_structure(gb, cfg), iters=10),
                          "device_ms": device_ms(lambda: rebuild_structure(gb, cfg), iters=5)}
    if res["qm9_rebuild"]["syncs"] != 1:
        raise AssertionError(f"the rebuild's host syncs: {res['qm9_rebuild']}")
    model, opt, ema, make_opt = _qm9_recipe(args, cfg, loaders["derive"])
    host_model = PAMNet(dataclasses.replace(cfg, device_graph=False)).to("cuda")
    res["qm9"], launches = _card_geometry_step(
        "QM9 device_graph", model, host_model, gb, gb_h, loaders["derive"], "l1", make_opt,
        opt, ema, *QM9_WANT, 2e-4, 2e-5, 1, reset_counts, read_counts)

    # PDBbind: the smoke batch's complexes, forward only (the candidate sets
    # are O(N^2) in nodes: ~0.6 GB of squared distances at n 12,032).
    mols = [pdbbind_molecule(g)
            for g in synthetic_pdbbind_complex_dataset(args.pdbbind_complexes, seed=805)]
    ploaders = {g: GraphLoader(mols, "pdbbind", 2.0, 6.0, 32, shuffle=True, seed=args.seed,
                               build_perms=True, wire_geometry=g) for g in ("host", "derive")}
    pgb_h = ploaders["host"].collate(list(range(32))).to("cuda")
    pgb = ploaders["derive"].collate(list(range(32))).to("cuda")
    pcfg = PAMNetConfig(dataset="PDBbind", dim=128, n_layer=3, cutoff_l=2.0, cutoff_g=6.0,
                        device_graph=True)
    pmodel = PAMNet(pcfg, torch.Generator().manual_seed(args.seed)).to("cuda")
    phost = PAMNet(dataclasses.replace(pcfg, device_graph=False)).to("cuda")
    phost.load_state_dict(pmodel.state_dict())
    torch.cuda.reset_peak_memory_stats()
    rebuilt = rebuild_structure(pgb, pcfg)
    rebuild_peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        want, got = phost(pgb_h), pmodel(pgb)
        plain = pmodel(pgb, plain=True)
    res["pdbbind"] = {
        "pads": dataclasses.asdict(ploaders["derive"].pads), "rebuild": {
            **_rebuilt_equals_host(rebuilt, pgb_h),
            "syncs": _syncs(lambda: rebuild_structure(pgb, pcfg)),
            "ms": time_ms(lambda: rebuild_structure(pgb, pcfg), iters=5, warmup=1),
            "peak_mem_gb": rebuild_peak},
        "forward_vs_host": compare("PDBbind device_graph forward vs host", got, want,
                                   atol=2e-5, rtol=2e-4),
        "forward_vs_plain": compare("PDBbind device_graph forward vs plain", got, plain,
                                    atol=2e-5, rtol=2e-4)}

    if res["pdbbind"]["rebuild"]["syncs"] != 1:
        raise AssertionError(f"the PDBbind rebuild's host syncs: {res['pdbbind']['rebuild']}")

    # main_qm9 --device_graph, in-process, one epoch at the recipe.
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), tempfile.TemporaryDirectory() as tmp:
        main_qm9.main(["--synthetic", "--limit", "320", "--epochs", "1", "--device_graph",
                       "--seed", str(args.seed), "--device", "cuda", "--save_dir", tmp])
    text = out.getvalue()
    maes = re.findall(r"(Train|Val|Test) MAE: (\S+?),? ", text)
    maes += re.findall(r"(Best Validation|Testing) MAE: (\S+)", text)
    if len(maes) != 5 or not all(math.isfinite(float(v)) for _, v in maes):
        raise AssertionError(f"main_qm9 --device_graph output: {text}")
    res["main_qm9_device_graph"] = {"seconds": time.perf_counter() - t0,
                                    "lines": [ln for ln in text.splitlines() if "MAE" in ln]}
    emit_line(res)
    return launches


def _repeat_step_bitwise(model, opt, ema, gb, kind: str) -> None:
    """One step from the same state twice: the loss, the parameters and the
    EMA bitwise equal; the state is put back after."""
    import torch

    from pamnet_tpu_torch.train.loop import train_step

    params = list(model.parameters())
    snap = ([p.detach().clone() for p in params], opt.state_dict(),
            None if ema is None else {k: v.clone() for k, v in ema.items()})
    runs = []
    for _ in range(2):
        with torch.no_grad():
            torch._foreach_copy_(params, snap[0])
        opt.load_state_dict(snap[1])
        if ema is not None:
            torch._foreach_copy_(list(ema.values()), list(snap[2].values()))
        loss = train_step(model, opt, ema, gb, kind)
        runs.append([loss] + [p.detach().clone() for p in params]
                    + ([] if ema is None else [v.clone() for v in ema.values()]))
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("a repeated step is not bitwise equal")
    with torch.no_grad():
        torch._foreach_copy_(params, snap[0])
    opt.load_state_dict(snap[1])
    if ema is not None:
        torch._foreach_copy_(list(ema.values()), list(snap[2].values()))


def _pdbbind_want(n_layer: int) -> tuple[dict, dict]:
    """Launches of a PDBbind step (None: at least one).  Unfolded at dim
    128: per layer kernel A's t2 and t1 sums and the gated el_dst sum, the
    global message summed by node, the two local messages (``edge_message``
    counts the summed call too); the radial table gathered at t2 and t1
    once; no embedding gather (the features go through init_linear), no
    kernel B.  Backward: the fused role swap 2 a layer, the gated backward
    1, no row gather, and no split group sum (no CSR of z; the global CSR's
    longest group is short)."""
    return ({"triplet_aggregate": 3 * n_layer, "edge_message_sum": n_layer,
             "edge_message": 3 * n_layer, "row_gather": 2, "sbf_modulate": 0},
            {"triplet_aggregate_grad_ab": 2 * n_layer, "gated_sum_backward": n_layer,
             "row_gather": 0, "group_sum_split": 0, "gather_product": 0,
             "triplet_aggregate_grad_a": 0, "sbf_modulate_backward": 0,
             "group_sum": None, "edge_message_backward": None})


def _pool_terms(model, gb, plain: bool = False):
    """((G, 2) float32, (G,) predictions): each graph's sum of the fused
    per-node energies over the atoms its pool adds (column 0) and over those
    it subtracts (column 1: PDBbind's pocket and ligand copies, x > 40 A; none
    elsewhere), fused from the layers' heads (read by forward hooks) as
    ``PAMNet.forward`` fuses them; RNA's mean pool divides both by the
    graph's atoms.  PDBbind's prediction is the difference of two near-equal
    sums; each column is a sum without that cancellation.  Raises where
    column 0 - column 1 is not the model's prediction."""
    import torch
    from torch.nn import functional as F

    heads = []
    hooks = [m.register_forward_hook(lambda _m, _i, out: heads.append(out[1:]))
             for pair in zip(model.global_layer, model.local_layer) for m in pair]
    try:
        pred = model(gb, plain=plain)
    finally:
        for h in hooks:
            h.remove()
    pairs = list(zip(heads[::2], heads[1::2]))  # (global, local) of each layer
    outs = torch.stack([torch.cat([hg[0], hl[0]], 1) for hg, hl in pairs]).float()
    att = torch.softmax(F.leaky_relu(
        torch.stack([torch.cat([hg[1], hl[1]], 1) for hg, hl in pairs]).float(), 0.2), dim=-1)
    node = (outs * att).sum(-1).sum(0) * gb.node_mask
    minus = gb.pos[:, 0] > 40.0
    if model.cfg.dataset_kind != "pdbbind":
        minus = torch.zeros_like(minus)
    cols = torch.stack([torch.where(minus, 0.0, node), torch.where(minus, node, 0.0)], 1)
    terms = cols.new_zeros((pred.shape[0], 2)).index_add_(0, gb.node_graph.long(), cols)
    if model.cfg.dataset_kind == "rna":
        atoms = torch.zeros_like(pred).index_add_(0, gb.node_graph.long(), gb.node_mask.float())
        terms = terms / atoms.clamp_min(1.0)[:, None]
    terms = terms * gb.graph_mask[:, None]
    if not bool(((terms[:, 0] - terms[:, 1] - pred).abs()
                 <= 1e-5 * float(terms.abs().max()) + 1e-6).all()):
        raise AssertionError("the pool's terms do not add up to the predictions")
    return terms, pred


def _moved_positions(gb, seed: int):
    """``gb`` with every position moved by up to 4 float32 ulps (seeded) and
    its geometry left to the step to derive from them: a float32 step moves
    by its rounding (~1e-7 relative), a bfloat16 one by its rounding noise."""
    import torch

    gen = torch.Generator(device=gb.pos.device).manual_seed(seed)
    ulps = torch.randint(-4, 5, gb.pos.shape, generator=gen, device=gb.pos.device)
    return dataclasses.replace(gb, pos=gb.pos * (1.0 + ulps * 2.0 ** -23), dist_g=None,
                               dist_l=None, sbf_radial=None, cbf1=None, cbf2=None)


def _plain_swaps(model16, gb, kind: str, grads: tuple, names: list[str]) -> dict:
    """The kernel route with one family of kernels at a time replaced by its
    plain version (``triplet_aggregate``: kernel A's sums, its fused role swap
    and gated backward; ``edge_message``: the messages, their sums by node and
    their backward with its group sums; ``row_gather``: the radial table's and
    the embedding's gathers), against ``grads`` = (kernel route, plain
    bfloat16 route, plain float32 route) on the batch, and the plain bfloat16
    route run again (its ``index_add_`` sums in no fixed order): max|difference|
    per tensor of ``names``."""
    import pamnet_tpu_torch.models.layers as layers
    import pamnet_tpu_torch.models.pamnet as pamnet
    from pamnet_tpu_torch.ops.gather import edge_message_plain, row_gather_plain
    from pamnet_tpu_torch.ops.triplet import triplet_aggregate_plain
    from pamnet_tpu_torch.train.loop import batch_loss

    g16, p16, p32 = grads

    def diff(a, b):
        return {n: float((a[n] - b[n]).abs().max()) for n in names}

    plain = {
        "triplet_aggregate": [(layers, lambda a, off, idx=None, b=None, total=None, grad=None:
                               triplet_aggregate_plain(a, off, idx, b))],
        "edge_message": [(layers, lambda *a, i_groups=None, j_groups=None, out_groups=None:
                          edge_message_plain(*a, None if out_groups is None
                                             else out_groups.off))],
        "row_gather": [(m, lambda src, idx, groups=None, valid=None:
                        row_gather_plain(src, idx, valid)) for m in (layers, pamnet)],
    }
    swaps = {}
    for name, where in plain.items():
        kept = [getattr(m, name) for m, _ in where]
        for m, fn in where:
            setattr(m, name, fn)
        try:
            g = _parameter_grads(model16, lambda: batch_loss(model16, gb, kind))
        finally:
            for (m, _), fn in zip(where, kept):
                setattr(m, name, fn)
        swaps[name] = {"vs_kernel_route": diff(g, g16), "vs_plain": diff(g, p16),
                       "vs_f32": diff(g, p32)}
    again = _parameter_grads(model16, lambda: batch_loss(model16, gb, kind, plain=True))
    return {"tensors": names, "swaps": swaps, "plain_route_again_vs_plain": diff(again, p16)}


def _route_grads(model16, model32, batch, kind: str) -> tuple[dict, dict, dict]:
    """(kernel route, plain bfloat16 route, plain float32 route) parameter
    gradients of the loss on ``batch``."""
    from pamnet_tpu_torch.train.loop import batch_loss

    return (_parameter_grads(model16, lambda: batch_loss(model16, batch, kind)),
            _parameter_grads(model16, lambda: batch_loss(model16, batch, kind, plain=True)),
            _parameter_grads(model32, lambda: batch_loss(model32, batch, kind, plain=True)))


def _tensor_ratios(g16: dict, p16: dict, p32: dict) -> dict:
    """Per tensor, max|g16 - p16| over its limit: 2e-2 * max|p16| + 1e-6 or
    twice max|p16 - p32|, whichever is larger."""
    return {n: float((g16[n] - w).abs().max())
            / max(2e-2 * float(w.abs().max()) + 1e-6, 2 * float((w - p32[n]).abs().max()))
            for n, w in p16.items()}


def _relative_distance(a: dict, b: dict) -> float:
    """|a - b| over every tensor as one vector, relative to |b|."""
    num = sum(float(((a[n] - v).double() ** 2).sum()) for n, v in b.items())
    return math.sqrt(num / sum(float((v.double() ** 2).sum()) for v in b.values()))


def _gradient_rule(model16, model32, batch, kind: str, what: str) -> dict:
    """The bfloat16 kernel route's parameter gradients against the plain
    bfloat16 route's on ``batch``, per tensor within 2e-2 * max|g_plain| +
    1e-6 or twice the tensor's distance between the plain bfloat16 and
    float32 routes (``_tensor_ratios``); raises beyond it."""
    g16, p16, p32 = _route_grads(model16, model32, batch, kind)
    ratios = _tensor_ratios(g16, p16, p32)
    worst = max(ratios, key=ratios.get)
    res = {"tensors": len(ratios), "worst": worst, "worst_err_over_tolerance": ratios[worst],
           "worst_five": dict(sorted(ratios.items(), key=lambda kv: -kv[1])[:5]),
           "heads_biases": {n: r for n, r in ratios.items() if n.endswith("W_out.bias")},
           "tolerance": "per tensor 2e-2 * max|g_plain_bf16| + 1e-6, or twice the tensor's "
                        "distance between the bf16 and f32 plain routes",
           "whole_gradient_relative_distance": {
               "kernel_vs_plain": _relative_distance(g16, p16),
               "kernel_vs_f32": _relative_distance(g16, p32),
               "plain_vs_f32": _relative_distance(p16, p32)}}
    if not ratios[worst] <= 1.0:
        raise AssertionError(f"{what}: {worst} at {ratios[worst]} of the tolerance: {res}")
    return res


def _signed_batch_gradients(model16, model32, gb, kind: str, what: str) -> dict:
    """PDBbind's signed batch, whose pool subtracts copies of the same atoms:
    the kernel route's whole gradient (every tensor as one vector) within
    2e-2 of the plain bfloat16 route's, or twice that route's distance from
    the float32 route; raises beyond it.  Reported beside it: the per-tensor
    ratios of ``_tensor_ratios`` and, for the worst five and the heads'
    biases, what rounding alone moves (``_moved_positions``: the batch with
    its positions moved by a few ulps, and ``_plain_swaps``)."""
    runs = [_route_grads(model16, model32, b, kind)
            for b in (gb, _moved_positions(gb, 1), _moved_positions(gb, 2))]
    g16, p16, p32 = runs[0]
    ratios = _tensor_ratios(g16, p16, p32)
    worst_five = dict(sorted(ratios.items(), key=lambda kv: -kv[1])[:5])
    shown = list(worst_five) + [n for n in ratios
                                if n.endswith("W_out.bias") and n not in worst_five]

    def diff(a, b):
        return {n: float((a[n] - b[n]).abs().max()) for n in shown}

    vector = {"kernel_vs_plain": _relative_distance(g16, p16),
              "kernel_vs_f32": _relative_distance(g16, p32),
              "plain_vs_f32": _relative_distance(p16, p32)}
    res = {"whole_gradient_relative_distance": vector,
           "tolerance": "kernel_vs_plain <= max(2e-2, twice plain_vs_f32)",
           "per_tensor_worst_five": worst_five,
           "per_tensor_heads_biases": {n: ratios[n] for n in shown
                                       if n.endswith("W_out.bias")},
           "distances": [{"kernel_vs_plain": diff(a, b), "plain_vs_f32": diff(b, c),
                          "kernel_vs_batch": diff(a, g16), "plain_vs_batch": diff(b, p16),
                          "f32_vs_batch": diff(c, p32)} for a, b, c in runs],
           "plain_swaps": _plain_swaps(model16, gb, kind, runs[0], shown)}
    if not vector["kernel_vs_plain"] <= max(2e-2, 2 * vector["plain_vs_f32"]):
        raise AssertionError(f"{what}: the signed batch's gradient: {res}")
    return res


def _bf16_step(what: str, kind: str, model32, model16, opt16, ema16, make_opt, gb, loader,
               want: tuple[dict, dict], reset_counts, read_counts,
               grad_batch=None) -> tuple[dict, dict]:
    """The checks and numbers of the bfloat16 step of ``model16`` (the
    weights of ``model32``, a float32 model of the same recipe): its
    parameter gradients through the kernels against PyTorch's autograd of
    the plain route in bfloat16, per tensor (``_gradient_rule``) on
    ``grad_batch``, by default ``gb``; PDBbind passes the same complexes with
    their three copies as graphs of their own, where the pool cancels
    nothing, and ``gb``'s own gradient is checked as a whole
    (``_signed_batch_gradients``); its loss within 1e-2 of the plain
    route's; the pool's terms (``_pool_terms``: the predictions, and for
    PDBbind each of the two sums its signed pool subtracts) within 1e-2 *
    max of the plain route's and 3e-2 * max of the float32 step's; a
    repeated step bitwise; ten steps on the batch with a finite loss that
    falls; the launches of every port kernel in a step equal to the float32
    step's; an epoch (the main path); and beside the float32 step's, in
    turns: ms per step, enqueue ms, device ms, idle share, every kernel
    launch and peak memory.  Returns (its numbers, the epoch's launches)."""
    import torch

    from pamnet_tpu_torch.train.loop import batch_loss, train_step

    model16.load_state_dict(model32.state_dict())
    grad_check = _gradient_rule(model16, model32, grad_batch or gb, kind, what)
    if grad_batch is not None:
        grad_check["signed_batch"] = _signed_batch_gradients(model16, model32, gb, kind, what)
    with torch.no_grad():
        (terms, pred), (terms_plain, _), (terms32, _) = (
            _pool_terms(model16, gb), _pool_terms(model16, gb, plain=True),
            _pool_terms(model32, gb))
        losses = [float(batch_loss(model16, gb, kind, plain=p)) for p in (False, True)]
    if pred.dtype != torch.float32:
        raise AssertionError(f"{what}: predictions in {pred.dtype}")
    terms_check = {"kernel_vs_plain": float((terms - terms_plain).abs().max()),
                   "kernel_vs_f32": float((terms - terms32).abs().max()),
                   "plain_vs_f32": float((terms_plain - terms32).abs().max()),
                   "max_plain": float(terms_plain.abs().max()),
                   "max_f32": float(terms32.abs().max()),
                   "signed_predictions_kernel_vs_f32": float(
                       (terms[:, 0] - terms[:, 1] - terms32[:, 0] + terms32[:, 1]).abs().max()),
                   "signed_predictions_max_f32": float((terms32[:, 0] - terms32[:, 1]).abs().max())}
    if not (terms_check["kernel_vs_plain"] <= 1e-2 * terms_check["max_plain"]
            and terms_check["kernel_vs_f32"] <= 3e-2 * terms_check["max_f32"]):
        raise AssertionError(f"{what}: the pool's terms {terms_check}")
    if not abs(losses[0] - losses[1]) <= 1e-2 * max(abs(v) for v in losses):
        raise AssertionError(f"{what}: loss {losses[0]} against the plain route's {losses[1]}")
    _repeat_step_bitwise(model16, opt16, ema16, gb, kind)
    start = {k: v.clone() for k, v in model16.state_dict().items()}
    opt = make_opt(model16)
    falls = [float(train_step(model16, opt, None, gb, kind)) for _ in range(10)]
    model16.load_state_dict(start)
    if not (all(math.isfinite(v) for v in falls) and falls[-1] < falls[0]):
        raise AssertionError(f"{what}: ten steps' losses {falls}")
    fwd, bwd = _step_launches(model16, gb, kind, reset_counts, read_counts, *want, what)
    fwd32, bwd32 = _step_launches(model32, gb, kind, reset_counts, read_counts, *want,
                                  what + " (f32)")
    if (fwd, bwd) != (fwd32, bwd32):
        raise AssertionError(f"{what}: launches {fwd}, {bwd} against the f32 step's "
                             f"{fwd32}, {bwd32}")
    launches, epoch = _epoch(model16, opt16, ema16, loader, kind, reset_counts, read_counts,
                             *want, what)
    model32.load_state_dict(model16.state_dict())
    opt32 = make_opt(model32)
    steps = {"bf16": lambda: train_step(model16, opt16, ema16, gb, kind),
             "f32": lambda: train_step(model32, opt32, None, gb, kind)}
    numbers = {}
    for name in ("bf16", "f32", "bf16"):  # in turns; the second bf16 reading is kept
        numbers[name] = {**_step_numbers(steps[name], gb.num_graphs),
                         **_kernel_launches_per_step(steps[name])}
    return {"gradient_check": grad_check, "loss": losses[0], "plain_loss": losses[1],
            "cast_parameters": _cast_cost(model16), "pool_terms": terms_check,
            "pool_terms_tolerance": "1e-2 * max of the plain route's, 3e-2 * max of the f32 "
                                    "step's",
            "bitwise_repeat": True, "ten_step_losses": falls,
            "launches_per_step_forward": fwd, "launches_per_step_backward": bwd,
            "launches_equal_f32_step": True, **epoch, "main_path_launches": launches,
            **numbers["bf16"], "f32_step": numbers["f32"]}, launches


def _cast_cost(model) -> dict:
    """The batched parameter cast of a bfloat16 step on its own
    (``nn.cast_parameters`` over the parameters the stack reads, which a
    bfloat16 forward of ``model`` has listed: the flat buffer's cat, cast and
    views, the views' lookups at their uses, and the backward's cast of the
    gradients back): host enqueue ms, event-timed ms and device ms of one
    forward and backward, beside a cast of each parameter on its own."""
    import torch

    from pamnet_tpu_torch.nn import as_dtype, cast_parameters

    params = model._stack_params
    grads = [torch.ones_like(p, dtype=torch.bfloat16) for p in params]

    def cast():
        with cast_parameters(params, torch.bfloat16):
            casts = [as_dtype(p, torch.bfloat16) for p in params]
        torch.autograd.backward(casts, grads)

    def per_use():  # a cast of each parameter and its backward, for comparison
        torch.autograd.backward([p.to(torch.bfloat16) for p in params], grads)

    res = {"tensors": len(params)}
    for name, fn in (("batched", cast), ("per_tensor", per_use)):
        res[name] = {"enqueue_ms": enqueue_ms(fn, iters=20), "ms": time_ms(fn, iters=20),
                     "device_ms": device_ms(fn, iters=5)}
    model.zero_grad()
    return res


def _pdbbind_copies(mol: dict) -> list[dict]:
    """A PDBbind graph's three subgraphs as graphs of their own, each where
    the signed pool adds (x <= 40 A): the complex, the pocket shifted back by
    100 A and the ligand by 200 A (exact: the shifts keep every difference of
    positions, so every distance and angle, bit for bit)."""
    x = mol["pos"][:, 0]
    out = []
    for sel, shift in ((x <= 40.0, 0.0), ((x > 40.0) & (x <= 140.0), 100.0),
                       (x > 140.0, 200.0)):
        pos = mol["pos"][sel].copy()
        pos[:, 0] -= shift
        out.append(dict(pos=pos, feat=mol["feat"][sel], y=mol["y"]))
    return out


def bf16_phase(args, gen, qm9_data: tuple, pdbbind_data: tuple, reset_counts, read_counts,
               emit_line) -> tuple[dict, dict, dict]:
    """Phases 14-16: bf16_kernels, every kernel with a bfloat16 version
    against its plain bfloat16 version within one ulp (``bf16_tolerance``)
    at the QM9 recipe's batch (D=128; the radial table at D=42) and at the
    PDBbind batch, the resident batches of the float32 training phases
    (``qm9_data``, ``pdbbind_data``: their loaders and batches, and the
    PDBbind complexes, whose copies ``_bf16_step`` checks per tensor); then
    qm9_bf16_train (the QM9 recipe in bfloat16: full PAMNet, dim 128, 6
    layers, batch 32, L1, Adam + clip 1000 + EMA 0.999, warmup-exponential)
    and pdbbind_bf16_train (the README recipe in bfloat16: dim 128, 3
    layers, batch 32, MSE, Adam, multistep), each checked by ``_bf16_step``
    beside its float32 step.  Returns (kernel cases by kernel, launches of
    the QM9 and of the PDBbind bfloat16 main paths)."""
    import torch

    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.loop import Optimizer, train_step
    from pamnet_tpu_torch.train.schedules import constant, multistep

    bf16, d = torch.bfloat16, 128
    (qloader, qgb), (ploader, pgb, pmols) = qm9_data, pdbbind_data
    # The resident batch's complexes with their three copies as graphs of
    # their own: the same atoms, edges and triplets, a pool without signs.
    copies = [c for m in pmols[:32] for c in _pdbbind_copies(m)]
    cgb = GraphLoader(copies, "pdbbind", 2.0, 6.0, len(copies), build_perms=True).collate(
        list(range(len(copies)))).to("cuda")

    # ---- 14. every bfloat16 kernel against its plain bfloat16 version ----
    def on_both(make):
        """``make(batch)``'s cases on the QM9 batch, then on the PDBbind one."""
        return [dict(case, batch=name) for name, batch in (("QM9", qgb), ("PDBbind", pgb))
                for case in make(batch)]

    cases = {
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
    emit_line({"phase": "bf16_kernels", "qm9_pads": dataclasses.asdict(qloader.pads),
               "pdbbind_pads": dataclasses.asdict(ploader.pads), "qm9_valid": qgb.valid,
               "pdbbind_valid": pgb.valid, "tolerance": BF16_RULE, **cases})

    # ---- 15. QM9 training at the recipe in bfloat16, beside float32 ----
    launches = {}
    recipe = dict(dataset="QM9", dim=d, n_layer=6, cutoff_l=5.0, cutoff_g=5.0)
    model32, _, _, _ = _qm9_recipe(args, PAMNetConfig(**recipe), qloader)
    model16, opt16, ema16, _ = _qm9_recipe(
        args, PAMNetConfig(**recipe, compute_dtype="bfloat16"), qloader)
    res, launches["qm9"] = _bf16_step(
        "QM9 bf16", "l1", model32, model16, opt16, ema16,
        lambda m: Optimizer(m.parameters(), constant(1e-3), clip_norm=1000.0), qgb, qloader,
        QM9_WANT, reset_counts, read_counts)
    emit_line({"phase": "qm9_bf16_train", "molecules": len(qloader.structs), "batch_size": 32,
               "dim": d, "n_layer": 6, "compute_dtype": "bfloat16",
               "resident_batch_valid": qgb.valid, **res})
    if args.profile:
        _profile_step(lambda: train_step(model16, opt16, ema16, qgb, "l1"),
                      "profile_qm9_bf16_train", res["ms_per_step"], emit_line)

    # ---- 16. PDBbind training at the README recipe in bfloat16 ----
    n_layer = 3
    recipe = dict(dataset="PDBbind", dim=d, n_layer=n_layer, cutoff_l=2.0, cutoff_g=6.0)
    model32 = PAMNet(PAMNetConfig(**recipe), torch.Generator().manual_seed(args.seed)).to("cuda")
    model16 = PAMNet(PAMNetConfig(**recipe, compute_dtype="bfloat16")).to("cuda")
    opt16 = Optimizer(model16.parameters(), multistep(1e-3, steps_per_epoch=len(ploader)))
    res, launches["pdbbind"] = _bf16_step(
        "PDBbind bf16", "mse", model32, model16, opt16, None,
        lambda m: Optimizer(m.parameters(), constant(1e-3)), pgb, ploader,
        _pdbbind_want(n_layer), reset_counts, read_counts, grad_batch=cgb)
    emit_line({"phase": "pdbbind_bf16_train", "complexes": len(ploader.structs),
               "batch_size": 32, "dim": d, "n_layer": n_layer, "compute_dtype": "bfloat16",
               "resident_batch_valid": pgb.valid, "longest": pgb.longest,
               "copies_batch_valid": cgb.valid, **res})
    if args.profile:
        _profile_step(lambda: train_step(model16, opt16, None, pgb, "mse"),
                      "profile_pdbbind_bf16_train", res["ms_per_step"], emit_line)
    return cases, launches["qm9"], launches["pdbbind"]


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


def sbf_bf16_phase(gen, scoring_gb, rna_gb, emit_line) -> dict:
    """Phase 17, sbf_bf16_kernels: kernel B forward and backward in bfloat16
    on the t2 and t1 arrays of the scoring batch (``scoring_gb``, with the
    backward's permutations), of the RNA training batch of 8 (``rna_gb``)
    and of the scoring batch with every triplet on edge 0 (``_cached_triplets``),
    summed by center edge: each within one bfloat16 ulp of its plain
    bfloat16 version, bitwise repeatable, timed (event and device) with its
    bound at 2 bytes a value and the float32 kernel's time on the same values
    beside it.  The backward walks each neighbour edge's triplets with one
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
    emit_line({"phase": "sbf_bf16_kernels", "tolerance": BF16_RULE,
               "scoring_valid": scoring_gb.valid, "rna_train_valid": rna_gb.valid, **cases})
    return cases


def _kernel_b_dtypes(fn) -> dict:
    """The operand types kernel B's forward and backward kernels were
    launched on (their ``m_neighbor``) during ``fn()``, read by wrapping the
    operand check that each launch makes (``ops/sbf_modulate.py``
    ``_check_operands``) for the call."""
    from pamnet_tpu_torch.ops import sbf_modulate as sm

    seen = {"sbf_modulate": set(), "sbf_modulate_backward": set()}
    orig = sm._check_operands

    def check(what, proj, m_neighbor, *a, **k):
        seen[what].add(str(m_neighbor.dtype))
        return orig(what, proj, m_neighbor, *a, **k)

    sm._check_operands = check
    try:
        fn()
    finally:
        sm._check_operands = orig
    return {"forward": sorted(seen["sbf_modulate"]),
            "backward": sorted(seen["sbf_modulate_backward"])}


def rna_bf16_phase(args, scoring_mols, scoring_gb, rna_data: tuple, reset_counts, read_counts,
                   emit_line) -> dict:
    """Phase 18, rna_bf16: the published RNA model (dim 16, 1 layer) in
    bfloat16, folded through kernel B's bfloat16 version, beside the float32
    model of the same weights, in turns.  On the resident scoring batch: the
    scores within 1e-2 * max|score| of the plain bfloat16 route and 3e-2 *
    max|score| of float32, kernel B launched 2 a layer as in float32, ms and
    device ms a batch in both types.  On the RNA training batch of 8 at the
    recipe (SmoothL1, Adam, lr 1e-4): ``_bf16_step`` (gradients per tensor
    against the plain bfloat16 route, the pool's terms, a repeated step
    bitwise, ten steps, the float32 step's launches, an epoch, ms per step,
    device ms and idle share beside float32).  Then the entry points in
    bfloat16: ``main_rna_puzzles --compute_dtype bfloat16`` in-process for
    one epoch on TU files of the scoring structures (12 train, 4 validate)
    and the scoring service (``serve --compute_dtype bfloat16``'s
    ``RNAScoringService`` behind ``make_server``) answering a JSON request as
    it scores directly, kernel B's forward and backward seen running on
    bfloat16 operands (``_kernel_b_dtypes``).  Returns the epoch's launches."""
    import torch

    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.loop import Optimizer
    from pamnet_tpu_torch.train.schedules import constant

    loader, gb = rna_data
    kw = dict(dataset="RNA-Puzzles", dim=16, n_layer=1, cutoff_l=2.6, cutoff_g=20.0,
              flow="target_to_source")
    model32 = PAMNet(PAMNetConfig(**kw), torch.Generator().manual_seed(args.seed)).to("cuda")
    model16 = PAMNet(PAMNetConfig(**kw, compute_dtype="bfloat16")).to("cuda")
    model16.load_state_dict(model32.state_dict())
    if not (model16.fold_sbf() and model32.fold_sbf()):
        raise AssertionError("the RNA model must fold in bfloat16 as in float32")
    ng = scoring_gb.num_graphs
    models = {"bf16": model16, "f32": model32}
    with torch.inference_mode():
        s16, s16_plain, s32 = (model16(scoring_gb)[:ng], model16(scoring_gb, plain=True)[:ng],
                               model32(scoring_gb)[:ng])
        torch.cuda.synchronize()
        if s16.dtype != torch.float32:
            raise AssertionError(f"bf16 scores in {s16.dtype}")
        scores = {"kernel_vs_plain": float((s16 - s16_plain).abs().max()),
                  "kernel_vs_f32": float((s16 - s32).abs().max()),
                  "max_plain": float(s16_plain.abs().max()), "max_f32": float(s32.abs().max()),
                  "tolerance": "1e-2 * max|plain bf16|, 3e-2 * max|f32|"}
        if not (scores["kernel_vs_plain"] <= 1e-2 * scores["max_plain"]
                and scores["kernel_vs_f32"] <= 3e-2 * scores["max_f32"]):
            raise AssertionError(f"RNA bf16 scores {scores}")
        forward = {}
        for name in ("bf16", "f32"):
            reset_counts()
            models[name](scoring_gb)
            forward[name] = read_counts()
        if forward["bf16"] != forward["f32"] or forward["bf16"]["sbf_modulate"] != 2:
            raise AssertionError(f"scoring forward launches {forward}")
        scoring = {}
        for name in ("bf16", "f32", "bf16"):  # in turns; the second bf16 reading is kept
            fn = lambda m=models[name]: m(scoring_gb)  # noqa: E731
            ms = time_ms(fn, iters=10)
            dev = device_ms(fn, iters=5)
            scoring[name] = {"ms_per_batch": ms, "graphs_per_s": ng / ms * 1e3,
                             "device_ms_per_batch": dev,
                             "device_idle_share": None if dev is None else 1.0 - dev / ms}
    opt16 = Optimizer(model16.parameters(), constant(1e-4))
    res, launches = _bf16_step(
        "RNA bf16", "smooth_l1", model32, model16, opt16, None,
        lambda m: Optimizer(m.parameters(), constant(1e-3)), gb, loader, RNA_WANT,
        reset_counts, read_counts)

    # The entry points in bfloat16.
    from pamnet_tpu_torch import main_rna_puzzles
    from pamnet_tpu_torch.data.tu import write_tu_split
    from pamnet_tpu_torch.serve import RNAScoringService, make_server

    entry = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        write_tu_split(root, "train", scoring_mols[:12])
        write_tu_split(root, "val", scoring_mols[12:16])
        out = {}

        def train():
            with contextlib.redirect_stdout(io.StringIO()):
                out.update(main_rna_puzzles.main([
                    "--dim", "16", "--n_layer", "1", "--batch_size", "8", "--lr", "1e-4",
                    "--epochs", "1", "--seed", str(args.seed), "--data_root", root,
                    "--device", "cuda", "--compute_dtype", "bfloat16",
                    "--save_dir", os.path.join(tmp, "save")]))

        reset_counts()
        t0 = time.perf_counter()
        dtypes = _kernel_b_dtypes(train)
        counts = read_counts()
        losses = out["train_loss"] + out["val_loss"]
        if not (dtypes == {"forward": ["torch.bfloat16"], "backward": ["torch.bfloat16"]}
                and counts["sbf_modulate_backward"] >= 2
                and all(math.isfinite(v) for v in losses)):
            raise AssertionError(f"main_rna_puzzles bf16: {dtypes}, {counts}, {losses}")
        entry["main_rna_puzzles"] = {"seconds": time.perf_counter() - t0,
                                     "kernel_b_dtypes": dtypes, "losses": losses,
                                     "sbf_modulate": counts["sbf_modulate"],
                                     "sbf_modulate_backward": counts["sbf_modulate_backward"]}
    service = RNAScoringService(model16.state_dict(), model16.cfg, batch_size=16, device="cuda")
    server = make_server(service, "127.0.0.1", 0, "the rna_bf16 model")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        body = json.dumps({"molecules": [
            {"name": f"s{i}", "z": m["z"].tolist(), "pos": m["pos"].tolist()}
            for i, m in enumerate(scoring_mols[:2])]}).encode()
        served = {}

        def ask():
            served.update(_check_names(post(
                f"http://127.0.0.1:{server.server_address[1]}/score", body,
                "application/json"), ["s0", "s1"]))

        dtypes = _kernel_b_dtypes(ask)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    direct = service.score_molecules(scoring_mols[:2])
    if dtypes["forward"] != ["torch.bfloat16"]:
        raise AssertionError(f"served bf16 forward ran on {dtypes}")
    entry["serve"] = {"kernel_b_dtypes": dtypes,
                      **compare("served bf16 vs direct", torch.tensor(served["scores"]),
                                torch.from_numpy(direct), atol=5e-5, rtol=1e-4)}
    emit_line({"phase": "rna_bf16", "dim": 16, "n_layer": 1, "compute_dtype": "bfloat16",
               "folded": True, "scoring_structures": ng, "scoring_scores": scores,
               "scoring_launches_per_batch": forward["bf16"], "scoring": scoring["bf16"],
               "scoring_f32": scoring["f32"], "train_structures": len(loader.structs),
               "batch_size": 8, "resident_batch_valid": gb.valid, **res,
               "entry_points": entry})
    return launches


def _dtoh_copies(fn) -> tuple[int, int]:
    """(device-to-host, host-to-device) memory copies that the profiler
    records in one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return (sum(ev.count for ev in events if "DtoH" in ev.key),
            sum(ev.count for ev in events if "HtoD" in ev.key))


def rna_csv_phase(args, mols, state: dict, reset_counts, read_counts, emit_line) -> dict:
    """Phase 19, rna_csv: ``python -m pamnet_tpu_torch.inference_rna_puzzles``
    in-process on the card, in float32 and bfloat16, on TU files written from
    the scoring phase's structures (with file names) and the scoring model's
    weights exported as a reference ``.pt``: the CSV's header, tags and
    puzzle number; the scores against ``RNAScoringService.score_molecules``
    on the structures read back from those files (float32 within 5e-5 + 1e-4
    |score|; bfloat16 within 1e-2 * max|score| of the bfloat16 service and
    3e-2 * max|score| of the float32 CSV); one device-to-host copy a run (the
    scores, fetched once), from the run's profile (its card activity only);
    every forward kernel launched; seconds per structure (under that
    profile).  Returns the launches of the two runs."""
    import torch

    from pamnet_tpu_torch import inference_rna_puzzles
    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.data.tu import TUDataset, write_tu_split
    from pamnet_tpu_torch.serve import RNAScoringService
    from pamnet_tpu_torch.train.checkpoint import export_state_dict

    dataset, bs = "rna_p21", 8
    res, total, csv = {"dataset": dataset, "structures": len(mols), "batch_size": bs}, {}, {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        write_tu_split(root, dataset, [dict(m, name=f"{dataset}_candidate_{i}.pdb")
                                       for i, m in enumerate(mols)])
        export_state_dict(state, os.path.join(tmp, "save", "model.pt"))
        structures = TUDataset(root, dataset).molecules()
        os.chdir(tmp)
        try:
            for dtype in ("float32", "bfloat16"):
                argv = ["--dataset", dataset, "--batch_size", str(bs), "--saved_model",
                        "model.pt", "--data_root", root, "--compute_dtype", dtype]

                out = {}

                def run(argv=argv):
                    with contextlib.redirect_stdout(io.StringIO()):
                        out.update(inference_rna_puzzles.main(argv))

                reset_counts()
                t0 = time.perf_counter()
                dtoh, htod = _dtoh_copies(run)
                wall = time.perf_counter() - t0
                launches = read_counts()
                with open(out["csv"]) as f:
                    lines = f.read().splitlines()
                rows = [ln.split(",") for ln in lines[1:]]
                want_tags = [f"{dataset}_candidate_{i}" for i in range(len(mols))]
                if (lines[0] != "PAMNet,tag,puzzle_number" or [r[1] for r in rows] != want_tags
                        or {r[2] for r in rows} != {"21"}):
                    raise AssertionError(f"rna_csv {dtype}: CSV {lines[:3]}")
                got = torch.tensor([float(r[0]) for r in rows], dtype=torch.float64)
                cfg = PAMNetConfig(dataset=dataset, dim=16, n_layer=1, cutoff_l=2.6,
                                   cutoff_g=20.0, flow="target_to_source", compute_dtype=dtype)
                serial = _serial_scores(structures, state, cfg, bs)
                if not np.array_equal(got.float().numpy(), serial):
                    raise AssertionError(f"rna_csv {dtype}: the pipelined scores {got[:4]} differ "
                                         f"from the serial loop's {serial[:4]}")
                service = RNAScoringService(state, cfg, batch_size=bs, device="cuda")
                want = torch.from_numpy(service.score_molecules(structures)).double()
                csv[dtype] = got
                if dtype == "float32":
                    check = compare("rna_csv vs service", got, want, atol=5e-5, rtol=1e-4)
                else:
                    check = {"vs_service": float((got - want).abs().max()),
                             "vs_f32_csv": float((got - csv["float32"]).abs().max()),
                             "max_service": float(want.abs().max()),
                             "max_f32_csv": float(csv["float32"].abs().max()),
                             "tolerance": "1e-2 * max|bf16 service|, 3e-2 * max|f32 CSV|"}
                    if not (check["vs_service"] <= 1e-2 * check["max_service"]
                            and check["vs_f32_csv"] <= 3e-2 * check["max_f32_csv"]):
                        raise AssertionError(f"rna_csv bf16 scores {check}")
                if dtoh != 1:
                    raise AssertionError(f"rna_csv {dtype}: {dtoh} device-to-host copies")
                if min(launches[k] for k in ("triplet_aggregate", "sbf_modulate", "edge_message",
                                             "edge_message_sum")) < 1:
                    raise AssertionError(f"rna_csv {dtype} skipped a kernel: {launches}")
                if launches["sbf_modulate"] != 2 * len(out["pads"]):
                    raise AssertionError(f"rna_csv {dtype}: kernel B launches {launches}")
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
                res[dtype] = {"check": check, "serial_loop_bitwise": True,
                              "batches": len(out["pads"]),
                              "pads": [dataclasses.asdict(p) for p in out["pads"]],
                              "scoring_s": out["seconds"], "wall_s": wall,
                              "s_per_structure": out["seconds"] / len(mols),
                              "wall_s_per_structure": wall / len(mols),
                              "device_to_host_copies": dtoh, "host_to_device_copies": htod,
                              "launches": launches, "scores_head": got[:4].tolist()}
        finally:
            os.chdir(cwd)
    emit_line({"phase": "rna_csv", **res})
    return total


def _serial_scores(structures: list[dict], state: dict, cfg, bs: int) -> np.ndarray:
    """The CSV driver's scores as its loop computed them before the epoch
    pipeline: each exact-pads batch collated and copied on the calling
    thread, one copy of the scores back."""
    import torch

    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.models.pamnet import PAMNet

    model = PAMNet(cfg)
    model.load_state_dict(state, strict=True)
    model = model.to("cuda").eval()
    loader = GraphLoader(structures, "rna", cfg.cutoff_l, cfg.cutoff_g, batch_size=bs,
                         ladder_pads="exact", num_spherical=cfg.num_spherical,
                         num_radial=cfg.num_radial, envelope_exponent=cfg.envelope_exponent)
    with torch.inference_mode():
        return torch.cat([model(gb.to("cuda"))[:gb.num_graphs] for gb in loader]).cpu().numpy()


@contextlib.contextmanager
def _fake_pyg():
    """``torch_geometric.data.data.Data`` as a plain class registered under
    PyG's module path (PyG is not installed), so ``torch.save`` pickles it
    by that name, as PyG's preprocessed artifacts name it."""
    names = ("torch_geometric", "torch_geometric.data", "torch_geometric.data.data")
    saved = {n: sys.modules.get(n) for n in names}
    for n in names:
        sys.modules[n] = type(sys)(n)
    data = type("Data", (), {"__init__": lambda self, **kw: self.__dict__.update(kw)})
    data.__module__, data.__qualname__ = names[-1], "Data"
    sys.modules[names[-1]].Data = data
    try:
        yield data
    finally:
        for n, old in saved.items():
            if old is None:
                del sys.modules[n]
            else:
                sys.modules[n] = old


def _write_qm9_artifact(path: str, mols: list[dict]) -> np.ndarray:
    """PyG's collated QM9 layout of ``mols`` (x float atom types, pos, the
    bonds with node ids offset by the nodes before each molecule, y (M, 19)
    with the label at target 7's column) and its slices; returns y."""
    import torch

    from pamnet_tpu_torch.data.qm9 import remap_target

    n = np.cumsum([0] + [len(m["z"]) for m in mols])
    e = np.cumsum([0] + [m["edge_index"].shape[1] for m in mols])
    y = np.random.default_rng(len(mols)).standard_normal((len(mols), 19)).astype(np.float32)
    y[:, remap_target(7)] = [m["y"] for m in mols]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with _fake_pyg() as data_cls:
        data = data_cls(
            x=torch.tensor(np.concatenate([m["z"] for m in mols]).astype(np.float32)),
            pos=torch.tensor(np.concatenate([m["pos"] for m in mols])),
            edge_index=torch.tensor(np.concatenate(
                [m["edge_index"] + n[i] for i, m in enumerate(mols)], axis=1)),
            y=torch.tensor(y))
        slices = {"x": torch.tensor(n), "pos": torch.tensor(n), "edge_index": torch.tensor(e),
                  "y": torch.arange(len(mols) + 1)}
        torch.save((data, slices), path)
    return y


def qm9_preprocessed_phase(args, emit_line) -> None:
    """Phase 21, qm9_preprocessed: a PyG-layout ``data_v2.pt`` of synthetic
    QM9 molecules under a temporary ``data/QM9/processed``: the molecules
    read back (``load_qm9_preprocessed``) bit for bit the source, then
    ``main_qm9`` without ``--synthetic`` at the recipe's width, from that
    artifact through ``load_qm9``, for one epoch on the card."""
    from pamnet_tpu_torch import main_qm9
    from pamnet_tpu_torch.data.qm9 import load_qm9_preprocessed
    from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset

    mols = synthetic_qm9_dataset(400, seed=args.seed + 7)
    res: dict = {"phase": "qm9_preprocessed", "molecules": len(mols)}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data", "QM9", "processed", "data_v2.pt")
        y = _write_qm9_artifact(path, mols)
        t0 = time.perf_counter()
        got = load_qm9_preprocessed(path)
        res["read_s"] = time.perf_counter() - t0
        same = len(got) == len(mols) and all(
            g[k].dtype == m[k].dtype and np.array_equal(g[k], m[k])
            for g, m in zip(got, mols) for k in ("z", "pos", "edge_index")) and all(
            np.array_equal(g["y"], yi.astype(np.float64)) for g, yi in zip(got, y))
        if not same:
            raise AssertionError("qm9_preprocessed: the molecules read back differ")
        res["bit_equal"] = True
        out = io.StringIO()
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                final = main_qm9.main(["--limit", "320", "--epochs", "1", "--seed",
                                       str(args.seed), "--device", "cuda",
                                       "--save_dir", os.path.join(tmp, "save")])
            res["main_qm9_s"] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        text = out.getvalue()
        cached = os.path.isfile(os.path.join(tmp, "data", "QM9", "processed",
                                             "qm9_pamnet_tpu_torch.npz"))
    maes = re.findall(r"(Train|Val|Test) MAE: (\S+?),? ", text)
    if ("Data loaded! train=256 val=32 test=32" not in text or len(maes) != 3
            or not all(math.isfinite(float(v)) for _, v in maes)
            or not math.isfinite(final["test_mae"]) or not cached):
        raise AssertionError(f"main_qm9 from the artifact: {text}")
    res["lines"] = [ln for ln in text.splitlines() if "MAE" in ln or "Data loaded" in ln]
    emit_line(res)


def _dp_rank(rank: int, world: int, init_method: str, job: dict) -> None:
    """Phase 22 (b), one of two ranks on the one card over gloo: three
    data-parallel steps of the QM9 recipe on pairs of batches (rank r takes
    batch r of each pair), then the step timed on the first pair; the first
    step's summed gradients, the losses, parameters and EMA, and ms per
    step to ``<out>/rank<r>.pt``."""
    import torch

    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.parallel import init_dp, teardown
    from pamnet_tpu_torch.train.ema import ema_init
    from pamnet_tpu_torch.train.loop import Optimizer, dp_train_step
    from pamnet_tpu_torch.train.schedules import constant

    dev = init_dp(world, rank, "cuda:0", backend="gloo", init_method=init_method)
    try:
        model = PAMNet(PAMNetConfig(**job["cfg"]),
                       torch.Generator().manual_seed(job["seed"])).to(dev)
        opt = Optimizer(model.parameters(), constant(1e-4), clip_norm=1000.0)
        ema = ema_init(model.state_dict())
        mine = [(pair[rank].to(dev), sum(b.num_graphs for b in pair)) for pair in job["pairs"]]
        losses, grads = [], None
        for gb, count in mine:
            losses.append(float(dp_train_step(model, opt, ema, gb, "l1", count)))
            if grads is None:  # the clip at 1000 leaves the summed gradients as they are
                grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        gb, count = mine[0]
        t0 = time.perf_counter()
        for _ in range(5):
            dp_train_step(model, opt, ema, gb, "l1", count)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        torch.save({"losses": losses, "grads": grads, "ms_per_step": ms,
                    "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
                    "ema": {k: v.cpu() for k, v in ema.items()}},
                   os.path.join(job["out"], f"rank{rank}.pt"))
    finally:
        teardown()


def dp_phase(args, qm9_data: tuple, train_launches: dict, reset_counts, read_counts,
             emit_line) -> dict:
    """Phase 22, dp: data parallelism at the QM9 recipe (dim 128, 6 layers,
    batch 32, L1, Adam + clip 1000 + EMA 0.999, constant lr 1e-4).
    (a) One rank over NCCL, float32 and bfloat16: three ``dp_train_step``s
    give the parameters, EMA and losses of three ``train_step``s bit for
    bit; the float32 run is this slice's main path (every kernel the QM9
    step launches must launch); ms per step of both in turns and launches a
    step.  (b) Two ranks sharing the one card over gloo (spawned), float32,
    three steps on pairs of batches: the replicas bit for bit equal, the
    first step's summed gradients within the per-tensor rule of one process
    stepping the union of the pair, its loss within 1e-5 + 1e-4 |loss|;
    their ms per step is two ranks on one card, not scaling.  (c)
    ``main_qm9 --dp 2`` on a one-card machine raises the device-count
    error.  Returns the launches of (a)'s float32 run."""
    import torch

    from pamnet_tpu_torch import main_qm9
    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.data.batch import collate_structures
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.parallel import init_dp, spawn, teardown
    from pamnet_tpu_torch.train.ema import ema_init
    from pamnet_tpu_torch.train.loop import (Optimizer, batch_loss, dp_train_step,
                                             train_step)
    from pamnet_tpu_torch.train.schedules import constant

    loader = qm9_data[0]
    recipe = dict(dataset="QM9", dim=128, n_layer=6, cutoff_l=5.0, cutoff_g=5.0)
    host = [loader.collate(list(range(32 * i, 32 * i + 32))) for i in range(6)]
    res: dict = {"phase": "dp", "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
                 "world_sizes": {"one_rank_nccl": 1, "two_ranks_gloo_one_card": 2},
                 "device_count": torch.cuda.device_count()}

    def fresh(dtype):
        model = PAMNet(PAMNetConfig(**recipe, compute_dtype=dtype),
                       torch.Generator().manual_seed(args.seed)).to("cuda")
        return (model, Optimizer(model.parameters(), constant(1e-4), clip_norm=1000.0),
                ema_init(model.state_dict()))

    # ---- (a) one rank over NCCL ----
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_dp(1, 0, "cuda:0", init_method=f"file://{tmp}/rendezvous")
        try:
            batches = [b.to("cuda") for b in host[:3]]
            for dtype in ("float32", "bfloat16"):
                runs = {}
                for route in ("train_step", "dp_train_step"):
                    model, opt, ema = fresh(dtype)
                    main_path = route == "dp_train_step" and dtype == "float32"
                    if main_path:
                        reset_counts()
                    losses = [dp_train_step(model, opt, ema, gb, "l1", gb.num_graphs)
                              if route == "dp_train_step" else
                              train_step(model, opt, ema, gb, "l1") for gb in batches]
                    torch.cuda.synchronize()
                    if main_path:
                        launches = read_counts()
                    runs[route] = ({n: p.detach().clone() for n, p in model.named_parameters()},
                                   ema, [float(v) for v in losses])
                (pt, et, lt), (pd, ed, ld) = runs["train_step"], runs["dp_train_step"]
                if not (all(torch.equal(pt[n], pd[n]) for n in pt)
                        and all(torch.equal(et[k], ed[k]) for k in et) and lt == ld):
                    raise AssertionError(f"dp {dtype}: one rank differs from train_step")
                gb = batches[0]
                steps = {}
                for route in ("train_step", "dp_train_step", "dp_train_step", "train_step"):
                    model, opt, ema = fresh(dtype)
                    step = ((lambda: dp_train_step(model, opt, ema, gb, "l1", gb.num_graphs))
                            if route == "dp_train_step" else
                            (lambda: train_step(model, opt, ema, gb, "l1")))
                    steps.setdefault(route, []).append(time_ms(step, iters=10, warmup=2))
                model, opt, ema = fresh(dtype)
                reset_counts()
                dp_train_step(model, opt, ema, gb, "l1", gb.num_graphs)
                torch.cuda.synchronize()
                res[f"one_rank_{dtype}"] = {
                    "bitwise_equal_to_train_step": True, "steps": len(batches),
                    "losses": ld, "ms_per_step_in_turns": steps,
                    "launches_per_step": read_counts()}
        finally:
            teardown()
    skipped = {k for k, v in train_launches.items() if v and not launches[k]}
    extra = {k for k, v in launches.items() if v and not train_launches[k]}
    if skipped or extra:
        raise AssertionError(f"the DP path launched {launches} against train's {train_launches}")
    res["main_path_launches"] = launches

    # ---- (b) two ranks sharing the one card over gloo ----
    pairs = [(host[2 * i], host[2 * i + 1]) for i in range(3)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn(_dp_rank, 2, {"cfg": recipe, "seed": args.seed, "pairs": pairs, "out": tmp})
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
                 for r in range(2)]
    a, b = ranks
    equal = (a["losses"] == b["losses"]
             and all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
             and all(torch.equal(a["ema"][k], b["ema"][k]) for k in a["ema"]))
    if not equal:
        raise AssertionError("dp: the two replicas differ")
    union = collate_structures([loader.structs[i] for i in range(64)], build_perms=True,
                               num_atom_types=5).to("cuda")
    model, _, _ = fresh("float32")
    want = _parameter_grads(model, lambda: batch_loss(model, union, "l1"))
    check = _worst_gradient({n: g.to("cuda") for n, g in a["grads"].items()}, want,
                            "two-rank DP gradients off the union batch's")
    with torch.no_grad():
        union_loss = float(batch_loss(model, union, "l1"))
    loss_check = compare("two-rank DP loss vs the union batch's",
                         torch.tensor(a["losses"][:1]), torch.tensor([union_loss]),
                         atol=1e-5, rtol=1e-4)
    res["two_ranks_one_card"] = {
        "backend": "gloo", "steps": 3, "replicas_bitwise_equal": True,
        "union_gradients": check, "union_loss_check": loss_check,
        "losses": a["losses"], "union_loss": union_loss, "spawn_s": spawn_s,
        "ms_per_step_two_ranks_sharing_one_card": [a["ms_per_step"], b["ms_per_step"]]}

    # ---- (c) --dp 2 on a one-card machine ----
    if torch.cuda.device_count() < 2:
        try:
            main_qm9.main(["--synthetic", "--limit", "64", "--epochs", "1", "--dp", "2"])
        except ValueError as e:
            if "needs 2 devices" not in str(e):
                raise
            res["dp2_on_one_card"] = str(e)
        else:
            raise AssertionError("main_qm9 --dp 2 ran on one card")
    emit_line(res)
    return launches


@contextlib.contextmanager
def _driver_probe(read_counts):
    """Record what an in-process driver run does that its printed lines do
    not show: each ``GraphLoader``'s construction seconds and structure-cache
    chunks built, each training epoch's per-step losses, its wrappers'
    launches and step count, and the model's parameters after it."""
    import torch

    from pamnet_tpu_torch.data import loader as loader_mod
    from pamnet_tpu_torch.train import loop

    rec = {"loaders": [], "epochs": []}
    init, run_epoch = loader_mod.GraphLoader.__init__, loop.run_epoch

    def timed_init(self, *a, **kw):
        t0 = time.perf_counter()
        init(self, *a, **kw)
        rec["loaders"].append({"s": time.perf_counter() - t0, "built": self.cache_built})

    def probed_epoch(model, *a, **kw):
        before = read_counts()
        out = run_epoch(model, *a, **kw)
        torch.cuda.synchronize()
        after = read_counts()
        rec["epochs"].append({
            "losses": torch.stack(out[2]).cpu(),
            "launches": {k: after[k] - before[k] for k in after},
            "params": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}})
        return out

    loader_mod.GraphLoader.__init__, loop.run_epoch = timed_init, probed_epoch
    try:
        yield rec
    finally:
        loader_mod.GraphLoader.__init__, loop.run_epoch = init, run_epoch


def _run_driver(main, argv: list[str], read_counts) -> tuple[dict, str]:
    """``main(argv)`` in-process with its stdout captured, under
    ``_driver_probe``: (the probe's record with the run's seconds and return
    value, the printed text)."""
    out = io.StringIO()
    with _driver_probe(read_counts) as rec, contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rec["result"] = main(argv)
        rec["s"] = time.perf_counter() - t0
    return rec, out.getvalue()


def _same_runs(runs: dict, what: str) -> None:
    """Every run's per-step losses and final parameters bit for bit the
    first run's, and the same launches."""
    import torch

    (first, a), *rest = runs.items()
    for name, b in rest:
        for ea, eb in zip(a["epochs"], b["epochs"], strict=True):
            if not torch.equal(ea["losses"], eb["losses"]):
                raise AssertionError(f"{what}: {name} step losses {eb['losses']} differ from "
                                     f"{first}'s {ea['losses']}")
            bad = [k for k in ea["params"] if not torch.equal(ea["params"][k], eb["params"][k])]
            if bad or ea["launches"] != eb["launches"]:
                raise AssertionError(f"{what}: {name} differs from {first} "
                                     f"(parameters {bad[:3]}, launches {eb['launches']})")


def _cache_numbers(runs: dict, cold: str, warm: str, what: str) -> dict:
    """Loader seconds and chunks built of each run; the cold run built
    chunks, the warm one none."""
    built = {name: sum(ld["built"] or 0 for ld in r["loaders"]) for name, r in runs.items()}
    if not built[cold] or built[warm] != 0:
        raise AssertionError(f"{what}: chunks built {built}")
    return {"loader_s": {name: sum(ld["s"] for ld in r["loaders"]) for name, r in runs.items()},
            "chunks_built": built, "driver_s": {name: r["s"] for name, r in runs.items()},
            "step_losses": runs[cold]["epochs"][0]["losses"].tolist()}


# Kernels that a QM9 step launches, by a piece of the symbol name the
# profiler records, with the source that defines each.
TRACE_KERNELS = {"SumRow": "csrc/triplet_aggregate.cu", "RoleSwapRow": "csrc/triplet_aggregate.cu",
                 "MessageRow": "csrc/row_gather.cu", "edge_message_kernel": "csrc/row_gather.cu",
                 "gated_sum_backward_kernel": "csrc/gather_backward.cu",
                 "edge_message_backward_kernel": "csrc/gather_backward.cu"}
# The raw_data phase's sizes: raw PDBbind complexes (those of them also in
# the core set) and the synthetic QM9 molecules of its cached runs.
RAW_COMPLEXES, RAW_CORE = 80, 16
RAW_QM9_MOLECULES = 1280


def raw_data_phase(args, rna_mols, pdb_step: dict, reset_counts, read_counts,
                   emit_line) -> dict:
    """Phase 23, raw_data: the data-preparation path into training on the
    card, each driver in-process.
    PDBbind: a raw tree of ``RAW_COMPLEXES`` complexes in PDBbind's layout
    (ligand and pocket mol2 files, the index; ``RAW_CORE`` also in the core set;
    ``data/synthetic.py::write_raw_pdbbind``) preprocessed by ``python -m
    pamnet_tpu_torch.preprocess_pdbbind`` (seconds a complex), then
    ``main_pdbbind`` at the README recipe (dim 128, 3 layers, batch 32, lr
    1e-3, MSE, cutoffs 2/6 A, f32) for one epoch three times: (a) without
    the structure cache, (b) ``--structure_cache`` cold, (c) warm.  (c)
    builds no chunk; the three runs' per-step losses and parameters are bit
    for bit equal, and their launches; a training step launches what the
    PDBbind step of phase 10 launches (``pdb_step``, per step).
    RNA: 16 training and 8 validation candidates (the geometry of the
    scoring set's structures, with P and H records and an ``rms`` line)
    preprocessed by ``preprocess_rna_puzzles``, then ``main_rna_puzzles`` at
    the published recipe (dim 16, 1 layer, batch 8, lr 1e-4, folded: kernel
    B forward and backward) with the cache cold and warm, checked alike, and
    ``inference_rna_puzzles`` scoring the preprocessed ``val`` split with the
    trained model.
    QM9: ``main_qm9 --synthetic`` at the recipe (dim 128, 6 layers, batch 32,
    bf16) with ``--structure_cache --cache_workers 2`` cold and warm,
    checked alike; then one run with ``--trace_dir``, whose Chrome trace
    must parse and name the port's kernels (``TRACE_KERNELS``).
    Returns the launches of each path's first run (the counts set to 0 just
    before it)."""
    import torch

    from pamnet_tpu_torch import (inference_rna_puzzles, main_pdbbind, main_qm9,
                                  main_rna_puzzles, preprocess_pdbbind, preprocess_rna_puzzles)
    from pamnet_tpu_torch.data.synthetic import write_raw_pdbbind, write_raw_rna_puzzles

    res: dict = {"phase": "raw_data"}
    paths: dict = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # ---- PDBbind ----
            t0 = time.perf_counter()
            write_raw_pdbbind("PDBbind", RAW_COMPLEXES, RAW_CORE, seed=args.seed + 805)
            gen_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                split = preprocess_pdbbind.main(["--data_dir", "PDBbind"])
            pre_s = time.perf_counter() - t0
            sizes = [len(m["pos"]) for m in split["train_val"] + split["test"]]
            base = ["--data_root", "PDBbind", "--epochs", "1", "--dim", "128", "--n_layer", "3",
                    "--batch_size", "32", "--lr", "1e-3", "--cutoff_l", "2", "--cutoff_g", "6",
                    "--seed", str(args.seed), "--device", "cuda"]
            runs = {}
            for name, extra in (("uncached", []), ("cold", ["--structure_cache", "pdb_cache"]),
                                ("warm", ["--structure_cache", "pdb_cache"])):
                if name == "uncached":
                    reset_counts()
                runs[name], text = _run_driver(main_pdbbind.main,
                                               base + extra + ["--save_dir", f"save_{name}"],
                                               read_counts)
                if name == "uncached":
                    paths["raw_pdbbind"] = read_counts()
                if not math.isfinite(runs[name]["result"]["test"][0]):
                    raise AssertionError(f"raw PDBbind {name}: {text}")
            _same_runs(runs, "raw PDBbind")
            epoch = runs["uncached"]["epochs"][0]
            steps = len(epoch["losses"])
            per_step = {k: v / steps for k, v in epoch["launches"].items()}
            if per_step != pdb_step:
                raise AssertionError(f"raw PDBbind step launches {per_step}, "
                                     f"the PDBbind step's {pdb_step}")
            res["pdbbind"] = {
                "complexes": RAW_COMPLEXES, "core": RAW_CORE,
                "train_val": len(split["train_val"]), "test": len(split["test"]),
                "atoms_min_median_max": [min(sizes), int(np.median(sizes)), max(sizes)],
                "fixture_s": gen_s, "preprocess_s": pre_s,
                "preprocess_s_per_complex": pre_s / RAW_COMPLEXES,
                "steps": steps, "launches_per_step_equal_pdbbind_step": True,
                "bitwise_equal_runs": True, **_cache_numbers(runs, "cold", "warm", "PDBbind"),
                "test_rmse": runs["warm"]["result"]["test"][0]}

            # ---- RNA-Puzzles ----
            t0 = time.perf_counter()
            write_raw_rna_puzzles("rna_raw", 16, 8, structures=rna_mols[:24])
            gen_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rsplit = preprocess_rna_puzzles.main(["--data_dir", "rna_raw",
                                                      "--save_dir", "RNA"])
            pre_s = time.perf_counter() - t0
            for got, src in zip(rsplit["train"] + rsplit["val"], rna_mols[:24]):
                # Coordinates are printed to 3 decimals: half a unit of the
                # last one, and float32's rounding of either side.
                if not (np.array_equal(got["z"], src["z"])
                        and np.abs(got["pos"] - src["pos"]).max() <= 6e-4):
                    raise AssertionError("raw RNA: a preprocessed structure differs from its source")
            base = ["--data_root", "RNA", "--dim", "16", "--n_layer", "1", "--batch_size", "8",
                    "--lr", "1e-4", "--epochs", "1", "--seed", str(args.seed), "--device", "cuda",
                    "--structure_cache", "rna_cache"]
            runs = {}
            for name in ("cold", "warm"):
                if name == "cold":
                    reset_counts()
                runs[name], _ = _run_driver(main_rna_puzzles.main,
                                            base + ["--save_dir", f"rna_{name}"], read_counts)
                if name == "cold":
                    paths["raw_rna"] = read_counts()
            _same_runs(runs, "raw RNA")
            launches = runs["cold"]["epochs"][0]["launches"]
            if launches["sbf_modulate"] < 2 or launches["sbf_modulate_backward"] < 2:
                raise AssertionError(f"raw RNA: kernel B did not run folded: {launches}")
            # The scoring driver takes RNA datasets by an "rna" name (the
            # reference's rule): the val split's files under the name rna_val.
            os.makedirs(os.path.join("RNA", "rna_val", "raw"))
            for f in os.listdir(os.path.join("RNA", "val", "raw")):
                shutil.copyfile(os.path.join("RNA", "val", "raw", f),
                                os.path.join("RNA", "rna_val", "raw", "rna_" + f))
            out = {}
            with contextlib.redirect_stdout(io.StringIO()):
                out.update(inference_rna_puzzles.main(
                    ["--dataset", "rna_val", "--data_root", "RNA", "--batch_size", "8",
                     "--saved_model", os.path.join("rna_warm", "pamnet_rna_best.pt"),
                     "--device", "cuda"]))
            with open(out["csv"]) as f:
                rows = [ln.split(",") for ln in f.read().splitlines()[1:]]
            tags = [r[1] for r in rows]
            if (tags != [f"cand_{i:03d}" for i in range(8)]
                    or not all(math.isfinite(float(r[0])) for r in rows)):
                raise AssertionError(f"raw RNA: inference CSV {rows}")
            res["rna"] = {"train": len(rsplit["train"]), "val": len(rsplit["val"]),
                          "atoms": len(rsplit["train"][0]["pos"]), "fixture_s": gen_s,
                          "preprocess_s": pre_s, "preprocess_s_per_structure": pre_s / 24,
                          "bitwise_equal_runs": True, "launches_per_epoch": launches,
                          **_cache_numbers(runs, "cold", "warm", "RNA"),
                          "val_scores_head": [float(r[0]) for r in rows[:4]],
                          "scoring_s": out["seconds"]}

            # ---- QM9 ----
            base = ["--synthetic", "--limit", str(RAW_QM9_MOLECULES), "--epochs", "1",
                    "--seed", str(args.seed), "--device", "cuda"]
            runs = {}
            for name in ("cold", "warm"):
                if name == "cold":
                    reset_counts()
                runs[name], _ = _run_driver(
                    main_qm9.main, base + ["--structure_cache", "qm9_cache", "--cache_workers",
                                           "2", "--save_dir", f"qm9_{name}"], read_counts)
                if name == "cold":
                    paths["raw_qm9"] = read_counts()
            _same_runs(runs, "raw QM9")
            res["qm9"] = {"molecules": RAW_QM9_MOLECULES, "cache_workers": 2,
                          "bitwise_equal_runs": True,
                          "steps": len(runs["cold"]["epochs"][0]["losses"]),
                          **_cache_numbers(runs, "cold", "warm", "QM9")}
            traced, _ = _run_driver(main_qm9.main, base[:2] + ["160"] + base[3:]
                                    + ["--trace_dir", "trace", "--save_dir", "qm9_trace"],
                                    read_counts)
            (name,) = os.listdir("trace")
            t0 = time.perf_counter()
            with open(os.path.join("trace", name)) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
            found = {k: sum(k in n for n in kernels) for k in TRACE_KERNELS}
            if not all(found.values()):
                raise AssertionError(f"the trace names no launch of {found}")
            res["qm9"]["trace"] = {"file": name, "bytes": os.path.getsize(os.path.join("trace", name)),
                                   "events": len(events), "kernel_events": len(kernels),
                                   "port_kernel_events": found, "parse_s": time.perf_counter() - t0,
                                   "run_s": traced["s"]}
        finally:
            os.chdir(cwd)
    torch.cuda.synchronize()
    emit_line(res)
    return paths


# The epoch_pipeline phase's QM9 molecules (``main_qm9 --synthetic``'s
# 80/10/10 split: 32 training steps of 32) and its pairs of runs in turns
# by recipe (a QM9 epoch takes ~4 s, an RNA or PDBbind one under 1 s, whose
# spread between runs is as wide as the difference between the ways).
PIPELINE_QM9_MOLECULES = 1280
PIPELINE_PAIRS = {"qm9": 2, "rna": 5, "pdbbind": 5}


def _pipeline_recipes(args, rna_mols: list[dict], pdb_mols: list[dict]):
    """The three training recipes of the epoch_pipeline phase, one at a time
    (each holds its loaders), as the drivers build them: the training
    loader shuffled with the seed, its batches deriving their geometry;
    the evaluation loaders with host geometry; the model's initial
    parameters from the seed; the optimizer; the loss; the evaluation
    splits by name (QM9: val and test; RNA: train and val; PDBbind: train,
    val and test, the training split over the training loader)."""
    import torch

    from pamnet_tpu_torch.config import PAMNetConfig
    from pamnet_tpu_torch.data.loader import GraphLoader
    from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset
    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.loop import Optimizer
    from pamnet_tpu_torch.train.schedules import constant, multistep, warmup_exponential

    def recipe(name, cfg, kind, ema, bs, train, evals, optimizer, **train_kw):
        t0 = time.perf_counter()
        common = dict(dataset_kind=cfg.dataset_kind, cutoff_l=cfg.cutoff_l,
                      cutoff_g=cfg.cutoff_g, batch_size=bs, variant=cfg.variant)
        loader = GraphLoader(train, shuffle=True, seed=args.seed, build_perms=True,
                             wire_geometry="derive", **common, **train_kw)
        splits = {k: loader if v is None else GraphLoader(v, **common)
                  for k, v in evals.items()}
        state = PAMNet(cfg, torch.Generator().manual_seed(args.seed)).state_dict()
        return {"name": name, "cfg": cfg, "kind": kind, "ema": ema, "train": loader,
                "splits": splits, "state": state, "optimizer": optimizer(len(loader)),
                "loader_s": time.perf_counter() - t0, "graphs": len(train),
                "split_graphs": {k: len(v or train) for k, v in evals.items()}}

    qmols = synthetic_qm9_dataset(PIPELINE_QM9_MOLECULES, seed=args.seed)
    n_train, n_val = int(len(qmols) * 0.8), int(len(qmols) * 0.1)
    yield recipe(
        "qm9", PAMNetConfig(dataset="QM9", dim=128, n_layer=6, compute_dtype="bfloat16"), "l1",
        True, 32, qmols[:n_train], {"val": qmols[n_train:n_train + n_val],
                                     "test": qmols[n_train + n_val:]},
        lambda steps: lambda m: Optimizer(m.parameters(), warmup_exponential(
            1e-4, steps, frac_steps_per_epoch=n_train / 32), clip_norm=1000.0),
        drop_last=True)
    n_val = len(rna_mols) // 4
    yield recipe(
        "rna", PAMNetConfig(dataset="rna_train", dim=16, n_layer=1, cutoff_l=2.6, cutoff_g=20.0,
                            flow="target_to_source"), "smooth_l1", False, 8,
        rna_mols[:-n_val], {"train": None, "val": rna_mols[-n_val:]},
        lambda steps: lambda m: Optimizer(m.parameters(), constant(1e-4)))
    n_test = len(pdb_mols) // 4
    refined = [pdb_mols[i] for i in np.random.default_rng(args.seed).permutation(
        len(pdb_mols) - n_test)]
    n_train = len(refined) - math.ceil(len(refined) * 0.1)
    yield recipe(
        "pdbbind", PAMNetConfig(dataset="PDBbind", dim=128, n_layer=3, cutoff_l=2.0,
                                cutoff_g=6.0), "mse", False, 32, refined[:n_train],
        {"train": None, "val": refined[n_train:], "test": pdb_mols[-n_test:]},
        lambda steps: lambda m: Optimizer(m.parameters(), multistep(1e-3, steps_per_epoch=steps)))


def _pipeline_epoch(rec: dict, way: str, reset_counts, read_counts,
                    profiled: bool = False) -> dict:
    """One epoch of the recipe ``rec`` and its evaluation of every split,
    from its initial parameters and the training loader's generator after
    the train split's draw: "serial" as the parent ran it
    (``run_epoch(pipelined=False)``; every split collated again, QM9's once
    before the epoch as the parent's ``main_qm9`` kept them, and copied
    again); "pipelined" as the drivers now run it (``run_epoch``, the
    splits' resident ``StackedEval`` batches).  ``profiled``: the card's
    busy seconds of the epoch from the profiler (``device_busy_s``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pamnet_tpu_torch.models.pamnet import PAMNet
    from pamnet_tpu_torch.train.ema import ema_init
    from pamnet_tpu_torch.train.loop import predict, run_epoch

    model = PAMNet(rec["cfg"])
    model.load_state_dict(rec["state"])
    model = model.to("cuda")
    opt = rec["optimizer"](model)
    ema = ema_init(model.state_dict()) if rec["ema"] else None
    evaluated = PAMNet(rec["cfg"]).to("cuda") if ema is not None else model
    rec["train"].set_rng_state(rec["rng"])
    host = {k: rec["host"][k] if way == "serial" else None for k in rec["splits"]}
    stats: dict = {}
    torch.cuda.synchronize()
    mallocs = torch.cuda.memory_stats()["segment.all.allocated"]
    with profile(activities=[ProfilerActivity.CUDA]) if profiled else contextlib.nullcontext() \
            as prof:
        reset_counts()
        t0 = time.perf_counter()
        loss_sum, graphs, losses, steps = run_epoch(
            model, opt, ema, rec["train"], "cuda", rec["kind"], pipelined=way == "pipelined",
            stats=stats)
        train_launches = read_counts()
        t1 = time.perf_counter()
        if ema is not None:
            evaluated.load_state_dict(ema)
        preds = {}
        for k, loader in rec["splits"].items():
            if way == "pipelined":
                source = rec["staged"][k]
            elif host[k] is not None:
                source = host[k]
            else:
                source = (loader.collate(idxs, build_perms=False) for idxs in rec["order"][k])
            preds[k] = predict(evaluated, source, "cuda")[0]
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = read_counts()
    if not math.isfinite(loss_sum):
        raise AssertionError(f"epoch_pipeline {rec['name']} {way}: loss sum {loss_sum}")
    return {"way": way, "epoch_s": epoch_s, "train_s": t1 - t0, "eval_s": epoch_s - (t1 - t0),
            "device_mallocs": torch.cuda.memory_stats()["segment.all.allocated"] - mallocs,
            **stats, "loss_sum": loss_sum, "graphs": graphs, "steps": steps,
            "losses": torch.stack(losses).cpu(),
            "params": {n: p.detach().cpu().clone() for n, p in model.named_parameters()},
            "preds": preds, "train_launches": train_launches, "launches": launches,
            "device_s": device_busy_s(prof) if profiled else None}


def _pipeline_same(a: dict, b: dict, what: str) -> None:
    """Two epochs bit for bit: per-step losses, parameters, every split's
    predictions, the loss sum, and launches per step."""
    import torch

    bad = [k for k in a["params"] if not torch.equal(a["params"][k], b["params"][k])]
    bad += [k for k in a["preds"] if not np.array_equal(a["preds"][k], b["preds"][k])]
    if not torch.equal(a["losses"], b["losses"]):
        bad.append("losses")
    per_step = [{k: v / r["steps"] for k, v in r["train_launches"].items()} for r in (a, b)]
    if bad or a["loss_sum"] != b["loss_sum"] or per_step[0] != per_step[1]:
        raise AssertionError(f"epoch_pipeline {what}: {a['way']} and {b['way']} differ in "
                             f"{bad[:4]}, loss sum {a['loss_sum']} / {b['loss_sum']}, "
                             f"launches per step {per_step}")


# Kernels each recipe's training step must launch.
PIPELINE_KERNELS = {
    "qm9": ("triplet_aggregate", "edge_message_sum", "triplet_aggregate_grad_ab",
            "gated_sum_backward", "group_sum_split"),
    "rna": ("sbf_modulate", "sbf_modulate_backward", "edge_message_sum", "gated_sum_backward"),
    "pdbbind": ("triplet_aggregate", "edge_message_sum", "triplet_aggregate_grad_ab",
                "edge_message_backward"),
}


def epoch_pipeline_phase(args, rna_mols: list[dict], pdb_mols: list[dict], reset_counts,
                         read_counts, emit_line) -> dict:
    """Phase 24, epoch_pipeline (module docstring).  Returns the launches of
    each recipe's first pipelined epoch (training and evaluation)."""
    import torch

    from pamnet_tpu_torch.train.loop import StackedEval

    t_phase = time.perf_counter()
    res: dict = {"phase": "epoch_pipeline", "pairs": PIPELINE_PAIRS}
    paths = {}
    for rec in _pipeline_recipes(args, rna_mols, pdb_mols):
        t_recipe = time.perf_counter()
        name, train = rec["name"], rec["train"]
        # The pipelined way's set-up, as the drivers make it: every split
        # staged once (the train split draws the loader's first permutation).
        before = train.rng_state()
        rec["staged"] = {k: StackedEval(ld, "cuda", verbose=False)
                         for k, ld in rec["splits"].items()}
        rec["rng"] = train.rng_state()
        # The serial way's splits: the same batches, collated again each
        # epoch (QM9's collated once, as the parent's main_qm9 kept them).
        train.set_rng_state(before)
        rec["order"] = {k: ld.batches() for k, ld in rec["splits"].items()}
        if train.rng_state() != rec["rng"]:
            raise AssertionError(f"epoch_pipeline {name}: the train split's draw differs")
        rec["host"] = {k: ([ld.collate(i, build_perms=False) for i in rec["order"][k]]
                           if name == "qm9" else None) for k, ld in rec["splits"].items()}
        runs = [_pipeline_epoch(rec, way, reset_counts, read_counts)
                for _ in range(PIPELINE_PAIRS[name]) for way in ("serial", "pipelined")]
        profiled = {way: _pipeline_epoch(rec, way, reset_counts, read_counts, profiled=True)
                    for way in ("serial", "pipelined")}
        for r in runs[1:] + list(profiled.values()):
            _pipeline_same(runs[0], r, name)
        first = next(r for r in runs if r["way"] == "pipelined")
        missing = [k for k in PIPELINE_KERNELS[name] if first["train_launches"][k] < 1]
        if missing:
            raise AssertionError(f"epoch_pipeline {name}: no launch of {missing}")
        paths[f"epoch_pipeline_{name}"] = first["launches"]
        by_way = {way: [r for r in runs if r["way"] == way] for way in ("serial", "pipelined")}
        median = {way: statistics.median(r["epoch_s"] for r in rs) for way, rs in by_way.items()}
        staged = rec["staged"].values()
        res[name] = {
            "graphs": rec["graphs"], "split_graphs": rec["split_graphs"],
            "steps": first["steps"], "pads": dataclasses.asdict(train.pads),
            "loader_s": rec["loader_s"], "bitwise_equal_ways": True,
            "launches_per_step": {k: v / first["steps"] for k, v in
                                  first["train_launches"].items() if v},
            "epoch_s": [r["epoch_s"] for r in runs], "median_epoch_s": median,
            "pipelined_faster_pairs": sum(p["epoch_s"] < q["epoch_s"] for q, p in
                                          zip(by_way["serial"], by_way["pipelined"])),
            "train_s": [r["train_s"] for r in runs], "eval_s": [r["eval_s"] for r in runs],
            "collate_s": [r["collate_s"] for r in by_way["serial"]],
            "h2d_s": [r["h2d_s"] for r in by_way["serial"]],
            "queue_wait_s": [r["queue_wait_s"] for r in by_way["pipelined"]],
            "device_mallocs": [r["device_mallocs"] for r in runs],
            "staged_MB": sum(se.staged_bytes for se in staged) / 1e6,
            "staged_MB_by_split": {k: se.staged_bytes / 1e6 for k, se in rec["staged"].items()},
            "staging_collate_s": sum(se.collate_s for se in staged),
            "staging_transfer_s": sum(se.transfer_s for se in staged),
            "device_s": {way: r["device_s"] for way, r in profiled.items()},
            "profiled_epoch_s": {way: r["epoch_s"] for way, r in profiled.items()},
            "device_idle_share": {way: 1.0 - profiled[way]["device_s"] / median[way]
                                  for way in median},
            "train_loss": first["loss_sum"] / first["graphs"],
            "recipe_s": time.perf_counter() - t_recipe}
        del rec, staged
        torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit_line(res)
    return paths


def _check_names(res: dict, names: list[str]) -> dict:
    if res.get("names") != names:
        raise AssertionError(f"service answered {res}")
    return res


if __name__ == "__main__":
    sys.exit(main())
