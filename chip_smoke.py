#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (pamnet_tpu_torch) on one card.

    python3 chip_smoke.py [--seed 0] [--structures 16] [--atoms 2100] [--profile]

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi) and the kernel
     build time (nvcc, sm_90a, from the sources in the checkout);
  2. kernels: each CUDA kernel against its plain PyTorch version on the card
     at the RNA batch-16 shapes, with kernel, plain, library and bound times;
  3. slice: RNAScoringService(device="cuda") scores a batch of synthetic
     RNA-scale structures with seeded weights (the main path; every kernel's
     launch count must rise), then the folded, unfolded and plain paths
     score the same batch and are compared; graphs/s and ms per batch;
  4. service: the HTTP server on an ephemeral port answers JSON and raw-PDB
     requests, compared with direct scoring;
  5. kernels: one line listing every kernel with its numbers.
Then the nvidia-smi line and, last, {"ok": true, "device": {...}}.
Any mismatch raises and the script exits non-zero.  It exits non-zero with no
result when CUDA is absent.
"""

from __future__ import annotations

import argparse
import json
import os
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
    a_read = (torch.unique(idx[:valid]).numel() if gather else valid) * d * 4
    nbytes = (a_read + (valid * d * 4 if modulate else 0) + (valid * 4 if gather else 0)
              + (num_out + 1) * 4 + num_out * d * 4)
    flops = valid * d * (2 if modulate else 1)
    bms, by = bound_ms(nbytes, flops)
    return {"case": name, "num_out": num_out, "rows": rows, "d": d,
            "gather": gather, "modulate": modulate, **err, "ms": ms, "ms_first": ms_first,
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
    edges_read = torch.unique(args[8]).numel()
    nbytes = (edges_read * (ns + 1) * d * 4 + triplets * (ns + 2) * 4
              + (2 * d * d + 3 * d) * 4 + triplets * d * 4)
    # Per triplet: ns*d multiply-adds, two d x d products, 3*d silu (4 ops
    # each), the mask and the modulation.
    flops = triplets * (2 * ns * d + 4 * d * d + 12 * d + 2 * d)
    bms, by = bound_ms(nbytes, flops)
    return {"case": "t2 fused folded gather", "edges": num_edges,
            "triplets": triplets, "ns": ns, "d": d, **err, "ms": ms, "ms_first": ms_first,
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
    nbytes = torch.unique(idx).numel() * d * 4 + rows * 4 + rows * d * 4
    bms, by = bound_ms(nbytes, 0.0)
    return {"case": name, "table_rows": table_rows, "rows": rows, "d": d, **err,
            "ms": ms, "ms_first": ms_first, "enqueue_ms": enq, "plain_ms": plain,
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
    nbytes = ((torch.unique(args[2]).numel() + torch.unique(args[3]).numel()) * d * 4
              + rows * 8 + rows * d * 4 * (3 if gated else 2) + (rows * 4 if masked else 0))
    # Per element: two adds, silu (exp, add, divide: 4 ops), the factors.
    flops = rows * d * (6 + int(gated) + int(masked))
    bms, by = bound_ms(nbytes, flops)
    return {"case": name, "nodes": nodes, "rows": rows, "d": d, "gated": gated,
            "masked": masked, **err, "ms": ms, "ms_first": ms_first, "enqueue_ms": enq,
            "plain_ms": plain,
            "library_ms": None, "bound_ms": bms, "bound_by": by}


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
    parser.add_argument("--profile", action="store_true",
                        help="also print the device-time breakdown of one forward")
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
    from pamnet_tpu_torch.ops.gather import edge_message, row_gather
    from pamnet_tpu_torch.ops.sbf_modulate import sbf_modulate
    from pamnet_tpu_torch.ops.triplet import triplet_aggregate
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
                "edge_message": edge_message, "row_gather": row_gather}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    reset_counts()
    t0 = time.perf_counter()
    scores = service.score_molecules(mols)  # the main path
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = read_counts()
    if min(launches.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
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
        rows = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            if dev_us > 0 and not ev.key.startswith("aten::"):  # kernels only
                rows.append({"name": ev.key[:80], "device_ms_per_batch": dev_us / 3e3,
                             "calls_per_batch": ev.count / 3})
        rows.sort(key=lambda r: -r["device_ms_per_batch"])
        host = sorted(prof.key_averages(), key=lambda ev: -ev.self_cpu_time_total)
        emit({"phase": "profile", "folded_forward_top": rows[:15],
              "device_ms_per_batch_total": sum(r["device_ms_per_batch"] for r in rows),
              "host_top": [{"name": ev.key[:80], "host_ms_per_batch": ev.self_cpu_time_total / 3e3,
                            "calls_per_batch": ev.count / 3} for ev in host[:12]]})

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

    # ---- 5. every kernel of the path, with its numbers ----
    # Each kernel's numbers are those of its main-path case: the folded t2
    # triplet sum, the global message and the embedding lookup.
    table = [
        ("triplet_aggregate", "triplet_aggregate.cu", "pamnet_tpu/ops/pallas_triplet.py:47",
         a_cases, a_cases[0]),
        ("sbf_modulate", "sbf_modulate.cu", "tools/fused_sbf_kernel_probe.py:42",
         [b_case], b_case),
        ("edge_message", "row_gather.cu", "tools/vmem_gather_probe.py:86",
         e_cases, e_cases[0]),
        ("row_gather", "row_gather.cu", "tools/vmem_gather_probe.py:42",
         g_cases, g_cases[0]),
    ]
    kernels = [
        {"name": name, "route": "cuda", "source": f"pamnet_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": max(c["max_abs_err"] for c in cases),
         **{k: rep[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "timed_case": rep["case"]}
        for name, src, replaces, cases, rep in table
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _check_names(res: dict, names: list[str]) -> dict:
    if res.get("names") != names:
        raise AssertionError(f"service answered {res}")
    return res


if __name__ == "__main__":
    sys.exit(main())
