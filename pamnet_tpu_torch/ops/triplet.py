"""Gather - modulate - segmented sum over CSR offsets (kernel A), and its
backward.

    out[e, :] = sum_{r in [off[e], off[e+1])} a[idx[r], :] * b[r, :]

``idx=None`` sums rows of ``a`` directly (a row per summed row) and
``b=None`` skips the modulation, so one operation serves every aggregation
of the forward (the local layer's el_dst sum takes its rbf gate as ``b``
without a gather).  The rows must be sorted by their output row; ``off`` is the
(num_out+1,) int32 CSR offset array that batches carry.

``triplet_aggregate`` is the entry point, a ``torch.autograd.Function``: on
CPU tensors its forward and backward run plain PyTorch versions, on CUDA
tensors they launch ``csrc/triplet_aggregate.cu`` and
``csrc/gather_backward.cu``.  It replaces the Pallas kernel
``pamnet_tpu/ops/pallas_triplet.py:47`` and its custom VJP (:117-133):

    d_a[v] = sum_{r: idx[r] = v} g[seg[r]] * b[r]     kernel A, roles swapped
    d_b[r] = a[idx[r]] * g[seg[r]]                    ``gather_product``

where ``seg[r]`` is the output row of row ``r``.  The role swap sums over the
CSR of ``idx`` (``Groups``: a permutation sorting the rows by ``idx`` and its
offsets, built on the host per batch), reading ``g`` through ``seg[perm]``
and ``b`` through ``perm``.  Where both gradients are wanted, one walk
computes both (``triplet_aggregate_grad_ab``: the role swap holds ``a[v]``
while it walks group ``v`` and writes each row's ``d_b``); ``gather_product``
is the route when ``b`` alone takes a gradient.  Without a gather the
modulated sum's gradients are ``d_a[r] = g[seg[r]] * b[r]`` and
``d_b[r] = a[r] * g[seg[r]]``, one launch of ``gated_sum_backward``
(``csrc/gather_backward.cu``).  ``group_sum`` sums rows over such a CSR alone,
the backward of every row gather (``ops/gather.py``): kernel A where the
groups are short, ``csrc/group_sum.cu`` (``group_sum_split``) where one is
long (``group_sum_route``).

Types: the kernels take float32 or bfloat16 rows (``csrc/vec.cuh``; every
float operand of a call in one type, the output in it too) and compute in
float32: a bfloat16 sum accumulates in float32 and rounds once, as the plain
versions do (a bfloat16 running sum stalls past about 256).  The one-gradient
routes (``triplet_aggregate_grad_a``, ``gather_product``) and the split group
sum take float32 only and raise on bfloat16.

Padded rows: a CSR's last offset is the batch's valid row count, so padded
rows never enter a sum, forward or backward.  The sums of this module are
exact with padding.  The row gathers' backward is exact because the model
masks every padded row before any sum or pool, so a padded row's cotangent
is zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pamnet_tpu_torch.ops import _build


class Groups(NamedTuple):
    """The rows of an array grouped by an integer key (its CSR): group ``k``
    holds rows ``perm[off[k]:off[k+1]]``, or rows ``off[k]:off[k+1]`` when
    ``perm`` is None (the rows are sorted by the key).  ``off`` (groups+1,)
    int32 with ``off[-1]`` the valid row count, which ``total`` gives on the
    host where known; ``perm`` (rows,) int32 with the padded rows parked at
    its end; ``longest`` the most rows of a group, on the host where known."""

    off: torch.Tensor
    perm: torch.Tensor | None = None
    total: int | None = None
    longest: int | None = None


class AggregateGrad(NamedTuple):
    """What the backward of ``triplet_aggregate`` reads besides its forward
    inputs: ``seg`` (rows,) the output row of each row (the key the rows are
    sorted by); with a gather, ``by_idx`` the ``Groups`` of ``idx`` and
    ``seg_by_idx`` = ``seg[by_idx.perm]``, built on the host."""

    seg: torch.Tensor
    by_idx: Groups | None = None
    seg_by_idx: torch.Tensor | None = None


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type a plain version computes in: float32 for bfloat16 rows (the
    kernels' registers), the rows' own type otherwise."""
    return torch.promote_types(dtype, torch.float32)


def triplet_aggregate_plain(a: torch.Tensor, off: torch.Tensor,
                            idx: torch.Tensor | None = None,
                            b: torch.Tensor | None = None,
                            bidx: torch.Tensor | None = None) -> torch.Tensor:
    """Reference version: gather, multiply, ``index_add_``, in float32 for
    bfloat16 rows, rounded once to ``a``'s type; the gathers read float32
    copies, so their backward sums a row's uses in float32 too.  ``bidx``
    reads the modulation ``b[bidx[r]]`` instead of ``b[r]``."""
    num_out = off.shape[0] - 1
    rows = int(off[-1])
    seg = torch.repeat_interleave(
        torch.arange(num_out, device=a.device), (off[1:] - off[:-1]).long(),
        output_size=rows,
    )
    dt, acc = a.dtype, acc_dtype(a.dtype)
    a = a.to(acc)
    vals = a[idx[:rows].long()] if idx is not None else a[:rows]
    if b is not None:
        b = b.to(acc)
        vals = vals * (b[bidx[:rows].long()] if bidx is not None else b[:rows])
    out = vals.new_zeros((num_out, a.shape[1]))
    return out.index_add_(0, seg, vals).to(dt)


# Rows whose loads one slot of the walk issues together (``kWalkUnroll`` of
# ``csrc/csr_walk.cuh``), the most threads of a team (its block), and the
# threads a walk aims to fill: two waves of an H100 (132 SMs x 2,048).
WALK_UNROLL = 4
WALK_MAX_TEAM = 256
WALK_THREADS = 2 * 132 * 2048


def vector_width(d: int, dtype: torch.dtype = torch.float32) -> int:
    """Values a lane of a kernel moves as one vector (``csrc/vec.cuh``):
    16 bytes (4 float32, 8 bfloat16 values), or for bfloat16 rows whose
    ``d`` is not a multiple of 8, 8 bytes (4 values)."""
    return 8 if dtype == torch.bfloat16 and d % 8 == 0 else 4


def walk_shape(d: int, num_out: int, total: int | None,
               dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """``(lanes, slots)`` of the team of threads that walks one output row
    of a CSR sum (``csrc/csr_walk.cuh``), from what the host knows: ``lanes``
    covers the row's vectors (``vector_width``: a D=128 row is 32 float32
    vectors, 16 bfloat16 ones), rounded up to a power of two (D=12
    leaves a lane idle) and at most 32 (wider rows loop over their columns);
    ``slots`` is the power of two that gives each slot about ``WALK_UNROLL``
    rows of a group of the mean length ``total / num_out``, but no more
    than keeps all teams within ``WALK_THREADS`` threads, nor a team beyond
    ``WALK_MAX_TEAM``.  (Timed on the H100, ``chip_smoke.py``
    ``walk_shape_trials``: past two waves more slots only add per-thread
    work; within them a long group gains from more.)  Where ``total`` is
    unknown the shape is one slot, right for any CSR.  A function of its
    arguments alone, so a fixed input keeps one summation order."""
    vecs = max(1, -(-d // vector_width(d, dtype)))
    lanes = min(32, 1 << (vecs - 1).bit_length())
    if total is None or num_out <= 0:
        return lanes, 1
    want = 1 << (max(1, -(-total // (num_out * WALK_UNROLL))) - 1).bit_length()
    fill = 1 << (max(1, WALK_THREADS // (num_out * lanes)).bit_length() - 1)
    return lanes, min(want, fill, WALK_MAX_TEAM // lanes)


def _kernel_a(what: str, a, off, idx, b, bidx, total, split: bool = False,
              longest: int | None = None):
    """Check the operands and launch kernel A on the current stream, or with
    ``split`` the split group sum (no ``b``; ``longest`` picks its grid)."""
    dev, dt = a.device, a.dtype
    d = a.shape[1] if a.dim() == 2 else -1
    if d % 4 or d <= 0:
        raise ValueError(f"{what}: a must be (rows, D) with D % 4 == 0, "
                         f"got {tuple(a.shape)}")
    if split:
        _build.f32_only(what, a)
    bf16 = _build.dtype_flag(what, dt)
    rows = next(t for t in (idx, bidx, b, a) if t is not None).shape[0]
    i32 = torch.int32
    operands = {"a": (a, dt, (None, d)), "off": (off, i32, (None,)),
                "idx": (idx, i32, (rows,)), "bidx": (bidx, i32, (rows,)),
                "b": (b, dt, (None if bidx is not None else rows, d))}
    for name, (t, dtype, shape) in operands.items():
        if t is not None:
            _build.check_operand(what, name, t, dtype, dev, shape)
    limit = rows if idx is not None else min(rows, a.shape[0])
    if total is not None and not 0 <= total <= limit:
        raise ValueError(f"{what}: off[-1] = {total}, but the inputs hold "
                         f"{limit} rows")
    num_out = off.shape[0] - 1
    out = torch.empty((num_out, d), dtype=a.dtype, device=dev)
    if num_out == 0:
        return out
    lib = _build.library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if split:
            code = lib.pamnet_group_sum_split(a.data_ptr(), ptr(idx), off.data_ptr(),
                                              out.data_ptr(), num_out, d,
                                              -1 if longest is None else longest, stream)
        else:
            lanes, slots = walk_shape(d, num_out, total, dt)
            code = lib.pamnet_triplet_aggregate(ptr(a), ptr(b), ptr(idx), ptr(bidx),
                                                off.data_ptr(), out.data_ptr(), num_out,
                                                d, lanes, slots, bf16, stream)
    _build.check(code, what)
    return out


def _forward(a, off, idx, b, total):
    """Kernel A on CUDA tensors (counted), the plain version on CPU ones."""
    if a.device.type == "cpu":
        return triplet_aggregate_plain(a, off, idx, b)
    out = _kernel_a("triplet_aggregate", a, off, idx, b, None, total)
    if out.shape[0]:
        triplet_aggregate.launches += 1
    return out


class _TripletAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, off, idx, total, grad):
        ctx.total, ctx.grad = total, grad
        ctx.save_for_backward(a, b, idx)
        return _forward(a, off, idx, b, total)

    @staticmethod
    def backward(ctx, g):
        a, b, idx = ctx.saved_tensors
        grad, total = ctx.grad, ctx.total
        g = g.contiguous()
        needs_a, needs_b = ctx.needs_input_grad[:2]
        d_a = d_b = None
        if idx is not None:
            if needs_a and needs_b:
                d_a, d_b = triplet_aggregate_grad_ab(g, grad.by_idx, grad.seg_by_idx, b, a)
            elif needs_a:
                d_a = triplet_aggregate_grad_a(g, grad.by_idx, grad.seg_by_idx, b)
            elif needs_b:
                d_b = gather_product(a, idx, g, grad.seg, total)
        elif b is not None:
            d_a, d_b = gated_sum_backward(a, b, g, grad.seg, total)
            d_a, d_b = (d_a if needs_a else None), (d_b if needs_b else None)
        elif needs_a:
            from pamnet_tpu_torch.ops.gather import row_gather

            d_a = row_gather(g, grad.seg, valid=total)
        return d_a, d_b, None, None, None, None


def _check_grad_inputs(a, b, idx, total, grad: AggregateGrad | None, needs_a: bool):
    """Raise unless ``total`` and ``grad`` hold what the backward reads: a
    gradient is never dropped without a word, and the backward never reads
    ``off`` back from the card."""
    if grad is None:
        raise ValueError("triplet_aggregate: an input requires grad, so the "
                         "backward needs grad=AggregateGrad(seg, ...)")
    if total is None:
        raise ValueError("triplet_aggregate: an input requires grad, so the "
                         "backward needs total = off[-1] from the host")
    rows = (idx if idx is not None else a).shape[0]
    if grad.seg.shape != (rows,):
        raise ValueError(f"triplet_aggregate: grad.seg must be ({rows},), got "
                         f"{tuple(grad.seg.shape)}")
    if needs_a and idx is not None:
        if grad.by_idx is None or grad.seg_by_idx is None:
            raise ValueError("triplet_aggregate: the gradient of a gathered a "
                             "needs grad.by_idx and grad.seg_by_idx")
        if grad.by_idx.perm is None or grad.by_idx.off.shape[0] != a.shape[0] + 1:
            raise ValueError("triplet_aggregate: grad.by_idx must be the "
                             f"permuted CSR of idx over the {a.shape[0]} rows of a")


def triplet_aggregate(a: torch.Tensor, off: torch.Tensor,
                      idx: torch.Tensor | None = None,
                      b: torch.Tensor | None = None,
                      total: int | None = None,
                      grad: AggregateGrad | None = None) -> torch.Tensor:
    """(num_out, D) sums, differentiable in ``a`` and ``b``; the plain
    version for CPU tensors, the CUDA kernels for CUDA tensors.  ``total``
    is ``off[-1]`` where the caller knows it on the host (the batch's valid
    row count): the rows the kernel reads are then checked without reading
    ``off`` back from the card.  ``total`` and ``grad``, the index arrays of
    the backward, must be given when ``a`` or ``b`` requires grad.  Counts
    its forward kernel launches in ``triplet_aggregate.launches``."""
    needs_a = a.requires_grad
    if not (torch.is_grad_enabled() and (needs_a or (b is not None and b.requires_grad))):
        return _forward(a, off, idx, b, total)  # no gradient wanted: no graph node
    _check_grad_inputs(a, b, idx, total, grad, needs_a)
    return _TripletAggregate.apply(a, b, off, idx, total, grad)


triplet_aggregate.launches = 0


def triplet_aggregate_grad_a_plain(g, by_idx: Groups, seg_by_idx, b=None) -> torch.Tensor:
    """Reference version of ``triplet_aggregate_grad_a`` (in any type: the
    fused role swap's plain version sums its ``d_a`` so)."""
    return triplet_aggregate_plain(g, by_idx.off, seg_by_idx, b,
                                   None if b is None else by_idx.perm)


def triplet_aggregate_grad_a(g: torch.Tensor, by_idx: Groups,
                             seg_by_idx: torch.Tensor,
                             b: torch.Tensor | None = None) -> torch.Tensor:
    """d_a of a gathered sum: kernel A with roles swapped,
    ``d_a[v] = sum_{r in [off[v], off[v+1])} g[seg_by_idx[r]] * b[perm[r]]``
    over ``by_idx`` = (perm, off), the CSR of the forward's ``idx``; float32
    only.  Counts its kernel launches in ``triplet_aggregate_grad_a.launches``."""
    _build.f32_only("triplet_aggregate_grad_a", g, b)
    if g.device.type == "cpu":
        return triplet_aggregate_grad_a_plain(g, by_idx, seg_by_idx, b)
    out = _kernel_a("triplet_aggregate_grad_a", g, by_idx.off, seg_by_idx, b,
                    None if b is None else by_idx.perm, by_idx.total)
    if out.shape[0]:
        triplet_aggregate_grad_a.launches += 1
    return out


triplet_aggregate_grad_a.launches = 0


def triplet_aggregate_grad_ab_plain(g, by_idx: Groups, seg_by_idx, b, a):
    """Reference version of ``triplet_aggregate_grad_ab``: the role swap's
    plain version, and ``d_b`` through the same CSR (``a`` of each group
    times ``g`` of each of its rows, zero on the rows no group holds)."""
    d_a = triplet_aggregate_grad_a_plain(g, by_idx, seg_by_idx, b)
    total = int(by_idx.off[-1])
    sizes = (by_idx.off[1:] - by_idx.off[:-1]).long()
    v = torch.repeat_interleave(torch.arange(a.shape[0], device=a.device), sizes,
                                output_size=total)
    acc = acc_dtype(b.dtype)
    d_b = b.new_zeros((by_idx.perm.shape[0], a.shape[1]))
    d_b[by_idx.perm[:total].long()] = (a[v].to(acc)
                                       * g[seg_by_idx[:total].long()].to(acc)).to(b.dtype)
    return d_a, d_b


def triplet_aggregate_grad_ab(g: torch.Tensor, by_idx: Groups, seg_by_idx: torch.Tensor,
                              b: torch.Tensor, a: torch.Tensor):
    """``(d_a, d_b)`` of a gathered, modulated sum in one walk: the role swap
    of ``triplet_aggregate_grad_a`` (its team shape, so its bits), which
    holds ``a[v]`` while it walks group ``v`` of ``by_idx`` and writes
    ``d_b[perm[r]] = a[v] * g[seg_by_idx[r]]`` for each of the group's rows
    (``gather_product``'s ``a[idx] * g[seg]``, its bits), and zero rows at
    ``perm[total:]``, the padded rows, from the same launch
    (``csrc/triplet_aggregate.cu``, ``RoleSwapRow``).  The plain version for
    CPU tensors.  Counts its kernel launches in
    ``triplet_aggregate_grad_ab.launches``."""
    if g.device.type == "cpu":
        return triplet_aggregate_grad_ab_plain(g, by_idx, seg_by_idx, b, a)
    what, dev, dt = "triplet_aggregate_grad_ab", g.device, g.dtype
    d = g.shape[1] if g.dim() == 2 else -1
    if d % 4 or d <= 0:
        raise ValueError(f"{what}: g must be (rows, D) with D % 4 == 0, got {tuple(g.shape)}")
    if by_idx.perm is None or by_idx.total is None:
        raise ValueError(f"{what}: by_idx must be a permuted CSR with its valid row count")
    bf16 = _build.dtype_flag(what, dt)
    rows, num_out, total = by_idx.perm.shape[0], by_idx.off.shape[0] - 1, by_idx.total
    i32 = torch.int32
    operands = {"g": (g, dt, (None, d)), "b": (b, dt, (rows, d)),
                "a": (a, dt, (num_out, d)), "seg_by_idx": (seg_by_idx, i32, (rows,)),
                "by_idx.perm": (by_idx.perm, i32, (rows,)),
                "by_idx.off": (by_idx.off, i32, (num_out + 1,))}
    for name, (t, dtype, shape) in operands.items():
        _build.check_operand(what, name, t, dtype, dev, shape)
    if not 0 <= total <= rows:
        raise ValueError(f"{what}: off[-1] = {total}, but perm holds {rows} rows")
    d_a = torch.empty((num_out, d), dtype=dt, device=dev)
    d_b = torch.empty((rows, d), dtype=dt, device=dev)
    if num_out == 0 or rows == 0:  # nothing to walk: every group and row is empty
        return d_a.zero_(), d_b.zero_()
    lanes, slots = walk_shape(d, num_out, total, dt)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_triplet_aggregate_grad_ab(
            g.data_ptr(), b.data_ptr(), a.data_ptr(), seg_by_idx.data_ptr(),
            by_idx.perm.data_ptr(), by_idx.off.data_ptr(), d_a.data_ptr(), d_b.data_ptr(),
            num_out, rows, total, d, lanes, slots, bf16, stream)
    _build.check(code, what)
    triplet_aggregate_grad_ab.launches += 1
    return d_a, d_b


triplet_aggregate_grad_ab.launches = 0


def group_sum_plain(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """Reference version of ``group_sum``."""
    return triplet_aggregate_plain(x, groups.off, groups.perm)


# Longest group (rows) up to which group_sum walks each group with kernel A.
# A walk takes ~0.1 us a row in order, the split kernel a few us whatever
# the length; a batch's short CSRs have groups of at most ~100 rows (global
# edges by node), its embedding CSR groups of ~300 (QM9) to ~7,500 (RNA).
SPLIT_ABOVE = 128


def group_sum_route(groups: Groups) -> str:
    """The kernel ``group_sum`` launches for ``groups``: "walk" (kernel A, a
    team of threads per group, ``walk_shape``) when the
    longest group is known on the host and at most ``SPLIT_ABOVE`` rows,
    else "split" (``group_sum_split``), which is right for every CSR."""
    if groups.longest is not None and groups.longest <= SPLIT_ABOVE:
        return "walk"
    return "split"


def group_sum(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """(groups, D): ``out[k] = sum of x[r] over the rows r of group k``, the
    backward of a row gather ``src[idx]`` over the CSR of ``idx``, gathering
    through ``groups.perm`` (or reading sorted rows in place): kernel A or
    the split kernel, as ``group_sum_route`` says, on CUDA tensors; the plain
    version on CPU ones.  Counts its calls that launch a kernel in
    ``group_sum.launches`` (the split kernel's in
    ``group_sum_split.launches`` too)."""
    if x.device.type == "cpu":
        return group_sum_plain(x, groups)
    if group_sum_route(groups) == "split":
        out = group_sum_split(x, groups)
    else:
        out = _kernel_a("group_sum", x, groups.off, groups.perm, None, None, groups.total)
    if out.shape[0]:
        group_sum.launches += 1
    return out


group_sum.launches = 0


def group_sum_split(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """``group_sum`` by ``csrc/group_sum.cu``: each group's rows spread over
    a block per 16 columns, or over a cluster of 8 such blocks where
    ``groups.longest`` is beyond one batch of a block's lanes or unknown;
    summed in a fixed order (bitwise repeatable); float32 only.  The plain
    version for CPU tensors.  Counts its kernel launches in
    ``group_sum_split.launches``."""
    _build.f32_only("group_sum_split", x)
    if x.device.type == "cpu":
        return group_sum_plain(x, groups)
    out = _kernel_a("group_sum_split", x, groups.off, groups.perm, None, None, groups.total,
                    split=True, longest=groups.longest)
    if out.shape[0]:
        group_sum_split.launches += 1
    return out


group_sum_split.launches = 0


def gather_product_plain(x, xi, y, yi, valid: int) -> torch.Tensor:
    """Reference version of ``gather_product``."""
    out = x.new_zeros((xi.shape[0], x.shape[1]))
    out[:valid] = x[xi[:valid].long()] * y[yi[:valid].long()]
    return out


def gather_product(x: torch.Tensor, xi: torch.Tensor, y: torch.Tensor,
                   yi: torch.Tensor, valid: int) -> torch.Tensor:
    """(rows, D): ``out[r] = x[xi[r]] * y[yi[r]]`` for ``r < valid``, zero
    after: the d_b of kernel A's gathered sum, ``a[idx] * g[seg]``.  The
    plain version for CPU tensors, ``csrc/gather_backward.cu`` for CUDA
    tensors; float32 only.  Counts its kernel launches in
    ``gather_product.launches``."""
    _build.f32_only("gather_product", x, y)
    if x.device.type == "cpu":
        return gather_product_plain(x, xi, y, yi, valid)
    dev = x.device
    rows = xi.shape[0]
    d = x.shape[1] if x.dim() == 2 else -1
    if d % 4 or d <= 0:
        raise ValueError(f"gather_product: needs D % 4 == 0, got {tuple(x.shape)}")
    f32, i32 = torch.float32, torch.int32
    operands = {"x": (x, f32, (None, d)), "xi": (xi, i32, (rows,)),
                "y": (y, f32, (None, d)), "yi": (yi, i32, (rows,))}
    for name, (t, dtype, shape) in operands.items():
        _build.check_operand("gather_product", name, t, dtype, dev, shape)
    if not 0 <= valid <= rows:
        raise ValueError(f"gather_product: valid = {valid} outside [0, {rows}]")
    out = torch.empty((rows, d), dtype=f32, device=dev)
    if rows == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_gather_product(x.data_ptr(), xi.data_ptr(), y.data_ptr(),
                                         yi.data_ptr(), out.data_ptr(), rows, valid, d,
                                         stream)
    _build.check(code, "gather_product")
    gather_product.launches += 1
    return out


gather_product.launches = 0


def gated_sum_backward_plain(a, b, g, seg, valid: int):
    """Reference version of ``gated_sum_backward`` (the products in float32
    for bfloat16 rows, each rounded once)."""
    acc = acc_dtype(g.dtype)
    gs = g[seg[:valid].long()].to(acc)
    d_a, d_b = b.new_zeros(b.shape), a.new_zeros(a.shape)
    d_a[:valid] = (gs * b[:valid].to(acc)).to(b.dtype)
    d_b[:valid] = (a[:valid].to(acc) * gs).to(a.dtype)
    return d_a, d_b


def gated_sum_backward(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor, seg: torch.Tensor,
                       valid: int):
    """``(d_a, d_b)`` of kernel A's modulated sum without a gather,
    ``out[e] = sum of a[r] * b[r] over the rows r of group e``, for output
    gradient ``g``: ``d_a[r] = g[seg[r]] * b[r]`` and ``d_b[r] = a[r] *
    g[seg[r]]`` for ``r < valid``, zero rows after, in one launch of
    ``csrc/gather_backward.cu`` for CUDA tensors; the plain version for CPU
    ones.  Counts its kernel launches in ``gated_sum_backward.launches``."""
    if a.device.type == "cpu":
        return gated_sum_backward_plain(a, b, g, seg, valid)
    what, dev, dt = "gated_sum_backward", a.device, a.dtype
    rows = a.shape[0]
    d = a.shape[1] if a.dim() == 2 else -1
    if d % 4 or d <= 0:
        raise ValueError(f"{what}: a must be (rows, D) with D % 4 == 0, got {tuple(a.shape)}")
    bf16 = _build.dtype_flag(what, dt)
    operands = {"a": (a, dt, (rows, d)), "b": (b, dt, (rows, d)), "g": (g, dt, (None, d)),
                "seg": (seg, torch.int32, (rows,))}
    for name, (t, dtype, shape) in operands.items():
        _build.check_operand(what, name, t, dtype, dev, shape)
    if not 0 <= valid <= rows:
        raise ValueError(f"{what}: valid = {valid} outside [0, {rows}]")
    d_a = torch.empty((rows, d), dtype=dt, device=dev)
    d_b = torch.empty_like(d_a)
    if rows == 0:
        return d_a, d_b
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_gated_sum_backward(a.data_ptr(), b.data_ptr(), g.data_ptr(),
                                             seg.data_ptr(), d_a.data_ptr(), d_b.data_ptr(),
                                             rows, valid, d, bf16, stream)
    _build.check(code, what)
    gated_sum_backward.launches += 1
    return d_a, d_b


gated_sum_backward.launches = 0
