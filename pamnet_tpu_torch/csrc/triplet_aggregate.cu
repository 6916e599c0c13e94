// Kernel A: gather - modulate - segmented sum over CSR offsets.
//
//   out[e, :] = sum_{r in [off[e], off[e+1])} a[idx[r], :] * b[bidx[r], :]
//
// accumulated in f32, in f32 or bf16 streams (vec.cuh: a, b and out share
// the stream's type; a bf16 row is summed in f32 and rounded once at the
// store).  Template flags switch the gather off (idx = identity,
// a has one row per summed row), the modulation off (b = 1) and the indexed
// read of b off (bidx = identity), so the same kernel does every edge->node
// and triplet->edge sum of the PAMNet forward (the global aggregation at
// eg_src / eg_dst, the el_dst edge->node sum, the t2_ji / t1_ji triplet sums)
// and the sums of the backward:
// * d_a of the gather+modulate sum, by role swap: for a row v of a,
//     d_a[v] = sum_{r: idx[r] = v} g[seg[r]] * b[r]
//   is this kernel over the CSR of idx (perm, poff) with a := g,
//   idx := seg[perm] and bidx := perm, so no permuted copy of b is written;
// * the same role swap with the gathered sum's d_b in one pass
//   (RoleSwapRow): walking group v of the CSR of idx, the kernel holds
//   a[v] and writes d_b[perm[r]] = a[v] * g[seg[perm[r]]] for each row r
//   it sums, so d_b = a[idx] * g[seg] needs no launch of its own; the rows
//   past the CSR's valid count (parked at the end of perm) get zero rows
//   from threads past the last team (the walk's tail);
// * the backward of every row gather, d_src[v] = sum_{r: idx[r] = v} g[r]:
//   gather only, idx := perm over the CSR of idx, or no gather where the
//   rows are sorted by idx.
//
// Replaces: pamnet_tpu/ops/pallas_triplet.py:47 (_kernel, launched by
// _pallas_forward :73 through fused_triplet_aggregate :107) and the d_a of
// its custom VJP (_bwd :122-130, the same kernel with roles swapped).  The
// TPU kernel expressed the gather and the scatter as one-hot matmuls on the
// MXU with the whole output resident in VMEM (pallas_triplet.py:10-19),
// which gated it to QM9 sizes.  None of that carries over: here it is a plain
// gather, a multiply and a segmented sum, with no size gate.
//
// What bounds it on an H100: memory.  At the RNA batch-16 pads (El=186,368
// center edges, T=935,296 triplets, D=16, f32) it moves about 135 MB with
// gather and modulation on (the T gathered 64-byte rows of a, the T rows of
// b, idx, the output) and about 72 MB with both off -- 40 us and 22 us at
// 3.35 TB/s.  It does 2 flops per 8 loaded bytes, far below the card's
// ridge point.  A bf16 stream moves half the row bytes; a lane then takes 8
// values (16 bytes) where D % 8 == 0, so a D=128 row is 16 lanes, not 32.
//
// What the design does about it (the walk itself is csr_walk.cuh, shared
// with the summed edge message of row_gather.cu):
// * Long groups need many loads in flight: one thread per (output row, 4
//   columns) walking its group in order makes ~49 dependent steps at the
//   RNA global sums (D=16, 4 threads a row) and reached 45-74% of the byte
//   bound there.
// * Now a team of lanes x slots threads owns a row: lanes = D/4 column
//   lanes (rounded up to a power of two), slots row slots taking rows
//   off[e] + s + k * slots, and each slot reads the indices of 4 of its rows
//   before it issues their 4 row loads.  The host gives each slot ~4 rows of
//   the mean group within two waves of the card's threads: at D=16 8 slots
//   at the RNA batch-8 global sums (~49 rows a node), 2 at the scoring
//   batch's and at the el sums; at D=128 (QM9, ~12 rows) 4 warps of 32 lanes.
// * The slots' sums meet in a fixed shuffle tree, then in warp order through
//   shared memory; slot 0 stores: no atomics and no zero-fill of the output,
//   and for a fixed shape (lanes, slots) the sum order is fixed, so two
//   calls give the same bits.
// * Registers (cuobjdump -res-usage, chip_smoke.py kernel_resources, sm_90a):
//   40 (no gather, no modulation) to 60 (gather, b through bidx), no stack;
//   4 KB of shared memory for the warps' sums of a team of several warps.
// * The fused role swap (RoleSwapRow) reads its d_a operands exactly as
//   SumRow<true, true, true> does, in the same team shape, so d_a has the
//   role swap's bits; d_b is one product per element, gather_product's
//   bits.  It holds a[v] (a float4 a lane) through the group's walk: the
//   rows of a group share it, and the t2/t1 role swaps have ~1.3 rows a
//   group at the QM9 pads, where d_b's own launch cost more than its
//   bytes.
#include "csr_walk.cuh"

namespace {

// Kernel A's row: a[idx[r]] * b[bidx[r]], the gather, the modulation and
// the indexed read of b each switched off by its flag.
template <class Elem, bool GATHER, bool MODULATE, bool BIDX>
struct SumRow {
  using E = Elem;
  using V = Vf<E::N>;
  const typename E::Raw* a;
  const typename E::Raw* b;
  const int* idx;
  const int* bidx;
  int vecs;

  struct Key {
    int a, b;
  };
  struct Group {};

  __device__ __forceinline__ Group group(long long, int, bool) const { return {}; }

  __device__ __forceinline__ Key key(int r, bool ok) const {
    Key k;
    k.a = GATHER ? (ok ? __ldg(idx + r) : 0) : r;
    k.b = BIDX ? (ok ? __ldg(bidx + r) : 0) : r;
    return k;
  }

  __device__ __forceinline__ V value(const Group&, const Key& k, int, int c) const {
    V v = ldv<E>(a, static_cast<long long>(k.a) * vecs + c);
    if (MODULATE) v = vmul(v, ldv<E>(b, static_cast<long long>(k.b) * vecs + c));
    return v;
  }
};

// The fused role swap's row: kernel A's role swap (d_a[v] += g[seg[r]] *
// b[perm[r]], SumRow<E, true, true, true> with a := g, idx := seg, bidx :=
// perm, the product taken in value() and added in add() as that row's is)
// that also stores d_b[perm[r]] = a[v] * g[seg[r]] for each row r it sums,
// after the batch's loads, and zeros the rows perm[total..rows) in its
// tail.  It keeps the gradient row g as loaded (a bf16 row in half the
// registers) until add() needs it.
template <class Elem>
struct RoleSwapRow {
  using E = Elem;
  using V = Vf<E::N>;
  using Raw = typename E::Raw;
  const Raw* g;
  const Raw* b;
  const Raw* a;
  const int* seg;
  const int* perm;
  Raw* d_b;
  int vecs;
  int total;

  struct Key {
    int a, b;
  };
  struct Group {
    V a;
  };
  // The summed product g * b and the gradient row g it came from.
  struct Value {
    V prod;
    Raw g;
  };

  __device__ __forceinline__ Group group(long long e, int c, bool ok) const {
    return {ok ? ldv<E>(a, e * vecs + c) : vzero<E::N>()};
  }

  __device__ __forceinline__ Key key(int r, bool ok) const {
    Key k;
    k.a = ok ? __ldg(seg + r) : 0;
    k.b = ok ? __ldg(perm + r) : 0;
    return k;
  }

  __device__ __forceinline__ Value value(const Group&, const Key& k, int, int c) const {
    Value out;
    out.g = __ldg(g + static_cast<long long>(k.a) * vecs + c);
    out.prod = vmul(E::unpack(out.g), ldv<E>(b, static_cast<long long>(k.b) * vecs + c));
    return out;
  }

  __device__ __forceinline__ void add(V& acc, const Group& grp, const Key& k, const Value& v,
                                      int c) const {
    stv<E>(d_b, static_cast<long long>(k.b) * vecs + c, vmul(grp.a, E::unpack(v.g)));
    vadd(acc, v.prod);
  }

  // Thread k of the tail: column k % vecs of padded row perm[total + k / vecs].
  __device__ __forceinline__ void tail(long long k) const {
    const long long r = total + k / vecs;
    stv<E>(d_b, static_cast<long long>(__ldg(perm + r)) * vecs + k % vecs, vzero<E::N>());
  }
};

template <class E, bool GATHER, bool MODULATE, bool BIDX>
int launch(const void* a, const void* b, const int* idx, const int* bidx, const int* off,
           void* out, int num_out, int d, int lanes, int slots, cudaStream_t stream) {
  using Raw = typename E::Raw;
  const SumRow<E, GATHER, MODULATE, BIDX> row{static_cast<const Raw*>(a),
                                              static_cast<const Raw*>(b), idx, bidx, d / E::N};
  return launch_walk(row, off, out, num_out, d, lanes, slots, stream);
}

template <class E, bool GATHER>
int launch_modulation(const void* a, const void* b, const int* idx, const int* bidx,
                      const int* off, void* out, int num_out, int d, int lanes, int slots,
                      cudaStream_t s) {
  if (b == nullptr) {
    return launch<E, GATHER, false, false>(a, b, idx, bidx, off, out, num_out, d, lanes, slots,
                                           s);
  }
  if (bidx == nullptr) {
    return launch<E, GATHER, true, false>(a, b, idx, bidx, off, out, num_out, d, lanes, slots,
                                          s);
  }
  return launch<E, GATHER, true, true>(a, b, idx, bidx, off, out, num_out, d, lanes, slots, s);
}

template <class E>
int launch_sum(const void* a, const void* b, const int* idx, const int* bidx, const int* off,
               void* out, int num_out, int d, int lanes, int slots, cudaStream_t s) {
  if (idx != nullptr) {
    return launch_modulation<E, true>(a, b, idx, bidx, off, out, num_out, d, lanes, slots, s);
  }
  return launch_modulation<E, false>(a, b, idx, bidx, off, out, num_out, d, lanes, slots, s);
}

template <class E>
int launch_grad_ab(const void* g, const void* b, const void* a, const int* seg, const int* perm,
                   const int* off, void* d_a, void* d_b, int num_out, int rows, int total,
                   int d, int lanes, int slots, cudaStream_t s) {
  using Raw = typename E::Raw;
  const int vecs = d / E::N;
  const RoleSwapRow<E> row{static_cast<const Raw*>(g), static_cast<const Raw*>(b),
                           static_cast<const Raw*>(a), seg, perm, static_cast<Raw*>(d_b),
                           vecs, total};
  return launch_walk<RoleSwapRow<E>, true>(row, off, d_a, num_out, d, lanes, slots, s,
                                           static_cast<long long>(rows - total) * vecs);
}

}  // namespace

// a: (rows of a, d); b: (rows of b, d) or null; idx: (rows,) i32 or null
// (no gather); bidx: (rows,) i32 or null (b read by row; needs b); off:
// (num_out + 1,) i32; out: (num_out, d).  a, b and out are f32 (bf16 = 0)
// or bf16 (bf16 = 1).  d % 4 == 0, all 16-byte aligned.  lanes, slots: the
// team shape (powers of two, lanes * slots <= 256).  Returns the launch's
// cudaError_t.
extern "C" int pamnet_triplet_aggregate(const void* a, const void* b, const int* idx,
                                        const int* bidx, const int* off, void* out,
                                        int num_out, int d, int lanes, int slots, int bf16,
                                        void* stream) {
  if (bidx != nullptr && b == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_kind(bf16, d)) {
    case kF32x4:
      return launch_sum<F32x4>(a, b, idx, bidx, off, out, num_out, d, lanes, slots, s);
    case kBf16x8:
      return launch_sum<Bf16x8>(a, b, idx, bidx, off, out, num_out, d, lanes, slots, s);
    case kBf16x4:
      return launch_sum<Bf16x4>(a, b, idx, bidx, off, out, num_out, d, lanes, slots, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The fused role swap.  g: (rows of g, d), the forward's output gradient;
// b: (rows, d); a: (num_out, d), the forward's gathered table; seg: (rows,)
// i32, seg[perm[r]] of the forward's rows in the CSR's order; perm: (rows,)
// i32, a permutation of the rows grouped by the forward's idx, the padded
// rows perm[total..rows) after the groups; off: (num_out + 1,) i32 with
// off[num_out] = total; d_a: (num_out, d); d_b: (rows, d), every row
// written.  g, b, a, d_a and d_b are f32 (bf16 = 0) or bf16 (bf16 = 1).
// d % 4 == 0, all 16-byte aligned; lanes, slots: the team shape.  Returns
// the launch's cudaError_t.
extern "C" int pamnet_triplet_aggregate_grad_ab(const void* g, const void* b, const void* a,
                                                const int* seg, const int* perm,
                                                const int* off, void* d_a, void* d_b,
                                                int num_out, int rows, int total, int d,
                                                int lanes, int slots, int bf16,
                                                void* stream) {
  if (total < 0 || total > rows || !g || !b || !a || !seg || !perm || !d_b) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_kind(bf16, d)) {
    case kF32x4:
      return launch_grad_ab<F32x4>(g, b, a, seg, perm, off, d_a, d_b, num_out, rows, total, d,
                                   lanes, slots, s);
    case kBf16x8:
      return launch_grad_ab<Bf16x8>(g, b, a, seg, perm, off, d_a, d_b, num_out, rows, total,
                                    d, lanes, slots, s);
    case kBf16x4:
      return launch_grad_ab<Bf16x4>(g, b, a, seg, perm, off, d_a, d_b, num_out, rows, total,
                                    d, lanes, slots, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pamnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
