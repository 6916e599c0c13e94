// Kernel A: gather - modulate - segmented sum over CSR offsets.
//
//   out[e, :] = sum_{r in [off[e], off[e+1])} a[idx[r], :] * b[bidx[r], :]
//
// accumulated in f32.  Template flags switch the gather off (idx = identity,
// a has one row per summed row), the modulation off (b = 1) and the indexed
// read of b off (bidx = identity), so the same kernel does every edge->node
// and triplet->edge sum of the PAMNet forward (the global aggregation at
// eg_src / eg_dst, the el_dst edge->node sum, the t2_ji / t1_ji triplet sums)
// and the sums of the backward:
// * d_a of the gather+modulate sum, by role swap: for a row v of a,
//     d_a[v] = sum_{r: idx[r] = v} g[seg[r]] * b[r]
//   is this kernel over the CSR of idx (perm, poff) with a := g,
//   idx := seg[perm] and bidx := perm, so no permuted copy of b is written;
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
// ridge point.
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
#include "csr_walk.cuh"

namespace {

// Kernel A's row: a[idx[r]] * b[bidx[r]], the gather, the modulation and
// the indexed read of b each switched off by its flag.
template <bool GATHER, bool MODULATE, bool BIDX>
struct SumRow {
  const float4* a;
  const float4* b;
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

  __device__ __forceinline__ float4 value(const Group&, const Key& k, int, int c) const {
    float4 v = __ldg(a + static_cast<long long>(k.a) * vecs + c);
    if (MODULATE) {
      const float4 w = __ldg(b + static_cast<long long>(k.b) * vecs + c);
      v.x *= w.x;
      v.y *= w.y;
      v.z *= w.z;
      v.w *= w.w;
    }
    return v;
  }
};

template <bool GATHER, bool MODULATE, bool BIDX>
int launch(const float* a, const float* b, const int* idx, const int* bidx, const int* off,
           float* out, int num_out, int d, int lanes, int slots, cudaStream_t stream) {
  const SumRow<GATHER, MODULATE, BIDX> row{reinterpret_cast<const float4*>(a),
                                           reinterpret_cast<const float4*>(b), idx, bidx,
                                           d / 4};
  return launch_walk(row, off, out, num_out, d, lanes, slots, stream);
}

template <bool GATHER>
int launch_modulation(const float* a, const float* b, const int* idx, const int* bidx,
                      const int* off, float* out, int num_out, int d, int lanes, int slots,
                      cudaStream_t s) {
  if (b == nullptr) {
    return launch<GATHER, false, false>(a, b, idx, bidx, off, out, num_out, d, lanes, slots, s);
  }
  if (bidx == nullptr) {
    return launch<GATHER, true, false>(a, b, idx, bidx, off, out, num_out, d, lanes, slots, s);
  }
  return launch<GATHER, true, true>(a, b, idx, bidx, off, out, num_out, d, lanes, slots, s);
}

}  // namespace

// a: (rows of a, d) f32; b: (rows of b, d) f32 or null; idx: (rows,) i32 or
// null (no gather); bidx: (rows,) i32 or null (b read by row; needs b);
// off: (num_out + 1,) i32; out: (num_out, d) f32.  d % 4 == 0, all 16-byte
// aligned.  lanes, slots: the team shape (powers of two, lanes * slots <=
// 32).  Returns the launch's cudaError_t.
extern "C" int pamnet_triplet_aggregate(const float* a, const float* b,
                                        const int* idx, const int* bidx,
                                        const int* off, float* out, int num_out,
                                        int d, int lanes, int slots, void* stream) {
  if (bidx != nullptr && b == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx != nullptr) {
    return launch_modulation<true>(a, b, idx, bidx, off, out, num_out, d, lanes, slots, s);
  }
  return launch_modulation<false>(a, b, idx, bidx, off, out, num_out, d, lanes, slots, s);
}

extern "C" const char* pamnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
