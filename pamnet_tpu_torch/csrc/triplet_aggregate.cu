// Kernel A: gather - modulate - segmented sum over CSR offsets.
//
//   out[e, :] = sum_{r in [off[e], off[e+1])} a[idx[r], :] * b[r, :]
//
// accumulated in f32.  Template flags switch the gather off (idx = identity,
// a has one row per summed row) and the modulation off (b = 1), so the same
// kernel does every edge->node and triplet->edge sum of the PAMNet forward:
// the global aggregation at eg_src / eg_dst, the el_dst edge->node sum and
// the t2_ji / t1_ji triplet sums.
//
// Replaces: pamnet_tpu/ops/pallas_triplet.py:47 (_kernel, launched by
// _pallas_forward :73 through fused_triplet_aggregate :107).  The TPU kernel
// expressed the gather and the scatter as one-hot matmuls on the MXU with the
// whole output resident in VMEM (pallas_triplet.py:10-19), which gated it to
// QM9 sizes.  None of that carries over: here it is a plain gather, a
// multiply and a segmented sum, with no size gate.
//
// What bounds it on an H100: memory.  At the RNA batch-16 pads (El=186,368
// center edges, T=935,296 triplets, D=16, f32) it moves about 135 MB with
// gather and modulation on (the T gathered 64-byte rows of a, the T rows of
// b, idx, the output) and about 72 MB with both off -- 40 us and 22 us at
// 3.35 TB/s.  It does 2 flops per 8 loaded bytes, far below the card's
// ridge point.
//
// What the design does about it:
// * Blocks own output rows and each thread walks the CSR range of its row,
//   so there are no atomics and the sum order is fixed: the result is
//   deterministic, and no zero-fill pass of the output is needed.
// * One thread per (output row, 4 columns): the D/4 threads of a row read a
//   gathered row as consecutive 16-byte loads, one whole 64-byte segment at
//   D=16, and write the output row the same way, so every transaction is
//   full.  Read-only loads go through the non-coherent cache (__ldg).
// * Groups are short (about 5 triplets per center edge, about 50 global
//   edges per node), so a thread per row keeps the load balanced without a
//   split of long groups.
#include <cuda_runtime.h>

namespace {

template <bool GATHER, bool MODULATE>
__global__ void triplet_aggregate_kernel(const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         const int* __restrict__ idx,
                                         const int* __restrict__ off,
                                         float* __restrict__ out,
                                         int num_out, int vecs_per_row) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(num_out) * vecs_per_row) return;
  const int e = static_cast<int>(tid / vecs_per_row);
  const int c = static_cast<int>(tid - static_cast<long long>(e) * vecs_per_row);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int stop = __ldg(off + e + 1);
  for (int r = __ldg(off + e); r < stop; ++r) {
    const long long src = GATHER ? static_cast<long long>(__ldg(idx + r)) : r;
    float4 v = __ldg(a4 + src * vecs_per_row + c);
    if (MODULATE) {
      const float4 w = __ldg(b4 + static_cast<long long>(r) * vecs_per_row + c);
      v.x *= w.x;
      v.y *= w.y;
      v.z *= w.z;
      v.w *= w.w;
    }
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  reinterpret_cast<float4*>(out)[tid] = acc;
}

template <bool GATHER, bool MODULATE>
void launch(const float* a, const float* b, const int* idx, const int* off,
            float* out, int num_out, int vecs, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long total = static_cast<long long>(num_out) * vecs;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  triplet_aggregate_kernel<GATHER, MODULATE>
      <<<blocks, kThreads, 0, stream>>>(a, b, idx, off, out, num_out, vecs);
}

}  // namespace

// a: (rows of a, d) f32; b: (rows, d) f32 or null; idx: (rows,) i32 or null;
// off: (num_out + 1,) i32; out: (num_out, d) f32.  d % 4 == 0, all 16-byte
// aligned.  Returns the launch's cudaError_t.
extern "C" int pamnet_triplet_aggregate(const float* a, const float* b,
                                        const int* idx, const int* off,
                                        float* out, int num_out, int d,
                                        int gather, int modulate, void* stream) {
  if (d <= 0 || d % 4 != 0 || num_out <= 0) return cudaErrorInvalidValue;
  if ((gather && idx == nullptr) || (modulate && b == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vecs = d / 4;
  if (gather && modulate) {
    launch<true, true>(a, b, idx, off, out, num_out, vecs, s);
  } else if (gather) {
    launch<true, false>(a, b, idx, off, out, num_out, vecs, s);
  } else if (modulate) {
    launch<false, true>(a, b, idx, off, out, num_out, vecs, s);
  } else {
    launch<false, false>(a, b, idx, off, out, num_out, vecs, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pamnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
