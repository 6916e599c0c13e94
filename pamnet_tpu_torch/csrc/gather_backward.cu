// Backward kernels of the gathers: the product of two gathered rows (d_b of
// kernel A) and the edge message's backward through silu, gate and mask.
//
//   gather_product:         out[r, :] = x[xi[r], :] * y[yi[r], :]   (r < valid)
//                           out[r, :] = 0                           (r >= valid)
//   edge_message_backward:  pre       = xi[i[r], :] + xj[j[r], :] + base[r, :]
//                           G         = g[r]  (rows), or g[i[r]]  (summed)
//                           d_pre[r]  = G * gate[r] * mask[r] * silu'(pre)
//                           d_gate[r] = G * mask[r] * silu(pre)
//                           (r < valid; both 0 for r >= valid)
//
//   gated_sum_backward:     d_a[r]    = g[seg[r], :] * b[r, :]       (r < valid)
//                           d_b[r]    = a[r, :] * g[seg[r], :]
//                           (both 0 for r >= valid)
//
// gate and mask may be null (no factor; then no d_gate).  silu'(p) =
// s (1 + p (1 - s)) with s = sigmoid(p).  The summed form is the backward of
// the edge message summed by the node it goes to (edge_message_sum in
// row_gather.cu): the (N, D) node gradient is read at each edge's i, so the
// (E, D) gather of it that kernel A's sum took in its backward is gone, and
// rows past the CSR's valid count, which the sum never read, get zeros.
//
// gather_product is d_b[t] = a[idx[t]] * g[seg[t]] of kernel A's gather +
// modulate sum (the role swap computes it itself where d_a is wanted too,
// triplet_aggregate.cu).  gated_sum_backward is both gradients of kernel
// A's modulated sum without a gather, out[e] = sum_{r in group e} a[r] *
// b[r]: the local layer's el_dst sum with the rbf gate as b, whose output
// gradient each row reads at its node seg[r] (sorted, so neighbouring
// threads read the same L2-resident row).  The rest of the edge message's backward is
// kernel A: d_base = d_pre, and d_xi, d_xj are sums of d_pre by i and by j
// over the CSR of each endpoint.
//
// Replaces: the backward of pamnet_tpu/ops/pallas_triplet.py (the custom
// VJP's d_b = a[idx] * g[seg] at :129, left to XLA on the TPU, and, with
// idx the identity, the whole of _bwd :122-130 for gated_sum_backward) and the
// backward of the row gathers of tools/vmem_gather_probe.py:86
// (probe_fori_rate, the edge message's gather of node rows).
//
// What bounds them on an H100: memory.  At the QM9 batch-32 pads (D=128,
// f32) gather_product at the two-hop triplets (3,328 rows) reads two
// gathered 512-byte rows and writes one per row; edge_message_backward at
// the global edges (23,808 rows) reads three gathered or streamed rows, the
// gate and the output gradient and writes two rows: about 61 MB, 18 us at
// 3.35 TB/s.  Summed, the gradient is a gathered (N, D) table that stays in
// L2 instead of an (E, D) stream.  An exp and a dozen multiply-adds per
// element are far below the f32 rate.
//
// What the design does about it: one thread per (row, 4 columns) with
// 16-byte loads and stores, as the forward kernels; the pre-activation is
// recomputed from the gathered rows in registers (the forward never writes
// it), so the backward reads the node tables (L2-resident) instead of an
// (E, D) activation.  Rows are independent: no atomics, deterministic.
// Registers (cuobjdump -res-usage, chip_smoke.py kernel_resources, sm_90a):
// edge_message_backward 29 without a gate, 32 with one, in both forms.
// gated_sum_backward reads a, b and the g row of each row's node and writes
// d_a, d_b: ~25 MB at the RNA batch-8 pads (el 91,136, D=16), 7.3 us at
// 3.35 TB/s, two multiplies per 32 bytes.  Its outputs, read once by the
// next kernels, go out with streaming stores (__stcs), so they do not evict
// the g rows that neighbouring threads share.
// edge_message_backward and gated_sum_backward take f32 or bf16 streams
// (vec.cuh: every float operand in the stream's type, the masks too), with
// the arithmetic in f32 and each output rounded once at its store; a bf16
// lane moves 8 values (16 bytes) where D % 8 == 0.  gather_product, off every
// main path since the fused role swap, takes f32 only.
#include <cuda_runtime.h>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;

unsigned blocks_for(long long total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__global__ void gather_product_kernel(const float* __restrict__ x,
                                      const int* __restrict__ xi,
                                      const float* __restrict__ y,
                                      const int* __restrict__ yi,
                                      float* __restrict__ out, int rows,
                                      int valid, int vecs) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(rows) * vecs) return;
  const int r = static_cast<int>(tid / vecs);
  const int c = static_cast<int>(tid - static_cast<long long>(r) * vecs);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < valid) {
    const long long xr = __ldg(xi + r);
    const long long yr = __ldg(yi + r);
    v = mul4(__ldg(reinterpret_cast<const float4*>(x) + xr * vecs + c),
             __ldg(reinterpret_cast<const float4*>(y) + yr * vecs + c));
  }
  reinterpret_cast<float4*>(out)[tid] = v;
}

template <class E>
__global__ void gated_sum_backward_kernel(const typename E::Raw* __restrict__ a,
                                          const typename E::Raw* __restrict__ b,
                                          const typename E::Raw* __restrict__ g,
                                          const int* __restrict__ seg,
                                          typename E::Raw* __restrict__ d_a,
                                          typename E::Raw* __restrict__ d_b, int rows,
                                          int valid, int vecs) {
  constexpr int N = E::N;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(rows) * vecs) return;
  const int r = static_cast<int>(tid / vecs);
  const int c = static_cast<int>(tid - static_cast<long long>(r) * vecs);
  Vf<N> da = vzero<N>();
  Vf<N> db = da;
  if (r < valid) {
    const Vf<N> gr = ldv<E>(g, static_cast<long long>(__ldg(seg + r)) * vecs + c);
    da = vmul(gr, ldv<E>(b, tid));
    db = vmul(ldv<E>(a, tid), gr);
  }
  stv_cs<E>(d_a, tid, da);
  stv_cs<E>(d_b, tid, db);
}

// One element: d_pre and (GATE) d_gate.
template <bool GATE>
__device__ __forceinline__ void silu_backward(float p, float g, float gt,
                                              float* d_pre, float* d_gate) {
  const float s = 1.0f / (1.0f + expf(-p));
  const float ds = s * (1.0f + p * (1.0f - s));
  if (GATE) {
    *d_pre = g * gt * ds;
    *d_gate = g * (p * s);
  } else {
    *d_pre = g * ds;
  }
}

template <class E, bool GATE, bool MASK, bool AT_I>
__global__ void edge_message_backward_kernel(const typename E::Raw* __restrict__ xi,
                                             const typename E::Raw* __restrict__ xj,
                                             const int* __restrict__ i_idx,
                                             const int* __restrict__ j_idx,
                                             const typename E::Raw* __restrict__ base,
                                             const typename E::Raw* __restrict__ gate,
                                             const typename E::T* __restrict__ mask,
                                             const typename E::Raw* __restrict__ grad,
                                             typename E::Raw* __restrict__ d_pre,
                                             typename E::Raw* __restrict__ d_gate, int rows,
                                             int valid, int vecs) {
  constexpr int N = E::N;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(rows) * vecs) return;
  const int r = static_cast<int>(tid / vecs);
  const int c = static_cast<int>(tid - static_cast<long long>(r) * vecs);
  if (r >= valid) {
    stv<E>(d_pre, tid, vzero<N>());
    if (GATE) stv<E>(d_gate, tid, vzero<N>());
    return;
  }
  const long long ir = __ldg(i_idx + r);
  const Vf<N> u = ldv<E>(xi, ir * vecs + c);
  const Vf<N> v = ldv<E>(xj, static_cast<long long>(__ldg(j_idx + r)) * vecs + c);
  const Vf<N> w = ldv<E>(base, tid);
  Vf<N> g = ldv<E>(grad, AT_I ? ir * vecs + c : tid);
  if (MASK) {
    const float k = E::scalar(mask + r);
#pragma unroll
    for (int i = 0; i < N; ++i) g.v[i] *= k;
  }
  Vf<N> gt;
#pragma unroll
  for (int i = 0; i < N; ++i) gt.v[i] = 1.f;
  if (GATE) gt = ldv<E>(gate, tid);
  Vf<N> dp, dg;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    silu_backward<GATE>(u.v[i] + v.v[i] + w.v[i], g.v[i], gt.v[i], &dp.v[i], &dg.v[i]);
  }
  stv<E>(d_pre, tid, dp);
  if (GATE) stv<E>(d_gate, tid, dg);
}

template <class E, bool AT_I>
int launch_edge_backward(const void* xi, const void* xj, const int* i_idx, const int* j_idx,
                         const void* base, const void* gate, const void* mask,
                         const void* grad, void* d_pre, void* d_gate, int rows, int valid,
                         int d, cudaStream_t s) {
  using Raw = typename E::Raw;
  using T = typename E::T;
  const int vecs = d / E::N;
  const unsigned blocks = blocks_for(static_cast<long long>(rows) * vecs);
  const Raw* xi_ = static_cast<const Raw*>(xi);
  const Raw* xj_ = static_cast<const Raw*>(xj);
  const Raw* base_ = static_cast<const Raw*>(base);
  const Raw* gate_ = static_cast<const Raw*>(gate);
  const T* mask_ = static_cast<const T*>(mask);
  const Raw* grad_ = static_cast<const Raw*>(grad);
  Raw* d_pre_ = static_cast<Raw*>(d_pre);
  Raw* d_gate_ = static_cast<Raw*>(d_gate);
  if (gate && mask) {
    edge_message_backward_kernel<E, true, true, AT_I><<<blocks, kThreads, 0, s>>>(
        xi_, xj_, i_idx, j_idx, base_, gate_, mask_, grad_, d_pre_, d_gate_, rows, valid, vecs);
  } else if (gate) {
    edge_message_backward_kernel<E, true, false, AT_I><<<blocks, kThreads, 0, s>>>(
        xi_, xj_, i_idx, j_idx, base_, gate_, mask_, grad_, d_pre_, d_gate_, rows, valid, vecs);
  } else if (mask) {
    edge_message_backward_kernel<E, false, true, AT_I><<<blocks, kThreads, 0, s>>>(
        xi_, xj_, i_idx, j_idx, base_, gate_, mask_, grad_, d_pre_, d_gate_, rows, valid, vecs);
  } else {
    edge_message_backward_kernel<E, false, false, AT_I><<<blocks, kThreads, 0, s>>>(
        xi_, xj_, i_idx, j_idx, base_, gate_, mask_, grad_, d_pre_, d_gate_, rows, valid, vecs);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int launch_edge_backward_of(const void* xi, const void* xj, const int* i_idx,
                            const int* j_idx, const void* base, const void* gate,
                            const void* mask, const void* grad, void* d_pre, void* d_gate,
                            int rows, int valid, int d, int grad_at_i, cudaStream_t s) {
  if (grad_at_i) {
    return launch_edge_backward<E, true>(xi, xj, i_idx, j_idx, base, gate, mask, grad, d_pre,
                                         d_gate, rows, valid, d, s);
  }
  return launch_edge_backward<E, false>(xi, xj, i_idx, j_idx, base, gate, mask, grad, d_pre,
                                        d_gate, rows, valid, d, s);
}

template <class E>
int launch_gated_backward(const void* a, const void* b, const void* g, const int* seg,
                          void* d_a, void* d_b, int rows, int valid, int d, cudaStream_t s) {
  using Raw = typename E::Raw;
  const int vecs = d / E::N;
  gated_sum_backward_kernel<E><<<blocks_for(static_cast<long long>(rows) * vecs), kThreads, 0,
                                 s>>>(static_cast<const Raw*>(a), static_cast<const Raw*>(b),
                                      static_cast<const Raw*>(g), seg, static_cast<Raw*>(d_a),
                                      static_cast<Raw*>(d_b), rows, valid, vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (rows of x, d) f32; xi: (rows,) i32; y: (rows of y, d) f32; yi:
// (rows,) i32; out: (rows, d) f32.  d % 4 == 0, 0 <= valid <= rows, all
// 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int pamnet_gather_product(const float* x, const int* xi, const float* y,
                                     const int* yi, float* out, int rows,
                                     int valid, int d, void* stream) {
  if (rows <= 0 || d <= 0 || d % 4 != 0 || valid < 0 || valid > rows || !xi || !yi) {
    return cudaErrorInvalidValue;
  }
  const int vecs = d / 4;
  gather_product_kernel<<<blocks_for(static_cast<long long>(rows) * vecs), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(x, xi, y, yi, out, rows,
                                                               valid, vecs);
  return static_cast<int>(cudaGetLastError());
}

// a, b: (rows, d); g: (num_out, d); seg: (rows,) i32, the output row of
// each row (read for r < valid); d_a, d_b: (rows, d).  The float operands
// are f32 (bf16 = 0) or bf16 (bf16 = 1).  d % 4 == 0, 0 <= valid <= rows,
// all 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int pamnet_gated_sum_backward(const void* a, const void* b, const void* g,
                                         const int* seg, void* d_a, void* d_b, int rows,
                                         int valid, int d, int bf16, void* stream) {
  if (rows <= 0 || valid < 0 || valid > rows || !a || !b || !g || !seg || !d_a || !d_b) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_kind(bf16, d)) {
    case kF32x4:
      return launch_gated_backward<F32x4>(a, b, g, seg, d_a, d_b, rows, valid, d, s);
    case kBf16x8:
      return launch_gated_backward<Bf16x8>(a, b, g, seg, d_a, d_b, rows, valid, d, s);
    case kBf16x4:
      return launch_gated_backward<Bf16x4>(a, b, g, seg, d_a, d_b, rows, valid, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// xi, xj: (nodes, d); i_idx, j_idx: (rows,) i32; base: (rows, d); grad:
// (rows, d), or with grad_at_i (nodes of xi, d) read at i; gate: (rows, d)
// or null; mask: (rows,) or null; d_pre: (rows, d); d_gate: (rows, d),
// written only with a gate; rows r >= valid get zeros.  The float operands
// are f32 (bf16 = 0) or bf16 (bf16 = 1).  d % 4 == 0, all 16-byte aligned.
// Returns the launch's cudaError_t.
extern "C" int pamnet_edge_message_backward(const void* xi, const void* xj,
                                            const int* i_idx, const int* j_idx,
                                            const void* base, const void* gate,
                                            const void* mask, const void* grad,
                                            void* d_pre, void* d_gate, int rows,
                                            int valid, int d, int grad_at_i, int bf16,
                                            void* stream) {
  if (rows <= 0 || valid < 0 || valid > rows) return cudaErrorInvalidValue;
  if (gate != nullptr && d_gate == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_kind(bf16, d)) {
    case kF32x4:
      return launch_edge_backward_of<F32x4>(xi, xj, i_idx, j_idx, base, gate, mask, grad,
                                            d_pre, d_gate, rows, valid, d, grad_at_i, s);
    case kBf16x8:
      return launch_edge_backward_of<Bf16x8>(xi, xj, i_idx, j_idx, base, gate, mask, grad,
                                             d_pre, d_gate, rows, valid, d, grad_at_i, s);
    case kBf16x4:
      return launch_edge_backward_of<Bf16x4>(xi, xj, i_idx, j_idx, base, gate, mask, grad,
                                             d_pre, d_gate, rows, valid, d, grad_at_i, s);
    default:
      return cudaErrorInvalidValue;
  }
}
