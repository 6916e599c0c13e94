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
#include <cuda_runtime.h>

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

__global__ void gated_sum_backward_kernel(const float4* __restrict__ a,
                                          const float4* __restrict__ b,
                                          const float4* __restrict__ g,
                                          const int* __restrict__ seg,
                                          float4* __restrict__ d_a, float4* __restrict__ d_b,
                                          int rows, int valid, int vecs) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(rows) * vecs) return;
  const int r = static_cast<int>(tid / vecs);
  const int c = static_cast<int>(tid - static_cast<long long>(r) * vecs);
  float4 da = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 db = da;
  if (r < valid) {
    const float4 gr = __ldg(g + static_cast<long long>(__ldg(seg + r)) * vecs + c);
    da = mul4(gr, __ldg(b + tid));
    db = mul4(__ldg(a + tid), gr);
  }
  __stcs(d_a + tid, da);
  __stcs(d_b + tid, db);
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

template <bool GATE, bool MASK, bool AT_I>
__global__ void edge_message_backward_kernel(const float* __restrict__ xi,
                                             const float* __restrict__ xj,
                                             const int* __restrict__ i_idx,
                                             const int* __restrict__ j_idx,
                                             const float* __restrict__ base,
                                             const float* __restrict__ gate,
                                             const float* __restrict__ mask,
                                             const float* __restrict__ grad,
                                             float* __restrict__ d_pre,
                                             float* __restrict__ d_gate, int rows,
                                             int valid, int vecs) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(rows) * vecs) return;
  const int r = static_cast<int>(tid / vecs);
  const int c = static_cast<int>(tid - static_cast<long long>(r) * vecs);
  if (r >= valid) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(d_pre)[tid] = zero;
    if (GATE) reinterpret_cast<float4*>(d_gate)[tid] = zero;
    return;
  }
  const long long ir = __ldg(i_idx + r);
  const float4 u = __ldg(reinterpret_cast<const float4*>(xi) + ir * vecs + c);
  const float4 v = __ldg(reinterpret_cast<const float4*>(xj)
                         + static_cast<long long>(__ldg(j_idx + r)) * vecs + c);
  const float4 w = __ldg(reinterpret_cast<const float4*>(base) + tid);
  float4 g = __ldg(reinterpret_cast<const float4*>(grad) + (AT_I ? ir * vecs + c : tid));
  if (MASK) {
    const float k = __ldg(mask + r);
    g = make_float4(g.x * k, g.y * k, g.z * k, g.w * k);
  }
  float4 gt = make_float4(1.f, 1.f, 1.f, 1.f);
  if (GATE) gt = __ldg(reinterpret_cast<const float4*>(gate) + tid);
  float4 dp, dg;
  silu_backward<GATE>(u.x + v.x + w.x, g.x, gt.x, &dp.x, &dg.x);
  silu_backward<GATE>(u.y + v.y + w.y, g.y, gt.y, &dp.y, &dg.y);
  silu_backward<GATE>(u.z + v.z + w.z, g.z, gt.z, &dp.z, &dg.z);
  silu_backward<GATE>(u.w + v.w + w.w, g.w, gt.w, &dp.w, &dg.w);
  reinterpret_cast<float4*>(d_pre)[tid] = dp;
  if (GATE) reinterpret_cast<float4*>(d_gate)[tid] = dg;
}

template <bool AT_I>
int launch_edge_backward(const float* xi, const float* xj, const int* i_idx, const int* j_idx,
                         const float* base, const float* gate, const float* mask,
                         const float* grad, float* d_pre, float* d_gate, int rows, int valid,
                         int vecs, cudaStream_t s) {
  const unsigned blocks = blocks_for(static_cast<long long>(rows) * vecs);
  if (gate && mask) {
    edge_message_backward_kernel<true, true, AT_I><<<blocks, kThreads, 0, s>>>(
        xi, xj, i_idx, j_idx, base, gate, mask, grad, d_pre, d_gate, rows, valid, vecs);
  } else if (gate) {
    edge_message_backward_kernel<true, false, AT_I><<<blocks, kThreads, 0, s>>>(
        xi, xj, i_idx, j_idx, base, gate, mask, grad, d_pre, d_gate, rows, valid, vecs);
  } else if (mask) {
    edge_message_backward_kernel<false, true, AT_I><<<blocks, kThreads, 0, s>>>(
        xi, xj, i_idx, j_idx, base, gate, mask, grad, d_pre, d_gate, rows, valid, vecs);
  } else {
    edge_message_backward_kernel<false, false, AT_I><<<blocks, kThreads, 0, s>>>(
        xi, xj, i_idx, j_idx, base, gate, mask, grad, d_pre, d_gate, rows, valid, vecs);
  }
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

// a, b: (rows, d) f32; g: (num_out, d) f32; seg: (rows,) i32, the output
// row of each row (read for r < valid); d_a, d_b: (rows, d) f32.  d % 4 ==
// 0, 0 <= valid <= rows, all 16-byte aligned.  Returns the launch's
// cudaError_t.
extern "C" int pamnet_gated_sum_backward(const float* a, const float* b, const float* g,
                                         const int* seg, float* d_a, float* d_b, int rows,
                                         int valid, int d, void* stream) {
  if (rows <= 0 || d <= 0 || d % 4 != 0 || valid < 0 || valid > rows || !a || !b || !g ||
      !seg || !d_a || !d_b) {
    return cudaErrorInvalidValue;
  }
  const int vecs = d / 4;
  gated_sum_backward_kernel<<<blocks_for(static_cast<long long>(rows) * vecs), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(b),
      reinterpret_cast<const float4*>(g), seg, reinterpret_cast<float4*>(d_a),
      reinterpret_cast<float4*>(d_b), rows, valid, vecs);
  return static_cast<int>(cudaGetLastError());
}

// xi, xj: (nodes, d) f32; i_idx, j_idx: (rows,) i32; base: (rows, d) f32;
// grad: (rows, d) f32, or with grad_at_i (nodes of xi, d) f32 read at i;
// gate: (rows, d) f32 or null; mask: (rows,) f32 or null; d_pre: (rows, d)
// f32; d_gate: (rows, d) f32, written only with a gate; rows r >= valid get
// zeros.  d % 4 == 0, all 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int pamnet_edge_message_backward(const float* xi, const float* xj,
                                            const int* i_idx, const int* j_idx,
                                            const float* base, const float* gate,
                                            const float* mask, const float* grad,
                                            float* d_pre, float* d_gate, int rows,
                                            int valid, int d, int grad_at_i, void* stream) {
  if (rows <= 0 || d <= 0 || d % 4 != 0 || valid < 0 || valid > rows) {
    return cudaErrorInvalidValue;
  }
  if (gate != nullptr && d_gate == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grad_at_i) {
    return launch_edge_backward<true>(xi, xj, i_idx, j_idx, base, gate, mask, grad, d_pre,
                                      d_gate, rows, valid, d / 4, s);
  }
  return launch_edge_backward<false>(xi, xj, i_idx, j_idx, base, gate, mask, grad, d_pre,
                                     d_gate, rows, valid, d / 4, s);
}
