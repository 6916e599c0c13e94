// Kernel B's backward: the gradient of the folded spherical-basis modulate
// stage (sbf_modulate.cu) with respect to the projected table, the neighbour
// messages and the stage's weights.
//
// Forward, per triplet t with neighbour edge e = idx[t]:
//   acc = bias + sum_l cbf[t, l] * proj[e, l*D:(l+1)*D]     s0 = silu(acc)
//   z1  = s0 @ W1^T + b1                                    s1 = silu(z1)
//   z2  = s1 @ W2^T + b2                                    h  = silu(z2) * mask[t]
//   out[t] = m[e] * h
// Backward, for the output gradient g = d_out[t]:
//   d_mrow = g * h                       d_z2 = g * m[e] * mask[t] * silu'(z2)
//   d_z1 = (d_z2 @ W2) * silu'(z1)       d_acc = (d_z1 @ W1) * silu'(acc)
//   d_W2 += d_z2 (x) s1   d_b2 += d_z2   d_W1 += d_z1 (x) s0   d_b1 += d_z1
//   d_bias += d_acc
//   d_proj[e, l*D:(l+1)*D] += cbf[t, l] * d_acc           d_m[e] += d_mrow
//
// Replaces: the gradient of tools/fused_sbf_kernel_probe.py:42 (make_kernel),
// which the JAX package takes by autodiff of _fused_sbf_gather
// (pamnet_tpu/models/layers.py:48-65).
//
// What bounds it on an H100: memory.  Each triplet reads its edge's 512 bytes
// of projected row and message (random rows, about 5 triplets share one), its
// 28 bytes of cbf and 64 bytes of g; each edge writes 512 bytes.  The
// arithmetic (about 3 kflop per triplet) is far below the f32 rate.
//
// What the design does about it, and about the scatter to e:
// * Pass 1, one thread per triplet: recomputes acc, z1, z2 in registers from
//   proj[e], cbf[t] and the weights (the forward saves no (T, D) activation),
//   and writes the two per-triplet gradients d_acc and d_mrow (2 x 64 bytes).
// * The weight gradients are sums over all triplets of outer products.  Each
//   block stages its threads' (d_z, s) vectors in shared memory and thread
//   (o, i) sums d_z[n][o] * s[n][i] over the block's threads n in order; the
//   block writes its 2*D*D + 3*D partial sums to its own row of a
//   (blocks, P) buffer.  Pass 3 sums the rows in a fixed order.  No float
//   atomics anywhere, so the result is bitwise repeatable; the grid depends on
//   the padded triplet count only.
// * Pass 2, one thread per (edge, 4 columns): walks the edge's group of
//   triplets through the permutation that sorts the triplets by idx (the CSR
//   the batch carries) in order, and sums cbf[t, l] * d_acc[t] and d_mrow[t]
//   in registers, writing d_proj[e] and d_m[e] once.  Triplets past the valid
//   count are outside every group and are skipped in pass 1.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// sigmoid(x); silu(x) = x * sg, silu'(x) = sg * (1 + x * (1 - sg)).
__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

// out_w[o*D + i] = sum_n x[n][o] * y[n][i], out_b[o] = sum_n x[n][o] over the
// block's threads n in order; x, y are (kThreads, D+1) in shared memory.
template <int D>
__device__ __forceinline__ void block_outer(const float* s_x, const float* s_y,
                                            float* out_w, float* out_b) {
  constexpr int S = D + 1;
  if (threadIdx.x < D * D) {
    const int o = threadIdx.x / D, i = threadIdx.x % D;
    float w = 0.0f, b = 0.0f;
    for (int n = 0; n < kThreads; ++n) {
      const float xv = s_x[n * S + o];
      w += xv * s_y[n * S + i];
      b += xv;
    }
    out_w[o * D + i] = w;
    if (i == 0) out_b[o] = b;
  }
}

template <int NS, int D>
__global__ void __launch_bounds__(kThreads)
sbf_backward_triplet_kernel(const float* __restrict__ proj, const float* __restrict__ m,
                            const float* __restrict__ cbf, const float* __restrict__ bias,
                            const float* __restrict__ w1, const float* __restrict__ b1,
                            const float* __restrict__ w2, const float* __restrict__ b2,
                            const int* __restrict__ idx, const float* __restrict__ mask,
                            const float* __restrict__ g, float* __restrict__ d_acc,
                            float* __restrict__ d_mrow, float* __restrict__ partial,
                            int num_valid) {
  constexpr int S = D + 1;
  constexpr int P = 2 * D * D + 3 * D;  // [W1 | b1 | W2 | b2 | bias]
  __shared__ float s_w1[D * D], s_w2[D * D], s_b1[D], s_b2[D], s_bias[D];
  __shared__ float s_x[kThreads * S], s_y[kThreads * S];
  for (int i = threadIdx.x; i < D * D; i += kThreads) {
    s_w1[i] = w1[i];
    s_w2[i] = w2[i];
  }
  for (int i = threadIdx.x; i < D; i += kThreads) {
    s_b1[i] = b1[i];
    s_b2[i] = b2[i];
    s_bias[i] = bias[i];
  }
  __syncthreads();
  const int tid = threadIdx.x;
  const int t = blockIdx.x * kThreads + tid;
  const bool active = t < num_valid;
  float* block_partial = partial + static_cast<long long>(blockIdx.x) * P;

  // s0, s1: the activations; fa, f1: silu' of acc and z1, later d_acc and
  // d_z1 in place; dz: d_z2.  An inactive thread contributes zeros.
  float s0[D], fa[D], s1[D], f1[D], dz[D];
#pragma unroll
  for (int d = 0; d < D; ++d) s0[d] = fa[d] = s1[d] = f1[d] = dz[d] = 0.0f;

  if (active) {
    const long long e = __ldg(idx + t);
#pragma unroll
    for (int d = 0; d < D; ++d) fa[d] = s_bias[d];
    const float4* p4 = reinterpret_cast<const float4*>(proj + e * (NS * D));
#pragma unroll
    for (int l = 0; l < NS; ++l) {
      const float c = __ldg(cbf + static_cast<long long>(t) * NS + l);
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 v = __ldg(p4 + l * (D / 4) + q);
        fa[4 * q + 0] += c * v.x;
        fa[4 * q + 1] += c * v.y;
        fa[4 * q + 2] += c * v.z;
        fa[4 * q + 3] += c * v.w;
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float x = fa[d], sg = sigmoid_f32(x);
      s0[d] = x * sg;
      fa[d] = sg * (1.0f + x * (1.0f - sg));
    }
#pragma unroll
    for (int o = 0; o < D; ++o) {
      float z = s_b1[o];
#pragma unroll
      for (int i = 0; i < D; ++i) z += s0[i] * s_w1[o * D + i];
      const float sg = sigmoid_f32(z);
      s1[o] = z * sg;
      f1[o] = sg * (1.0f + z * (1.0f - sg));
    }
    const float mk = __ldg(mask + t);
    const float4* g4 = reinterpret_cast<const float4*>(g + static_cast<long long>(t) * D);
    const float4* m4 = reinterpret_cast<const float4*>(m + e * D);
    float4* r4 = reinterpret_cast<float4*>(d_mrow + static_cast<long long>(t) * D);
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      const float4 gv = __ldg(g4 + q);
      const float4 mv = __ldg(m4 + q);
      const float gq[4] = {gv.x, gv.y, gv.z, gv.w};
      const float mq[4] = {mv.x, mv.y, mv.z, mv.w};
      float rq[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int o = 4 * q + k;
        float z = s_b2[o];
#pragma unroll
        for (int i = 0; i < D; ++i) z += s1[i] * s_w2[o * D + i];
        const float sg = sigmoid_f32(z);
        rq[k] = gq[k] * (z * sg * mk);
        dz[o] = gq[k] * mq[k] * mk * (sg * (1.0f + z * (1.0f - sg)));
      }
      r4[q] = make_float4(rq[0], rq[1], rq[2], rq[3]);
    }
  }

  // d_W2 = sum d_z2 (x) s1, d_b2 = sum d_z2.
#pragma unroll
  for (int d = 0; d < D; ++d) {
    s_x[tid * S + d] = dz[d];
    s_y[tid * S + d] = s1[d];
  }
  __syncthreads();
  block_outer<D>(s_x, s_y, block_partial + D * D + D, block_partial + 2 * D * D + D);
  __syncthreads();

  // d_z1 = (d_z2 @ W2) * silu'(z1), in f1.
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int o = 0; o < D; ++o) s += dz[o] * s_w2[o * D + i];
    f1[i] *= s;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    s_x[tid * S + d] = f1[d];
    s_y[tid * S + d] = s0[d];
  }
  __syncthreads();
  block_outer<D>(s_x, s_y, block_partial, block_partial + D * D);
  __syncthreads();

  // d_acc = (d_z1 @ W1) * silu'(acc), in fa.
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int o = 0; o < D; ++o) s += f1[o] * s_w1[o * D + i];
    fa[i] *= s;
  }
  if (active) {
    float4* a4 = reinterpret_cast<float4*>(d_acc + static_cast<long long>(t) * D);
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      a4[q] = make_float4(fa[4 * q + 0], fa[4 * q + 1], fa[4 * q + 2], fa[4 * q + 3]);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) s_x[tid * S + d] = fa[d];
  __syncthreads();
  if (tid < D) {
    float b = 0.0f;
    for (int n = 0; n < kThreads; ++n) b += s_x[n * S + tid];
    block_partial[2 * D * D + 2 * D + tid] = b;
  }
}

// d_proj[e, l*D + c] = sum over the group of e of cbf[t, l] * d_acc[t, c],
// d_m[e, c] = sum of d_mrow[t, c]; t = perm[r] for r in [off[e], off[e+1]).
template <int NS, int D>
__global__ void sbf_backward_edge_kernel(const float* __restrict__ cbf,
                                         const float* __restrict__ d_acc,
                                         const float* __restrict__ d_mrow,
                                         const int* __restrict__ perm,
                                         const int* __restrict__ off,
                                         float* __restrict__ d_proj,
                                         float* __restrict__ d_m, int num_edges) {
  constexpr int Q = D / 4;
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= static_cast<long long>(num_edges) * Q) return;
  const long long e = gid / Q;
  const int q = static_cast<int>(gid % Q);
  float4 dp[NS];
#pragma unroll
  for (int l = 0; l < NS; ++l) dp[l] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 dm = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int end = __ldg(off + e + 1);
  for (int r = __ldg(off + e); r < end; ++r) {
    const long long t = __ldg(perm + r);
    const float4 a = __ldg(reinterpret_cast<const float4*>(d_acc + t * D) + q);
    const float4 mr = __ldg(reinterpret_cast<const float4*>(d_mrow + t * D) + q);
    dm.x += mr.x;
    dm.y += mr.y;
    dm.z += mr.z;
    dm.w += mr.w;
#pragma unroll
    for (int l = 0; l < NS; ++l) {
      const float c = __ldg(cbf + t * NS + l);
      dp[l].x += c * a.x;
      dp[l].y += c * a.y;
      dp[l].z += c * a.z;
      dp[l].w += c * a.w;
    }
  }
  float4* p4 = reinterpret_cast<float4*>(d_proj + e * (NS * D));
#pragma unroll
  for (int l = 0; l < NS; ++l) p4[l * Q + q] = dp[l];
  reinterpret_cast<float4*>(d_m + e * D)[q] = dm;
}

// out[j] = sum over the blocks of partial[b, j]: thread k sums rows k,
// k + kThreads, ... in order, then a tree over the threads; a fixed order.
__global__ void __launch_bounds__(kThreads)
sbf_backward_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                           int num_blocks, int width) {
  __shared__ float s[kThreads];
  const int j = blockIdx.x;
  float v = 0.0f;
  for (int b = threadIdx.x; b < num_blocks; b += kThreads) {
    v += partial[static_cast<long long>(b) * width + j];
  }
  s[threadIdx.x] = v;
  __syncthreads();
  for (int step = kThreads / 2; step > 0; step /= 2) {
    if (threadIdx.x < step) s[threadIdx.x] += s[threadIdx.x + step];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = s[0];
}

template <int NS, int D>
int launch(const float* proj, const float* m, const float* cbf, const float* bias,
           const float* w1, const float* b1, const float* w2, const float* b2,
           const int* idx, const float* mask, const float* g, const int* perm,
           const int* off, float* d_acc, float* d_mrow, float* partial, float* wgrad,
           float* d_proj, float* d_m, int num_blocks, int num_valid, int num_edges,
           cudaStream_t stream) {
  constexpr int P = 2 * D * D + 3 * D;
  sbf_backward_triplet_kernel<NS, D><<<num_blocks, kThreads, 0, stream>>>(
      proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, g, d_acc, d_mrow, partial, num_valid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sbf_backward_reduce_kernel<<<P, kThreads, 0, stream>>>(partial, wgrad, num_blocks, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = static_cast<long long>(num_edges) * (D / 4);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  sbf_backward_edge_kernel<NS, D><<<blocks, kThreads, 0, stream>>>(
      cbf, d_acc, d_mrow, perm, off, d_proj, d_m, num_edges);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs as pamnet_sbf_modulate, plus g: (T, d) f32 the output gradient;
// perm: (T,) i32 and off: (El+1,) i32 the CSR of idx over its first
// num_valid rows (off[El] == num_valid).  Scratch: d_acc, d_mrow: (T, d);
// partial: (num_blocks, 2*d*d + 3*d) with num_blocks * 256 >= num_valid.
// Outputs: wgrad: (2*d*d + 3*d,) = [d_W1 | d_b1 | d_W2 | d_b2 | d_bias];
// d_proj: (El, ns*d); d_m: (El, d).  Compiled for ns = 7 and d in {8, 16}.
// Returns the first failed launch's cudaError_t.
extern "C" int pamnet_sbf_modulate_backward(
    const float* proj, const float* m, const float* cbf, const float* bias,
    const float* w1, const float* b1, const float* w2, const float* b2, const int* idx,
    const float* mask, const float* g, const int* perm, const int* off, float* d_acc,
    float* d_mrow, float* partial, float* wgrad, float* d_proj, float* d_m,
    int num_blocks, int num_valid, int num_edges, int ns, int d, void* stream) {
  if (num_blocks <= 0 || num_edges <= 0 || num_valid < 0 ||
      static_cast<long long>(num_blocks) * kThreads < num_valid) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ns == 7 && d == 16) {
    return launch<7, 16>(proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, g, perm, off, d_acc,
                         d_mrow, partial, wgrad, d_proj, d_m, num_blocks, num_valid,
                         num_edges, s);
  }
  if (ns == 7 && d == 8) {
    return launch<7, 8>(proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, g, perm, off, d_acc,
                        d_mrow, partial, wgrad, d_proj, d_m, num_blocks, num_valid,
                        num_edges, s);
  }
  return cudaErrorInvalidValue;
}
