// Kernel B's backward: the gradient of the folded spherical-basis modulate
// stage (sbf_modulate.cu), summed by center edge, with respect to the
// projected table, the neighbour messages and the stage's weights.  The
// gradient of the (T, D) rows is that of their sums over identity groups
// (seg[t] = t), which the wrapper passes: one form of the kernel.
//
// Forward, per triplet t with neighbour edge e = idx[t]:
//   acc = bias + sum_l cbf[t, l] * proj[e, l*D:(l+1)*D]     s0 = silu(acc)
//   z1  = s0 @ W1^T + b1                                    s1 = silu(z1)
//   z2  = s1 @ W2^T + b2                                    h  = silu(z2) * mask[t]
//   row(t) = m[e] * h,   summed into out[seg[t]]
// Backward, for the output gradient G and g = G[seg[t]]:
//   d_mrow = g * h                       d_z2 = g * m[e] * mask[t] * silu'(z2)
//   d_z1 = (d_z2 @ W2) * silu'(z1)       d_acc = (d_z1 @ W1) * silu'(acc)
//   d_W2 += d_z2 (x) s1   d_b2 += d_z2   d_W1 += d_z1 (x) s0   d_b1 += d_z1
//   d_bias += d_acc
//   d_proj[e, l*D:(l+1)*D] += cbf[t, l] * d_acc           d_m[e] += d_mrow
//
// Replaces: the gradient of tools/fused_sbf_kernel_probe.py:42 (make_kernel),
// which the JAX package takes by autodiff of _fused_sbf_gather
// (pamnet_tpu/models/layers.py:48-65) and of its sum by center edge
// (:324-332).
//
// Types (csrc/vec.cuh): every float operand, G and the outputs are f32, or
// all bf16.  A bf16 stream is read as single bf16 values (each lane reads
// its column), converted to f32 at the load; the chain, d_proj and d_m are
// kept in f32 registers and rounded once at their store; the weight
// gradients' partials and their fixed-order sum run in f32, and the sum is
// rounded once into the operands' type.  The f32 instance does the
// arithmetic of the f32-only kernel before it, in its order.
//
// What bounds it on an H100: by bytes, memory: the edge rows are read once
// and written once (El x 1 KB in f32, El x 512 B in bf16); each triplet
// reads 40 bytes (perm, cbf, mask, its center id; 24 in bf16) and its row
// of G (64 bytes, 32 in bf16), which is El x 64 B (6 MB at the RNA batch-8
// pads) and stays in L2: about 118 MB, 0.035 ms at 3.35 TB/s at the
// batch-8 t2 pads in f32.  It runs at about a quarter of that
// bound; the likely limit, which no hardware counter has checked, is its
// instructions: about 3 kflop a triplet over four D x D products and two
// outer products, at 126 registers (two blocks of 256 an SM) for D=16.
//
// What the design does about it:
// * Edge-major: D lanes own one neighbour edge e and walk its triplets
//   through the CSR of idx (perm, off) in order.  proj[e] and m[e] are
//   read once per edge, d_proj[e] and d_m[e] summed in registers and written
//   once; no per-triplet scratch is written or read back.
// * Per chunk of D triplets, lane j loads the permuted triplet's cbf row,
//   mask and center id (independent loads in flight together); the walk
//   takes them by __shfl_sync and loads the next triplet's G row ahead.
// * The chain is recomputed in registers.  The four D x D products read the
//   group's vectors as broadcast float4 loads from a per-warp shared buffer
//   and W1, W2 and their transposes from shared memory, rows padded by 4
//   floats so that a quarter-warp's float4 loads hit distinct banks; each
//   product runs as two FMA chains.  Registers are the limit (2 blocks of
//   256 an SM), so values that a shuffle can bring back are not held.
// * Weight gradients: lane c accumulates row c of d_W1 and d_W2 and entries c
//   of d_b1, d_b2, d_bias in registers over every triplet it visits; a
//   block adds its groups in a fixed tree (shuffles, then warps in order)
//   into one row of partials.  The grid is a fixed number of blocks (2 an
//   SM, fewer for few edges; the wrapper's choice from the edge count
//   alone), each walking edges at a fixed stride, so a second kernel sums
//   a few hundred rows in a fixed order.  (Contiguous ranges of edges per
//   block read slower in trials that the repository does not keep.)
//   No float atomics: bitwise repeatable.
#include <cuda_runtime.h>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// sigmoid(x) by the fast exponential and division (a few ulp, far inside
// the gradients' 1e-4 tolerance); silu(x) = x * sg,
// silu'(x) = sg * (1 + x * (1 - sg)).
__device__ __forceinline__ float sigmoid_f32(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

// out + sum_i a[i] * w[i] over D floats from shared memory, both 16-byte
// aligned, a read as a broadcast, w as lane c's own padded row.  Two chains
// (even and odd groups of 4) halve the dependent FMAs; a fixed order.
template <int D>
__device__ __forceinline__ float dot_shared(const float* a, const float* w, float out) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float acc[2] = {out, 0.0f};
#pragma unroll
  for (int q = 0; q < D / 4; ++q) {
    const float4 x = a4[q], y = w4[q];
    float& r = acc[q & 1];
    r += x.x * y.x;
    r += x.y * y.y;
    r += x.z * y.z;
    r += x.w * y.w;
  }
  return acc[0] + acc[1];
}

// acc[i] += s * a[i] over D floats read from shared memory as broadcasts.
template <int D>
__device__ __forceinline__ void outer_row(const float* a, float s, float (&acc)[D]) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
#pragma unroll
  for (int q = 0; q < D / 4; ++q) {
    const float4 x = a4[q];
    acc[4 * q + 0] += s * x.x;
    acc[4 * q + 1] += s * x.y;
    acc[4 * q + 2] += s * x.z;
    acc[4 * q + 3] += s * x.w;
  }
}

// Triplet t's output gradient is G[seg[t]] for t < rows_with_grad, zero
// after.  Writes d_proj, d_m for every edge and row blockIdx.x of partial =
// [d_W1 | d_b1 | d_W2 | d_b2 | d_bias] (f32) of the block's triplets.
template <class E, int NS, int D>
__global__ void __launch_bounds__(kThreads, 2)
sbf_backward_kernel(const typename E::T* __restrict__ proj, const typename E::T* __restrict__ m,
                    const typename E::T* __restrict__ cbf,
                    const typename E::T* __restrict__ bias,
                    const typename E::T* __restrict__ w1, const typename E::T* __restrict__ b1,
                    const typename E::T* __restrict__ w2, const typename E::T* __restrict__ b2,
                    const typename E::T* __restrict__ mask, const typename E::T* __restrict__ g,
                    const int* __restrict__ seg, const int* __restrict__ perm,
                    const int* __restrict__ off, float* __restrict__ partial,
                    typename E::T* __restrict__ d_proj, typename E::T* __restrict__ d_m,
                    int num_edges, int rows_with_grad) {
  static_assert(D == 8 || D == 16, "a group is a power-of-two part of a warp");
  constexpr int kWarps = kThreads / 32;
  constexpr int kGroups = kThreads / D;
  constexpr int S = D + 4;                 // padded row of a weight matrix
  constexpr int P = 2 * D * D + 3 * D;     // [W1 | b1 | W2 | b2 | bias]
  // W1 rows, W1 columns (W1^T rows), W2 rows, W2 columns.
  __shared__ __align__(16) float s_w[4][D * S];
  // Per warp: s0, s1, d_z2, d_z1 of the warp's groups.
  __shared__ __align__(16) float s_act[kWarps][4][32];
  __shared__ float s_red[kWarps * P];
  for (int i = threadIdx.x; i < D * D; i += kThreads) {
    const int o = i / D, k = i % D;
    const float a = E::scalar(w1 + i), b = E::scalar(w2 + i);
    s_w[0][o * S + k] = a;
    s_w[1][k * S + o] = a;
    s_w[2][o * S + k] = b;
    s_w[3][k * S + o] = b;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane & (D - 1);
  const int base = lane - c;
  float(*act)[32] = s_act[warp];
  const float* w1_row = s_w[0] + c * S;
  const float* w1_col = s_w[1] + c * S;
  const float* w2_row = s_w[2] + c * S;
  const float* w2_col = s_w[3] + c * S;
  const float bias_c = E::scalar(bias + c), b1_c = E::scalar(b1 + c), b2_c = E::scalar(b2 + c);

  float dw1[D], dw2[D], db1 = 0.0f, db2 = 0.0f, dbias = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) dw1[i] = dw2[i] = 0.0f;

  // The warp's groups take edges first, first + 1, ...; every lane of the
  // warp runs the same edge and triplet steps (shuffles, warp barriers).
  // Strided over the grid: each block's edges spread over the batch, which
  // balances the blocks' triplets.
  const long long stride = static_cast<long long>(gridDim.x) * kGroups;
  const long long first = static_cast<long long>(blockIdx.x) * kGroups + warp * (32 / D);
  for (long long e0 = first; e0 < num_edges; e0 += stride) {
    const long long e = e0 + lane / D;
    const bool edge = e < num_edges;
    float p[NS], mv = 0.0f;
#pragma unroll
    for (int l = 0; l < NS; ++l) p[l] = 0.0f;
    int begin = 0, count = 0;
    if (edge) {
      const typename E::T* pr = proj + e * (NS * D) + c;
#pragma unroll
      for (int l = 0; l < NS; ++l) p[l] = E::scalar(pr + l * D);
      mv = E::scalar(m + e * D + c);
      begin = __ldg(off + e);
      count = __ldg(off + e + 1) - begin;
    }
    float dp[NS], dm = 0.0f;
#pragma unroll
    for (int l = 0; l < NS; ++l) dp[l] = 0.0f;
    const int steps = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(count)));
    for (int k0 = 0; k0 < steps; k0 += D) {
      // Lane c: the chunk's c-th triplet's basis row, mask and G row (-1:
      // none, the triplet takes no gradient).
      int row_c = -1;
      float mk_c = 0.0f, cb_row[NS];
#pragma unroll
      for (int l = 0; l < NS; ++l) cb_row[l] = 0.0f;
      if (k0 + c < count) {
        const int t = __ldg(perm + begin + k0 + c);
        mk_c = E::scalar(mask + t);
        const typename E::T* cr = cbf + static_cast<long long>(t) * NS;
#pragma unroll
        for (int l = 0; l < NS; ++l) cb_row[l] = E::scalar(cr + l);
        row_c = t < rows_with_grad ? __ldg(seg + t) : -1;
      }
      const int n = min(D, steps - k0);
      const int r0 = __shfl_sync(kFull, row_c, base);
      float gv = r0 >= 0 ? E::scalar(g + static_cast<long long>(r0) * D + c) : 0.0f;
      for (int j = 0; j < n; ++j) {
        // The next triplet's G row, in flight during this one's arithmetic.
        const int rn = __shfl_sync(kFull, row_c, base + ((j + 1) & (D - 1)));
        const float gn = (j + 1 < n && rn >= 0)
                             ? E::scalar(g + static_cast<long long>(rn) * D + c) : 0.0f;
        float acc = bias_c;
#pragma unroll
        for (int l = 0; l < NS; ++l) acc += __shfl_sync(kFull, cb_row[l], base + j) * p[l];
        const float mk = __shfl_sync(kFull, mk_c, base + j);
        const float sg0 = sigmoid_f32(acc);
        const float f0 = sg0 * (1.0f + acc * (1.0f - sg0));
        __syncwarp();  // the previous triplet's reads of act are done
        act[0][lane] = acc * sg0;
        __syncwarp();
        const float z1 = dot_shared<D>(act[0] + base, w1_row, b1_c);
        const float sg1 = sigmoid_f32(z1);
        const float f1 = sg1 * (1.0f + z1 * (1.0f - sg1));
        act[1][lane] = z1 * sg1;
        __syncwarp();
        const float z2 = dot_shared<D>(act[1] + base, w2_row, b2_c);
        const float sg2 = sigmoid_f32(z2);
        // A lane past its edge's triplets has gv = 0: it adds zeros.
        dm += gv * (z2 * sg2 * mk);
        const float dz2 = gv * mv * mk * (sg2 * (1.0f + z2 * (1.0f - sg2)));
        act[2][lane] = dz2;
        __syncwarp();
        outer_row<D>(act[1] + base, dz2, dw2);
        db2 += dz2;
        const float dz1 = f1 * dot_shared<D>(act[2] + base, w2_col, 0.0f);
        act[3][lane] = dz1;
        __syncwarp();
        outer_row<D>(act[0] + base, dz1, dw1);
        db1 += dz1;
        const float dacc = f0 * dot_shared<D>(act[3] + base, w1_col, 0.0f);
        dbias += dacc;
        // The basis values again by shuffle: cheaper than holding NS
        // registers across the chain.
#pragma unroll
        for (int l = 0; l < NS; ++l) dp[l] += __shfl_sync(kFull, cb_row[l], base + j) * dacc;
        gv = gn;
      }
    }
    if (edge) {
      typename E::T* dr = d_proj + e * (NS * D) + c;
#pragma unroll
      for (int l = 0; l < NS; ++l) E::put(dr + l * D, dp[l]);
      E::put(d_m + e * D + c, dm);
    }
  }

  // The block's weight gradients: the warp's groups by a fixed shuffle
  // tree, then the warps in order.
#pragma unroll
  for (int s = 16; s >= D; s >>= 1) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      dw1[i] += __shfl_down_sync(kFull, dw1[i], s);
      dw2[i] += __shfl_down_sync(kFull, dw2[i], s);
    }
    db1 += __shfl_down_sync(kFull, db1, s);
    db2 += __shfl_down_sync(kFull, db2, s);
    dbias += __shfl_down_sync(kFull, dbias, s);
  }
  float* red = s_red + warp * P;
  if (lane < D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      red[c * D + i] = dw1[i];
      red[D * D + D + c * D + i] = dw2[i];
    }
    red[D * D + c] = db1;
    red[2 * D * D + D + c] = db2;
    red[2 * D * D + 2 * D + c] = dbias;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P; i += kThreads) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_red[w * P + i];
    partial[static_cast<long long>(blockIdx.x) * P + i] = v;
  }
}

// out[j] = sum over the blocks of partial[b, j]: thread k sums rows k,
// k + kThreads, ... in order, then a tree over the threads; a fixed order,
// in f32, rounded once into out's type.
template <class E>
__global__ void __launch_bounds__(kThreads)
sbf_backward_reduce_kernel(const float* __restrict__ partial, typename E::T* __restrict__ out,
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
  if (threadIdx.x == 0) E::put(out + j, s[0]);
}

template <class E, int NS, int D>
int launch(const void* proj, const void* m, const void* cbf, const void* bias, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* mask, const void* g,
           const int* seg, const int* perm, const int* off, float* partial, void* wgrad,
           void* d_proj, void* d_m, int num_blocks, int num_edges, int rows_with_grad,
           cudaStream_t stream) {
  using T = typename E::T;
  constexpr int P = 2 * D * D + 3 * D;
  sbf_backward_kernel<E, NS, D><<<num_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(proj), static_cast<const T*>(m), static_cast<const T*>(cbf),
      static_cast<const T*>(bias), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<const T*>(mask),
      static_cast<const T*>(g), seg, perm, off, partial, static_cast<T*>(d_proj),
      static_cast<T*>(d_m), num_edges, rows_with_grad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sbf_backward_reduce_kernel<E><<<P, kThreads, 0, stream>>>(partial, static_cast<T*>(wgrad),
                                                            num_blocks, P);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int launch_shape(const void* proj, const void* m, const void* cbf, const void* bias,
                 const void* w1, const void* b1, const void* w2, const void* b2,
                 const void* mask, const void* g, const int* seg, const int* perm,
                 const int* off, float* partial, void* wgrad, void* d_proj, void* d_m,
                 int num_blocks, int num_edges, int rows_with_grad, int ns, int d,
                 cudaStream_t stream) {
  if (ns == 7 && d == 16) {
    return launch<E, 7, 16>(proj, m, cbf, bias, w1, b1, w2, b2, mask, g, seg, perm, off,
                            partial, wgrad, d_proj, d_m, num_blocks, num_edges,
                            rows_with_grad, stream);
  }
  if (ns == 7 && d == 8) {
    return launch<E, 7, 8>(proj, m, cbf, bias, w1, b1, w2, b2, mask, g, seg, perm, off,
                           partial, wgrad, d_proj, d_m, num_blocks, num_edges,
                           rows_with_grad, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Inputs as pamnet_sbf_modulate (idx through its CSR), plus g (rows, d),
// the output gradient: triplet t < rows_with_grad takes g[seg[t]], seg (T,)
// i32 the center edge of each triplet, the others none.  perm: (T,) i32
// and off: (El+1,) i32 the CSR of idx over its valid rows.  Scratch:
// partial (num_blocks, 2*d*d + 3*d) f32, num_blocks >= 1 blocks of 256
// threads walking the edges.  Outputs: wgrad: (2*d*d + 3*d,) = [d_W1 | d_b1
// | d_W2 | d_b2 | d_bias]; d_proj: (El, ns*d); d_m: (El, d).  Every float
// operand, g and the outputs f32 (bf16 = 0) or all bf16 (bf16 = 1).
// Compiled for ns = 7 and d in {8, 16}.  Returns the first failed launch's
// cudaError_t.
extern "C" int pamnet_sbf_modulate_backward(
    const void* proj, const void* m, const void* cbf, const void* bias, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* mask, const void* g,
    const int* seg, const int* perm, const int* off, float* partial, void* wgrad,
    void* d_proj, void* d_m, int num_blocks, int num_edges, int rows_with_grad, int ns,
    int d, int bf16, void* stream) {
  if (seg == nullptr || num_blocks <= 0 || num_edges <= 0 || rows_with_grad < 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_kind(bf16, d)) {
    case kF32x4:
      return launch_shape<F32x4>(proj, m, cbf, bias, w1, b1, w2, b2, mask, g, seg, perm, off,
                                 partial, wgrad, d_proj, d_m, num_blocks, num_edges,
                                 rows_with_grad, ns, d, s);
    case kBf16x8:
      return launch_shape<Bf16x8>(proj, m, cbf, bias, w1, b1, w2, b2, mask, g, seg, perm,
                                  off, partial, wgrad, d_proj, d_m, num_blocks, num_edges,
                                  rows_with_grad, ns, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}
