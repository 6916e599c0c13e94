// Kernel B: the folded spherical-basis modulate stage of the local layer,
// summed by center edge.
//
// For each triplet t with neighbour edge e = idx[t]:
//   acc = bias + sum_l cbf[t, l] * proj[e, l*D:(l+1)*D]        (l < NS)
//   h   = silu(silu(silu(acc) @ W1^T + b1) @ W2^T + b2) * mask[t]
//   row(t) = m_neighbor[e, :] * h
// i.e. the model-level 1-stage sbf MLP folded through the gather, then the
// layer's 2-stage mlp_sbf, the triplet mask and the modulation of the
// gathered neighbour message.  W1, W2 are torch (out, in) matrices.  With
// the center edges' sorted CSR `off` the kernel writes
//   out[c] = sum over t in [off[c], off[c+1]) of row(t)
// (the sum that kernel A took over its (T, D) output before).  The (T, D)
// rows themselves are the sums over identity groups (off = 0, 1, ..., T),
// which the wrapper passes where a caller asks for the rows: one form of the
// kernel serves both.
//
// Types (csrc/vec.cuh): every float operand and the output are f32, or all
// bf16.  A bf16 stream is read as bf16 (proj and m as 16-byte vectors of 8
// values, cbf, mask and the weights as single values: a cbf row is 14
// bytes, so it is not 16-byte aligned), the weights and biases are
// converted to f32 once into shared memory, and every multiply-add, both
// D x D products, the silus and the sum by center edge run in f32; each
// output value is rounded once at its store.  The f32 instance does the
// arithmetic of the f32-only kernel before it, in its order.
//
// Replaces: tools/fused_sbf_kernel_probe.py:42 (make_kernel, launched by
// fused :58), the Pallas version of _fused_sbf_gather
// (pamnet_tpu/models/layers.py:48-65), and the sum by center edge the JAX
// package takes of its output (pamnet_tpu/models/layers.py:324-332).  The
// Pallas probe was handed rows gathered beforehand, because Mosaic could not
// gather (tools/vmem_gather_probe.py:1-28); this kernel gathers by idx itself.
//
// What bounds it on an H100: by bytes, memory: at the RNA batch-16 pads
// (T=935,296 triplets, El=186,368 edges, NS=7, D=16) the edge tables are
// El x 512 B = 95 MB in f32 (El x 256 B in bf16); each triplet adds 36
// bytes (idx, cbf, mask; 20 in bf16) and each center edge writes 64 bytes
// (32): about 142 MB in f32, 0.04 ms at 3.35 TB/s, and about 73 MB in bf16.
// In practice the arithmetic and the row gather bind it: with every triplet
// on one edge (its rows always cached; chip_smoke.py's sbf_kernels phase)
// the t2 sum takes about half its time on real data; the rest is gathering
// an edge row per triplet (512 bytes in f32, 224 + 32 in bf16; ~0.5 GB
// through L2 at batch 16 in f32, where the table is twice L2).
//
// What the design does about it:
// * One thread per triplet computes the whole D-wide row: it reads its
//   edge's rows as 16-byte loads, keeps every intermediate in registers and
//   reads the DxD weights from shared memory as broadcasts (no exchange
//   between lanes, the fewest instructions a triplet).
// * A block owns whole center edges, about 7/8 of a tile of 256 triplets
//   (picked from the host-known triplet count): its threads compute the
//   rows into a shared-memory tile, then thread k adds the rows of (center
//   edge, column) pairs k, k + 256, ... in triplet order.  The sums are
//   written once, a D-value row per center edge; the (T, D) rows never
//   reach device memory.  Nearly every block is one full tile, and
//   thousands of small blocks keep the SMs evenly loaded.  (Blocks of
//   ~1,000 triplets read slower in trials that the repository does not
//   keep; part-filled tiles and few waves are the likely cause, unmeasured.)
// * silu takes the fast exponential and division (a few ulp, far inside the
//   stage's 1e-4 tolerance).
// * No atomics: each center edge's sum is one thread's, in triplet order,
//   so the result is bitwise repeatable.
#include <cuda_runtime.h>

#include <algorithm>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;

// silu(x) = x * sigmoid(x), by the fast exponential and division.
__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.0f + __expf(-x)); }

// The most center edges a block sums.
constexpr int kMaxBlockGroups = 256;

// One thread per triplet computes its whole row (a tile of kThreads
// consecutive triplets at a time).  The block owns groups
// [block_groups * blockIdx.x, + block_groups) and their triplets; after
// each tile, thread k adds the tile's rows of (group, column) pairs k,
// k + kThreads, ... in triplet order into their sums in shared memory, and
// the sums are written once.
template <class E, int NS, int D>
__global__ void __launch_bounds__(kThreads)
sbf_modulate_kernel(const typename E::T* __restrict__ proj,
                    const typename E::T* __restrict__ m,
                    const typename E::T* __restrict__ cbf,
                    const typename E::T* __restrict__ bias,
                    const typename E::T* __restrict__ w1, const typename E::T* __restrict__ b1,
                    const typename E::T* __restrict__ w2, const typename E::T* __restrict__ b2,
                    const int* __restrict__ idx, const typename E::T* __restrict__ mask,
                    const int* __restrict__ off, typename E::T* __restrict__ out,
                    int num_groups, int block_groups) {
  using Raw = typename E::Raw;
  constexpr int N = E::N;
  static_assert(D % N == 0, "a slice of the row is whole vectors");
  constexpr int R = D + 1;  // padded row of the tile: (group, column) reads spread over banks
  __shared__ __align__(16) float s_w1[D * D], s_w2[D * D];
  __shared__ float s_b1[D], s_b2[D], s_bias[D];
  __shared__ float s_rows[kThreads * R];
  // The block's groups' offsets and their sums.
  __shared__ int s_off[kMaxBlockGroups + 1];
  __shared__ float s_sum[kMaxBlockGroups * D];
  for (int i = threadIdx.x; i < D * D; i += kThreads) {
    s_w1[i] = E::scalar(w1 + i);
    s_w2[i] = E::scalar(w2 + i);
  }
  for (int i = threadIdx.x; i < D; i += kThreads) {
    s_b1[i] = E::scalar(b1 + i);
    s_b2[i] = E::scalar(b2 + i);
    s_bias[i] = E::scalar(bias + i);
  }
  const long long g0 = static_cast<long long>(blockIdx.x) * block_groups;
  const int groups = static_cast<int>(min(static_cast<long long>(block_groups), num_groups - g0));
  for (int j = threadIdx.x; j <= groups; j += kThreads) s_off[j] = __ldg(off + g0 + j);
  for (int q = threadIdx.x; q < groups * D; q += kThreads) s_sum[q] = 0.0f;
  __syncthreads();
  const int t_begin = s_off[0], t_end = s_off[groups];

  for (int tile = t_begin; tile < t_end; tile += kThreads) {
    const int t = tile + threadIdx.x;
    if (t < t_end) {
      float h[D];
      const long long e = __ldg(idx + t);
      float acc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = s_bias[d];
      const Raw* pv = reinterpret_cast<const Raw*>(proj + e * (NS * D));
#pragma unroll
      for (int l = 0; l < NS; ++l) {
        const float c = E::scalar(cbf + static_cast<long long>(t) * NS + l);
#pragma unroll
        for (int q = 0; q < D / N; ++q) {
          const Vf<N> v = ldv<E>(pv, l * (D / N) + q);
#pragma unroll
          for (int k = 0; k < N; ++k) acc[N * q + k] += c * v.v[k];
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) h[d] = silu(acc[d]);
#pragma unroll
      for (int o = 0; o < D; ++o) {
        float z = s_b1[o];
#pragma unroll
        for (int i = 0; i < D; ++i) z += h[i] * s_w1[o * D + i];
        acc[o] = silu(z);
      }
      const float mk = E::scalar(mask + t);
      const Raw* mv = reinterpret_cast<const Raw*>(m + e * D);
#pragma unroll
      for (int q = 0; q < D / N; ++q) {
        const Vf<N> mq = ldv<E>(mv, q);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int o = N * q + k;
          float z = s_b2[o];
#pragma unroll
          for (int i = 0; i < D; ++i) z += acc[i] * s_w2[o * D + i];
          h[o] = mq.v[k] * (silu(z) * mk);
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) s_rows[threadIdx.x * R + d] = h[d];
    }
    __syncthreads();
    for (int q = threadIdx.x; q < groups * D; q += kThreads) {
      const int j = q / D, c = q % D;
      const int a = max(s_off[j], tile), b = min(s_off[j + 1], tile + kThreads);
      if (a < b) {
        float v = s_sum[q];
        for (int r = a; r < b; ++r) v += s_rows[(r - tile) * R + c];
        s_sum[q] = v;
      }
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < groups * D; q += kThreads) E::put(out + g0 * D + q, s_sum[q]);
}

template <class E, int NS, int D>
int launch(const void* proj, const void* m, const void* cbf, const void* bias, const void* w1,
           const void* b1, const void* w2, const void* b2, const int* idx, const void* mask,
           const int* off, void* out, int num_groups, int block_groups,
           cudaStream_t stream) {
  using T = typename E::T;
  const unsigned blocks = static_cast<unsigned>((num_groups + block_groups - 1) / block_groups);
  sbf_modulate_kernel<E, NS, D><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(proj), static_cast<const T*>(m), static_cast<const T*>(cbf),
      static_cast<const T*>(bias), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), idx, static_cast<const T*>(mask),
      off, static_cast<T*>(out), num_groups, block_groups);
  return static_cast<int>(cudaGetLastError());
}

template <class E>
int launch_shape(const void* proj, const void* m, const void* cbf, const void* bias,
                 const void* w1, const void* b1, const void* w2, const void* b2,
                 const int* idx, const void* mask, const int* off, void* out, int num_groups,
                 int block_groups, int ns, int d, cudaStream_t stream) {
  if (ns == 7 && d == 16) {
    return launch<E, 7, 16>(proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, off, out,
                            num_groups, block_groups, stream);
  }
  if (ns == 7 && d == 8) {
    return launch<E, 7, 8>(proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, off, out,
                           num_groups, block_groups, stream);
  }
  return cudaErrorInvalidValue;
}

// Triplets a block aims to walk: 7/8 of one tile, so that nearly every
// block is one tile (a second, part-filled tile would idle most of the
// block) and the grid has many small blocks to balance.
constexpr long long kBlockTriplets = kThreads * 7 / 8;

}  // namespace

// proj: (El, ns*d); m: (El, d); cbf: (T, ns); bias, b1, b2: (d,); w1, w2:
// (d, d) torch (out, in); mask: (T,); out: (num_out, d); all f32 (bf16 = 0)
// or all bf16 (bf16 = 1).  idx: (T,) i32; off: (num_out+1,) i32, the sorted
// CSR of the center edges over the triplets, with valid = off[num_out] <= T
// known on the host; out[c] is group c's sum.  Compiled for ns = 7 and d in
// {8, 16}.  Returns the launch's cudaError_t.
extern "C" int pamnet_sbf_modulate(const void* proj, const void* m, const void* cbf,
                                   const void* bias, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const int* idx,
                                   const void* mask, const int* off, void* out, int num_out,
                                   int num_triplets, int valid, int ns, int d, int bf16,
                                   void* stream) {
  if (off == nullptr || num_out <= 0 || num_triplets < 0 || valid < 0 ||
      valid > num_triplets) {
    return cudaErrorInvalidValue;
  }
  // Groups a block sums: about kBlockTriplets of the batch's triplets.
  const long long per_group = valid > 0 ? valid : 1;
  const int block_groups = static_cast<int>(
      std::max(1LL, std::min(static_cast<long long>(kMaxBlockGroups),
                             (kBlockTriplets * num_out + per_group / 2) / per_group)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_kind(bf16, d)) {
    case kF32x4:
      return launch_shape<F32x4>(proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, off, out,
                                 num_out, block_groups, ns, d, s);
    case kBf16x8:
      return launch_shape<Bf16x8>(proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, off, out,
                                  num_out, block_groups, ns, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}
