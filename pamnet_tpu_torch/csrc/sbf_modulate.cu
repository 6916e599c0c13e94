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
// (the sum that kernel A took over its (T, D) output before); without it,
// each triplet is its own group and out[t] = row(t).
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
// El x 512 B = 95 MB; each triplet adds 36 bytes (idx, cbf, mask) and each
// center edge writes 64 bytes: about 142 MB, 0.04 ms at 3.35 TB/s.  In
// practice the arithmetic and the row gather bind it: with every triplet
// on one edge (its rows always cached; chip_smoke.py's sbf_kernels phase)
// the t2 sum takes about half its time on real data; the rest is gathering
// a 512-byte edge row per triplet (~0.5 GB through L2 at batch 16, where
// the table is twice L2).
//
// What the design does about it:
// * One thread per triplet computes the whole D-wide row: it reads its
//   edge's rows as 16-byte loads, keeps every intermediate in registers and
//   reads the 16x16 weights from shared memory as broadcasts (no exchange
//   between lanes, the fewest instructions a triplet).
// * Summed, a block owns whole center edges, about 7/8 of a tile of 256
//   triplets (picked from the host-known triplet count): its threads
//   compute the rows into a shared-memory tile, then thread k adds the
//   rows of (center edge, column) pairs k, k + 256, ... in triplet order.
//   The sums are written once, a D-float row per center edge; the (T, D)
//   rows never reach device memory.  Nearly every block is one full tile,
//   and thousands of small blocks keep the SMs evenly loaded.  (Blocks of
//   ~1,000 triplets read slower in trials that the repository does not
//   keep; part-filled tiles and few waves are the likely cause, unmeasured.)
// * silu takes the fast exponential and division (a few ulp, far inside the
//   stage's 1e-4 tolerance).
// * No atomics: each center edge's sum is one thread's, in triplet order,
//   so the result is bitwise repeatable.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

// silu(x) = x * sigmoid(x), by the fast exponential and division.
__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.0f + __expf(-x)); }

// The most center edges a block sums (SUMMED).
constexpr int kMaxBlockGroups = 256;

// One thread per triplet computes its whole row (a tile of kThreads
// consecutive triplets at a time).  SUMMED: the block owns groups
// [block_groups * blockIdx.x, + block_groups) and their triplets; after
// each tile, thread k adds the tile's rows of (group, column) pairs k,
// k + kThreads, ... in triplet order into their sums in shared memory, and
// the sums are written once.  Else the block's tile is rows
// [kThreads * blockIdx.x, + kThreads), written as computed.
template <int NS, int D, bool SUMMED>
__global__ void __launch_bounds__(kThreads)
sbf_modulate_kernel(const float* __restrict__ proj, const float* __restrict__ m,
                    const float* __restrict__ cbf, const float* __restrict__ bias,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const int* __restrict__ idx, const float* __restrict__ mask,
                    const int* __restrict__ off, float* __restrict__ out, int num_groups,
                    int num_triplets, int block_groups) {
  constexpr int R = D + 1;  // padded row of the tile: (group, column) reads spread over banks
  __shared__ __align__(16) float s_w1[D * D], s_w2[D * D];
  __shared__ float s_b1[D], s_b2[D], s_bias[D];
  __shared__ float s_rows[SUMMED ? kThreads * R : 1];
  // SUMMED: the block's groups' offsets and their sums.
  __shared__ int s_off[SUMMED ? kMaxBlockGroups + 1 : 1];
  __shared__ float s_sum[SUMMED ? kMaxBlockGroups * D : 1];
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

  int t_begin, t_end;
  long long g0 = 0;
  int groups = 0;  // the block's groups
  if (SUMMED) {
    g0 = static_cast<long long>(blockIdx.x) * block_groups;
    groups = static_cast<int>(min(static_cast<long long>(block_groups), num_groups - g0));
    for (int j = threadIdx.x; j <= groups; j += kThreads) s_off[j] = __ldg(off + g0 + j);
    for (int q = threadIdx.x; q < groups * D; q += kThreads) s_sum[q] = 0.0f;
    __syncthreads();
    t_begin = s_off[0];
    t_end = s_off[groups];
  } else {
    t_begin = blockIdx.x * kThreads;
    t_end = min(t_begin + kThreads, num_triplets);
  }

  for (int tile = t_begin; tile < t_end; tile += kThreads) {
    const int t = tile + threadIdx.x;
    float h[D];
    if (t < t_end) {
      const long long e = __ldg(idx + t);
      float acc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = s_bias[d];
      const float4* p4 = reinterpret_cast<const float4*>(proj + e * (NS * D));
#pragma unroll
      for (int l = 0; l < NS; ++l) {
        const float c = __ldg(cbf + static_cast<long long>(t) * NS + l);
#pragma unroll
        for (int q = 0; q < D / 4; ++q) {
          const float4 v = __ldg(p4 + l * (D / 4) + q);
          acc[4 * q + 0] += c * v.x;
          acc[4 * q + 1] += c * v.y;
          acc[4 * q + 2] += c * v.z;
          acc[4 * q + 3] += c * v.w;
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
      const float mk = __ldg(mask + t);
      const float4* m4 = reinterpret_cast<const float4*>(m + e * D);
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 v = __ldg(m4 + q);
        const float mq[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int o = 4 * q + k;
          float z = s_b2[o];
#pragma unroll
          for (int i = 0; i < D; ++i) z += acc[i] * s_w2[o * D + i];
          h[o] = mq[k] * (silu(z) * mk);
        }
      }
      if (!SUMMED) {
        float4* o4 = reinterpret_cast<float4*>(out + static_cast<long long>(t) * D);
#pragma unroll
        for (int q = 0; q < D / 4; ++q) {
          o4[q] = make_float4(h[4 * q + 0], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
        }
      }
    }
    if (SUMMED) {
      if (t < t_end) {
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
  }
  if (SUMMED) {
    for (int q = threadIdx.x; q < groups * D; q += kThreads) out[g0 * D + q] = s_sum[q];
  }
}

template <int NS, int D>
int launch(const float* proj, const float* m, const float* cbf, const float* bias,
           const float* w1, const float* b1, const float* w2, const float* b2,
           const int* idx, const float* mask, const int* off, float* out, int num_groups,
           int num_triplets, int block_groups, cudaStream_t stream) {
  if (off != nullptr) {
    const unsigned blocks = static_cast<unsigned>((num_groups + block_groups - 1) / block_groups);
    sbf_modulate_kernel<NS, D, true><<<blocks, kThreads, 0, stream>>>(
        proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, off, out, num_groups, num_triplets,
        block_groups);
  } else {
    const unsigned blocks = static_cast<unsigned>((num_triplets + kThreads - 1) / kThreads);
    sbf_modulate_kernel<NS, D, false><<<blocks, kThreads, 0, stream>>>(
        proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, off, out, num_groups, num_triplets,
        block_groups);
  }
  return static_cast<int>(cudaGetLastError());
}


// Triplets a block of the summed kernel aims to walk: 7/8 of one tile, so
// that nearly every block is one tile (a second, part-filled tile would
// idle most of the block) and the grid has many small blocks to balance.
constexpr long long kBlockTriplets = kThreads * 7 / 8;

}  // namespace

// proj: (El, ns*d) f32; m: (El, d) f32; cbf: (T, ns) f32; bias, b1, b2: (d,);
// w1, w2: (d, d) torch (out, in); idx: (T,) i32; mask: (T,) f32.  With off
// (num_out+1,) i32, the sorted CSR of the center edges over the triplets,
// and valid = off[num_out] <= T known on the host: out (num_out, d), each
// group's sum.  With off NULL (num_out and valid ignored): out (T, d), a
// row per triplet.  Compiled for ns = 7 and d in {8, 16}.  Returns the
// launch's cudaError_t.
extern "C" int pamnet_sbf_modulate(const float* proj, const float* m, const float* cbf,
                                   const float* bias, const float* w1, const float* b1,
                                   const float* w2, const float* b2, const int* idx,
                                   const float* mask, const int* off, float* out,
                                   int num_out, int num_triplets, int valid, int ns, int d,
                                   void* stream) {
  if ((off != nullptr ? num_out : num_triplets) <= 0 || num_triplets < 0 || valid < 0 ||
      valid > num_triplets) {
    return cudaErrorInvalidValue;
  }
  // Groups a block sums: about kBlockTriplets of the batch's triplets.
  const long long per_group = valid > 0 ? valid : 1;
  const int block_groups = static_cast<int>(
      std::max(1LL, std::min(static_cast<long long>(kMaxBlockGroups),
                             (kBlockTriplets * num_out + per_group / 2) / per_group)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ns == 7 && d == 16) {
    return launch<7, 16>(proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, off, out, num_out,
                         num_triplets, block_groups, s);
  }
  if (ns == 7 && d == 8) {
    return launch<7, 8>(proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, off, out, num_out,
                        num_triplets, block_groups, s);
  }
  return cudaErrorInvalidValue;
}
