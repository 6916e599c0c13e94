// Split group sum: the sum of rows by group over a CSR whose groups are long.
//
//   out[k, :] = sum_{p in [off[k], off[k+1])} x[perm[p], :]      (x[p] without perm)
//
// accumulated in f32, in a fixed order.  This is the backward of a row gather
// src[idx] over the CSR of idx (perm, off), where a group is every row that
// gathered one row of src: for the atom-type embedding that is 3 groups of
// ~5,600 rows on an RNA batch of 8 (D=16) and 5 groups of up to ~330 rows on
// a QM9 batch of 32 (D=128).  Rows past off[groups] (the padded rows parked
// at the end of perm) are never read.
//
// Replaces: the backward of the Pallas row gathers tools/vmem_gather_probe.py:42
// (probe_take_1d) and :62 (probe_dynamic_gather), which the JAX package takes
// as XLA's scatter-add, for the CSRs with long groups.  Kernel A
// (triplet_aggregate.cu) sums the other CSRs, whose groups are short.
//
// What bounds it on an H100: latency, not bytes.  At the RNA batch-8 shapes it
// reads ~1.1 MB (0.3 us at 3.35 TB/s), but kernel A gives each (group, 4
// columns) one thread that walks its group in order: 12 threads on the card,
// each ~5,600 dependent perm -> row loads, about 0.1 us each.
//
// What the design does about it: spread each group's rows and columns over
// many threads, so that each thread has one or two batches of independent
// loads, and reduce in a fixed order.
// * A block sums 16 columns (4 column lanes of 16-byte loads) of a group's
//   rows, or of an eighth of them; its 128 row lanes are interleaved over the
//   rows, so neighbouring lanes read neighbouring perm entries, and each
//   thread issues four perm loads, then four row loads, before it adds.
// * Each block reduces its row lanes by a fixed tree in shared memory.  Where
//   the longest group has more rows than one batch of the block's lanes (or
//   is not known), a cluster of 8 blocks splits each group's rows and the
//   cluster's first block adds the 8 partial rows in rank order through
//   distributed shared memory; otherwise one block writes its sum directly.
//   No float atomics, no scratch in device memory and one launch: the sum
//   order depends on the group's length alone, so the result is bitwise
//   repeatable.
// * The grid is one block or cluster per (group, 16 columns), so a CSR of
//   many short groups runs right but wastes blocks: group_sum sends it to
//   kernel A instead.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 512;
constexpr int kLanes = 4;   // column lanes (float4s) of a block
constexpr int kUnroll = 4;  // rows whose loads a thread keeps in flight

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// Rows start + lr, start + lr + step, ... below stop of column quad col, in
// batches of kUnroll: their perm loads, then their row loads, then the adds
// (rows past stop add zeros).
template <bool PERM>
__device__ __forceinline__ float4 lane_sum(const float4* __restrict__ x4,
                                           const int* __restrict__ perm, int first, int stop,
                                           int step, int vecs, int col) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = first; r < stop; r += kUnroll * step) {
    int src[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ru = r + u * step;
      src[u] = ru < stop ? (PERM ? __ldg(perm + ru) : ru) : -1;
    }
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = src[u] >= 0 ? __ldg(x4 + static_cast<long long>(src[u]) * vecs + col)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add4(acc, v[u]);
  }
  return acc;
}

// Block blockIdx.x / CLUSTER sums column lanes [cc * lanes, cc * lanes +
// lanes) of group k (rank-th part of its rows when CLUSTER > 1).
template <bool PERM, int CLUSTER>
__device__ __forceinline__ void group_sum_block(const float* __restrict__ x,
                                                const int* __restrict__ perm,
                                                const int* __restrict__ off,
                                                float* __restrict__ out, int vecs, int lanes,
                                                int row_lanes, int chunks, float4* buf) {
  int rank = 0;
  if constexpr (CLUSTER > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tile = blockIdx.x / CLUSTER;
  const int k = tile / chunks;
  const int col0 = (tile - k * chunks) * lanes;
  const int lo = __ldg(off + k);
  const int hi = __ldg(off + k + 1);
  const int per = (hi - lo + CLUSTER - 1) / CLUSTER;
  const int start = min(hi, lo + rank * per);
  const int stop = min(hi, start + per);
  const int c = threadIdx.x % lanes;
  const int lr = threadIdx.x / lanes;  // >= row_lanes: idle, but takes part in the syncs
  const int col = col0 + c;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lr < row_lanes && col < vecs) {
    acc = lane_sum<PERM>(reinterpret_cast<const float4*>(x), perm, start + lr, stop, row_lanes,
                         vecs, col);
  }
  if (lr < row_lanes) buf[lr * lanes + c] = acc;
  __syncthreads();
  for (int half = row_lanes / 2; half > 0; half /= 2) {
    if (lr < half) add4(buf[lr * lanes + c], buf[(lr + half) * lanes + c]);
    __syncthreads();
  }
  float4* out4 = reinterpret_cast<float4*>(out) + static_cast<long long>(k) * vecs;
  if constexpr (CLUSTER == 1) {
    if (threadIdx.x < lanes && col < vecs) out4[col] = buf[threadIdx.x];
  } else {
    // buf[0 .. lanes) holds this block's partial row; the cluster's first
    // block adds the partials of all its blocks in rank order.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0 && threadIdx.x < lanes && col < vecs) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int b = 0; b < CLUSTER; ++b) {
        add4(sum, *cluster.map_shared_rank(buf + threadIdx.x, b));
      }
      out4[col] = sum;
    }
    // No block leaves (its shared memory) before the first block has read it.
    cluster.sync();
  }
}

template <bool PERM>
__global__ void __launch_bounds__(kThreads) __cluster_dims__(kCluster, 1, 1)
    group_sum_cluster_kernel(const float* __restrict__ x, const int* __restrict__ perm,
                             const int* __restrict__ off, float* __restrict__ out, int vecs,
                             int lanes, int row_lanes, int chunks) {
  __shared__ float4 buf[kThreads];
  group_sum_block<PERM, kCluster>(x, perm, off, out, vecs, lanes, row_lanes, chunks, buf);
}

template <bool PERM>
__global__ void __launch_bounds__(kThreads)
    group_sum_block_kernel(const float* __restrict__ x, const int* __restrict__ perm,
                           const int* __restrict__ off, float* __restrict__ out, int vecs,
                           int lanes, int row_lanes, int chunks) {
  __shared__ float4 buf[kThreads];
  group_sum_block<PERM, 1>(x, perm, off, out, vecs, lanes, row_lanes, chunks, buf);
}

template <bool PERM>
void launch(const float* x, const int* perm, const int* off, float* out, int groups, int vecs,
            bool clustered, cudaStream_t s) {
  const int lanes = vecs < kLanes ? vecs : kLanes;
  const int chunks = (vecs + lanes - 1) / lanes;
  int row_lanes = 1;  // the largest power of two that fits beside the column lanes
  while (row_lanes * 2 * lanes <= kThreads) row_lanes *= 2;
  const unsigned tiles = static_cast<unsigned>(groups) * chunks;
  if (clustered) {
    group_sum_cluster_kernel<PERM><<<tiles * kCluster, kThreads, 0, s>>>(
        x, perm, off, out, vecs, lanes, row_lanes, chunks);
  } else {
    group_sum_block_kernel<PERM><<<tiles, kThreads, 0, s>>>(x, perm, off, out, vecs, lanes,
                                                            row_lanes, chunks);
  }
}

}  // namespace

// x: (rows of x, d) f32; perm: (rows,) i32 or null (rows sorted by group);
// off: (groups + 1,) i32; out: (groups, d) f32; longest: the most rows of a
// group, or <= 0 when not known.  d % 4 == 0, all 16-byte aligned.  Returns
// the launch's cudaError_t.
extern "C" int pamnet_group_sum_split(const float* x, const int* perm, const int* off,
                                      float* out, int groups, int d, int longest,
                                      void* stream) {
  if (d <= 0 || d % 4 != 0 || groups <= 0) return cudaErrorInvalidValue;
  const int vecs = d / 4;
  if (static_cast<long long>(groups) * ((vecs + kLanes - 1) / kLanes) * kCluster > (1LL << 31) - 1) {
    return cudaErrorInvalidValue;
  }
  // One block per group and 16 columns while a group fits one batch of its
  // 128 row lanes (at 16 or more columns); a cluster beyond that.
  const bool clustered = longest <= 0 || longest > (kThreads / kLanes) * kUnroll;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (perm != nullptr) {
    launch<true>(x, perm, off, out, groups, vecs, clustered, s);
  } else {
    launch<false>(x, perm, off, out, groups, vecs, clustered, s);
  }
  return static_cast<int>(cudaGetLastError());
}
