// Row gathers of the PAMNet forward: a plain row gather and the edge message
// that gathers its node rows itself, as rows or summed by the node it goes to.
//
//   row_gather:        out[r, :] = src[idx[r], :]          (r < valid; 0 after)
//   edge_message:      out[r, :] = silu(xi[i[r], :] + xj[j[r], :] + base[r, :])
//                                  * gate[r, :] * mask[r]    (gate, mask optional)
//   edge_message_sum:  out[v, :] = sum_{r in [off[v], off[v+1])} of that row,
//                      over the sorted CSR of i (i[r] = v in group v)
//
// row_gather is the atom-type embedding lookup, the unfolded path's gather
// of the radial table and the backward of kernel A's no-gather sums
// (d_a[r] = g[seg[r]] for the rows a sum read, 0 for its padded rows);
// edge_message is the message of the global layer
// (gate = W_edge_attr(e), mask = edge mask) and both messages of the local
// layer (m_ji: no gate; m_kj: gate = lin_rbf(rbf)).  xi and xj are the node
// features projected through the slices of the message MLP's first weight
// (project-then-gather), base the edge slice of that product plus its bias.
//
// Replaces: tools/vmem_gather_probe.py:42 (probe_take_1d), :62
// (probe_dynamic_gather) and :86 (probe_fori_rate), the three Pallas row
// gathers out[r] = src[idx[r]].  On the TPU they were probes of whether
// Mosaic could gather rows from VMEM at all; the model gathered through XLA.
// On the card a gather is a plain indexed load, so one kernel does the row
// gather and a second fuses it into the one consumer that gathers the most.
//
// What bounds it on an H100: memory.  At the RNA batch-16 pads the global
// message reads 1,675,136 edges x (two int32 indices + a 64-byte base row +
// a 64-byte gate row + a mask) and writes a 64-byte row each: about 0.34 GB,
// 0.10 ms at 3.35 TB/s.  The gathered tables are 34,304 nodes x 64 B = 2.2 MB
// each and stay in L2, so the gather itself costs L2 and not HBM traffic.
// The arithmetic (an exp and a few multiply-adds per element) is far below
// the f32 rate.
//
// The summed message is the global layer's message and its edge->node sum
// (pamnet_tpu/models/layers.py:224-228, global_mp: the message, then the
// segment sum at i), which kernel A took over the (E, D) rows before.  At the
// batch-16 scoring pads it moves 1,675,136 edges x (a 4-byte j, 64 B of base,
// 64 B of gate, a 4-byte mask) plus the 2.2 MB tables and the (N, D) output:
// about 0.235 GB, 0.070 ms at 3.35 TB/s, where the rows (0.10 ms bound) and
// kernel A's sum of them (~0.033 ms) moved 0.45 GB.
//
// What the design does about it:
// * The summed message runs the CSR walk of csr_walk.cuh (kernel A's) with
//   the message as its row functor: a team of lanes x slots threads per
//   node (its shape from ops/triplet.py::walk_shape), xi[v] read once per
//   group (the rows are sorted by i), the rows' j, mask, base and gate
//   loaded 4 rows ahead; no (E, D) message is written.
//   Registers (cuobjdump -res-usage, chip_smoke.py kernel_resources, sm_90a):
//   64, with 8 bytes of stack where a mask is read; 4 KB of shared memory.
// * One thread per (row, 4 columns): the D/4 threads of a row read a gathered
//   row, and the row's base and gate, as consecutive 16-byte loads, and write
//   the output the same way, so each transaction is whole.
// * The sum, silu, gate and mask happen in registers: the plain version's
//   two gathered (E, D) tensors, their sum and the silu output are never
//   written, and the int32 indices are read as they are (no int64 copy).
// * row_gather takes the 16-byte path, a thread per (row, 4 columns), when
//   D % 4 == 0.
// * Otherwise (the unfolded path's radial table has D = 42 columns, a
//   168-byte row) a warp owns a tile of 32 consecutive output rows, which
//   are 32 * D contiguous floats: lanes take its 8-byte (float2) columns
//   when D is even (4-byte ones when it is odd) in order, so each step of
//   the warp writes 256 contiguous bytes.  Each lane reads one row's index
//   and the lanes broadcast it with __shfl_sync; a lane's row and column
//   advance by 32 elements a step with 32-bit adds (one division per thread,
//   where a thread per element did a 64-bit division and remainder each),
//   and each lane issues eight loads before its eight stores, which are
//   marked streaming (evict first), so the output leaves the gathered table
//   in L2.
#include "csr_walk.cuh"

namespace {

__global__ void row_gather_vec4_kernel(const float4* __restrict__ src,
                                       const int* __restrict__ idx,
                                       float4* __restrict__ out, int rows, int valid,
                                       int vecs) {
  // Rows past `valid` are written as zeros and their indices are not read.
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(rows) * vecs) return;
  const int r = static_cast<int>(tid / vecs);
  const int c = static_cast<int>(tid - static_cast<long long>(r) * vecs);
  out[tid] = r < valid ? __ldg(src + static_cast<long long>(__ldg(idx + r)) * vecs + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ float2 zero_of<float2>() { return make_float2(0.f, 0.f); }

// T is float2 (D even, vecs = D / 2) or float (vecs = D).  A warp writes
// output rows [32 w, 32 w + 32) as one run of 32 * vecs elements: element e
// of the run is column e % vecs of row e / vecs.  Rows past `valid` are
// written as zeros and their indices are not read.
template <typename T>
__global__ void row_gather_tile_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                                       T* __restrict__ out, int rows, int valid, int vecs) {
  constexpr int kUnroll = 8;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * blockDim.x + threadIdx.x - lane);  // 32 rows per warp
  if (row0 >= rows) return;  // the whole warp
  const int tile_rows = min(32, rows - row0);
  const int mine = row0 + lane < valid ? __ldg(idx + row0 + lane) : -1;  // -1: a zero row
  T* tile = out + static_cast<long long>(row0) * vecs;
  int tr = lane / vecs;  // this lane's row in the tile and column, advanced by
  int col = lane % vecs;  // 32 elements a step
  const int step_r = 32 / vecs;
  const int step_c = 32 % vecs;
  for (int i0 = 0; i0 < vecs; i0 += kUnroll) {
    T v[kUnroll];
    int at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = __shfl_sync(kAll, mine, tr & 31);
      const bool in = i0 + u < vecs && tr < tile_rows;
      at[u] = in ? tr * vecs + col : -1;
      v[u] = in && s >= 0 ? __ldg(src + static_cast<long long>(s) * vecs + col) : zero_of<T>();
      tr += step_r;
      col += step_c;
      if (col >= vecs) {
        col -= vecs;
        ++tr;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (at[u] >= 0) __stcs(tile + at[u], v[u]);  // streamed: leave L2 to the table
    }
  }
}

template <bool GATE, bool MASK>
__global__ void edge_message_kernel(const float* __restrict__ xi,
                                    const float* __restrict__ xj,
                                    const int* __restrict__ i_idx,
                                    const int* __restrict__ j_idx,
                                    const float* __restrict__ base,
                                    const float* __restrict__ gate,
                                    const float* __restrict__ mask,
                                    float* __restrict__ out, int rows, int vecs) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(rows) * vecs) return;
  const int r = static_cast<int>(tid / vecs);
  const int c = static_cast<int>(tid - static_cast<long long>(r) * vecs);
  const float4 u = __ldg(reinterpret_cast<const float4*>(xi)
                         + static_cast<long long>(__ldg(i_idx + r)) * vecs + c);
  const float4 v = __ldg(reinterpret_cast<const float4*>(xj)
                         + static_cast<long long>(__ldg(j_idx + r)) * vecs + c);
  const float4 w = __ldg(reinterpret_cast<const float4*>(base) + tid);
  float4 m = make_float4(silu(u.x + v.x + w.x), silu(u.y + v.y + w.y),
                         silu(u.z + v.z + w.z), silu(u.w + v.w + w.w));
  if (GATE) {
    const float4 g = __ldg(reinterpret_cast<const float4*>(gate) + tid);
    m.x *= g.x;
    m.y *= g.y;
    m.z *= g.z;
    m.w *= g.w;
  }
  if (MASK) {
    const float k = __ldg(mask + r);
    m.x *= k;
    m.y *= k;
    m.z *= k;
    m.w *= k;
  }
  reinterpret_cast<float4*>(out)[tid] = m;
}

// The summed message's row: silu(xi[v] + xj[j[r]] + base[r]) * gate[r] *
// mask[r], with the operations of edge_message_kernel in its order, so a
// group of one row gives that kernel's row bit for bit.
template <bool GATE, bool MASK>
struct MessageRow {
  const float4* xi;
  const float4* xj;
  const int* j_idx;
  const float4* base;
  const float4* gate;
  const float* mask;
  int vecs;

  struct Key {
    int j;
    float k;
  };
  struct Group {
    float4 xi;
  };

  __device__ __forceinline__ Group group(long long v, int c, bool ok) const {
    return {ok ? __ldg(xi + v * vecs + c) : make_float4(0.f, 0.f, 0.f, 0.f)};
  }

  __device__ __forceinline__ Key key(int r, bool ok) const {
    return {ok ? __ldg(j_idx + r) : 0, MASK && ok ? __ldg(mask + r) : 1.f};
  }

  __device__ __forceinline__ float4 value(const Group& g, const Key& k, int r, int c) const {
    const float4 u = g.xi;
    const float4 v = __ldg(xj + static_cast<long long>(k.j) * vecs + c);
    const float4 w = __ldg(base + static_cast<long long>(r) * vecs + c);
    float4 m = make_float4(silu(u.x + v.x + w.x), silu(u.y + v.y + w.y),
                           silu(u.z + v.z + w.z), silu(u.w + v.w + w.w));
    if (GATE) {
      const float4 gt = __ldg(gate + static_cast<long long>(r) * vecs + c);
      m.x *= gt.x;
      m.y *= gt.y;
      m.z *= gt.z;
      m.w *= gt.w;
    }
    if (MASK) {
      m.x *= k.k;
      m.y *= k.k;
      m.z *= k.k;
      m.w *= k.k;
    }
    return m;
  }
};

template <bool GATE, bool MASK>
int launch_message_sum(const float* xi, const float* xj, const int* j_idx, const float* base,
                       const float* gate, const float* mask, const int* off, float* out,
                       int num_out, int d, int lanes, int slots, cudaStream_t stream) {
  const MessageRow<GATE, MASK> row{
      reinterpret_cast<const float4*>(xi), reinterpret_cast<const float4*>(xj), j_idx,
      reinterpret_cast<const float4*>(base), reinterpret_cast<const float4*>(gate), mask,
      d / 4};
  return launch_walk(row, off, out, num_out, d, lanes, slots, stream);
}

constexpr int kThreads = 256;

unsigned blocks_for(long long total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

}  // namespace

// src: (rows of src, d) f32; idx: (rows,) i32; out: (rows, d) f32, rows
// r >= valid zero; 16-byte aligned when d % 4 == 0.  Returns the launch's
// cudaError_t.
extern "C" int pamnet_row_gather(const float* src, const int* idx, float* out,
                                 int rows, int valid, int d, void* stream) {
  if (rows <= 0 || d <= 0 || valid < 0 || valid > rows) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0) {
    const int vecs = d / 4;
    row_gather_vec4_kernel<<<blocks_for(static_cast<long long>(rows) * vecs), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(src), idx, reinterpret_cast<float4*>(out), rows, valid,
        vecs);
  } else if (d % 2 == 0) {
    row_gather_tile_kernel<float2><<<blocks_for(rows), kThreads, 0, s>>>(
        reinterpret_cast<const float2*>(src), idx, reinterpret_cast<float2*>(out), rows, valid,
        d / 2);
  } else {
    row_gather_tile_kernel<float><<<blocks_for(rows), kThreads, 0, s>>>(src, idx, out, rows,
                                                                        valid, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// xi, xj: (nodes, d) f32; i_idx, j_idx: (rows,) i32; base: (rows, d) f32;
// gate: (rows, d) f32 or null; mask: (rows,) f32 or null; out: (rows, d)
// f32.  d % 4 == 0, all 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int pamnet_edge_message(const float* xi, const float* xj,
                                   const int* i_idx, const int* j_idx,
                                   const float* base, const float* gate,
                                   const float* mask, float* out, int rows,
                                   int d, void* stream) {
  if (rows <= 0 || d <= 0 || d % 4 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vecs = d / 4;
  const unsigned blocks = blocks_for(static_cast<long long>(rows) * vecs);
  if (gate && mask) {
    edge_message_kernel<true, true><<<blocks, kThreads, 0, s>>>(
        xi, xj, i_idx, j_idx, base, gate, mask, out, rows, vecs);
  } else if (gate) {
    edge_message_kernel<true, false><<<blocks, kThreads, 0, s>>>(
        xi, xj, i_idx, j_idx, base, gate, mask, out, rows, vecs);
  } else if (mask) {
    edge_message_kernel<false, true><<<blocks, kThreads, 0, s>>>(
        xi, xj, i_idx, j_idx, base, gate, mask, out, rows, vecs);
  } else {
    edge_message_kernel<false, false><<<blocks, kThreads, 0, s>>>(
        xi, xj, i_idx, j_idx, base, gate, mask, out, rows, vecs);
  }
  return static_cast<int>(cudaGetLastError());
}

// xi: (num_out, d) f32, the nodes the messages go to; xj: (nodes, d) f32;
// j_idx: (rows,) i32; base: (rows, d) f32; gate: (rows, d) f32 or null;
// mask: (rows,) f32 or null; off: (num_out + 1,) i32, the sorted CSR of the
// rows by the node they go to; out: (num_out, d) f32.  d % 4 == 0, all
// 16-byte aligned; lanes, slots: the walk's team shape.  Returns the
// launch's cudaError_t.
extern "C" int pamnet_edge_message_sum(const float* xi, const float* xj, const int* j_idx,
                                       const float* base, const float* gate,
                                       const float* mask, const int* off, float* out,
                                       int num_out, int d, int lanes, int slots,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gate && mask) {
    return launch_message_sum<true, true>(xi, xj, j_idx, base, gate, mask, off, out, num_out,
                                          d, lanes, slots, s);
  }
  if (gate) {
    return launch_message_sum<true, false>(xi, xj, j_idx, base, gate, mask, off, out,
                                           num_out, d, lanes, slots, s);
  }
  if (mask) {
    return launch_message_sum<false, true>(xi, xj, j_idx, base, gate, mask, off, out,
                                           num_out, d, lanes, slots, s);
  }
  return launch_message_sum<false, false>(xi, xj, j_idx, base, gate, mask, off, out, num_out,
                                          d, lanes, slots, s);
}
