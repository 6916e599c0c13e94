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
// * One thread per (row, vector of 16 bytes): the threads of a row read a gathered
//   row, and the row's base and gate, as consecutive 16-byte loads, and write
//   the output the same way, so each transaction is whole.
// * The sum, silu, gate and mask happen in registers: the plain version's
//   two gathered (E, D) tensors, their sum and the silu output are never
//   written, and the int32 indices are read as they are (no int64 copy).
// * row_gather takes the 16-byte path, a thread per (row, 16 bytes), when
//   a row is a multiple of 16 bytes.
// * Otherwise (the unfolded path's radial table has D = 42 columns, a
//   168-byte f32 row) a warp owns a tile of 32 consecutive output rows, which
//   are contiguous: lanes take its 8-byte columns (float2 in f32) where a row
//   is a multiple of 8 bytes, else 4- or 2-byte ones, in order, so each step
//   of the warp writes 32 contiguous units.  Each lane reads one row's index
//   and the lanes broadcast it with __shfl_sync; a lane's row and column
//   advance by 32 elements a step with 32-bit adds (one division per thread,
//   where a thread per element did a 64-bit division and remainder each),
//   and each lane issues eight loads before its eight stores, which are
//   marked streaming (evict first), so the output leaves the gathered table
//   in L2.
// * bf16 streams (vec.cuh): the edge messages compute in f32 and round once
//   at the store, their masks in the stream's type.  The row gather is a
//   copy and goes by the bytes of a row: 16-byte vectors where a row is a
//   multiple of 16 bytes (f32 D % 4 == 0, bf16 D % 8 == 0), else the warp
//   tiles in the widest unit that divides a row: 8 bytes (f32 D = 42), 4
//   bytes (bf16 D = 42, an 84-byte row: bf16x2 columns) or 2.
#include "csr_walk.cuh"

namespace {

template <typename U>
__device__ __forceinline__ U zero_of();
template <>
__device__ __forceinline__ uint4 zero_of<uint4>() { return make_uint4(0u, 0u, 0u, 0u); }
template <>
__device__ __forceinline__ uint2 zero_of<uint2>() { return make_uint2(0u, 0u); }
template <>
__device__ __forceinline__ unsigned zero_of<unsigned>() { return 0u; }
template <>
__device__ __forceinline__ unsigned short zero_of<unsigned short>() { return 0; }

// U is the 16-byte unit (uint4), vecs the units of a row.
template <typename U>
__global__ void row_gather_vec_kernel(const U* __restrict__ src, const int* __restrict__ idx,
                                      U* __restrict__ out, int rows, int valid, int vecs) {
  // Rows past `valid` are written as zeros and their indices are not read.
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(rows) * vecs) return;
  const int r = static_cast<int>(tid / vecs);
  const int c = static_cast<int>(tid - static_cast<long long>(r) * vecs);
  out[tid] = r < valid ? __ldg(src + static_cast<long long>(__ldg(idx + r)) * vecs + c)
                       : zero_of<U>();
}

// T is the unit a lane moves (uint2, unsigned or unsigned short: 8, 4 or 2
// bytes) and vecs the units of a row.  A warp writes output rows [32 w,
// 32 w + 32) as one run of 32 * vecs units: unit e of the run is column
// e % vecs of row e / vecs.  Rows past `valid` are written as zeros and
// their indices are not read.
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

template <class E, bool GATE, bool MASK>
__global__ void edge_message_kernel(const typename E::Raw* __restrict__ xi,
                                    const typename E::Raw* __restrict__ xj,
                                    const int* __restrict__ i_idx,
                                    const int* __restrict__ j_idx,
                                    const typename E::Raw* __restrict__ base,
                                    const typename E::Raw* __restrict__ gate,
                                    const typename E::T* __restrict__ mask,
                                    typename E::Raw* __restrict__ out, int rows, int vecs) {
  constexpr int N = E::N;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(rows) * vecs) return;
  const int r = static_cast<int>(tid / vecs);
  const int c = static_cast<int>(tid - static_cast<long long>(r) * vecs);
  const Vf<N> u = ldv<E>(xi, static_cast<long long>(__ldg(i_idx + r)) * vecs + c);
  const Vf<N> v = ldv<E>(xj, static_cast<long long>(__ldg(j_idx + r)) * vecs + c);
  const Vf<N> w = ldv<E>(base, tid);
  Vf<N> m;
#pragma unroll
  for (int i = 0; i < N; ++i) m.v[i] = silu(u.v[i] + v.v[i] + w.v[i]);
  if (GATE) m = vmul(m, ldv<E>(gate, tid));
  if (MASK) {
    const float k = E::scalar(mask + r);
#pragma unroll
    for (int i = 0; i < N; ++i) m.v[i] *= k;
  }
  stv<E>(out, tid, m);
}

// The summed message's row: silu(xi[v] + xj[j[r]] + base[r]) * gate[r] *
// mask[r], with the operations of edge_message_kernel in its order, so a
// group of one row gives that kernel's row bit for bit.
template <class Elem, bool GATE, bool MASK>
struct MessageRow {
  using E = Elem;
  using V = Vf<E::N>;
  using Raw = typename E::Raw;
  const Raw* xi;
  const Raw* xj;
  const int* j_idx;
  const Raw* base;
  const Raw* gate;
  const typename E::T* mask;
  int vecs;

  struct Key {
    int j;
    float k;
  };
  struct Group {
    V xi;
  };

  __device__ __forceinline__ Group group(long long v, int c, bool ok) const {
    return {ok ? ldv<E>(xi, v * vecs + c) : vzero<E::N>()};
  }

  __device__ __forceinline__ Key key(int r, bool ok) const {
    return {ok ? __ldg(j_idx + r) : 0, MASK && ok ? E::scalar(mask + r) : 1.f};
  }

  __device__ __forceinline__ V value(const Group& g, const Key& k, int r, int c) const {
    const V v = ldv<E>(xj, static_cast<long long>(k.j) * vecs + c);
    const V w = ldv<E>(base, static_cast<long long>(r) * vecs + c);
    V m;
#pragma unroll
    for (int i = 0; i < E::N; ++i) m.v[i] = silu(g.xi.v[i] + v.v[i] + w.v[i]);
    if (GATE) m = vmul(m, ldv<E>(gate, static_cast<long long>(r) * vecs + c));
    if (MASK) {
#pragma unroll
      for (int i = 0; i < E::N; ++i) m.v[i] *= k.k;
    }
    return m;
  }
};

template <class E, bool GATE, bool MASK>
int launch_message_sum(const void* xi, const void* xj, const int* j_idx, const void* base,
                       const void* gate, const void* mask, const int* off, void* out,
                       int num_out, int d, int lanes, int slots, cudaStream_t stream) {
  using Raw = typename E::Raw;
  const MessageRow<E, GATE, MASK> row{
      static_cast<const Raw*>(xi), static_cast<const Raw*>(xj), j_idx,
      static_cast<const Raw*>(base), static_cast<const Raw*>(gate),
      static_cast<const typename E::T*>(mask), d / E::N};
  return launch_walk(row, off, out, num_out, d, lanes, slots, stream);
}

template <class E>
int launch_message_sum_of(const void* xi, const void* xj, const int* j_idx, const void* base,
                          const void* gate, const void* mask, const int* off, void* out,
                          int num_out, int d, int lanes, int slots, cudaStream_t s) {
  if (gate && mask) {
    return launch_message_sum<E, true, true>(xi, xj, j_idx, base, gate, mask, off, out,
                                             num_out, d, lanes, slots, s);
  }
  if (gate) {
    return launch_message_sum<E, true, false>(xi, xj, j_idx, base, gate, mask, off, out,
                                              num_out, d, lanes, slots, s);
  }
  if (mask) {
    return launch_message_sum<E, false, true>(xi, xj, j_idx, base, gate, mask, off, out,
                                              num_out, d, lanes, slots, s);
  }
  return launch_message_sum<E, false, false>(xi, xj, j_idx, base, gate, mask, off, out,
                                             num_out, d, lanes, slots, s);
}

constexpr int kThreads = 256;

unsigned blocks_for(long long total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

template <class E, bool GATE, bool MASK>
void launch_message_rows(const void* xi, const void* xj, const int* i_idx, const int* j_idx,
                         const void* base, const void* gate, const void* mask, void* out,
                         int rows, int vecs, cudaStream_t s) {
  using Raw = typename E::Raw;
  edge_message_kernel<E, GATE, MASK><<<blocks_for(static_cast<long long>(rows) * vecs),
                                       kThreads, 0, s>>>(
      static_cast<const Raw*>(xi), static_cast<const Raw*>(xj), i_idx, j_idx,
      static_cast<const Raw*>(base), static_cast<const Raw*>(gate),
      static_cast<const typename E::T*>(mask), static_cast<Raw*>(out), rows, vecs);
}

template <class E>
int launch_message_rows_of(const void* xi, const void* xj, const int* i_idx, const int* j_idx,
                           const void* base, const void* gate, const void* mask, void* out,
                           int rows, int d, cudaStream_t s) {
  const int vecs = d / E::N;
  if (gate && mask) {
    launch_message_rows<E, true, true>(xi, xj, i_idx, j_idx, base, gate, mask, out, rows,
                                       vecs, s);
  } else if (gate) {
    launch_message_rows<E, true, false>(xi, xj, i_idx, j_idx, base, gate, mask, out, rows,
                                        vecs, s);
  } else if (mask) {
    launch_message_rows<E, false, true>(xi, xj, i_idx, j_idx, base, gate, mask, out, rows,
                                        vecs, s);
  } else {
    launch_message_rows<E, false, false>(xi, xj, i_idx, j_idx, base, gate, mask, out, rows,
                                         vecs, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
void launch_tile(const void* src, const int* idx, void* out, int rows, int valid, int vecs,
                 cudaStream_t s) {
  row_gather_tile_kernel<T><<<blocks_for(rows), kThreads, 0, s>>>(
      static_cast<const T*>(src), idx, static_cast<T*>(out), rows, valid, vecs);
}

}  // namespace

// src: (rows of src, d); idx: (rows,) i32; out: (rows, d), rows r >= valid
// zero; src and out f32 (bf16 = 0) or bf16 (bf16 = 1), 16-byte aligned.
// Returns the launch's cudaError_t.
extern "C" int pamnet_row_gather(const void* src, const int* idx, void* out, int rows,
                                 int valid, int d, int bf16, void* stream) {
  if (rows <= 0 || d <= 0 || valid < 0 || valid > rows) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_bytes = d * (bf16 ? 2 : 4);
  if (row_bytes % 16 == 0) {
    const int vecs = row_bytes / 16;
    row_gather_vec_kernel<uint4><<<blocks_for(static_cast<long long>(rows) * vecs), kThreads,
                                   0, s>>>(static_cast<const uint4*>(src), idx,
                                           static_cast<uint4*>(out), rows, valid, vecs);
  } else if (row_bytes % 8 == 0) {
    launch_tile<uint2>(src, idx, out, rows, valid, row_bytes / 8, s);
  } else if (row_bytes % 4 == 0) {
    launch_tile<unsigned>(src, idx, out, rows, valid, row_bytes / 4, s);
  } else {
    launch_tile<unsigned short>(src, idx, out, rows, valid, row_bytes / 2, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// xi, xj: (nodes, d); i_idx, j_idx: (rows,) i32; base: (rows, d); gate:
// (rows, d) or null; mask: (rows,) or null; out: (rows, d).  The float
// operands are f32 (bf16 = 0) or bf16 (bf16 = 1).  d % 4 == 0, all 16-byte
// aligned.  Returns the launch's cudaError_t.
extern "C" int pamnet_edge_message(const void* xi, const void* xj, const int* i_idx,
                                   const int* j_idx, const void* base, const void* gate,
                                   const void* mask, void* out, int rows, int d, int bf16,
                                   void* stream) {
  if (rows <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_kind(bf16, d)) {
    case kF32x4:
      return launch_message_rows_of<F32x4>(xi, xj, i_idx, j_idx, base, gate, mask, out, rows,
                                           d, s);
    case kBf16x8:
      return launch_message_rows_of<Bf16x8>(xi, xj, i_idx, j_idx, base, gate, mask, out,
                                            rows, d, s);
    case kBf16x4:
      return launch_message_rows_of<Bf16x4>(xi, xj, i_idx, j_idx, base, gate, mask, out,
                                            rows, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// xi: (num_out, d), the nodes the messages go to; xj: (nodes, d); j_idx:
// (rows,) i32; base: (rows, d); gate: (rows, d) or null; mask: (rows,) or
// null; off: (num_out + 1,) i32, the sorted CSR of the rows by the node they
// go to; out: (num_out, d).  The float operands are f32 (bf16 = 0) or bf16
// (bf16 = 1).  d % 4 == 0, all 16-byte aligned; lanes, slots: the walk's
// team shape.  Returns the launch's cudaError_t.
extern "C" int pamnet_edge_message_sum(const void* xi, const void* xj, const int* j_idx,
                                       const void* base, const void* gate, const void* mask,
                                       const int* off, void* out, int num_out, int d,
                                       int lanes, int slots, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_kind(bf16, d)) {
    case kF32x4:
      return launch_message_sum_of<F32x4>(xi, xj, j_idx, base, gate, mask, off, out, num_out,
                                          d, lanes, slots, s);
    case kBf16x8:
      return launch_message_sum_of<Bf16x8>(xi, xj, j_idx, base, gate, mask, off, out,
                                           num_out, d, lanes, slots, s);
    case kBf16x4:
      return launch_message_sum_of<Bf16x4>(xi, xj, j_idx, base, gate, mask, off, out,
                                           num_out, d, lanes, slots, s);
    default:
      return cudaErrorInvalidValue;
  }
}
