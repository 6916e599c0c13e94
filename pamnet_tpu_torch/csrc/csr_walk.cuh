// The CSR walk that every sum over sorted groups runs on the card:
//
//   out[e, :] = sum_{r in [off[e], off[e+1])} row(e, r)
//
// where the row value is a device functor (Row): kernel A's gathered,
// modulated row a[idx[r]] * b[bidx[r]] (triplet_aggregate.cu) and the global
// edge message silu(xi[e] + xj[j[r]] + base[r]) * gate[r] * mask[r]
// (row_gather.cu).  Included by both; each gets its own copy.
//
// Layout: a team of lanes x slots threads owns one output row.  Lane l takes
// the vector columns l, l + lanes, ... (vec.cuh: 4 f32 or 8 bf16 values, 16
// bytes, or 4 bf16 values where D % 8 != 0; lanes a power of two, so a row of
// vectors that is not, such as D = 12, leaves a lane idle); slot s takes the
// group's rows
// off[e] + s, off[e] + s + slots, ..., fixed by position.  Each slot reads
// the keys (indices, mask) of kWalkUnroll of its rows first, then issues
// their row loads together, then adds them in row order: kWalkUnroll rows'
// loads are in flight per thread, and a long group is spread over many
// slots instead of one walker per row waiting on each row in turn.  The
// slots' partial sums meet in a fixed order: a __shfl_xor_sync tree inside
// each warp, then, for a team of several warps, the warps' sums added in
// warp order through shared memory; slot 0 stores the row.  No atomics, no
// scratch in device memory: for a fixed team shape (lanes, slots) the order
// of every sum is fixed, so two calls give the same bits.  The row's values
// and every partial sum are f32 whatever the stream's type (Row::E); the
// stored row is rounded once.  The host picks
// the shape (ops/triplet.py::walk_shape) from D and the mean group length;
// a team is at most a block and divides it.
//
// A row functor may also write per-row outputs beside the sum (the role
// swap's d_b): a row that declares its own Value type gets it back in
// row.add(), which runs exactly once for each (summed row, column) of a
// lane that holds the column, after the loads of its batch of rows were
// issued, and never on an idle lane (D = 12 leaves one).  With TAIL, the
// grid takes `tail` threads past the last team, and thread k of them calls
// row.tail(k) once: the rows that no group holds (a CSR's padded rows) are
// written in the same launch.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "vec.cuh"

namespace {

constexpr int kWalkThreads = 256;
constexpr int kWalkUnroll = 4;
constexpr unsigned kWalkAll = 0xffffffffu;

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// What a row loads per (summed row, column): the f32 values of a vector
// (Vf<N>), which the walk adds, or the row's own Value, which row.add()
// adds (and may store from).
template <class Row, class = void>
struct WalkValue {
  using type = Vf<Row::E::N>;
  static constexpr bool kOwn = false;
};
template <class Row>
struct WalkValue<Row, std::void_t<typename Row::Value>> {
  using type = typename Row::Value;
  static constexpr bool kOwn = true;
};

// Row must provide (V = Vf<E::N>):
//   using E;       the element type of its rows and of the output (vec.cuh)
//   struct Key;    per summed row, loaded before the row's values (indices)
//   struct Group;  per (output row, column), loaded once (e.g. xi[e])
//   Group group(long long e, int c, bool ok) const;
//   Key key(int r, bool ok) const;          ok false: r is past the group
//   V value(const Group&, const Key&, int r, int c) const;
// or, declaring its own Value,
//   Value value(const Group&, const Key&, int r, int c) const;
//   void add(V& acc, const Group&, const Key&, const Value&, int c) const;
// and, with TAIL,
//   void tail(long long k) const;           k in [0, tail)
template <class Row, bool TAIL = false>
__global__ void __launch_bounds__(kWalkThreads)
csr_walk_kernel(Row row, const int* __restrict__ off, typename Row::E::Raw* __restrict__ out,
                int num_out, int vecs, int lanes_log2, int slots_log2, long long tail) {
  constexpr int N = Row::E::N;
  // One vector of f32 sums per thread: each warp's sum, for teams of
  // several warps.
  __shared__ Vf<N> warp_sums[kWalkThreads];
  const int team_log2 = lanes_log2 + slots_log2;
  const int warp_team_log2 = min(team_log2, 5);
  const long long t = static_cast<long long>(blockIdx.x) * kWalkThreads + threadIdx.x;
  const long long e = t >> team_log2;
  const int in_team = static_cast<int>(t & ((1 << team_log2) - 1));
  const int slot = in_team >> lanes_log2;
  const int lane = in_team & ((1 << lanes_log2) - 1);
  const int lanes = 1 << lanes_log2;
  const int stride = (1 << slots_log2) * kWalkUnroll;
  const bool live = e < num_out;
  if constexpr (TAIL) {
    const long long teams_end = static_cast<long long>(num_out) << team_log2;
    if (t >= teams_end && t - teams_end < tail) row.tail(t - teams_end);
    // A block of tail threads alone holds no team: it has no shuffle or
    // barrier to reach.
    if (static_cast<long long>(blockIdx.x) * kWalkThreads >= teams_end) return;
  }
  const int start = live ? __ldg(off + e) : 0;
  const int stop = live ? __ldg(off + e + 1) : 0;
  // Every thread of the block runs the same column steps, so each reaches
  // the shuffles and barriers below.
  for (int c0 = 0; c0 < vecs; c0 += lanes) {
    const int c = c0 + lane;
    const bool col = live && c < vecs;
    const typename Row::Group grp = row.group(e, c, col);
    Vf<N> acc = vzero<N>();
    for (int r0 = start + slot; r0 < stop; r0 += stride) {
      typename Row::Key key[kWalkUnroll];
#pragma unroll
      for (int u = 0; u < kWalkUnroll; ++u) {
        const int r = r0 + (u << slots_log2);
        key[u] = row.key(r, r < stop);
      }
      typename WalkValue<Row>::type v[kWalkUnroll];
#pragma unroll
      for (int u = 0; u < kWalkUnroll; ++u) {
        const int r = r0 + (u << slots_log2);
        if (col && r < stop) v[u] = row.value(grp, key[u], r, c);
      }
#pragma unroll
      for (int u = 0; u < kWalkUnroll; ++u) {
        if (col && r0 + (u << slots_log2) < stop) {
          if constexpr (WalkValue<Row>::kOwn) {
            row.add(acc, grp, key[u], v[u], c);
          } else {
            vadd(acc, v[u]);
          }
        }
      }
    }
    for (int o = lanes; o < (1 << warp_team_log2); o <<= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) acc.v[i] += __shfl_xor_sync(kWalkAll, acc.v[i], o);
    }
    if (team_log2 > 5) {  // the same for the whole block
      const int warp_in_team = in_team >> 5;
      __syncthreads();  // the previous column step's sums are read
      warp_sums[threadIdx.x] = acc;
      __syncthreads();
      if (warp_in_team == 0) {
        for (int w = 1; w < (1 << (team_log2 - 5)); ++w) {
          vadd(acc, warp_sums[threadIdx.x + (w << 5)]);
        }
      }
    }
    if (col && slot == 0) stv<typename Row::E>(out, e * vecs + c, acc);
  }
}

int log2_of(int x) {
  int n = 0;
  while (n < 9 && (1 << n) < x) ++n;
  return (1 << n) == x ? n : -1;
}

// Checks the team shape and launches the walk on `stream`, with `tail`
// threads of row.tail() past the teams where TAIL; returns the launch's
// cudaError_t.  `out` holds num_out rows of d values of the row's type.
template <class Row, bool TAIL = false>
int launch_walk(const Row& row, const int* off, void* out, int num_out, int d, int lanes,
                int slots, cudaStream_t stream, long long tail = 0) {
  constexpr int N = Row::E::N;
  const int lanes_log2 = log2_of(lanes), slots_log2 = log2_of(slots);
  if (d <= 0 || d % N != 0 || num_out <= 0 || lanes_log2 < 0 || slots_log2 < 0 ||
      lanes > 32 || lanes * slots > kWalkThreads || tail < 0 || (tail > 0 && !TAIL)) {
    return cudaErrorInvalidValue;
  }
  const long long threads =
      (static_cast<long long>(num_out) << (lanes_log2 + slots_log2)) + tail;
  const unsigned blocks = static_cast<unsigned>((threads + kWalkThreads - 1) / kWalkThreads);
  csr_walk_kernel<Row, TAIL><<<blocks, kWalkThreads, 0, stream>>>(
      row, off, static_cast<typename Row::E::Raw*>(out), num_out, d / N, lanes_log2, slots_log2,
      tail);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
