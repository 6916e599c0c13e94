// Row gathers of the PAMNet forward: a plain row gather and the edge message
// that gathers its node rows itself.
//
//   row_gather:    out[r, :] = src[idx[r], :]          (r < valid; 0 after)
//   edge_message:  out[r, :] = silu(xi[i[r], :] + xj[j[r], :] + base[r, :])
//                              * gate[r, :] * mask[r]        (gate, mask optional)
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
// What the design does about it:
// * One thread per (row, 4 columns): the D/4 threads of a row read a gathered
//   row, and the row's base and gate, as consecutive 16-byte loads, and write
//   the output the same way, so each transaction is whole.
// * The sum, silu, gate and mask happen in registers: the plain version's
//   two gathered (E, D) tensors, their sum and the silu output are never
//   written, and the int32 indices are read as they are (no int64 copy).
// * row_gather takes the 16-byte path when D % 4 == 0 and a thread per
//   element otherwise (the radial table has 42 columns).
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

template <bool VEC4>
__global__ void row_gather_kernel(const float* __restrict__ src,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out, int rows, int valid,
                                  int cols) {
  // cols counts float4s when VEC4, floats otherwise.  Rows past `valid`
  // are written as zeros and their indices are not read.
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(rows) * cols) return;
  const int r = static_cast<int>(tid / cols);
  const int c = static_cast<int>(tid - static_cast<long long>(r) * cols);
  if (r >= valid) {
    if (VEC4) {
      reinterpret_cast<float4*>(out)[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      out[tid] = 0.f;
    }
    return;
  }
  const long long s = static_cast<long long>(__ldg(idx + r)) * cols + c;
  if (VEC4) {
    reinterpret_cast<float4*>(out)[tid] = __ldg(reinterpret_cast<const float4*>(src) + s);
  } else {
    out[tid] = __ldg(src + s);
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
    row_gather_kernel<true><<<blocks_for(static_cast<long long>(rows) * vecs), kThreads, 0, s>>>(
        src, idx, out, rows, valid, vecs);
  } else {
    row_gather_kernel<false><<<blocks_for(static_cast<long long>(rows) * d), kThreads, 0, s>>>(
        src, idx, out, rows, valid, d);
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
