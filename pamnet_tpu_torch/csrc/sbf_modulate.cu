// Kernel B: the folded spherical-basis modulate stage of the local layer.
//
// For each triplet t with neighbour edge e = idx[t]:
//   acc = bias + sum_l cbf[t, l] * proj[e, l*D:(l+1)*D]        (l < NS)
//   h   = silu(silu(silu(acc) @ W1^T + b1) @ W2^T + b2) * mask[t]
//   out[t, :] = m_neighbor[e, :] * h
// i.e. the model-level 1-stage sbf MLP folded through the gather, then the
// layer's 2-stage mlp_sbf, the triplet mask and the modulation of the
// gathered neighbour message.  W1, W2 are torch (out, in) matrices.
//
// Replaces: tools/fused_sbf_kernel_probe.py:42 (make_kernel, launched by
// fused :58), the Pallas version of _fused_sbf_gather
// (pamnet_tpu/models/layers.py:48-65).  The Pallas probe was handed rows
// gathered beforehand, because Mosaic could not gather
// (tools/vmem_gather_probe.py:1-28); this kernel gathers by idx itself.
//
// What bounds it on an H100: memory, through the random row gather.  At the
// RNA batch-16 pads (T=935,296 triplets, NS=7, D=16) each triplet reads its
// edge's 448-byte projected row and 64-byte message row: about 0.5 GB of
// random 512-byte rows, plus about 60 MB written.  The edge tables
// themselves are El x 512 B = 95 MB, twice the 50 MB L2.  The arithmetic,
// about 1.3 kflop per triplet, is far below the f32 rate.
//
// What the design does about it:
// * One thread per triplet.  The thread reads its two rows as 16-byte loads
//   that together cover whole 128-byte lines, so no sector of a fetched row
//   is wasted; rows of the same edge (about 5 triplets share one) hit L1/L2.
// * The projected table and the messages stay two tensors: the gather reads
//   the same 512 bytes per triplet as a gather of their concatenation,
//   without a pass that writes the concatenation each layer.
// * The 16x16 weights and biases sit in shared memory and are read as
//   broadcasts; every intermediate (acc, h) stays in registers, so the only
//   write is the (T, D) output.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

template <int NS, int D>
__global__ void sbf_modulate_kernel(const float* __restrict__ proj,
                                    const float* __restrict__ m,
                                    const float* __restrict__ cbf,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ w1,
                                    const float* __restrict__ b1,
                                    const float* __restrict__ w2,
                                    const float* __restrict__ b2,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ mask,
                                    float* __restrict__ out, int num_triplets) {
  __shared__ float s_w1[D * D], s_w2[D * D], s_b1[D], s_b2[D], s_bias[D];
  for (int i = threadIdx.x; i < D * D; i += blockDim.x) {
    s_w1[i] = w1[i];
    s_w2[i] = w2[i];
  }
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    s_b1[i] = b1[i];
    s_b2[i] = b2[i];
    s_bias[i] = bias[i];
  }
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_triplets) return;

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
  float h[D];
#pragma unroll
  for (int d = 0; d < D; ++d) h[d] = silu(acc[d]);
#pragma unroll
  for (int o = 0; o < D; ++o) {
    float s = s_b1[o];
#pragma unroll
    for (int i = 0; i < D; ++i) s += h[i] * s_w1[o * D + i];
    acc[o] = silu(s);
  }
  const float mk = __ldg(mask + t);
#pragma unroll
  for (int o = 0; o < D; ++o) {
    float s = s_b2[o];
#pragma unroll
    for (int i = 0; i < D; ++i) s += acc[i] * s_w2[o * D + i];
    h[o] = silu(s) * mk;
  }
  const float4* m4 = reinterpret_cast<const float4*>(m + e * D);
  float4* o4 = reinterpret_cast<float4*>(out + static_cast<long long>(t) * D);
#pragma unroll
  for (int q = 0; q < D / 4; ++q) {
    const float4 v = __ldg(m4 + q);
    o4[q] = make_float4(v.x * h[4 * q + 0], v.y * h[4 * q + 1],
                        v.z * h[4 * q + 2], v.w * h[4 * q + 3]);
  }
}

template <int NS, int D>
void launch(const float* proj, const float* m, const float* cbf,
            const float* bias, const float* w1, const float* b1,
            const float* w2, const float* b2, const int* idx,
            const float* mask, float* out, int num_triplets,
            cudaStream_t stream) {
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((num_triplets + kThreads - 1) / kThreads);
  sbf_modulate_kernel<NS, D><<<blocks, kThreads, 0, stream>>>(
      proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, out, num_triplets);
}

}  // namespace

// proj: (El, ns*d) f32; m: (El, d) f32; cbf: (T, ns) f32; bias, b1, b2: (d,);
// w1, w2: (d, d) torch (out, in); idx: (T,) i32; mask: (T,) f32;
// out: (T, d) f32.  Compiled for ns = 7 and d in {8, 16}.  Returns the
// launch's cudaError_t.
extern "C" int pamnet_sbf_modulate(const float* proj, const float* m,
                                   const float* cbf, const float* bias,
                                   const float* w1, const float* b1,
                                   const float* w2, const float* b2,
                                   const int* idx, const float* mask,
                                   float* out, int num_triplets, int ns, int d,
                                   void* stream) {
  if (num_triplets <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ns == 7 && d == 16) {
    launch<7, 16>(proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, out, num_triplets, s);
  } else if (ns == 7 && d == 8) {
    launch<7, 8>(proj, m, cbf, bias, w1, b1, w2, b2, idx, mask, out, num_triplets, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
