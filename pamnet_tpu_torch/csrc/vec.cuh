// Element types of the kernels: a row of D values is read and written as
// vectors of N values of the stream's type, and every value is computed in
// f32 registers (Vf<N>), so a bf16 stream accumulates in f32 and rounds once
// at the store (round to nearest even, __float2bfloat16_rn).
//
//   F32x4   float,  4 values a vector (float4, 16 bytes)
//   Bf16x8  bf16,   8 values a vector (uint4, 16 bytes), D % 8 == 0
//   Bf16x4  bf16,   4 values a vector (uint2, 8 bytes),  D % 4 == 0
//
// Each provides T (the element), N, Raw (the vector moved as one load or
// store), unpack(Raw) -> Vf<N> and pack(Vf<N>) -> Raw, and for one value
// scalar(const T*) -> float and put(T*, float) (rounded once).  A bf16
// value's bits are the top half of its f32 bits, so unpacking is exact; the
// low element of a word is the one at the lower address.  elem_kind()
// picks the type from the stream (the wrapper's dtype flag) and D;
// ops/triplet.py::vector_width gives the host the same choice.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <int N>
struct Vf {
  float v[N];
};

template <int N>
__device__ __forceinline__ Vf<N> vzero() {
  Vf<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = 0.f;
  return r;
}

template <int N>
__device__ __forceinline__ void vadd(Vf<N>& acc, const Vf<N>& x) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc.v[i] += x.v[i];
}

template <int N>
__device__ __forceinline__ Vf<N> vmul(const Vf<N>& a, const Vf<N>& b) {
  Vf<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = a.v[i] * b.v[i];
  return r;
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w & 0xffffu)));
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w >> 16)));
}
__device__ __forceinline__ unsigned bf16_word(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

struct F32x4 {
  using T = float;
  using Raw = float4;
  static constexpr int N = 4;
  static __device__ __forceinline__ Vf<4> unpack(const float4& r) {
    return {{r.x, r.y, r.z, r.w}};
  }
  static __device__ __forceinline__ float4 pack(const Vf<4>& f) {
    return make_float4(f.v[0], f.v[1], f.v[2], f.v[3]);
  }
  static __device__ __forceinline__ float scalar(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void put(float* p, float v) { *p = v; }
};

struct Bf16x8 {
  using T = __nv_bfloat16;
  using Raw = uint4;
  static constexpr int N = 8;
  static __device__ __forceinline__ Vf<8> unpack(const uint4& r) {
    return {{bf16_lo(r.x), bf16_hi(r.x), bf16_lo(r.y), bf16_hi(r.y), bf16_lo(r.z),
             bf16_hi(r.z), bf16_lo(r.w), bf16_hi(r.w)}};
  }
  static __device__ __forceinline__ uint4 pack(const Vf<8>& f) {
    return make_uint4(bf16_word(f.v[0], f.v[1]), bf16_word(f.v[2], f.v[3]),
                      bf16_word(f.v[4], f.v[5]), bf16_word(f.v[6], f.v[7]));
  }
  static __device__ __forceinline__ float scalar(const __nv_bfloat16* p) {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

struct Bf16x4 {
  using T = __nv_bfloat16;
  using Raw = uint2;
  static constexpr int N = 4;
  static __device__ __forceinline__ Vf<4> unpack(const uint2& r) {
    return {{bf16_lo(r.x), bf16_hi(r.x), bf16_lo(r.y), bf16_hi(r.y)}};
  }
  static __device__ __forceinline__ uint2 pack(const Vf<4>& f) {
    return make_uint2(bf16_word(f.v[0], f.v[1]), bf16_word(f.v[2], f.v[3]));
  }
  static __device__ __forceinline__ float scalar(const __nv_bfloat16* p) {
    return Bf16x8::scalar(p);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) { Bf16x8::put(p, v); }
};

// Vector i of the rows at p, in f32 registers.
template <class E>
__device__ __forceinline__ Vf<E::N> ldv(const typename E::Raw* p, long long i) {
  return E::unpack(__ldg(p + i));
}

template <class E>
__device__ __forceinline__ void stv(typename E::Raw* p, long long i, const Vf<E::N>& f) {
  p[i] = E::pack(f);
}

// A streaming store (evict first): outputs read once by the next kernels.
template <class E>
__device__ __forceinline__ void stv_cs(typename E::Raw* p, long long i, const Vf<E::N>& f) {
  __stcs(p + i, E::pack(f));
}

enum ElemKind { kElemInvalid = 0, kF32x4 = 1, kBf16x8 = 2, kBf16x4 = 3 };

// The element type of a stream of rows of d values: f32 (bf16 = 0) in
// float4s, bf16 in 16-byte vectors where d % 8 == 0, else 8-byte ones.
inline ElemKind elem_kind(int bf16, int d) {
  if (d <= 0 || d % 4 != 0) return kElemInvalid;
  if (!bf16) return kF32x4;
  return d % 8 == 0 ? kBf16x8 : kBf16x4;
}

}  // namespace
