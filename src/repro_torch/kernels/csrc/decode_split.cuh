// What the split-K decode kernels share (decode_attention.cu, kernel 6;
// mla_decode.cu, kernel 7): a 16-byte unit of a cache row widened to
// float32, a position read on the device, the online softmax's rescale,
// and the merge of the key splits' partials in split order, the one place
// whose order keeps a call bitwise the same from run to run.
//
// A split's partial is a row of W + 2 floats: its unnormalised
// accumulator (W columns), then its running max m and sum l.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace decode_split {

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// exp(m_old - m_new), 0 for a state that has seen no key yet
__device__ __forceinline__ float rescale(float m_old, float m_new) {
  return m_old == neg_inf() ? 0.f : __expf(m_old - m_new);
}

// A 16-byte unit of a row, widened to float32; one element widened and stored.
template <typename T>
struct Unit;

template <>
struct Unit<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ float one(float x) { return x; }
  static __device__ __forceinline__ void store(float* o, float x) { *o = x; }
};

template <>
struct Unit<__nv_bfloat16> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ void widen(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float one(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ void store(__nv_bfloat16* o, float x) {
    *o = __float2bfloat16_rn(x);
  }
};

// A position: read from the device when `ptr` is set (int64 when `is64`,
// else int32), else `val`.
struct Pos {
  const void* ptr;
  long long val;
  int is64;
};

__device__ __forceinline__ long long read_pos(const Pos& p) {
  if (p.ptr == nullptr) return p.val;
  return p.is64 ? *static_cast<const long long*>(p.ptr)
                : static_cast<long long>(*static_cast<const int*>(p.ptr));
}

// out[bh] (W columns) from the first `live` of row bh's `splits` partials
// (laid out [bh][split][W + 2]), in split order; one warp, `lane` its lane.
template <typename T, int W>
__device__ __forceinline__ void merge_splits(const float* __restrict__ part, T* __restrict__ o,
                                             int bh, int splits, int live, int lane) {
  constexpr int kPer = (W + 31) / 32;
  const size_t row = static_cast<size_t>(W + 2);
  const float* p = part + static_cast<size_t>(bh) * splits * row;
  float M = neg_inf();
  for (int s = 0; s < live; ++s) M = fmaxf(M, p[s * row + W]);
  float L = 0.f, acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int s = 0; s < live; ++s) {
    const float* ps = p + s * row;
    const float f = rescale(ps[W], M);
    L += ps[W + 1] * f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      if (d < W) acc[i] += ps[d] * f;
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane + 32 * i;
    if (d < W) Unit<T>::store(o + static_cast<size_t>(bh) * W + d, acc[i] / fmaxf(L, 1e-30f));
  }
}

}  // namespace decode_split
