// Rotary position embedding of a layer's q and k (RoPE, and Qwen2-VL's
// multimodal M-RoPE) for Hopper (sm_90a): both tensors in one launch, in
// place, in their own type (float32 or bfloat16).
//
// Replaces no TPU kernel: the JAX package rotates q and k in XLA ops
// (src/repro/models/layers.py: apply_rope, apply_mrope), which XLA fuses.
// In PyTorch the same ops run one kernel each: the frequencies rebuilt, the
// positions cast, the angles, cos and sin, a float32 copy of x, four
// products, a subtract, an add, a concatenation and a cast back, ~22
// launches a tensor and ~44 a layer.
//
// What it computes, exactly as layers.apply_rope / apply_mrope do on the
// card, each rounding in the same place:
//   inv_i = 1 / theta^(i * (1 / half))                     float32, i < half
//   ang_i = float(pos[b, s, stream(i)]) * inv_i              float32
//   out   = (x1 cos - x2 sin ‖ x2 cos + x1 sin)              float32, x = (x1 ‖ x2)
// rounded once to x's type.  Slot i takes the position stream of the
// section that holds it (sections (16, 24, 24) over half = 64 for M-RoPE;
// one section and one stream for RoPE).  Accurate powf, cosf and sinf, and
// products and sums rounded one at a time (no contraction into an FMA), so
// the result is the plain route's bit for bit where the math library
// gives both the same values.  No fast intrinsics: angles reach ~8,200 rad
// at the benchmark's longest prompts, where __sinf / __cosf lose accuracy.
//
// What bounds it on this card: the bytes.  Each element of q and k is read
// and written once; the angles cost `half` sincos a token row, shared by
// every head.
//
// Design: a block a token row (b, s).  Its threads first put the row's half
// (cos, sin) pairs in shared memory, then rotate every head of q and of k:
// a thread takes V elements of x1 and the V facing them in x2, in 16-byte
// loads and stores where the row, head strides and the rotary width allow
// (V = 8 in bfloat16, 4 in float32), else one element at a time (V = 1).
// q and k are read through their batch, row and head strides, the last
// axis dense, so a slice of a wider tensor (latent attention's rope columns
// of q and of the latent product) is rotated where it lies.  The positions
// are read through their strides as int32 or int64 on the device: a decode
// step's 0-d position expanded to (B, 1) or (B, 1, 3) is read with no copy
// and no host read, so the launch runs inside a captured graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHalf = 256;     // rotary widths up to 512
constexpr int kMaxSections = 4;

// One of the two rotated tensors, (B, S, heads, width) by its strides in
// elements; the last axis dense.
struct Rows {
  void* ptr;
  long long sb, ss, sh;
  int heads;
};

struct Args {
  Rows q, k;
  int S, half;
  const void* pos;  // (B, S) or (B, S, streams), int32 or int64
  long long pb, ps, pj;
  int pos64;
  int ends[kMaxSections - 1];  // the first sections' last slot + 1, cumulative
  float theta;
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float* f) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4) {
      f[0] = *p;
    } else {
      f[0] = __bfloat162float(*p);
    }
  } else if constexpr (sizeof(T) == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* f) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4) {
      *p = f[0];
    } else {
      *p = __float2bfloat16_rn(f[0]);
    }
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) rotary_kernel(const Args a) {
  __shared__ float cs[kMaxHalf], sn[kMaxHalf];
  const long long row = blockIdx.x;
  const long long b = row / a.S, s = row % a.S;

  const float step = 1.f / static_cast<float>(a.half);
  for (int i = threadIdx.x; i < a.half; i += kThreads) {
    int j = 0;
#pragma unroll
    for (int t = 0; t < kMaxSections - 1; ++t) j += i >= a.ends[t];
    const long long at = b * a.pb + s * a.ps + j * a.pj;
    const long long p = a.pos64 ? static_cast<const long long*>(a.pos)[at]
                                : static_cast<long long>(static_cast<const int*>(a.pos)[at]);
    const float inv = 1.f / powf(a.theta, __fmul_rn(static_cast<float>(i), step));
    const float ang = __fmul_rn(__ll2float_rn(p), inv);
    cs[i] = cosf(ang);
    sn[i] = sinf(ang);
  }
  __syncthreads();

  const int per_head = a.half / V;
  const int units = (a.q.heads + a.k.heads) * per_head;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int h = u / per_head, c = (u - h * per_head) * V;
    const bool is_q = h < a.q.heads;
    T* x = static_cast<T*>(is_q ? a.q.ptr : a.k.ptr) + b * (is_q ? a.q.sb : a.k.sb) +
           s * (is_q ? a.q.ss : a.k.ss) +
           static_cast<long long>(is_q ? h : h - a.q.heads) * (is_q ? a.q.sh : a.k.sh) + c;
    float x1[V], x2[V], o1[V], o2[V];
    load<T, V>(x, x1);
    load<T, V>(x + a.half, x2);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float co = cs[c + e], si = sn[c + e];
      o1[e] = __fsub_rn(__fmul_rn(x1[e], co), __fmul_rn(x2[e], si));
      o2[e] = __fadd_rn(__fmul_rn(x2[e], co), __fmul_rn(x1[e], si));
    }
    store<T, V>(x, o1);
    store<T, V>(x + a.half, o2);
  }
}

template <typename T>
cudaError_t launch(const Args& a, int rows, int vec, cudaStream_t stream) {
  if (vec == 1) {
    rotary_kernel<T, 1><<<rows, kThreads, 0, stream>>>(a);
  } else if (vec == 16 / static_cast<int>(sizeof(T))) {
    rotary_kernel<T, static_cast<int>(16 / sizeof(T))><<<rows, kThreads, 0, stream>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q (B, S, hq, 2 half) and k (B, S, hk, 2 half) rotated in place; dtype 0
// float32, 1 bfloat16; vec elements a thread's load (1, or 16 bytes' worth);
// positions int64 when pos64, else int32; sections s0..s3 (0 past the last),
// summing to half.
extern "C" int rotary_fwd(void* q, long long qb, long long qs, long long qh, int hq, void* k,
                          long long kb, long long ks, long long kh, int hk, int B, int S,
                          int half, int dtype, int vec, const void* pos, long long pb,
                          long long ps, long long pj, int pos64, int s0, int s1, int s2, int s3,
                          float theta, void* stream) {
  const long long rows = static_cast<long long>(B) * S;
  if (rows < 1 || rows > INT_MAX || half < 1 || half > kMaxHalf || s0 + s1 + s2 + s3 != half) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{Rows{q, qb, qs, qh, hq}, Rows{k, kb, ks, kh, hk}, S, half, pos, pb, ps, pj, pos64,
         {s0, s0 + s1, s0 + s1 + s2}, theta};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(a, static_cast<int>(rows), vec, st));
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(a, static_cast<int>(rows), vec, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* rotary_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
