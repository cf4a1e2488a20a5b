// Flash attention (online softmax, GQA, causal / q_offset / sliding window)
// for Hopper (sm_90a), float32 in, float32 arithmetic on the CUDA cores.
//
// Replaces, for float32, the TPU kernel `_attn_kernel` behind
// `flash_attention_pallas` in src/repro/kernels/flash_attention.py;
// bfloat16 inputs go to the tensor-core kernel of flash_attention_mma.cu.
// float32 stays off the tensor cores: its 2e-5 tolerance rules out bf16
// and TF32 operands.
//
// What it computes, as `_attn_kernel` does: for query row i of head h (kv
// head h // (H / K)), out = softmax(scale * q k^T) v over the visible keys,
// scale = 1 / sqrt(hd), where key t is visible when t < T, qpos >= t
// (causal, qpos = q_offset + i) and qpos - t < window (window > 0).  The
// running max m, denominator l and accumulator acc are float32; masked
// scores are -1e30, so a row whose first keys are all masked carries
// garbage that the first visible key's correction exp(-1e30 - m) wipes to
// 0, as on the TPU.  The result is acc / max(l, 1e-30).
//
// What bounds it on this card: the tensor-core operations of the two
// products (4 B H hd per visible (query, key) pair; 989 TFLOP/s bf16) are
// above the bytes (q, k, v, o once each over 3.35 TB/s) at prefill
// lengths.  This kernel does the products on the float32 CUDA cores (67
// TFLOP/s), so it runs far above that bound.
//
// Design: one block of 256 threads per (b * H + h, tile of BQ query rows).
// A group of G = hd / 16 lanes of a warp shares one query row; each lane
// holds 16 of its dims (q, acc) in registers, as float4 units interleaved
// across the group so that the group's shared-memory reads hit distinct
// banks, and a score is the group's partial dots summed by shuffles.  The
// kv axis, which the Pallas grid walked as its innermost dimension with
// m/l/acc in VMEM scratch, is a loop inside the block: each tile of
// BKV = 4096 / hd keys and values is staged into 32 KB of static shared
// memory.  Scores go through the online softmax 16 keys at
// a time.  The loop stops at the causal diagonal of the tile's last row
// and, under a window, starts at the tile holding the first row's oldest
// visible key: the tiles skipped are masked for every row of the block.
// Inputs are read once per query tile; no scratch lives in device memory.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kDims = 16;  // head dims a lane holds
constexpr int kSub = 16;   // keys per online-softmax update
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int T_,
                       int H, int K, int q_offset, int causal, int window,
                       float scale) {
  constexpr int G = HD / kDims;     // lanes sharing a query row
  constexpr int BQ = kThreads / G;  // query rows a block
  constexpr int BKV = 4096 / HD;    // keys a tile: K and V tiles take 32 KB
  constexpr int U = kDims / 4;      // float4 units a lane holds
  static_assert(G >= 1 && G <= 16 && (G & (G - 1)) == 0, "hd / 16 must be a power of 2");
  static_assert(BKV % kSub == 0, "tile must hold whole score groups");
  __shared__ __align__(16) float ks[BKV * HD];
  __shared__ __align__(16) float vs[BKV * HD];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int row = tid / G, lane = tid % G;
  const int i = blockIdx.x * BQ + row;
  const bool live = i < S;
  const int qpos = q_offset + i;

  // This lane's dims of the query row: float4 units lane, lane + G, ...
  float qr[kDims];
  const T* qrow = q + (static_cast<size_t>(b) * S + (live ? i : 0)) * H * HD +
                  static_cast<size_t>(h) * HD;
#pragma unroll
  for (int c = 0; c < U; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (lane + G * c) + e;
      qr[4 * c + e] = live ? to_f32(qrow[d]) * scale : 0.0f;
    }
  }
  float m = kNegInf, l = 0.0f;
  float acc[kDims];
#pragma unroll
  for (int c = 0; c < kDims; ++c) acc[c] = 0.0f;

  // Block-uniform kv range: tiles outside it are masked for every row.
  const int q_first = q_offset + blockIdx.x * BQ;
  const int q_last = q_offset + min(blockIdx.x * BQ + BQ, S) - 1;
  int kv_end = T_;
  if (causal) kv_end = min(kv_end, q_last + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_first - window + 1) / BKV * BKV;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BKV * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD, t = k0 + r;
      float kk = 0.0f, vv = 0.0f;
      if (t < T_) {
        const size_t off = ((static_cast<size_t>(b) * T_ + t) * K + kh) * HD + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[idx] = kk;
      vs[idx] = vv;
    }
    __syncthreads();
    for (int j0 = 0; j0 < BKV; j0 += kSub) {
      float s[kSub];
      float mc = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (j0 + jj) * HD);
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < U; ++c) {
          const float4 kv4 = kr[lane + G * c];
          part += qr[4 * c] * kv4.x;
          part += qr[4 * c + 1] * kv4.y;
          part += qr[4 * c + 2] * kv4.z;
          part += qr[4 * c + 3] * kv4.w;
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        const int kpos = k0 + j0 + jj;
        bool ok = kpos < T_;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[jj] = ok ? part : kNegInf;
        mc = fmaxf(mc, s[jj]);
      }
      const float mn = fmaxf(m, mc);
      const float corr = expf(m - mn);
      l *= corr;
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[c] *= corr;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float p = expf(s[jj] - mn);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs + (j0 + jj) * HD);
#pragma unroll
        for (int c = 0; c < U; ++c) {
          const float4 vv4 = vr[lane + G * c];
          acc[4 * c] += p * vv4.x;
          acc[4 * c + 1] += p * vv4.y;
          acc[4 * c + 2] += p * vv4.z;
          acc[4 * c + 3] += p * vv4.w;
        }
      }
      m = mn;
    }
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
  T* orow = o + (static_cast<size_t>(b) * S + i) * H * HD + static_cast<size_t>(h) * HD;
#pragma unroll
  for (int c = 0; c < U; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) orow[4 * (lane + G * c) + e] = from_f32<T>(acc[4 * c + e] / den);
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S,
                      int T_, int H, int K, int q_offset, int causal, int window,
                      float scale, cudaStream_t stream) {
  constexpr int BQ = kThreads / (HD / kDims);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, T_, H, K, q_offset, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(int hd, const void* q, const void* k, const void* v, void* o,
                         int B, int S, int T_, int H, int K, int q_offset, int causal,
                         int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, o, B, S, T_, H, K, q_offset, causal, window, scale, stream);
    case 32: return launch_hd<T, 32>(q, k, v, o, B, S, T_, H, K, q_offset, causal, window, scale, stream);
    case 64: return launch_hd<T, 64>(q, k, v, o, B, S, T_, H, K, q_offset, causal, window, scale, stream);
    case 128: return launch_hd<T, 128>(q, k, v, o, B, S, T_, H, K, q_offset, causal, window, scale, stream);
    case 256: return launch_hd<T, 256>(q, k, v, o, B, S, T_, H, K, q_offset, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, hd), k and v (B, T, K, hd), o (B, S, H, hd), all contiguous
// float32.  hd is 16, 32, 64, 128 or 256; H % K == 0, B * H <= 65535,
// S >= 1 and T >= 1 are the caller's checks.  Launches on `stream`, returns
// cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int T, int H, int K, int hd, int q_offset, int causal,
                                   int window, float scale, void* stream) {
  return static_cast<int>(launch_typed<float>(hd, q, k, v, o, B, S, T, H, K, q_offset, causal,
                                              window, scale, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
