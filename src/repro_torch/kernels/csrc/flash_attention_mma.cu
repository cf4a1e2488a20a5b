// Flash attention on the tensor cores for bfloat16 q, k and v (online
// softmax, GQA, causal / q_offset / sliding window), Hopper (sm_90a).
//
// Replaces, for bfloat16, the TPU kernel `_attn_kernel` behind
// `flash_attention_pallas` in src/repro/kernels/flash_attention.py; float32
// inputs keep the CUDA-core kernel of flash_attention.cu.
//
// What it computes, as `_attn_kernel` does: for query row i of head h (kv
// head h // (H / K)), out = softmax(scale * q k^T) v over the visible keys,
// scale = 1 / sqrt(hd), where key t is visible when t < T, qpos >= t
// (causal, qpos = q_offset + i) and qpos - t < window (window > 0).  q k^T
// multiplies bf16 operands into float32 sums; scale and masks apply to
// those float32 scores (q is not pre-scaled in bf16: 1/sqrt(32) and
// 1/sqrt(128) are not exact there).  m, l and the output accumulator are
// float32; the probabilities p are rounded to bf16 for the p v product,
// which is what the TPU's MXU does with a float32 dot at default
// precision.  Masked scores are -1e30, so a row whose first keys are all
// masked carries garbage that the first visible key's correction
// exp(-1e30 - m) wipes to 0; a row with no visible key gets the mean of the
// values of the tiles it visited, or 0.  The result is acc / max(l, 1e-30).
//
// What bounds it on this card: the operations of the two products, 4 hd
// per visible (query, key) pair and query head, at 989 TFLOP/s bf16 (the
// bytes of q, k, v and o, read or written once, take less at prefill
// lengths).  mma.sync reaches only part of that peak: Hopper's full rate
// needs wgmma (warpgroup products on shared-memory tiles) fed by TMA and a
// producer warp, which is later work.
//
// Design:
// - GQA-packed query tiles.  One block of 4 warps per (b, kv head, tile of
//   64 packed rows): packed row r of kv head kh is query position r / G of
//   query head kh * G + r % G, G = H / K.  Each kv tile is loaded once for
//   the whole group of G heads.  Each row computes its own position for
//   the masks.  The block's kv range runs from the tile holding its first
//   row's oldest visible key (window) to its last row's position + 1
//   (causal); masks are applied only on tiles that are not fully visible.
// - Tensor-core products.  Each warp owns 16 packed rows.  S = Q K^T by
//   mma.m16n8k16 with Q and K fragments by ldmatrix; the online softmax runs
//   in registers in the accumulator layout, a row's max and sum reduced over
//   the 4 lanes that hold it (exp2 with log2(e) folded into the scale).  P
//   is rounded to bf16 in registers: the m16n8 accumulators are the A
//   fragments of O += P V, whose V fragments come by ldmatrix.trans.
// - Staging.  Q (64 rows) and a two-slot ring of K and V tiles live in
//   dynamic shared memory, filled by 16-byte cp.async copies (the next
//   tile's copies overlap this tile's products); rows are padded by 16
//   bytes, so the 8 rows an ldmatrix phase reads fall in distinct banks.
//   Up to hd 128 each warp keeps its Q fragments in registers; at hd 256,
//   where O alone is 128 float32 registers a lane, Q stays in shared memory
//   and the kv tile is 32 keys (64 below), so that two blocks fit an SM.
// - Causal balance.  The 1-D grid runs the longest query tiles first.
// - The epilogue stages each warp's bf16 rows in its own Q rows and writes
//   them with 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // packed query rows a block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Shape {
  static constexpr int kv = HD >= 256 ? 32 : 64;  // keys a staged tile
  static constexpr int row_bytes = 2 * HD + 16;   // a padded shared-memory row
  static constexpr int chunks = HD / 8;           // 16-byte chunks a row
  static constexpr int smem = (kRows + 4 * kv) * row_bytes;  // Q, 2 K and 2 V tiles
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o, int B, int S,
                           int T, int H, int K, int q_offset, int causal, int window,
                           float scale_log2, int n_tiles) {
  using Sh = Shape<HD>;
  constexpr int BKV = Sh::kv;
  constexpr int RB = Sh::row_bytes;
  constexpr int CH = Sh::chunks;
  constexpr int NS = BKV / 8;    // score n-tiles (8 keys each)
  constexpr int KQ = HD / 16;    // k-steps of Q K^T
  constexpr int NO = HD / 8;     // output n-tiles (8 dims each)
  constexpr int KP = BKV / 16;   // k-steps of P V
  constexpr bool kQRegs = HD <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const qs = smem;
  unsigned char* const ks = smem + kRows * RB;  // K slots 0 and 1
  unsigned char* const vs = ks + 2 * BKV * RB;  // V slots 0 and 1

  const int G = H / K;
  const int rows = S * G;  // packed rows of one (b, kv head)
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / (B * K);  // longest first
  const int bk = static_cast<int>(blockIdx.x) % (B * K);
  const int b = bk / K, kh = bk % K;
  const int row0 = tile * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  // The global row of packed row r (r < rows).
  auto q_row = [&](int r) -> size_t {
    return (static_cast<size_t>(b) * S + r / G) * H + static_cast<size_t>(kh) * G + r % G;
  };

  for (int idx = tid; idx < kRows * CH; idx += kThreads) {
    const int r = idx / CH, c = idx % CH, pr = row0 + r;
    const bool ok = pr < rows;
    cp_async_16(qs + r * RB + c * 16, q + (ok ? q_row(pr) * HD + c * 8 : 0), ok);
  }
  cp_async_commit();

  // Block-uniform kv range: tiles outside it are masked for every row.
  const int p_first = q_offset + row0 / G;
  const int p_last = q_offset + (min(row0 + kRows, rows) - 1) / G;
  int kv_end = T;
  if (causal) kv_end = min(kv_end, p_last + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, p_first - window + 1) / BKV * BKV;
  const int n_kv = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  auto load_kv = [&](int it) {
    const int t0 = kv_begin + it * BKV;
    unsigned char* const kd = ks + (it & 1) * BKV * RB;
    unsigned char* const vd = vs + (it & 1) * BKV * RB;
    for (int idx = tid; idx < BKV * CH; idx += kThreads) {
      const int r = idx / CH, c = idx % CH, t = t0 + r;
      const bool ok = t < T;
      const size_t off = ok ? ((static_cast<size_t>(b) * T + t) * K + kh) * HD + c * 8 : 0;
      cp_async_16(kd + r * RB + c * 16, k + off, ok);
      cp_async_16(vd + r * RB + c * 16, v + off, ok);
    }
  };
  if (n_kv > 0) load_kv(0);
  cp_async_commit();

  // This lane's two rows of the warp's 16: g and g + 8.
  const int r_lo = row0 + warp * 16 + g, r_hi = r_lo + 8;
  const int qp_lo = q_offset + r_lo / G, qp_hi = q_offset + r_hi / G;
  const unsigned char* const qw = qs + warp * 16 * RB;  // the warp's Q rows

  uint32_t qf[kQRegs ? KQ : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;  // l: this lane's part

  for (int it = 0; it < n_kv; ++it) {
    if (it + 1 < n_kv) load_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile it have landed
    __syncthreads();
    const unsigned char* const kt = ks + (it & 1) * BKV * RB;
    const unsigned char* const vt = vs + (it & 1) * BKV * RB;
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk)
          ldmatrix_x4(qf[kk], qw + (lane % 16) * RB + (kk * 16 + 8 * (lane / 16)) * 2);
      }
    }

    // S = Q K^T for the warp's 16 rows and the tile's BKV keys.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, qw + (lane % 16) * RB + (kk * 16 + 8 * (lane / 16)) * 2);
      }
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        // keys 16 j2 + (0..7 | 8..15) by dims 16 kk + (0..7 | 8..15)
        uint32_t bf[4];
        ldmatrix_x4(bf, kt + (j2 * 16 + lane % 8 + 8 * (lane / 16)) * RB +
                            (kk * 16 + 8 * ((lane / 8) % 2)) * 2);
        mma_16816(s[2 * j2], a, bf[0], bf[1]);
        mma_16816(s[2 * j2 + 1], a, bf[2], bf[3]);
      }
    }

    // Scale (to the log2 domain) and mask the float32 scores.
    const int k0 = kv_begin + it * BKV;
    const bool full = k0 + BKV <= T && (!causal || p_first >= k0 + BKV - 1) &&
                      (window <= 0 || p_last - k0 < window);
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!full) {
          const int t = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = e < 2 ? qp_lo : qp_hi;
          bool ok = t < T;
          if (causal) ok = ok && qp >= t;
          if (window > 0) ok = ok && qp - t < window;
          x = ok ? x : kNegInf;
        }
        s[j][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = exp2f(m_lo - mn_lo), corr_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= corr_lo;
    l_hi *= corr_hi;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr_lo;
      acc[n][1] *= corr_lo;
      acc[n][2] *= corr_hi;
      acc[n][3] *= corr_hi;
    }

    // P = exp2(s - m), summed in float32, rounded to bf16 as the A
    // fragments of P V (k-step kp covers keys 16 kp .. 16 kp + 15).
    uint32_t pa[KP][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = exp2f(s[j][0] - mn_lo), p1 = exp2f(s[j][1] - mn_lo);
      const float p2 = exp2f(s[j][2] - mn_hi), p3 = exp2f(s[j][3] - mn_hi);
      l_lo += p0 + p1;
      l_hi += p2 + p3;
      pa[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
    }

    // O += P V.
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
#pragma unroll
      for (int d2 = 0; d2 < NO / 2; ++d2) {
        // keys 16 kp + (0..7 | 8..15) by dims 16 d2 + (0..7 | 8..15), transposed
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vt + (kp * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * RB +
                                  (d2 * 16 + 8 * (lane / 16)) * 2);
        mma_16816(acc[2 * d2], pa[kp], bf[0], bf[1]);
        mma_16816(acc[2 * d2 + 1], pa[kp], bf[2], bf[3]);
      }
    }
    __syncthreads();  // slot it & 1 is consumed before tile it + 2 lands there
  }
  cp_async_wait<0>();
  __syncthreads();  // Q's copies have landed everywhere, even with no kv tile

  // Epilogue: the rows' sums over their 4 lanes, acc / max(l, 1e-30) in
  // bf16 into the warp's own Q rows, then 16-byte stores to o.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
  unsigned char* const ow = qs + warp * 16 * RB;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = (8 * n + 2 * t4) * 2;
    *reinterpret_cast<uint32_t*>(ow + g * RB + col) =
        pack_bf16(acc[n][0] / den_lo, acc[n][1] / den_lo);
    *reinterpret_cast<uint32_t*>(ow + (g + 8) * RB + col) =
        pack_bf16(acc[n][2] / den_hi, acc[n][3] / den_hi);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH, pr = row0 + warp * 16 + r;
    if (pr < rows)
      *reinterpret_cast<uint4*>(o + q_row(pr) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(ow + r * RB + c * 16);
  }
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int T,
                      int H, int K, int q_offset, int causal, int window, float scale,
                      int rows, int kv_tile, int smem, cudaStream_t stream) {
  using Sh = Shape<HD>;
  // The caller's launch plan must be this build's.
  if (rows != kRows || kv_tile != Sh::kv || smem != Sh::smem) return cudaErrorInvalidValue;
  const long long n_tiles = (static_cast<long long>(S) * (H / K) + kRows - 1) / kRows;
  const long long blocks = n_tiles * B * K;
  if (blocks > INT_MAX || static_cast<long long>(S) * (H / K) > INT_MAX - kRows)
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::smem);
  if (e != cudaSuccess) return e;
  flash_attention_kernel_mma<HD><<<static_cast<unsigned>(blocks), kThreads, Sh::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), B, S, T, H, K, q_offset, causal, window, scale * kLog2e,
      static_cast<int>(n_tiles));
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, hd), k and v (B, T, K, hd), o (B, S, H, hd): contiguous
// bfloat16, 16-byte aligned.  hd is 16, 32, 64, 128 or 256; H % K == 0,
// B * S * H >= 1 and T >= 1 are the caller's checks.  rows, kv_tile and smem
// are the caller's launch plan (packed rows a block, keys a kv tile, dynamic
// shared-memory bytes) and must equal this build's.  Launches on `stream`,
// returns cudaGetLastError().
extern "C" int flash_attention_mma_fwd(const void* q, const void* k, const void* v, void* o,
                                       int B, int S, int T, int H, int K, int hd, int q_offset,
                                       int causal, int window, float scale, int rows,
                                       int kv_tile, int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (hd) {
    case 16: e = launch_hd<16>(q, k, v, o, B, S, T, H, K, q_offset, causal, window, scale, rows, kv_tile, smem, st); break;
    case 32: e = launch_hd<32>(q, k, v, o, B, S, T, H, K, q_offset, causal, window, scale, rows, kv_tile, smem, st); break;
    case 64: e = launch_hd<64>(q, k, v, o, B, S, T, H, K, q_offset, causal, window, scale, rows, kv_tile, smem, st); break;
    case 128: e = launch_hd<128>(q, k, v, o, B, S, T, H, K, q_offset, causal, window, scale, rows, kv_tile, smem, st); break;
    case 256: e = launch_hd<256>(q, k, v, o, B, S, T, H, K, q_offset, causal, window, scale, rows, kv_tile, smem, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* flash_attention_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
