// Latent decode attention (MLA's absorbed decode: DeepSeek-V2/V3,
// Moonlight) for Hopper (sm_90a): every query head of a row against one
// shared cache row a token, read in its own type, the keys split over
// blocks; bfloat16 on the tensor cores, float32 on the CUDA cores.
//
// What it computes, for row b and query head h: out = softmax(scale * s) c
// over the visible tokens t < n, n = min(T, max(kv_len, 1)), where
// s_t = q_lat . c_t + q_rope . r_t; q is (B, H, 512 + 64), the latent query
// (q_nope W_k_b^T) then the rotated rope query; c (B, T, 512) the cached
// latent, which is also the value; r (B, T, 64) the cached rope key; out
// (B, H, 512) the latent of the output, which the caller maps through W_v_b
// and W_o.  Scores, softmax and sums are float32.  Kernel 6
// (decode_attention.cu) takes neither a 576-wide key nor a value that is the
// key's first 512 columns, and reads each kv head for at most 8 query heads.
//
// What bounds it on this card: the bytes.  At Moonlight's 16 heads a row is
// 1152 bytes in bfloat16 and takes 16 x (576 + 512) multiply-adds, ~30 FLOP
// a byte: about the CUDA cores' 67 TFLOP/s at 3.35 TB/s, so on the CUDA
// cores the products bound it (a first version read 14-18% of the bytes
// bound there); on the tensor cores the bytes do.
//
// bfloat16 (`mla_decode_mma_kernel`): the 16 heads are the 16 rows of one
// mma.sync m16n8k16 tile.  A block of four warps takes one (row b, key split);
// the split's keys come in tiles of 32 rows through shared memory by cp.async
// (a ring of two), beside q's 16 rows.  Per tile: warp w scores keys 8w..8w+7
// (S = Q K^T over 36 k-steps, fragments by ldmatrix); the scores go to shared
// memory; 8 threads a row run the row's online softmax (float32 exp, max and
// sum) and leave p and the row's correction there; then warp w adds p c to its
// 128 columns of the output (O += P V, V's fragments by ldmatrix.trans), p
// entering the product as a bf16 pair hi + lo, which carries it to about 16
// bits, so the only rounding past the float32 plain route's is that of p's low
// part.
//
// float32 (`mla_decode_kernel`): a block of four warps takes the same (row b,
// split), four heads a warp.  Keys come in tiles of 16 rows by cp.async; lane
// c holds latent columns of its 16-byte units c and c + 32 (and so on) and
// rope columns 2c, 2c + 1, and keeps those columns of q and of the accumulator
// for its four heads in registers.  A row's four dots are summed over the warp
// by a reduce-scatter of shuffles: lane c ends with the score of head c / 8 of
// its warp and runs that head's online softmax, once a tile; each head's p and
// correction reach the warp's lanes by one shuffle from lane 8 j; a second
// pass over the tile's rows adds p c.
//
// With one split a block writes the output; with more it writes its partial
// (acc, m, l) to scratch and a merge kernel combines the live splits in split
// order, a warp a (b, h), by kernel 6's merge (decode_split.cuh).  Every sum
// has a fixed order, so a call is bitwise the same from run to run.  The live
// length is read on the device (kv_len as a value or a pointer to a 0-d int32
// / int64 tensor), so a captured step replays at every fill: each split takes
// ceil(n / splits) keys rounded up to whole tiles, and a split past n exits at
// once (the merge skips it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "decode_split.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mma_bf16::cp_async_16;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;
using mma_bf16::ldmatrix_x4;
using mma_bf16::ldmatrix_x4_trans;
using mma_bf16::mma_16816;
using mma_bf16::pack_bf16;
using mma_bf16::pack_bf16_split;
using decode_split::merge_splits;
using decode_split::neg_inf;
using decode_split::Pos;
using decode_split::read_pos;
using decode_split::rescale;
using decode_split::Unit;

constexpr int kR = 512;           // the latent's width: the value
constexpr int kP = 64;            // the rope key's width
constexpr int kW = kR + kP;       // a query row
constexpr int kH = 16;            // query heads a row: Moonlight's, one mma row tile
constexpr int kHw = 4;            // float32: query heads a warp
constexpr int kNw = kH / kHw;     // float32: warps a block
constexpr int kTile = 16;         // float32: keys a staged tile
constexpr int kStagesMax = 4;     // float32: tiles a block has in flight or in use at most
constexpr int kStageBudget = 98304;  // float32: shared-memory bytes of a block's stages
constexpr int kMmaTile = 32;      // bfloat16: keys a staged tile, 8 a warp
constexpr int kMmaStages = 2;     // bfloat16: tiles in flight or in use
constexpr int kMmaRow = (kW + 8) * 2;  // bfloat16: a staged row, padded by 16 bytes
constexpr int kMmaSmem =
    (16 + kMmaStages * kMmaTile) * kMmaRow + 16 * kMmaTile * 4 + 3 * 16 * 4;
constexpr int kMergeWarps = 4;    // the merge kernel's warps a block
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Shape {
  static constexpr int kEs = static_cast<int>(sizeof(T));
  static constexpr int kVec = Unit<T>::kElems;   // elements a 16-byte unit
  static constexpr int kLUnits = kR / kVec;      // units of a latent row
  static constexpr int kLu = kLUnits / 32;       // latent units a lane
  static constexpr int kLc = kLu * kVec;         // latent columns a lane: 16
  static constexpr int kPUnits = kP / kVec;      // units of a rope row
  static constexpr int kLatBytes = kTile * kR * kEs;
  static constexpr int kStage = kTile * kW * kEs;  // a latent tile, then a rope tile
  static constexpr int kStages =
      kStageBudget / kStage < kStagesMax ? kStageBudget / kStage : kStagesMax;
  static constexpr int kSmem = kStages * kStage;
  static_assert(kLUnits % 32 == 0 && kP == 64, "a lane takes whole latent units, 2 rope columns");
  static_assert(kStages >= 2, "the next tile loads while this one is read");
};

// n = min(T, max(kv_len, 1)): the visible keys
__device__ __forceinline__ long long live_keys(const Pos& p, int T_) {
  return min(static_cast<long long>(T_), max(read_pos(p), 1LL));
}

// keys a split: ceil(n / splits) rounded up to whole tiles of `tile` keys
__device__ __forceinline__ long long split_keys(long long n, int splits, int tile) {
  const long long per = (n + splits - 1) / splits;
  return (per + tile - 1) / tile * tile;
}

template <typename T>
__global__ void __launch_bounds__(32 * kNw)
mla_decode_kernel(const T* __restrict__ q, const T* __restrict__ ckv, const T* __restrict__ kr,
                  T* __restrict__ o, float* __restrict__ part, int T_, int splits, Pos len,
                  float scale) {
  using Sh = Shape<T>;
  constexpr int kThreads = 32 * kNw;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x % splits;
  const int b = blockIdx.x / splits;
  const long long n = live_keys(len, T_);
  const long long per = split_keys(n, splits, kTile);
  const int s0 = static_cast<int>(static_cast<long long>(split) * per);
  const int s1 = static_cast<int>(min(n, static_cast<long long>(split + 1) * per));
  if (s0 >= s1) return;  // past the live keys: the merge skips this split

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h0 = warp * kHw;
  const T* cb = ckv + static_cast<size_t>(b) * T_ * kR;
  const T* rb = kr + static_cast<size_t>(b) * T_ * kP;

  // this lane's columns of each of the warp's heads' q, widened and scaled
  float ql[kHw][Sh::kLc], qr[kHw][2];
#pragma unroll
  for (int j = 0; j < kHw; ++j) {
    const T* qrow = q + (static_cast<size_t>(b) * kH + h0 + j) * kW;
#pragma unroll
    for (int u = 0; u < Sh::kLu; ++u) {
      Unit<T>::widen(*reinterpret_cast<const uint4*>(qrow + (u * 32 + lane) * Sh::kVec),
                     &ql[j][u * Sh::kVec]);
#pragma unroll
      for (int e = 0; e < Sh::kVec; ++e) ql[j][u * Sh::kVec + e] *= scale;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) qr[j][e] = Unit<T>::one(qrow[kR + 2 * lane + e]) * scale;
  }

  const int n_tiles = (s1 - s0 + kTile - 1) / kTile;
  auto stage_tile = [&](int it) {
    unsigned char* ls = smem + (it % Sh::kStages) * Sh::kStage;
    unsigned char* rs = ls + Sh::kLatBytes;
    const int t0 = s0 + it * kTile;
    for (int i = tid; i < kTile * Sh::kLUnits; i += kThreads) {
      const int r = i / Sh::kLUnits, w = i % Sh::kLUnits;
      const bool ok = t0 + r < s1;  // rows past the split's live end are zero-filled
      cp_async_16(ls + (r * Sh::kLUnits + w) * 16,
                  cb + (ok ? static_cast<size_t>(t0 + r) * kR + w * Sh::kVec : 0), ok);
    }
    for (int i = tid; i < kTile * Sh::kPUnits; i += kThreads) {
      const int r = i / Sh::kPUnits, w = i % Sh::kPUnits;
      const bool ok = t0 + r < s1;
      cp_async_16(rs + (r * Sh::kPUnits + w) * 16,
                  rb + (ok ? static_cast<size_t>(t0 + r) * kP + w * Sh::kVec : 0), ok);
    }
  };

  // the running max and sum of head lane / 8 of the warp, and this lane's
  // columns of each head's acc
  float m = neg_inf(), l = 0.f, acc[kHw][Sh::kLc];
#pragma unroll
  for (int j = 0; j < kHw; ++j) {
#pragma unroll
    for (int e = 0; e < Sh::kLc; ++e) acc[j][e] = 0.f;
  }

  // the first kStages - 1 tiles in flight, a commit group each (empty past the last)
#pragma unroll
  for (int it = 0; it < Sh::kStages - 1; ++it) {
    if (it < n_tiles) stage_tile(it);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<Sh::kStages - 2>();  // tile it has landed
    __syncthreads();  // for every thread's copies; and the stage read last round is free
    if (it + Sh::kStages - 1 < n_tiles) stage_tile(it + Sh::kStages - 1);
    cp_async_commit();
    const unsigned char* ls = smem + (it % Sh::kStages) * Sh::kStage;
    const unsigned char* rs = ls + Sh::kLatBytes;
    const int live = min(kTile, s1 - (s0 + it * kTile));

    // scores: a row's four dots summed over the warp and scattered, lane c
    // ending with head c / 8's
    float sc[kTile];
#pragma unroll
    for (int st = 0; st < kTile; ++st) {
      float kf[Sh::kLc];
#pragma unroll
      for (int u = 0; u < Sh::kLu; ++u)
        Unit<T>::widen(*reinterpret_cast<const uint4*>(
                           ls + (st * Sh::kLUnits + u * 32 + lane) * 16),
                       &kf[u * Sh::kVec]);
      const T* rrow = reinterpret_cast<const T*>(rs) + st * kP + 2 * lane;
      const float r0 = Unit<T>::one(rrow[0]), r1 = Unit<T>::one(rrow[1]);
      float d[kHw];
#pragma unroll
      for (int j = 0; j < kHw; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < Sh::kLc; ++e) dot = fmaf(ql[j][e], kf[e], dot);
        dot = fmaf(qr[j][0], r0, dot);
        d[j] = fmaf(qr[j][1], r1, dot);
      }
      // lanes with bit 16 keep heads 2, 3, then lanes with bit 8 the upper of two
      const bool up16 = (lane & 16) != 0, up8 = (lane & 8) != 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float send = up16 ? d[i] : d[i + 2];
        d[i] = (up16 ? d[i + 2] : d[i]) + __shfl_xor_sync(kFull, send, 16);
      }
      {
        const float send = up8 ? d[0] : d[1];
        d[0] = (up8 ? d[1] : d[0]) + __shfl_xor_sync(kFull, send, 8);
      }
#pragma unroll
      for (int mask = 4; mask >= 1; mask /= 2) d[0] += __shfl_xor_sync(kFull, d[0], mask);
      sc[st] = d[0];
    }

    // the online softmax of this lane's head, once a tile; p into sc
    float mx = neg_inf();
#pragma unroll
    for (int st = 0; st < kTile; ++st)
      if (st < live) mx = fmaxf(mx, sc[st]);
    const float mn = fmaxf(m, mx);
    const float corr = rescale(m, mn);
    float sum = 0.f;
#pragma unroll
    for (int st = 0; st < kTile; ++st) {
      const float p = st < live ? __expf(sc[st] - mn) : 0.f;
      sum += p;
      sc[st] = p;
    }
    l = l * corr + sum;
    m = mn;
#pragma unroll
    for (int j = 0; j < kHw; ++j) {
      const float cj = __shfl_sync(kFull, corr, 8 * j);
#pragma unroll
      for (int e = 0; e < Sh::kLc; ++e) acc[j][e] *= cj;
    }

    // acc += p c, the tile's rows read again
#pragma unroll
    for (int st = 0; st < kTile; ++st) {
      float vf[Sh::kLc];
#pragma unroll
      for (int u = 0; u < Sh::kLu; ++u)
        Unit<T>::widen(*reinterpret_cast<const uint4*>(
                           ls + (st * Sh::kLUnits + u * 32 + lane) * 16),
                       &vf[u * Sh::kVec]);
#pragma unroll
      for (int j = 0; j < kHw; ++j) {
        const float p = __shfl_sync(kFull, sc[st], 8 * j);
#pragma unroll
        for (int e = 0; e < Sh::kLc; ++e) acc[j][e] = fmaf(p, vf[e], acc[j][e]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < kHw; ++j) {
    const float mj = __shfl_sync(kFull, m, 8 * j), lj = __shfl_sync(kFull, l, 8 * j);
    const size_t bh = static_cast<size_t>(b) * kH + h0 + j;
    if (splits == 1) {
      const float inv = 1.f / fmaxf(lj, 1e-30f);
#pragma unroll
      for (int u = 0; u < Sh::kLu; ++u) {
#pragma unroll
        for (int e = 0; e < Sh::kVec; ++e)
          Unit<T>::store(o + bh * kR + (u * 32 + lane) * Sh::kVec + e,
                         acc[j][u * Sh::kVec + e] * inv);
      }
    } else {
      float* pr = part + (bh * splits + split) * (kR + 2);
#pragma unroll
      for (int u = 0; u < Sh::kLu; ++u) {
#pragma unroll
        for (int e = 0; e < Sh::kVec; ++e)
          pr[(u * 32 + lane) * Sh::kVec + e] = acc[j][u * Sh::kVec + e];
      }
      if (lane == 0) {
        pr[kR] = mj;
        pr[kR + 1] = lj;
      }
    }
  }
}

// The bfloat16 route: the heads as the 16 rows of an mma tile (see the top).
__global__ void __launch_bounds__(128)
mla_decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ckv,
                      const bf16* __restrict__ kr, bf16* __restrict__ o, float* __restrict__ part,
                      int T_, int splits, Pos len, float scale) {
  static_assert(kH == 16, "the heads fill one 16-row mma tile");
  constexpr int kThreads = 128, KQ = kW / 16, RB = kMmaRow;
  constexpr int kRowUnits = kW / 8;  // 16-byte units of a staged row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const qs = smem;                       // q's 16 rows
  unsigned char* const ks = smem + 16 * RB;             // the ring of key tiles
  float* const sb = reinterpret_cast<float*>(ks + kMmaStages * kMmaTile * RB);  // [16][32]
  float* const row_m = sb + 16 * kMmaTile;
  float* const row_l = row_m + 16;
  float* const row_c = row_l + 16;

  const int split = blockIdx.x % splits;
  const int b = blockIdx.x / splits;
  const long long n = live_keys(len, T_);
  const long long per = split_keys(n, splits, kMmaTile);
  const int s0 = static_cast<int>(static_cast<long long>(split) * per);
  const int s1 = static_cast<int>(min(n, static_cast<long long>(split + 1) * per));
  if (s0 >= s1) return;  // past the live keys: the merge skips this split

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const bf16* cb = ckv + static_cast<size_t>(b) * T_ * kR;
  const bf16* rb = kr + static_cast<size_t>(b) * T_ * kP;

  // q's rows with the first tile: one commit group
  const bf16* qb = q + static_cast<size_t>(b) * kH * kW;
  for (int i = tid; i < kH * kRowUnits; i += kThreads) {
    const int r = i / kRowUnits, c = i % kRowUnits;
    cp_async_16(qs + r * RB + c * 16, qb + r * kW + c * 8, true);
  }
  const int n_tiles = (s1 - s0 + kMmaTile - 1) / kMmaTile;
  auto stage_tile = [&](int it) {
    unsigned char* kt = ks + (it % kMmaStages) * kMmaTile * RB;
    const int t0 = s0 + it * kMmaTile;
    for (int i = tid; i < kMmaTile * kRowUnits; i += kThreads) {
      const int r = i / kRowUnits, c = i % kRowUnits;
      const bool ok = t0 + r < s1;  // rows past the split's live end are zero-filled
      const bf16* src = c < kR / 8 ? cb + (ok ? static_cast<size_t>(t0 + r) * kR + c * 8 : 0)
                                   : rb + (ok ? static_cast<size_t>(t0 + r) * kP + (c - kR / 8) * 8
                                              : 0);
      cp_async_16(kt + r * RB + c * 16, src, ok);
    }
  };
  if (tid < 16) {
    row_m[tid] = neg_inf();
    row_l[tid] = 0.f;
  }
  stage_tile(0);
  cp_async_commit();

  float acc[16][4];  // this warp's 128 output columns, rows g and g + 8
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage_tile(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // q and tile it have landed
    __syncthreads();
    const unsigned char* kt = ks + (it % kMmaStages) * kMmaTile * RB;
    const int t0 = s0 + it * kMmaTile;

    // S = Q K^T for keys 8 warp .. 8 warp + 7 of the tile, two k-steps a load
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KQ; kk += 2) {
      uint32_t a0[4], a1[4], bk[4];
      ldmatrix_x4(a0, qs + (lane % 16) * RB + (kk * 16 + 8 * (lane / 16)) * 2);
      ldmatrix_x4(a1, qs + (lane % 16) * RB + ((kk + 1) * 16 + 8 * (lane / 16)) * 2);
      ldmatrix_x4(bk, kt + (8 * warp + lane % 8) * RB + (kk * 16 + 8 * (lane / 8)) * 2);
      mma_16816(s[0], a0, bk[0], bk[1]);
      mma_16816(s[1], a1, bk[2], bk[3]);
    }
    // scaled, masked past the live end, into shared memory
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * warp + 2 * t4 + (e & 1), row = g + 8 * (e >> 1);
      const float x = (s[0][e] + s[1][e]) * scale;
      sb[row * kMmaTile + key] = t0 + key < s1 ? x : neg_inf();
    }
    __syncthreads();

    // the online softmax: 8 threads a row, 4 keys each; p into sb
    {
      const int r = tid / 8, j = tid % 8;
      float4 x = *reinterpret_cast<float4*>(sb + r * kMmaTile + 4 * j);
      float mx = fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w));
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_old = row_m[r];
      const float mn = fmaxf(m_old, mx);
      x.x = x.x == neg_inf() ? 0.f : __expf(x.x - mn);
      x.y = x.y == neg_inf() ? 0.f : __expf(x.y - mn);
      x.z = x.z == neg_inf() ? 0.f : __expf(x.z - mn);
      x.w = x.w == neg_inf() ? 0.f : __expf(x.w - mn);
      float sum = (x.x + x.y) + (x.z + x.w);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(kFull, sum, off);
      *reinterpret_cast<float4*>(sb + r * kMmaTile + 4 * j) = x;
      __syncwarp();
      if (j == 0) {
        const float corr = rescale(m_old, mn);
        row_c[r] = corr;
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = mn;
      }
    }
    __syncthreads();

    // O = O * corr + P V for this warp's 128 columns
    const float c_lo = row_c[g], c_hi = row_c[g + 8];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      acc[nt][0] *= c_lo;
      acc[nt][1] *= c_lo;
      acc[nt][2] *= c_hi;
      acc[nt][3] *= c_hi;
    }
#pragma unroll
    for (int kp = 0; kp < kMmaTile / 16; ++kp) {
      uint32_t hi[4], lo[4];
      const float* p0 = sb + g * kMmaTile + 16 * kp + 2 * t4;
      const float* p1 = p0 + 8 * kMmaTile;
      pack_bf16_split(p0[0], p0[1], hi[0], lo[0]);
      pack_bf16_split(p1[0], p1[1], hi[1], lo[1]);
      pack_bf16_split(p0[8], p0[9], hi[2], lo[2]);
      pack_bf16_split(p1[8], p1[9], hi[3], lo[3]);
#pragma unroll
      for (int d2 = 0; d2 < 8; ++d2) {
        // keys 16 kp + (0..7 | 8..15) by columns 128 warp + 16 d2 + (0..7 | 8..15), transposed
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, kt + (kp * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * RB +
                                  (128 * warp + d2 * 16 + 8 * (lane / 16)) * 2);
        mma_16816(acc[2 * d2], hi, bv[0], bv[1]);
        mma_16816(acc[2 * d2], lo, bv[0], bv[1]);
        mma_16816(acc[2 * d2 + 1], hi, bv[2], bv[3]);
        mma_16816(acc[2 * d2 + 1], lo, bv[2], bv[3]);
      }
    }
    __syncthreads();  // sb and the tile's slot are consumed before they are written again
  }
  cp_async_wait<0>();

  const float l_lo = row_l[g], l_hi = row_l[g + 8];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = g + 8 * half;
    const size_t bh = static_cast<size_t>(b) * kH + row;
    const float den = fmaxf(half ? l_hi : l_lo, 1e-30f);
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int col = 128 * warp + 8 * nt + 2 * t4;
      const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
      if (splits == 1) {
        *reinterpret_cast<uint32_t*>(o + bh * kR + col) = pack_bf16(v0 / den, v1 / den);
      } else {
        float* pr = part + (bh * splits + split) * (kR + 2);
        pr[col] = v0;
        pr[col + 1] = v1;
        if (warp == 0 && t4 == 0 && nt == 0) {
          pr[kR] = row_m[row];
          pr[kR + 1] = half ? l_hi : l_lo;
        }
      }
    }
  }
}

// out[b, h] from the live splits' partials, in split order: a warp a (b, h).
template <typename T>
__global__ void __launch_bounds__(32 * kMergeWarps)
mla_decode_merge_kernel(const float* __restrict__ part, T* __restrict__ o, int BH, int splits,
                        int T_, Pos len, int tile) {
  const int bh = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  if (bh >= BH) return;
  const long long n = live_keys(len, T_);
  const long long per = split_keys(n, splits, tile);
  merge_splits<T, kR>(part, o, bh, splits, static_cast<int>((n + per - 1) / per),
                      threadIdx.x % 32);
}

struct Args {
  const void *q, *ckv, *kr;
  void *o, *part;
  int dtype, B, n_keys, H, splits;
  Pos len;
  float scale;
  int tile, smem;
  cudaStream_t stream;
};

cudaError_t merge(const Args& a, int tile) {
  const long long bh = static_cast<long long>(a.B) * kH;
  const unsigned grid = static_cast<unsigned>((bh + kMergeWarps - 1) / kMergeWarps);
  if (a.dtype == 1)
    mla_decode_merge_kernel<bf16><<<grid, 32 * kMergeWarps, 0, a.stream>>>(
        static_cast<const float*>(a.part), static_cast<bf16*>(a.o), static_cast<int>(bh),
        a.splits, a.n_keys, a.len, tile);
  else
    mla_decode_merge_kernel<float><<<grid, 32 * kMergeWarps, 0, a.stream>>>(
        static_cast<const float*>(a.part), static_cast<float*>(a.o), static_cast<int>(bh),
        a.splits, a.n_keys, a.len, tile);
  return cudaGetLastError();
}

// The float32 route (the CUDA cores), four heads a warp.
cudaError_t launch_f32(const Args& a) {
  using Sh = Shape<float>;
  // The caller's launch plan must be this build's.
  if (a.tile != kTile || a.smem != Sh::kSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mla_decode_kernel<float>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (e != cudaSuccess) return e;
  mla_decode_kernel<float><<<static_cast<unsigned>(a.B * a.splits), 32 * kNw, Sh::kSmem,
                             a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.ckv),
      static_cast<const float*>(a.kr), static_cast<float*>(a.o), static_cast<float*>(a.part),
      a.n_keys, a.splits, a.len, a.scale);
  e = cudaGetLastError();
  return e != cudaSuccess || a.splits == 1 ? e : merge(a, kTile);
}

// The bfloat16 route (the tensor cores), the heads one 16-row tile.
cudaError_t launch_bf16(const Args& a) {
  if (a.tile != kMmaTile || a.smem != kMmaSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mla_decode_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
  if (e != cudaSuccess) return e;
  mla_decode_mma_kernel<<<static_cast<unsigned>(a.B * a.splits), 128, kMmaSmem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.ckv),
      static_cast<const bf16*>(a.kr), static_cast<bf16*>(a.o), static_cast<float*>(a.part),
      a.n_keys, a.splits, a.len, a.scale);
  e = cudaGetLastError();
  return e != cudaSuccess || a.splits == 1 ? e : merge(a, kMmaTile);
}

cudaError_t launch(const Args& a) {
  const long long blocks = static_cast<long long>(a.B) * a.splits;
  if (blocks > INT_MAX || blocks < 1 || a.H != kH) return cudaErrorInvalidValue;
  return a.dtype == 1 ? launch_bf16(a) : launch_f32(a);
}

}  // namespace

// q (B, H, 576), ckv (B, T, 512), kr (B, T, 64), o (B, H, 512): contiguous,
// 16-byte aligned, float32 (dtype 0) or bfloat16 (1); H is 16.
// `part` holds B * H * splits * 514 floats when splits > 1 (null
// otherwise).  The live length is `len_val`, or read on the device from
// `len_ptr` (int64 when `len_64`, else int32) when set.  `tile` and `smem`
// are the caller's launch plan and must equal this build's.  Launches on
// `stream` (the merge kernel after the split kernel when splits > 1),
// returns cudaGetLastError().
extern "C" int mla_decode_fwd(const void* q, const void* ckv, const void* kr, void* o, void* part,
                              int dtype, int B, int T, int H, int splits, const void* len_ptr,
                              long long len_val, int len_64, float scale, int tile, int smem,
                              void* stream) {
  const Args a{q, ckv, kr, o, part, dtype, B, T, H, splits, Pos{len_ptr, len_val, len_64},
               scale, tile, smem, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dtype == 0 || dtype == 1 ? launch(a) : cudaErrorInvalidValue);
}

extern "C" const char* mla_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
