// Mamba-2 SSD scan on the tensor cores for bfloat16 x, B and C, chunks in
// parallel, Hopper (sm_90a).  dt, A, D, the state and every sum are float32.
//
// Replaces, for bfloat16, the TPU kernel `_ssd_kernel` behind
// `ssd_scan_pallas` in src/repro/kernels/ssd_scan.py; float32 inputs keep
// the CUDA-core kernel of ssd_scan.cu.
//
// What it computes, as `_ssd_kernel` does, for batch row b and head h
// (B/C group g = h / (nh / ng)) and each chunk of L positions, with cum_t
// the within-chunk cumulative sum of dt A and total = cum_{L-1}:
//   y_t    = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s     (intra)
//          + exp(cum_t) C_t . h_in                                    (inter)
//          + D x_t                                                    (skip)
//   h_out  = exp(total) h_in + sum_s B_s^T exp(total - cum_s) dt_s x_s
// with h_in the (ds, hp) state entering the chunk (zero before the first).
// y is stored in bf16; the final state is float32.
//
// What bounds it on this card: at mamba2-130m's prefill (L 256, ds 128,
// hp 64) the bytes of x, B, C, dt and y (61.6 MB over 3.35 TB/s) just above
// the 16.1 GFLOP of the products at the bf16 tensor-core rate.  This design
// adds 56 MB of float32 and bf16 scratch there, written and read once.
//
// Design: four launches, each a grid of independent blocks (chunks run in
// parallel; only the state pass walks the chunks, element by element).
// 1. Chunk pass, a block of 8 warps a (b, chunk, head).  The block scans
//    dt A into `cum` (global scratch, read by the later passes, so all use
//    the same float32 values).  The chunk's own state
//    S_c = B^T diag(w) x, w_s = exp(total - cum_s) dt_s, runs on mma.sync
//    m16n8k16: B^T by ldmatrix.trans straight from B's staged rows, x w by
//    ldmatrix.trans, 128 state rows a group (16 a warp).  S_c goes to a
//    float32 scratch (B, n_chunks, nh, ds, hp).
// 2. Score pass, a block of 4 warps a (b, chunk, B/C group, tile of 64
//    rows t): G = C B^T for each source tile of 64 rows s at or below the
//    diagonal, over ds in slices of 64 (ldmatrix on C's and B's rows, as
//    Q K^T in flash_attention_mma.cu), stored in float32 in the
//    accumulators' own order.  G depends on the group, not the head: one
//    score pass serves nh / ng heads (24 at mamba2-130m).
// 3. State pass, a thread an element of (b, head, ds, hp): h_c =
//    exp(total_c) h_{c-1} + S_c in float32, over the chunks in order.  It
//    writes the state entering each chunk c > 0 as two bf16 planes, hi and
//    lo (below), rows padded to HP columns, and the final state.
// 4. Output pass, a block of 4 warps a (b, chunk, head, tile of 64 rows t),
//    the tiles with the most source tiles first.  Each warp owns 16 rows.
//    First the inter term, C h_in, over ds in slices of 64; then for each
//    source tile s at or below the diagonal, the warp's G fragments come
//    from the score pass into registers (a step ahead), are scaled in
//    float32 by exp(cum_t - cum_s) dt_s and masked to s <= t, and
//    multiply x (ldmatrix.trans).  Then y = acc + D x_t, from the diagonal
//    tile's x.  Slices and tiles stage by cp.async into two-slot rings, the
//    next step's copies in flight during this step's products; rows are
//    padded by 16 bytes, so an ldmatrix phase's 8 rows fall in distinct
//    banks.
//
// Rounding.  The reference computes in float32.  C, B and x are bf16
// inputs, so C B^T and products against x take exact operands.  The other
// operands, x w (pass 1), P (pass 4) and h_in (inter term), are float32:
// each is split into bf16 hi + lo, and both parts multiply the same exact
// operand (two mma.sync a product), so the operand keeps about 16 bits.
// A single bf16 rounding is too coarse: in a plain-torch emulation of
// these rounding points at mamba2-130m's widths, against the float32
// reference (tests/test_torch_ssd_mma.py), rounding each once put y at
// 0.48 of its atol = rtol = 2e-2 bound and the final state 0.016 off
// (bound 2e-2, set by x w); with the splits, y is at 0.001 of its bound
// and the state 7e-6 off.  exp(cum_t - cum_s) is taken of the
// difference, never as a product of exp(cum_t) and exp(-cum_s), which
// overflows float32 within a chunk of 256.
//
// Edges.  hp pads to HP in {16, 32, 64, 128} and ds to slices of 64 (128
// in pass 1): columns past hp or ds and rows past the chunk are
// zero-filled in shared memory (cp.async's zero fill, which reads
// nothing), and rows or columns past them are never stored.  When hp or ds
// is not a multiple of 8, or x, B or C is not 16-byte aligned, the staging
// takes 2-byte loads instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

constexpr int kWarps = 4;           // passes 2 and 4
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // positions a tile (t or s)
constexpr int kKD = 64;             // states (ds) a staged slice in passes 2 and 4
constexpr int kKRB = 2 * kKD + 16;  // bytes of a staged C or B row of a slice, padded
constexpr int kChunkWarps = 8;      // pass 1
constexpr int kChunkThreads = 32 * kChunkWarps;
constexpr int kDG = 16 * kChunkWarps;  // states a group in pass 1
constexpr int kDRB = 2 * kDG + 16;     // bytes of a staged B row of a group, padded
constexpr int kStateThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNS = kRows / 8;            // score n-tiles (8 positions s) a warp
constexpr int kTileFloats = kRows * kRows;  // floats of a stored 64 x 64 score tile
static_assert(kKD == kRows, "a state slice stages like a tile of rows");

template <int HP>
struct Shape {
  static constexpr int rb = 2 * HP + 16;  // bytes of a staged x, x w or state row, padded
  // pass 1: two slots of a B group, an x tile and the tile's dt; x w hi
  // and lo; the scan's warp sums; and (not counted here) the chunk's cum
  static constexpr int chunk_slot = kRows * kDRB + kRows * rb + 4 * kRows;
  static constexpr int chunk_base = 2 * chunk_slot + 2 * kRows * rb + 4 * kChunkWarps;
  // pass 4: two slots of a C slice with state slices hi and lo; two x
  // tiles; cum of the rows t; cum and dt of two source tiles
  static constexpr int slot = kRows * kKRB + 2 * kKD * rb;
  static constexpr int out_smem = 2 * slot + 2 * kRows * rb + 4 * 5 * kRows;
};
// pass 2: two slots of a C slice and a B slice
constexpr int kScoreSmem = 2 * 2 * kRows * kKRB;

// Rows [0, kRows) by COLS bf16 columns into dst (a row every RB bytes), by
// NT threads: row r column j is src[r * stride + j] for r < rows and
// j < cols, else 0.  With `vec` by 16-byte cp.async (cols, stride and src
// a multiple of 8 elements, src 16-byte aligned), else by 2-byte loads and
// stores.
template <int COLS, int RB, int NT>
__device__ __forceinline__ void stage(unsigned char* dst, const bf16* src, size_t stride, int rows,
                                      int cols, bool vec) {
  if (vec) {
    constexpr int CH = COLS / 8;
    for (int idx = threadIdx.x; idx < kRows * CH; idx += NT) {
      const int r = idx / CH, c = idx % CH;
      const bool ok = r < rows && c * 8 < cols;
      cp_async_16(dst + r * RB + c * 16, ok ? src + r * stride + c * 8 : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * COLS; idx += NT) {
      const int r = idx / COLS, j = idx % COLS;
      reinterpret_cast<bf16*>(dst + r * RB)[j] =
          r < rows && j < cols ? src[r * stride + j] : __float2bfloat16(0.0f);
    }
  }
}

// The index of score tile (ti, si), si <= ti, among a chunk's tiles.
__device__ __forceinline__ int pair_index(int ti, int si) { return ti * (ti + 1) / 2 + si; }

// Pass 1: cum of the chunk, and its own state S_c = B^T diag(w) x.
template <int HP>
__global__ void __launch_bounds__(kChunkThreads, 2)
ssd_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm, float* cum,
                 float* __restrict__ sc, int nc, int L, int nh, int hp, int ng, int ds, int vec) {
  using Sh = Shape<HP>;
  constexpr int RB = Sh::rb;
  constexpr int NO = HP / 8;  // n-tiles of 8 columns p
  constexpr int CH = HP / 8;  // 16-byte pieces of an x row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const xh = smem + 2 * Sh::chunk_slot;  // bf16(x w)
  unsigned char* const xl = xh + kRows * RB;           // bf16(x w - bf16(x w))
  float* const wsum = reinterpret_cast<float*>(xl + kRows * RB);  // the scan's warp sums
  float* const cs = wsum + kChunkWarps;                            // cum of the chunk

  const int h = static_cast<int>(blockIdx.x) % nh;
  const int bc = static_cast<int>(blockIdx.x) / nh;
  const int c = bc % nc, b = bc / nc;
  const int g = h / (nh / ng);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const size_t S = static_cast<size_t>(nc) * L;
  const size_t pos0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;
  const size_t x_row = static_cast<size_t>(nh) * hp, bc_row = static_cast<size_t>(ng) * ds;
  const float* const dtc = dt + pos0 * nh + h;  // dt of position t: dtc[t * nh]
  const bf16* const xc = x + pos0 * x_row + static_cast<size_t>(h) * hp;
  const bf16* const bcp = Bm + pos0 * bc_row + static_cast<size_t>(g) * ds;
  float* const cumc = cum + (static_cast<size_t>(b) * nh + h) * S + static_cast<size_t>(c) * L;

  // Step i: state group i / n_s, source tile i % n_s: its B group, raw x
  // and dt, staged a step ahead into slot i & 1 (step 0 during the scan).
  const int n_s = (L + kRows - 1) / kRows;
  const int n_steps = n_s * ((ds + kDG - 1) / kDG);
  auto issue = [&](int i) {
    unsigned char* const sl = smem + (i & 1) * Sh::chunk_slot;
    const int d0 = i / n_s * kDG, s0 = i % n_s * kRows, rows = min(kRows, L - s0);
    stage<kDG, kDRB, kChunkThreads>(sl, bcp + s0 * bc_row + d0, bc_row, rows, ds - d0, vec);
    stage<HP, RB, kChunkThreads>(sl + kRows * kDRB, xc + s0 * x_row, x_row, rows, hp, vec);
    float* const f = reinterpret_cast<float*>(sl + kRows * kDRB + kRows * RB);
    for (int r = tid; r < kRows; r += kChunkThreads) {
      const bool ok = r < rows;
      cp_async_4(f + r, ok ? dtc + static_cast<size_t>(s0 + r) * nh : dtc, ok);
    }
  };

  if (n_steps > 0) issue(0);
  cp_async_commit();

  {  // cum = inclusive scan of dt A: a run of positions a thread, then warp and block sums
    const float a = A[h];
    const int per = (L + kChunkThreads - 1) / kChunkThreads;
    const int lo = tid * per, hi = min(lo + per, L);
    float run = 0.0f;
    for (int t = lo; t < hi; ++t) {
      run += dtc[static_cast<size_t>(t) * nh] * a;
      cs[t] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    float before = incl - run;
    for (int w = 0; w < warp; ++w) before += wsum[w];
    for (int t = lo; t < hi; ++t) {
      const float v = cs[t] + before;
      cs[t] = v;
      cumc[t] = v;
    }
  }
  __syncthreads();
  const float total = cs[L - 1];

  float* const scb = sc + ((static_cast<size_t>(b) * nc + c) * nh + h) * ds * hp;
  float acc[NO][4];
  for (int i = 0; i < n_steps; ++i) {
    if (i % n_s == 0) {
#pragma unroll
      for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    }
    if (i + 1 < n_steps) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // step i's copies have landed
    __syncthreads();
    const unsigned char* const bs = smem + (i & 1) * Sh::chunk_slot;
    const unsigned char* const xs = bs + kRows * kDRB;
    const float* const f = reinterpret_cast<const float*>(xs + kRows * RB);
    const int s0 = i % n_s * kRows, rows = min(kRows, L - s0);
    // x w, w = exp(total - cum_s) dt_s, 8 columns a piece, as bf16 hi and lo
    for (int idx = tid; idx < kRows * CH; idx += kChunkThreads) {
      const int r = idx / CH, p0 = (idx % CH) * 8;
      const float w = r < rows ? expf(total - cs[s0 + r]) * f[r] : 0.0f;
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + r * RB + p0 * 2);
      const bf16* const e = reinterpret_cast<const bf16*>(&raw);
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        pack_bf16_split(__bfloat162float(e[2 * k]) * w, __bfloat162float(e[2 * k + 1]) * w, ph[k],
                        pl[k]);
      *reinterpret_cast<uint4*>(xh + r * RB + p0 * 2) = make_uint4(ph[0], ph[1], ph[2], ph[3]);
      *reinterpret_cast<uint4*>(xl + r * RB + p0 * 2) = make_uint4(pl[0], pl[1], pl[2], pl[3]);
    }
    __syncthreads();
    // S[d, p] += sum_s B[s, d] (x w)[s, p]: the A fragments are B^T,
    // read transposed from B's rows; the warp's states d0 + 16 warp ..
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4_trans(af, bs + (kk * 16 + lane % 8 + 8 * (lane / 16)) * kDRB +
                                (warp * 16 + 8 * ((lane / 8) % 2)) * 2);
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        const int off = (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * RB +
                        (n2 * 16 + 8 * (lane / 16)) * 2;
        uint32_t bh[4], bl[4];
        ldmatrix_x4_trans(bh, xh + off);
        ldmatrix_x4_trans(bl, xl + off);
        mma_16816(acc[2 * n2], af, bh[0], bh[1]);
        mma_16816(acc[2 * n2 + 1], af, bh[2], bh[3]);
        mma_16816(acc[2 * n2], af, bl[0], bl[1]);
        mma_16816(acc[2 * n2 + 1], af, bl[2], bl[3]);
      }
    }
    if (i % n_s == n_s - 1) {  // the group's last source tile: store its states
      const int d0 = i / n_s * kDG;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = d0 + warp * 16 + gr + 8 * (e / 2), p = 8 * n + 2 * t4 + (e & 1);
          if (d < ds && p < hp) scb[static_cast<size_t>(d) * hp + p] = acc[n][e];
        }
      }
    }
    __syncthreads();  // slot i & 1, xh and xl are rewritten next
  }
  cp_async_wait<0>();
}

// Pass 2: the score tiles G = C B^T of rows t of one (b, chunk, group)
// against every source tile at or below the diagonal.
__global__ void __launch_bounds__(kThreads)
ssd_score_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                 float* __restrict__ gbuf, int Bb, int nc, int L, int ng, int ds, int n_tiles,
                 int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbcg = Bb * nc * ng;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / nbcg;  // most work first
  const int bcg = static_cast<int>(blockIdx.x) % nbcg;                 // (b * nc + c) * ng + g
  const int g = bcg % ng, c = bcg / ng % nc, b = bcg / ng / nc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = tile * kRows, t_rows = min(kRows, L - t0);
  const size_t pos0 = static_cast<size_t>(b) * nc * L + static_cast<size_t>(c) * L;
  const size_t bc_row = static_cast<size_t>(ng) * ds;
  const bf16* const bcp = Bm + pos0 * bc_row + static_cast<size_t>(g) * ds;
  const bf16* const ccp = Cm + pos0 * bc_row + static_cast<size_t>(g) * ds;
  const int nk = (ds + kKD - 1) / kKD;
  const int n_steps = (tile + 1) * nk;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  float* const gchunk = gbuf + static_cast<size_t>(bcg) * n_pairs * kTileFloats;

  auto issue = [&](int i) {  // step i: source tile i / nk, state slice i % nk
    unsigned char* const cs = smem + (i & 1) * 2 * kRows * kKRB;
    const int s0 = i / nk * kRows, k0 = i % nk * kKD;
    stage<kKD, kKRB, kThreads>(cs, ccp + t0 * bc_row + k0, bc_row, t_rows, ds - k0, vec);
    stage<kKD, kKRB, kThreads>(cs + kRows * kKRB, bcp + s0 * bc_row + k0, bc_row,
                               min(kRows, L - s0), ds - k0, vec);
  };

  float gs[kNS][4];
  issue(0);
  cp_async_commit();
  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // step i's copies have landed
    __syncthreads();
    const unsigned char* const cw = smem + (i & 1) * 2 * kRows * kKRB + warp * 16 * kKRB;
    const unsigned char* const bsl = smem + (i & 1) * 2 * kRows * kKRB + kRows * kKRB;
    if (i % nk == 0) {
#pragma unroll
      for (int n = 0; n < kNS; ++n) gs[n][0] = gs[n][1] = gs[n][2] = gs[n][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kKD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, cw + (lane % 16) * kKRB + (kk * 16 + 8 * (lane / 16)) * 2);
#pragma unroll
      for (int j2 = 0; j2 < kNS / 2; ++j2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, bsl + (j2 * 16 + lane % 8 + 8 * (lane / 16)) * kKRB +
                            (kk * 16 + 8 * ((lane / 8) % 2)) * 2);
        mma_16816(gs[2 * j2], a, bf[0], bf[1]);
        mma_16816(gs[2 * j2 + 1], a, bf[2], bf[3]);
      }
    }
    if (i % nk == nk - 1) {  // store the tile in the accumulators' order: a float4 a lane
      float4* const out = reinterpret_cast<float4*>(
          gchunk + static_cast<size_t>(pair_index(tile, i / nk)) * kTileFloats);
#pragma unroll
      for (int n = 0; n < kNS; ++n)
        out[(warp * kNS + n) * 32 + lane] = make_float4(gs[n][0], gs[n][1], gs[n][2], gs[n][3]);
    }
    __syncthreads();  // slot i & 1 is consumed before step i + 2 lands there
  }
  cp_async_wait<0>();
}

// Pass 3: h_c = exp(total_c) h_{c-1} + S_c over the chunks, a thread two
// neighbouring elements (b, h, d, p, p + 1 < HP).  hbuf's hi and lo planes
// get the state entering each chunk c > 0 (zero in the columns p >= hp);
// st the final state.
__global__ void __launch_bounds__(kStateThreads)
ssd_state_kernel(const float* __restrict__ cum, const float* __restrict__ sc,
                 bf16* __restrict__ hbuf, float* __restrict__ st, int Bb, int nc, int L, int nh,
                 int hp, int ds, int HP) {
  const int half = HP / 2;
  const size_t n = static_cast<size_t>(Bb) * nh * ds * half;
  const size_t e = static_cast<size_t>(blockIdx.x) * kStateThreads + threadIdx.x;
  if (e >= n) return;
  const int p = static_cast<int>(e % half) * 2;
  const int d = static_cast<int>(e / half % ds);
  const size_t bh = e / half / ds;  // b * nh + h
  const size_t b = bh / nh, h = bh % nh;
  const size_t plane = static_cast<size_t>(Bb) * nc * nh * ds * HP;
  const float* const cumbh = cum + bh * nc * L;
  const bool pair = hp % 2 == 0;  // S rows of hp floats hold aligned pairs
  float h0 = 0.0f, h1 = 0.0f;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const size_t slot = ((b * nc + c) * nh + h) * ds + d;  // row d of chunk c's slot
    if (c > 0) {
      uint32_t hi, lo;
      pack_bf16_split(h0, h1, hi, lo);
      *reinterpret_cast<uint32_t*>(hbuf + slot * HP + p) = hi;
      *reinterpret_cast<uint32_t*>(hbuf + plane + slot * HP + p) = lo;
    }
    float s0 = 0.0f, s1 = 0.0f;
    const float* const row = sc + slot * hp;
    if (pair && p < hp) {
      const float2 v = *reinterpret_cast<const float2*>(row + p);
      s0 = v.x;
      s1 = v.y;
    } else {
      if (p < hp) s0 = row[p];
      if (p + 1 < hp) s1 = row[p + 1];
    }
    const float dec = expf(cumbh[static_cast<size_t>(c) * L + L - 1]);
    h0 = dec * h0 + s0;
    h1 = dec * h1 + s1;
  }
  float* const out = st + (bh * ds + d) * hp;
  if (p < hp) out[p] = h0;
  if (p + 1 < hp) out[p + 1] = h1;
}

// Pass 4: y of a tile of kRows positions of one (b, chunk, head).  Three
// blocks an SM up to HP 64; at HP 128 the accumulators need the registers.
template <int HP>
__global__ void __launch_bounds__(kThreads, HP >= 128 ? 1 : 3)
ssd_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ D, const bf16* __restrict__ Cm,
               const float* __restrict__ cum, const float* __restrict__ gbuf,
               const bf16* __restrict__ hbuf, bf16* __restrict__ y, int Bb, int nc, int L,
               int nh, int hp, int ng, int ds, int n_tiles, int vec) {
  using Sh = Shape<HP>;
  constexpr int RB = Sh::rb;
  constexpr int NO = HP / 8;      // output n-tiles (8 columns p)
  constexpr int KS = kKD / 16;    // k-steps of a state slice
  constexpr int KP = kRows / 16;  // k-steps of P x
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const slots = smem;              // two (C slice, state slices hi and lo)
  unsigned char* const xs = smem + 2 * Sh::slot;  // two x tiles
  float* const cum_t = reinterpret_cast<float*>(xs + 2 * kRows * RB);
  float* const cum_s = cum_t + kRows;  // two source tiles'
  float* const dt_s = cum_s + 2 * kRows;

  const int nbch = Bb * nc * nh;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / nbch;  // most work first
  const int rem = static_cast<int>(blockIdx.x) % nbch;
  const int h = rem % nh, c = rem / nh % nc, b = rem / nh / nc;
  const int g = h / (nh / ng);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const int t0 = tile * kRows, t_rows = min(kRows, L - t0);
  const size_t S = static_cast<size_t>(nc) * L;
  const size_t pos0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * L;
  const size_t x_row = static_cast<size_t>(nh) * hp, bc_row = static_cast<size_t>(ng) * ds;
  const float* const dtc = dt + pos0 * nh + h;
  const bf16* const xc = x + pos0 * x_row + static_cast<size_t>(h) * hp;
  const bf16* const ccp = Cm + pos0 * bc_row + static_cast<size_t>(g) * ds;
  const float* const cumc = cum + (static_cast<size_t>(b) * nh + h) * S + static_cast<size_t>(c) * L;
  const bf16* const hin = hbuf + ((static_cast<size_t>(b) * nc + c) * nh + h) * ds * HP;
  const size_t plane = static_cast<size_t>(Bb) * nc * nh * ds * HP;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  // this warp's fragments of score tile (tile, si): a float4 a lane and n-tile
  const float4* const gw =
      reinterpret_cast<const float4*>(
          gbuf + (((static_cast<size_t>(b) * nc + c) * ng + g) * n_pairs + pair_index(tile, 0)) *
                     kTileFloats) +
      warp * kNS * 32 + lane;

  for (int r = tid; r < kRows; r += kThreads) cum_t[r] = r < t_rows ? cumc[t0 + r] : 0.0f;

  const int nk = (ds + kKD - 1) / kKD;
  const int n_inter = c > 0 ? nk : 0;  // no state enters the first chunk
  const int n_steps = n_inter + tile + 1;

  // Step i: the C slice of the rows t with the state slice hi and lo
  // (i < n_inter), or source tile i - n_inter's x, cum and dt.
  auto issue = [&](int i) {
    if (i < n_inter) {
      unsigned char* const cs = slots + (i & 1) * Sh::slot;
      unsigned char* const hs = cs + kRows * kKRB;
      const int k0 = i * kKD, rows = min(kKD, ds - k0);
      stage<kKD, kKRB, kThreads>(cs, ccp + t0 * bc_row + k0, bc_row, t_rows, ds - k0, vec);
      stage<HP, RB, kThreads>(hs, hin + static_cast<size_t>(k0) * HP, HP, rows, HP, true);
      stage<HP, RB, kThreads>(hs + kKD * RB, hin + plane + static_cast<size_t>(k0) * HP, HP,
                              rows, HP, true);
      return;
    }
    const int j = i - n_inter, s0 = j * kRows, rows = min(kRows, L - s0);
    stage<HP, RB, kThreads>(xs + (j & 1) * kRows * RB, xc + s0 * x_row, x_row, rows, hp, vec);
    for (int r = tid; r < kRows; r += kThreads) {
      const bool ok = r < rows;
      cp_async_4(cum_s + (j & 1) * kRows + r, ok ? cumc + s0 + r : cumc, ok);
      cp_async_4(dt_s + (j & 1) * kRows + r, ok ? dtc + static_cast<size_t>(s0 + r) * nh : dtc,
                 ok);
    }
  };
  // the warp's score fragments of source tile j, into registers
  auto load_scores = [&](int j, float (&gn)[kNS][4]) {
#pragma unroll
    for (int n = 0; n < kNS; ++n) {
      const float4 v = gw[static_cast<size_t>(j) * (kTileFloats / 4) + n * 32];
      gn[n][0] = v.x;
      gn[n][1] = v.y;
      gn[n][2] = v.z;
      gn[n][3] = v.w;
    }
  };

  const int rl = warp * 16 + gr, rh = rl + 8;  // this lane's two rows of the tile
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  // The next source tile's scores, loaded a step ahead: once this step's
  // scores are used (a source step) or its products issued (a state step).
  float gn[kNS][4];
  if (n_inter == 0) load_scores(0, gn);
  auto prefetch_scores = [&](int i) {
    if (i + 1 < n_steps && i + 1 >= n_inter) load_scores(i + 1 - n_inter, gn);
  };

  issue(0);
  cp_async_commit();
  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // step i's copies have landed
    __syncthreads();
    if (i < n_inter) {
      // acc += C (h hi + h lo) over this slice's states
      const unsigned char* const cs = slots + (i & 1) * Sh::slot;
      const unsigned char* const hs = cs + kRows * kKRB;
      const unsigned char* const cw = cs + warp * 16 * kKRB;  // the warp's C rows
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, cw + (lane % 16) * kKRB + (kk * 16 + 8 * (lane / 16)) * 2);
#pragma unroll
        for (int d2 = 0; d2 < NO / 2; ++d2) {
          const int off = (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * RB +
                          (d2 * 16 + 8 * (lane / 16)) * 2;
          uint32_t bh[4], bl[4];
          ldmatrix_x4_trans(bh, hs + off);
          ldmatrix_x4_trans(bl, hs + kKD * RB + off);
          mma_16816(acc[2 * d2], a, bh[0], bh[1]);
          mma_16816(acc[2 * d2 + 1], a, bh[2], bh[3]);
          mma_16816(acc[2 * d2], a, bl[0], bl[1]);
          mma_16816(acc[2 * d2 + 1], a, bl[2], bl[3]);
        }
      }
      prefetch_scores(i);
      if (i == n_inter - 1) {  // exp(cum_t) C_t . h_in
        const float e_lo = exp2f(cum_t[rl] * kLog2e), e_hi = exp2f(cum_t[rh] * kLog2e);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[n][0] *= e_lo;
          acc[n][1] *= e_lo;
          acc[n][2] *= e_hi;
          acc[n][3] *= e_hi;
        }
      }
    } else {
      // P = G exp(cum_t - cum_s) dt_s for s <= t, in float32, as bf16 hi
      // and lo A fragments (k-step kp covers positions 16 kp .. 16 kp + 15)
      const int j = i - n_inter;
      const float* const cst = cum_s + (j & 1) * kRows;
      const float* const dst = dt_s + (j & 1) * kRows;
      const int dlt = t0 - j * kRows;  // s <= t  <=>  local s <= local t + dlt
      const int s_end = 16 * warp + 16 + dlt;  // the warp's rows see local s < s_end
      const float ct_lo = cum_t[rl], ct_hi = cum_t[rh];
      float gc[kNS][4];
#pragma unroll
      for (int n = 0; n < kNS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) gc[n][e] = gn[n][e];
      prefetch_scores(i);
      uint32_t ph[KP][4], pl[KP][4];
#pragma unroll
      for (int n = 0; n < kNS; ++n) {
        float pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (8 * n < s_end) {  // warp-uniform: n-tiles past the diagonal are all masked
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int sl = 8 * n + 2 * t4 + (e & 1);
            const int tl = e < 2 ? rl : rh;
            const float ct = e < 2 ? ct_lo : ct_hi;
            pv[e] = sl <= tl + dlt ? gc[n][e] * (exp2f((ct - cst[sl]) * kLog2e) * dst[sl])
                                   : 0.0f;
          }
        }
        pack_bf16_split(pv[0], pv[1], ph[n / 2][2 * (n % 2)], pl[n / 2][2 * (n % 2)]);
        pack_bf16_split(pv[2], pv[3], ph[n / 2][2 * (n % 2) + 1], pl[n / 2][2 * (n % 2) + 1]);
      }
      // acc += (P hi + P lo) x
      const unsigned char* const xt = xs + (j & 1) * kRows * RB;
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
        if (16 * kp >= s_end) continue;  // warp-uniform: an all-zero k-step of P
#pragma unroll
        for (int d2 = 0; d2 < NO / 2; ++d2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, xt + (kp * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * RB +
                                    (d2 * 16 + 8 * (lane / 16)) * 2);
          mma_16816(acc[2 * d2], ph[kp], bf[0], bf[1]);
          mma_16816(acc[2 * d2 + 1], ph[kp], bf[2], bf[3]);
          mma_16816(acc[2 * d2], pl[kp], bf[0], bf[1]);
          mma_16816(acc[2 * d2 + 1], pl[kp], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // slot i & 1 is consumed before step i + 2 lands there
  }
  cp_async_wait<0>();

  // y = acc + D x_t, x_t from the diagonal source tile (the last one staged)
  const unsigned char* const xt = xs + (tile & 1) * kRows * RB;
  const float dskip = D[h];
  const bool pairs = hp % 2 == 0;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int p = 8 * n + 2 * t4;
    if (p >= hp) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rh : rl;
      if (r >= t_rows) continue;
      const bf16* const xr = reinterpret_cast<const bf16*>(xt + r * RB);
      const float v0 = acc[n][2 * half] + dskip * __bfloat162float(xr[p]);
      const float v1 = acc[n][2 * half + 1] + dskip * __bfloat162float(xr[p + 1]);
      bf16* const yr = y + (pos0 + t0 + r) * x_row + static_cast<size_t>(h) * hp;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(yr + p) = pack_bf16(v0, v1);
      } else {
        yr[p] = __float2bfloat16(v0);
        if (p + 1 < hp) yr[p + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int HP>
cudaError_t launch_hp(const void* x, const float* dt, const float* A, const void* Bm,
                      const void* Cm, const float* D, void* y, float* st, float* cum, float* sc,
                      float* gbuf, void* hbuf, int Bb, int S, int nh, int hp, int ng, int ds,
                      int L, int chunk_smem, int score_smem, int out_smem, int vec,
                      cudaStream_t stream) {
  using Sh = Shape<HP>;
  // The caller's launch plan must be this build's.
  if (chunk_smem != Sh::chunk_base + 4 * L || score_smem != kScoreSmem ||
      out_smem != Sh::out_smem)
    return cudaErrorInvalidValue;
  const int nc = S / L;
  const long long n_tiles = (L + kRows - 1) / kRows;
  const long long chunk_blocks = static_cast<long long>(Bb) * nc * nh;
  const long long score_blocks = n_tiles * Bb * nc * ng;
  const long long out_blocks = n_tiles * chunk_blocks;
  const long long state_blocks =
      (static_cast<long long>(Bb) * nh * ds * (HP / 2) + kStateThreads - 1) / kStateThreads;
  if (out_blocks > INT_MAX || state_blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ssd_chunk_kernel<HP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(ssd_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           score_smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(ssd_out_kernel<HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           out_smem);
  if (e != cudaSuccess) return e;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(Bm);
  const bf16* cb = static_cast<const bf16*>(Cm);
  ssd_chunk_kernel<HP><<<static_cast<unsigned>(chunk_blocks), kChunkThreads, chunk_smem,
                         stream>>>(xb, dt, A, bb, cum, sc, nc, L, nh, hp, ng, ds, vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (ds > 0) {  // ds 0: no scores and no state, y = D x
    ssd_score_kernel<<<static_cast<unsigned>(score_blocks), kThreads, score_smem, stream>>>(
        bb, cb, gbuf, Bb, nc, L, ng, ds, static_cast<int>(n_tiles), vec);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    ssd_state_kernel<<<static_cast<unsigned>(state_blocks), kStateThreads, 0, stream>>>(
        cum, sc, static_cast<bf16*>(hbuf), st, Bb, nc, L, nh, hp, ds, HP);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  ssd_out_kernel<HP><<<static_cast<unsigned>(out_blocks), kThreads, out_smem, stream>>>(
      xb, dt, D, cb, cum, gbuf, static_cast<const bf16*>(hbuf), static_cast<bf16*>(y), Bb, nc, L,
      nh, hp, ng, ds, static_cast<int>(n_tiles), vec);
  return cudaGetLastError();
}

}  // namespace

// x (B, S, nh, hp), B and C (B, S, ng, ds) and y: contiguous bfloat16; dt
// (B, S, nh), A and D (nh,): float32; st (B, nh, ds, hp) float32.  Scratch
// from the caller: cum (B, nh, S) float32; sc (B, S / chunk, nh, ds, hp)
// float32; gbuf (B, S / chunk, ng, T (T + 1) / 2, 64 * 64) float32 for T
// tiles of 64 positions a chunk (zero-filled when ds is 0); hbuf two
// planes (B, S / chunk, nh, ds, HP) bfloat16.  HP is hp padded to 16, 32,
// 64 or 128; chunk_smem, score_smem and out_smem are the caller's plan
// (dynamic shared-memory bytes of passes 1, 2 and 4) and must equal this
// build's; vec = 1 when hp and ds are multiples of 8 and x, B, C are
// 16-byte aligned.  B * nh >= 1, S >= 1, S % chunk == 0 and nh % ng == 0
// are the caller's checks.  Launches the four passes on `stream`, returns
// cudaGetLastError().
extern "C" int ssd_scan_mma_fwd(const void* x, const float* dt, const float* A, const void* Bm,
                                const void* Cm, const float* D, void* y, float* st, float* cum,
                                float* sc, float* gbuf, void* hbuf, int Bb, int S, int nh, int hp,
                                int ng, int ds, int chunk, int HP, int chunk_smem, int score_smem,
                                int out_smem, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (HP) {
    case 16: e = launch_hp<16>(x, dt, A, Bm, Cm, D, y, st, cum, sc, gbuf, hbuf, Bb, S, nh, hp, ng, ds, chunk, chunk_smem, score_smem, out_smem, vec, s); break;
    case 32: e = launch_hp<32>(x, dt, A, Bm, Cm, D, y, st, cum, sc, gbuf, hbuf, Bb, S, nh, hp, ng, ds, chunk, chunk_smem, score_smem, out_smem, vec, s); break;
    case 64: e = launch_hp<64>(x, dt, A, Bm, Cm, D, y, st, cum, sc, gbuf, hbuf, Bb, S, nh, hp, ng, ds, chunk, chunk_smem, score_smem, out_smem, vec, s); break;
    case 128: e = launch_hp<128>(x, dt, A, Bm, Cm, D, y, st, cum, sc, gbuf, hbuf, Bb, S, nh, hp, ng, ds, chunk, chunk_smem, score_smem, out_smem, vec, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* ssd_scan_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
