// Mamba-2 SSD scan, chunked dual form, for Hopper (sm_90a): x, B, C in
// float32 or bfloat16, dt, A, D and all arithmetic in float32.
//
// Replaces the TPU kernel `_ssd_kernel` behind `ssd_scan_pallas` in
// src/repro/kernels/ssd_scan.py.
//
// What it computes, as `_ssd_kernel` does, for batch row b and head h
// (B/C group g = h // (nh / ng)), chunk by chunk with the state entering
// the chunk (zero before the first):
//   cum_t   = sum_{r <= t} dt_r A              (within the chunk)
//   y_t     = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s   (intra)
//           + exp(cum_t) C_t . state                                  (inter)
//           + D x_t                                                   (skip)
//   state'  = exp(total) state + sum_s B_s^T exp(total - cum_s) dt_s x_s
// with total = cum_{last}.  y is stored in x's type; the final state
// (ds, hp) is float32.
//
// What bounds it on this card: the chunk's quadratic products, about
// 2 L (ds + hp) FLOPs a position per head over a chunk of L, plus the state
// terms 4 ds hp a position; at mamba2-130m's prefill (L = 256, ds = 128,
// hp = 64) that is above the bytes (x, dt, B, C, y once each over
// 3.35 TB/s).  This first version runs them on the float32 CUDA cores.
//
// Design.  The Pallas grid (B, nh, n_chunks) carried the state in VMEM
// along its sequential chunk axis; blocks on Hopper run in no order, so one
// block of 256 threads takes one (b, h) and loops over the chunks itself,
// keeping the (ds, hp) float32 state in shared memory (32 KB at
// mamba2-130m).  One chunk's B and C at L = 256, ds = 128 would take 128 KB
// each in float32, so the chunk's ROWS are tiled: 32 output rows t at a
// time against 32 source rows s at a time (only s-tiles at or below the
// t-tile: the rest is masked by s <= t), with a 32 x 32 tile of masked
// scores in shared memory.  C and B rows are stored with a stride of
// ds + 1 floats so that a warp's reads hit distinct banks.  The products
// run from shared memory, whose bandwidth bounds them, so each thread
// holds a block of outputs in registers and reuses every value it loads:
// a 2 x 2 block of scores, and 4 rows x hp / 32 columns of y and of the
// state (hp <= 128).  The within-chunk cumulative sum is a warp scan.
// Dynamic shared memory: at mamba2-130m, 80,256 bytes a block, so two
// blocks fit an SM.
//
// Summation order differs from the plain version's (einsums and a
// library cumsum): the two agree to float32 rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;                       // chunk rows a tile
constexpr int kRowGroups = kThreads / 32;       // a warp a group of rows
constexpr int kRowsPer = kTile / kRowGroups;    // rows of a tile a thread holds
static_assert(kThreads == 16 * 16 && kTile == 32, "scores are 2 x 2 blocks of a 16 x 16 grid");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// JP: columns (of 32 lanes) of a head's hp a thread holds, hp <= 32 JP.
template <typename T, int JP>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                T* __restrict__ y, float* __restrict__ st, int S, int nh, int hp,
                int ng, int ds, int chunk) {
  extern __shared__ float smem[];
  const int cs_stride = ds + 1;
  float* state = smem;                          // ds * hp
  float* cs = state + ds * hp;                  // kTile rows of C (stride ds + 1)
  float* bs = cs + kTile * cs_stride;           // kTile rows of B (stride ds + 1)
  float* xs = bs + kTile * cs_stride;           // kTile rows of weighted x (stride hp)
  float* ms = xs + kTile * hp;                  // kTile x kTile masked scores (stride kTile + 1)
  float* cum = ms + kTile * (kTile + 1);        // chunk
  float* dts = cum + chunk;                     // chunk

  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const int g = h / (nh / ng);
  const int tid = threadIdx.x;
  const int rg = tid / 32, pc = tid % 32;  // row group (the warp) and column lane
  const int ty = tid / 16, tx = tid % 16;  // the score tile's 2 x 2 blocks
  const float a = A[h], dskip = D[h];
  const size_t x_row = static_cast<size_t>(nh) * hp;   // x / y stride of one position
  const size_t bc_row = static_cast<size_t>(ng) * ds;  // B / C stride of one position
  const T* xb = x + static_cast<size_t>(b) * S * x_row + static_cast<size_t>(h) * hp;
  T* yb = y + static_cast<size_t>(b) * S * x_row + static_cast<size_t>(h) * hp;
  const T* bb = Bm + static_cast<size_t>(b) * S * bc_row + static_cast<size_t>(g) * ds;
  const T* cb = Cm + static_cast<size_t>(b) * S * bc_row + static_cast<size_t>(g) * ds;
  const float* dtb = dt + static_cast<size_t>(b) * S * nh + h;

  for (int e = tid; e < ds * hp; e += kThreads) state[e] = 0.0f;

  // Rows [r0, r0 + kTile) of the chunk at c0: B rows into bs, and x rows
  // times dt (times exp(total - cum) when `decay_in`) into xs; rows past
  // the chunk are zero.
  auto load_sources = [&](int c0, int r0, bool decay_in, float total) {
    for (int e = tid; e < kTile * ds; e += kThreads) {
      const int r = e / ds, d = e % ds, t = r0 + r;
      bs[r * cs_stride + d] = t < chunk ? to_f32(bb[(c0 + t) * bc_row + d]) : 0.0f;
    }
    for (int e = tid; e < kTile * hp; e += kThreads) {
      const int r = e / hp, p = e % hp, t = r0 + r;
      float w = 0.0f;
      if (t < chunk) {
        w = to_f32(xb[(c0 + t) * x_row + p]) * dts[t];
        if (decay_in) w *= expf(total - cum[t]);
      }
      xs[r * hp + p] = w;
    }
  };

  for (int c0 = 0; c0 < S; c0 += chunk) {
    __syncthreads();  // the previous chunk's state update is done
    for (int t = tid; t < chunk; t += kThreads) dts[t] = dtb[static_cast<size_t>(c0 + t) * nh];
    __syncthreads();
    if (tid < 32) {  // cum = inclusive scan of dt * A, one warp
      const int per = (chunk + 31) / 32, lo = tid * per, hi = min(lo + per, chunk);
      float run = 0.0f;
      for (int t = lo; t < hi; ++t) {
        run += dts[t] * a;
        cum[t] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float before = incl - run;
      for (int t = lo; t < hi; ++t) cum[t] += before;
    }
    __syncthreads();
    const float total = cum[chunk - 1];

    for (int t0 = 0; t0 < chunk; t0 += kTile) {
      for (int e = tid; e < kTile * ds; e += kThreads) {
        const int r = e / ds, d = e % ds, t = t0 + r;
        cs[r * cs_stride + d] = t < chunk ? to_f32(cb[(c0 + t) * bc_row + d]) : 0.0f;
      }
      __syncthreads();
      // inter: exp(cum_t) C_t . state, rows rg + 8 i and columns pc + 32 j
      float yacc[kRowsPer][JP];
      {
        float acc[kRowsPer][JP] = {};
        for (int d = 0; d < ds; ++d) {
          float cv[kRowsPer];
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) cv[i] = cs[(rg + kRowGroups * i) * cs_stride + d];
#pragma unroll
          for (int j = 0; j < JP; ++j) {
            const int p = pc + 32 * j;
            const float sv = p < hp ? state[d * hp + p] : 0.0f;
#pragma unroll
            for (int i = 0; i < kRowsPer; ++i) acc[i][j] += cv[i] * sv;
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          const int t = t0 + rg + kRowGroups * i;
          const float dec = t < chunk ? expf(cum[t]) : 0.0f;
#pragma unroll
          for (int j = 0; j < JP; ++j) yacc[i][j] = dec * acc[i][j];
        }
      }
      // intra: source tiles at or below this output tile
      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        load_sources(c0, s0, false, total);
        __syncthreads();
        {  // masked scores, a 2 x 2 block (rows ty, ty + 16; columns tx, tx + 16) a thread
          const float* c_0 = cs + ty * cs_stride;
          const float* c_1 = c_0 + 16 * cs_stride;
          const float* b_0 = bs + tx * cs_stride;
          const float* b_1 = b_0 + 16 * cs_stride;
          float dot[2][2] = {};
          for (int d = 0; d < ds; ++d) {
            const float cv0 = c_0[d], cv1 = c_1[d], bv0 = b_0[d], bv1 = b_1[d];
            dot[0][0] += cv0 * bv0;
            dot[0][1] += cv0 * bv1;
            dot[1][0] += cv1 * bv0;
            dot[1][1] += cv1 * bv1;
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int r = ty + 16 * i, sc = tx + 16 * j, t = t0 + r, s = s0 + sc;
              ms[r * (kTile + 1) + sc] =
                  (s <= t && t < chunk) ? dot[i][j] * expf(cum[t] - cum[s]) : 0.0f;
            }
          }
        }
        __syncthreads();
        for (int sc = 0; sc < kTile; ++sc) {
          float mv[kRowsPer];
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) mv[i] = ms[(rg + kRowGroups * i) * (kTile + 1) + sc];
#pragma unroll
          for (int j = 0; j < JP; ++j) {
            const int p = pc + 32 * j;
            const float xv = p < hp ? xs[sc * hp + p] : 0.0f;
#pragma unroll
            for (int i = 0; i < kRowsPer; ++i) yacc[i][j] += mv[i] * xv;
          }
        }
        __syncthreads();  // bs, xs and ms are rewritten next
      }
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const int t = t0 + rg + kRowGroups * i;
        if (t >= chunk) continue;
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          const int p = pc + 32 * j;
          if (p < hp) {
            const size_t off = (c0 + t) * x_row + p;
            yb[off] = from_f32<T>(yacc[i][j] + to_f32(xb[off]) * dskip);
          }
        }
      }
    }

    // state' = exp(total) state + sum_s B_s^T (x_s dt_s exp(total - cum_s)),
    // rows d0 + rg + 8 i and columns pc + 32 j of the state a thread
    const float decay = expf(total);
    for (int e = tid; e < ds * hp; e += kThreads) state[e] *= decay;
    for (int s0 = 0; s0 < chunk; s0 += kTile) {
      __syncthreads();  // every read of the old state, bs and xs is done, and the scaling
      load_sources(c0, s0, true, total);
      __syncthreads();
      for (int d0 = 0; d0 < ds; d0 += kTile) {
        float acc[kRowsPer][JP] = {};
        for (int sc = 0; sc < kTile; ++sc) {
          float bv[kRowsPer];
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) {
            const int d = d0 + rg + kRowGroups * i;
            bv[i] = d < ds ? bs[sc * cs_stride + d] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < JP; ++j) {
            const int p = pc + 32 * j;
            const float xv = p < hp ? xs[sc * hp + p] : 0.0f;
#pragma unroll
            for (int i = 0; i < kRowsPer; ++i) acc[i][j] += bv[i] * xv;
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          const int d = d0 + rg + kRowGroups * i;
          if (d >= ds) continue;
#pragma unroll
          for (int j = 0; j < JP; ++j) {
            const int p = pc + 32 * j;
            if (p < hp) state[d * hp + p] += acc[i][j];
          }
        }
      }
    }
  }
  __syncthreads();
  float* stb = st + static_cast<size_t>(blockIdx.x) * ds * hp;
  for (int e = tid; e < ds * hp; e += kThreads) stb[e] = state[e];
}

template <typename T, int JP>
cudaError_t launch_jp(const void* x, const float* dt, const float* A, const void* Bm,
                      const void* Cm, const float* D, void* y, float* st, int Bb, int S, int nh,
                      int hp, int ng, int ds, int chunk, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<T, JP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  ssd_scan_kernel<T, JP><<<Bb * nh, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), D,
      static_cast<T*>(y), st, S, nh, hp, ng, ds, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* dt, const float* A, const void* Bm,
                         const void* Cm, const float* D, void* y, float* st, int Bb, int S,
                         int nh, int hp, int ng, int ds, int chunk, size_t smem,
                         cudaStream_t stream) {
  if (hp <= 32)
    return launch_jp<T, 1>(x, dt, A, Bm, Cm, D, y, st, Bb, S, nh, hp, ng, ds, chunk, smem, stream);
  if (hp <= 64)
    return launch_jp<T, 2>(x, dt, A, Bm, Cm, D, y, st, Bb, S, nh, hp, ng, ds, chunk, smem, stream);
  if (hp <= 128)
    return launch_jp<T, 4>(x, dt, A, Bm, Cm, D, y, st, Bb, S, nh, hp, ng, ds, chunk, smem, stream);
  return cudaErrorInvalidValue;
}

// Shared memory a block of the kernel takes, in bytes (the wrapper's
// `_smem_bytes` computes the same).
size_t smem_bytes(int hp, int ds, int chunk) {
  const size_t floats = static_cast<size_t>(ds) * hp + 2 * static_cast<size_t>(kTile) * (ds + 1) +
                        static_cast<size_t>(kTile) * hp + kTile * (kTile + 1) +
                        2 * static_cast<size_t>(chunk);
  return floats * sizeof(float);
}

}  // namespace

// x (B, S, nh, hp) and y in one type (dtype 0 float32, 1 bfloat16), dt
// (B, S, nh), A and D (nh,) float32, B and C (B, S, ng, ds) in x's type,
// st (B, nh, ds, hp) float32; all contiguous.  S % chunk == 0,
// nh % ng == 0, hp <= 128 and the shared memory are the caller's checks.
// Launches on `stream`, returns cudaGetLastError().
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A, const void* Bm,
                            const void* Cm, const float* D, void* y, float* st, int dtype,
                            int Bb, int S, int nh, int hp, int ng, int ds, int chunk,
                            void* stream) {
  const size_t smem = smem_bytes(hp, ds, chunk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0 ? launch_typed<float>(x, dt, A, Bm, Cm, D, y, st, Bb, S, nh, hp, ng, ds, chunk,
                                       smem, s)
                 : launch_typed<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, st, Bb, S, nh, hp, ng, ds,
                                               chunk, smem, s);
  return static_cast<int>(e);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
