// Decode attention (one query position a row against a key / value cache;
// GQA, causal at a runtime position, a sliding window, a runtime fill) for
// Hopper (sm_90a): the cache read in its own type, bfloat16 or float32,
// float32 arithmetic on the CUDA cores, the keys split over blocks.
//
// The JAX package has no kernel here (its decode runs chunked_attention's
// online softmax in XLA ops), and neither had this port: its plain route,
// layers.chunked_attention, widens the whole cache to float32 and repeats
// it over the query heads every step.
//
// What it computes, for the query of row b and head h (kv head
// h / (H / K)) at position qpos: out = softmax(scale * q k^T) v over the
// visible keys, q widened as float(q) * scale, scale = 1 / sqrt(hd); key t
// is visible when t < min(T, kv_len), t <= qpos (causal) and
// qpos - t < window (window > 0).  A row with no visible key averages
// every value of the cache, as chunked_attention's single chunk of T keys
// does (its scores are all -1e30 there, so every p is 1).  Under p_bf16, p
// and v are rounded to bfloat16 before their product, as chunked_attention
// does with p_dtype="bfloat16"; l sums the unrounded p.
//
// What bounds it on this card: the bytes.  Each cached row of the live
// range is read once, for all the query heads of its kv head; the work is
// 4 FLOP a (query head, key, dim), ~6 FLOP a byte of a bf16 cache at 6
// query heads a kv head, under the FP32 CUDA cores' 67 TFLOP/s at
// 3.35 TB/s.  So the products stay on the CUDA cores; mma.sync buys
// nothing at one query position.
//
// Design: a block of four warps takes one (b, kv head, chunk of up to 8
// query heads, split of the keys).  Its keys are staged in tiles through
// shared memory by cp.async, 16 bytes a thread a copy, in a ring of up to
// four stages: the next tiles load while this one is read.  A key row is
// shared by `kLanes` lanes of a warp (16 bytes of the row each, kVpl units
// a lane); the warp's 32 / kLanes row groups each take their own rows, and
// each lane holds its columns of q and of the accumulator for every query
// head of the block in registers.  A row's dots (one a head) are summed
// over the row group by a reduce-scatter of shuffles: each level halves
// the heads a lane keeps, so a lane ends with the whole score of one head
// (kNv heads where the row group has fewer lanes than heads), and runs the
// online softmax of that head alone, once a tile of kSteps rows; each
// head's p and correction then reach the row group's lanes by one shuffle
// from the lane that holds it.  At the end the row groups of a warp, then
// the four warps, are merged in a fixed order.  With one split the block
// writes the output; with more it writes its partial (acc, m, l) to
// scratch, and a second kernel merges the splits in split order: a warp a
// (b, query head).  Every sum has a fixed order, so a call is bitwise the
// same from run to run.  Registers are budgeted for three blocks an SM to
// six heads a block (the chat cell's qwen2-vl: 165, no spills).
//
// The live range is read on the device: qpos and kv_len come as values or
// as pointers to 0-d int32 / int64 tensors, so a captured step replays at
// every position, and a split whose keys all lie outside the range writes
// an empty partial and exits.

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
using decode_split::merge_splits;
using decode_split::neg_inf;
using decode_split::Pos;
using decode_split::read_pos;
using decode_split::rescale;
using decode_split::Unit;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 4;        // rows a row group takes from a tile
constexpr int kStagesMax = 4;    // tiles a block has in flight or in use at most
constexpr int kStageBudget = 65536;  // shared-memory bytes of a block's stages
constexpr int kMinBlocks = 3;    // blocks an SM the registers are budgeted for, to 6 heads
constexpr int kMergeWarps = 4;   // the merge kernel's warps a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int HD, int G>
struct Shape {
  static constexpr int kEs = static_cast<int>(sizeof(T));
  static constexpr int kVec = Unit<T>::kElems;              // elements a 16-byte unit
  static constexpr int kUnits = HD / kVec;                   // units a row
  static constexpr int kLanes = kUnits < 32 ? kUnits : 32;  // lanes a row
  static constexpr int kVpl = kUnits / kLanes;              // units a lane
  static constexpr int kCols = kVec * kVpl;                 // columns a lane
  static constexpr int kGroups = 32 / kLanes;               // row groups a warp
  // A row's dots are summed over its row group and scattered: kPad slots
  // (the heads, padded to a power of two) in kScat groups of kNv slots,
  // each held by kSpan lanes; lane c of a row group holds the slots from
  // (c / kSpan) * kNv on.
  static constexpr int kPad = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  static constexpr int kScat = kPad < kLanes ? kPad : kLanes;
  static constexpr int kScatLevels = kScat >= 8 ? 3 : kScat >= 4 ? 2 : kScat >= 2 ? 1 : 0;
  static constexpr int kNv = kPad / kScat;
  static constexpr int kSpan = kLanes / kScat;
  static constexpr int kTile = kWarps * kGroups * kSteps;   // keys a tile
  static constexpr int kRowBytes = HD * kEs;
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kStage = 2 * kTileBytes;  // a K tile, then a V tile
  static constexpr int kStages =
      kStageBudget / kStage < kStagesMax ? kStageBudget / kStage : kStagesMax;
  static constexpr int kMerge = kWarps * G * (HD + 2) * 4;
  static constexpr int kSmem = kStages * kStage > kMerge ? kStages * kStage : kMerge;
  static_assert(kUnits >= 1 && kUnits % kLanes == 0, "a row must split into whole units");
  static_assert((kTile * kUnits) % kThreads == 0, "a tile's copies must split evenly");
  static_assert(kStages >= 2, "the next tile loads while this one is read");
};

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads, G <= 6 ? kMinBlocks : 2)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, float* __restrict__ part,
                        int T_, int H, int K, int chunks, int split_keys, int splits, Pos off,
                        Pos len, int causal, int window, float scale, int p_bf16) {
  using Sh = Shape<T, HD, G>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x % splits;
  const int pair = blockIdx.x / splits;
  const int chunk = pair % chunks;
  const int bk = pair / chunks;
  const int b = bk / K, kh = bk % K;
  const int group = H / K;
  const int h0 = kh * group + chunk * G;
  const int nh = min(G, group - chunk * G);  // live query heads of this block

  // the live keys: [lo, hi), or every key, scored alike, when none is live
  const long long qpos = read_pos(off);
  long long hi = min(static_cast<long long>(T_), read_pos(len));
  if (causal) hi = min(hi, qpos + 1);
  long long lo = window > 0 ? max(0LL, qpos - window + 1) : 0LL;
  const bool uniform = lo >= hi;
  if (uniform) {
    lo = 0;
    hi = T_;
  }
  const int s0 = static_cast<int>(max(lo, static_cast<long long>(split) * split_keys));
  const int s1 = static_cast<int>(min(hi, static_cast<long long>(split + 1) * split_keys));
  const size_t part_row = static_cast<size_t>(HD + 2);
  if (s0 >= s1) {  // an empty partial: m = -inf, l = 0, acc = 0
    for (int i = threadIdx.x; i < nh * (HD + 2); i += kThreads) {
      const int j = i / (HD + 2), d = i % (HD + 2);
      part[((static_cast<size_t>(b) * H + h0 + j) * splits + split) * part_row + d] =
          d == HD ? neg_inf() : 0.f;
    }
    return;
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / Sh::kLanes, c = lane % Sh::kLanes;
  const size_t row_stride = static_cast<size_t>(K) * HD;  // elements from key t to t + 1
  const T* kb = k + (static_cast<size_t>(b) * T_ * K + kh) * HD;
  const T* vb = v + (static_cast<size_t>(b) * T_ * K + kh) * HD;

  // this lane's columns of q, widened and scaled; zero for heads past nh
  float qf[G][Sh::kCols];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int u = 0; u < Sh::kVpl; ++u) {
      uint4 x = make_uint4(0, 0, 0, 0);
      if (j < nh)
        x = *reinterpret_cast<const uint4*>(
            q + (static_cast<size_t>(b) * H + h0 + j) * HD + (u * Sh::kLanes + c) * Sh::kVec);
      Unit<T>::widen(x, &qf[j][u * Sh::kVec]);
#pragma unroll
      for (int e = 0; e < Sh::kVec; ++e) qf[j][u * Sh::kVec + e] *= scale;
    }
  }

  const int n_tiles = (s1 - s0 + Sh::kTile - 1) / Sh::kTile;
  auto stage_tile = [&](int it) {
    unsigned char* ks = smem + (it % Sh::kStages) * Sh::kStage;
    unsigned char* vs = ks + Sh::kTileBytes;
    const int t0 = s0 + it * Sh::kTile;
#pragma unroll
    for (int i = 0; i < Sh::kTile * Sh::kUnits / kThreads; ++i) {
      const int cidx = tid + i * kThreads;
      const int r = cidx / Sh::kUnits, w = cidx % Sh::kUnits;
      const bool ok = t0 + r < s1;  // rows past the split's live end are zero-filled
      const size_t at = ok ? static_cast<size_t>(t0 + r) * row_stride + w * Sh::kVec : 0;
      cp_async_16(ks + r * Sh::kRowBytes + w * 16, kb + at, ok);
      cp_async_16(vs + r * Sh::kRowBytes + w * 16, vb + at, ok);
    }
  };

  // the running max and sum of this lane's slots, and its columns of every head's acc
  float ms[Sh::kNv], ls[Sh::kNv], acc[G][Sh::kCols];
#pragma unroll
  for (int i = 0; i < Sh::kNv; ++i) {
    ms[i] = neg_inf();
    ls[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int e = 0; e < Sh::kCols; ++e) acc[j][e] = 0.f;
  }
  const int owner = grp * Sh::kLanes;  // the row group's first lane

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
    const unsigned char* ks = smem + (it % Sh::kStages) * Sh::kStage;
    const unsigned char* vs = ks + Sh::kTileBytes;
    const int t0 = s0 + it * Sh::kTile;

    // scores of this row group's kSteps rows: a row's kPad dots (zero past
    // G), summed over the row group and scattered, so that a lane ends with
    // the sums of its kNv slots
    float sc[kSteps][Sh::kNv];
    bool valid[kSteps];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int r = (st * kWarps + warp) * Sh::kGroups + grp;
      valid[st] = t0 + r < s1;
      float kf[Sh::kCols];
#pragma unroll
      for (int u = 0; u < Sh::kVpl; ++u)
        Unit<T>::widen(*reinterpret_cast<const uint4*>(
                           ks + r * Sh::kRowBytes + (u * Sh::kLanes + c) * 16),
                       &kf[u * Sh::kVec]);
      float d[Sh::kPad];
#pragma unroll
      for (int j = 0; j < Sh::kPad; ++j) {
        float dot = 0.f;
        if (j < G) {
#pragma unroll
          for (int e = 0; e < Sh::kCols; ++e) dot = fmaf(qf[j][e], kf[e], dot);
        }
        d[j] = dot;
      }
      // each level halves the slots a lane holds: the upper half to lanes
      // with the level's bit set, the lower to the others
#pragma unroll
      for (int lvl = 0; lvl < Sh::kScatLevels; ++lvl) {
        const int mask = Sh::kLanes >> (lvl + 1), half = Sh::kPad >> (lvl + 1);
        const bool up = (c & mask) != 0;
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const float send = up ? d[i] : d[i + half];
          d[i] = (up ? d[i + half] : d[i]) + __shfl_xor_sync(kFull, send, mask);
        }
      }
#pragma unroll
      for (int mask = Sh::kSpan / 2; mask >= 1; mask /= 2) {
#pragma unroll
        for (int i = 0; i < Sh::kNv; ++i) d[i] += __shfl_xor_sync(kFull, d[i], mask);
      }
#pragma unroll
      for (int i = 0; i < Sh::kNv; ++i) sc[st][i] = uniform ? 0.f : d[i];
    }

    // the online softmax of this lane's slots, once a tile; p into sc
    float corr_s[Sh::kNv];
#pragma unroll
    for (int i = 0; i < Sh::kNv; ++i) {
      float mx = neg_inf();
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
        if (valid[st]) mx = fmaxf(mx, sc[st][i]);
      const float mn = fmaxf(ms[i], mx);
      corr_s[i] = rescale(ms[i], mn);
      float sum = 0.f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const float p = valid[st] ? __expf(sc[st][i] - mn) : 0.f;
        sum += p;
        sc[st][i] = p_bf16 ? round_bf16(p) : p;
      }
      ls[i] = ls[i] * corr_s[i] + sum;
      ms[i] = mn;
    }
    // a head's correction and p reach every lane of the row group from its slot's first lane
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float corr = __shfl_sync(kFull, corr_s[j % Sh::kNv], owner + (j / Sh::kNv) * Sh::kSpan);
#pragma unroll
      for (int e = 0; e < Sh::kCols; ++e) acc[j][e] *= corr;
    }

    // acc += p v
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int r = (st * kWarps + warp) * Sh::kGroups + grp;
      float vf[Sh::kCols];
#pragma unroll
      for (int u = 0; u < Sh::kVpl; ++u)
        Unit<T>::widen(*reinterpret_cast<const uint4*>(
                           vs + r * Sh::kRowBytes + (u * Sh::kLanes + c) * 16),
                       &vf[u * Sh::kVec]);
      if (Sh::kEs == 4 && p_bf16) {  // a bfloat16 cache is already so
#pragma unroll
        for (int e = 0; e < Sh::kCols; ++e) vf[e] = round_bf16(vf[e]);
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float p = __shfl_sync(kFull, sc[st][j % Sh::kNv], owner + (j / Sh::kNv) * Sh::kSpan);
#pragma unroll
        for (int e = 0; e < Sh::kCols; ++e) acc[j][e] = fmaf(p, vf[e], acc[j][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage is read: the warps' merge below reuses them
  float m[G], l[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int src = owner + (j / Sh::kNv) * Sh::kSpan;
    m[j] = __shfl_sync(kFull, ms[j % Sh::kNv], src);
    l[j] = __shfl_sync(kFull, ls[j % Sh::kNv], src);
  }

  // merge the warp's row groups, lowest lane bit first
#pragma unroll
  for (int mask = Sh::kLanes; mask < 32; mask *= 2) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float mo = __shfl_xor_sync(kFull, m[j], mask);
      const float lo_ = __shfl_xor_sync(kFull, l[j], mask);
      const float mn = fmaxf(m[j], mo);
      const float a = rescale(m[j], mn), bo = rescale(mo, mn);
      l[j] = l[j] * a + lo_ * bo;
#pragma unroll
      for (int e = 0; e < Sh::kCols; ++e)
        acc[j][e] = acc[j][e] * a + __shfl_xor_sync(kFull, acc[j][e], mask) * bo;
      m[j] = mn;
    }
  }

  // then the warps, in warp order, through shared memory
  float* ws = reinterpret_cast<float*>(smem);  // [warp][head][HD + 2]: acc, m, l
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float* row = ws + (warp * G + j) * (HD + 2);
#pragma unroll
      for (int u = 0; u < Sh::kVpl; ++u) {
#pragma unroll
        for (int e = 0; e < Sh::kVec; ++e)
          row[(u * Sh::kLanes + c) * Sh::kVec + e] = acc[j][u * Sh::kVec + e];
      }
      if (c == 0) {
        row[HD] = m[j];
        row[HD + 1] = l[j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nh * HD; i += kThreads) {
    const int j = i / HD, d = i % HD;
    float mw = neg_inf();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, ws[(w * G + j) * (HD + 2) + HD]);
    float lw = 0.f, aw = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* row = ws + (w * G + j) * (HD + 2);
      const float f = rescale(row[HD], mw);
      lw += row[HD + 1] * f;
      aw += row[d] * f;
    }
    const size_t bh = static_cast<size_t>(b) * H + h0 + j;
    if (splits == 1) {
      Unit<T>::store(o + bh * HD + d, aw / fmaxf(lw, 1e-30f));
    } else {
      float* pr = part + (bh * splits + split) * part_row;
      pr[d] = aw;
      if (d == 0) {
        pr[HD] = mw;
        pr[HD + 1] = lw;
      }
    }
  }
}

// out[b, h] from the splits' partials, in split order: a warp a (b, h).
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kMergeWarps)
decode_attention_merge_kernel(const float* __restrict__ part, T* __restrict__ o, int BH,
                              int splits) {
  const int bh = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  if (bh < BH) merge_splits<T, HD>(part, o, bh, splits, splits, threadIdx.x % 32);
}

struct Args {
  const void *q, *k, *v;
  void *o, *part;
  int B, n_keys, H, K, chunks, split_keys, splits;
  Pos off, len;
  int causal, window;
  float scale;
  int p_bf16, tile, smem;
  cudaStream_t stream;
};

template <typename T, int HD, int G>
cudaError_t launch(const Args& a) {
  using Sh = Shape<T, HD, G>;
  // The caller's launch plan must be this build's.
  if (a.tile != Sh::kTile || a.smem != Sh::kSmem) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(a.B) * a.K * a.chunks * a.splits;
  if (blocks > INT_MAX || blocks < 1) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<T, HD, G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (e != cudaSuccess) return e;
  decode_attention_kernel<T, HD, G><<<static_cast<unsigned>(blocks), kThreads, Sh::kSmem,
                                      a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), static_cast<float*>(a.part), a.n_keys, a.H, a.K, a.chunks,
      a.split_keys,
      a.splits, a.off, a.len, a.causal, a.window, a.scale, a.p_bf16);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  const long long bh = static_cast<long long>(a.B) * a.H;
  decode_attention_merge_kernel<T, HD>
      <<<static_cast<unsigned>((bh + kMergeWarps - 1) / kMergeWarps), 32 * kMergeWarps, 0,
         a.stream>>>(static_cast<const float*>(a.part), static_cast<T*>(a.o),
                     static_cast<int>(bh), a.splits);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_heads(const Args& a, int heads) {
  switch (heads) {
    case 1: return launch<T, HD, 1>(a);
    case 2: return launch<T, HD, 2>(a);
    case 3: return launch<T, HD, 3>(a);
    case 4: return launch<T, HD, 4>(a);
    case 5: return launch<T, HD, 5>(a);
    case 6: return launch<T, HD, 6>(a);
    case 7: return launch<T, HD, 7>(a);
    case 8: return launch<T, HD, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_hd(const Args& a, int hd, int heads) {
  switch (hd) {
    case 16: return launch_heads<T, 16>(a, heads);
    case 32: return launch_heads<T, 32>(a, heads);
    case 64: return launch_heads<T, 64>(a, heads);
    case 128: return launch_heads<T, 128>(a, heads);
    case 256: return launch_heads<T, 256>(a, heads);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, 1, H, hd), k and v (B, T, K, hd), o like q: contiguous, 16-byte
// aligned, float32 (dtype 0) or bfloat16 (1).  hd is 16, 32, 64, 128 or
// 256; `heads` (1-8) query heads a block in `chunks` blocks a kv head;
// H % K == 0 and B, T >= 1 are the caller's checks.  `part` holds
// B * H * splits * (hd + 2) floats when splits > 1 (null otherwise).  The query's position
// and the cache's fill are `off_val` / `len_val`, or read on the device
// from `off_ptr` / `len_ptr` (int64 when `*_64`, else int32) when set.
// `tile` and `smem` are the caller's launch plan and must equal this
// build's.  Launches on `stream` (the merge kernel after the split kernel
// when splits > 1), returns cudaGetLastError().
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* part, int dtype, int B, int T, int H, int K, int hd,
                                    int heads, int chunks, int split_keys, int splits,
                                    const void* off_ptr, long long off_val, int off_64,
                                    const void* len_ptr, long long len_val, int len_64,
                                    int causal, int window, float scale, int p_bf16, int tile,
                                    int smem, void* stream) {
  const Args a{q, k, v, o, part, B, T, H, K, chunks, split_keys, splits,
               Pos{off_ptr, off_val, off_64}, Pos{len_ptr, len_val, len_64}, causal, window,
               scale, p_bf16, tile, smem, static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  switch (dtype) {
    case 0: e = launch_hd<float>(a, hd, heads); break;
    case 1: e = launch_hd<bf16>(a, hd, heads); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
