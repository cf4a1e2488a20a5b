// The Alg-2 placement sweep's row loop and tile walk for Hopper (sm_90a),
// float64, shared by the single-instance kernel (placement_sweep.cu) and
// the fleet-parallel one (placement_sweep_batch.cu).
//
// The two kernels run one walk: kernel 1 is the batched walk over a stack
// of one instance whose live counts are its widths.  They differ only in
// how a tile finds its instance and tables (the `Instance` policy each
// source defines): row `row` of the flattened stack belongs to instance
// `row / R` (kernel 2) or 0 (kernel 1), and kernel 1 has no count arrays.
//
// Exactness.  Verdicts must be bit-identical to the plain version and to
// the scalar oracle at float64, so the chain replays its operations in the
// same order:
//   avail     = (c - tcfg) - extra
//   can_start = (c > (tcfg + ii) + EPS) && (avail > EPS)
//   split     = (rem - avail) > EPS
//   c_after   = avail - rem
//   closure   = c_after <= (tcfg + ii) + EPS
// There is no multiply to contract; both sources build with -fmad=false
// and no fast-math (kernels/_build.py), so nothing reassociates or fuses.
// A row is live while k < n_t_eff; it dies when its device cursor reaches
// n_f_eff with tasks left; it refills capacity only while j < n_f_eff.
// Live counts are clamped to the padded widths once a row, so no gather
// passes a table whatever the counts hold (with counts in range, as the
// plain version requires them, the clamp changes nothing), and an
// instance with n_f_eff == 0 reads the zero pad at slot 0.  Every row of
// the stack is computed, padded rows too.
//
// Layout of the work (sizes from sweep_plan in kernels/placement_step.py,
// passed in by the launchers):
//   * the B x R rows are flattened, row-major, and cut into tiles of 32
//     consecutive rows, a warp's, one a lane; a tile may span several
//     instances (at most `span`: two at R = 16, 32 at R = 1); the grid
//     covers the stack, one tile a warp;
//   * staged path, for a launch whose warps the card holds at once: a warp
//     copies its tile's shares (a contiguous span of 32 n_t doubles) into
//     its own shared memory with cp.async, 16 bytes a copy where the tile
//     start is 16-byte aligned and n_t even (row stride `stride`, even),
//     else 8 bytes (`stride` odd, so the lanes' reads at one task index
//     fall on distinct bank pairs); the tables and live counts of the
//     instances the tile spans follow in the same group, so one round trip
//     to device memory covers both.  Each lane then runs its row's loop on
//     shared memory only.  No block barrier: warps go their own pace;
//   * direct path, for larger launches and for rows too wide to stage
//     (n_t in the hundreds or more): each lane reads its row and its
//     instance's tables from device memory through the read-only cache.
//     A launch of more warps than the card holds is bound by instruction
//     throughput (about 54 a step, a warp running as long as its longest
//     row); there staging only adds instructions, and measured slower, as
//     did a persistent grid that stages a warp's next tile while it sweeps
//     one, and staging the tables alone (PERF.md, Findings).
//
// Both paths keep their operand base pointers in registers (`pinned`),
// start a row's first loads before its counts arrive, and, from device
// memory, load an operand again only when its cursor moves.
//
// Bound on this card: each share is read once (8 n_t bytes a row), each
// instance's tables once, and 13 bytes a row are written; a row does ~12
// float64 operations a step and at most n_t_eff + n_f_eff steps, so by the
// data sheet's rates the kernels are bound by memory traffic.

#pragma once

#include <cuda_runtime.h>

namespace placement_sweep {

constexpr double kEps = 1e-9;  // == repro_torch.core.placement._EPS
constexpr int kTile = 32;       // rows a tile: a warp's
constexpr int kMaxThreads = 256;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// A load from device memory through the read-only cache (kGlobal) or a
// plain load (shared memory).
template <bool kGlobal>
__device__ __forceinline__ double ld(const double* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// `p` in a register from here on: the compiler may not fold the offset
// arithmetic that made it back into every load's address (it would rather
// redo a 64-bit multiply-add a load than keep two registers).
__device__ __forceinline__ const double* pinned(const double* p) {
  asm("" : "+l"(p));
  return p;
}

// One row's sweep.  `share` is the row's n_t shares, `iis` (n_t), `slr`
// and `cfg` (n_f) its instance's tables, all in device memory (kGlobal) or
// all in shared memory; 0 <= nte <= n_t and 0 <= nfe <= n_f its live
// counts, so k < nte and j < max(nfe, 1) index every gather.  kRepay is
// the repay_init option.
struct RowResult {
  bool feasible;
  int placed, n_splits, devices_used;
};

template <bool kGlobal, bool kRepay>
__device__ __forceinline__ RowResult sweep_row(const double* share, const double* iis,
                                               const double* slr, const double* cfg, int nte,
                                               int nfe, double resume_cost, double eps) {
  if constexpr (kGlobal) share = pinned(share);
  int j = 0, k = 0, ns = 0, du = 0;
  // The first step's operands: slot 0 of every table exists whatever the
  // counts, so these loads need not wait for them.  From device memory,
  // later operands load when their cursor moves; staged, at the top of
  // each step (a shorter chain).  Either way a step sees what the oracle
  // gathers at (k, j).
  double c = ld<kGlobal>(slr);
  double tcfg = ld<kGlobal>(cfg);
  double ii = ld<kGlobal>(iis);
  double sh = ld<kGlobal>(share);
  double tsd = 0.0;
  bool dead = false;
  while (k < nte) {
    if constexpr (!kGlobal) {
      ii = iis[k];
      tcfg = cfg[j];
      sh = share[k];
    }
    const bool carried = tsd > eps;
    const double extra = carried ? (kRepay ? ii : resume_cost) : 0.0;
    const double rem = sh - tsd;
    const double avail = (c - tcfg) - extra;
    const double gate = (tcfg + ii) + eps;
    const bool can_start = (c > gate) && (avail > eps);
    const bool split = can_start && ((rem - avail) > eps);
    const bool fits = can_start && !split;

    // Any placement (split or full) occupies the current device.
    if (can_start) du = max(du, j + 1);
    // Split: run `avail` here, carry the remainder to the next device.
    ns += split && !carried;
    if (split) tsd = tsd + avail;
    // Fits: consume cfg + extra + remaining share, advance the task.
    const double c_after = avail - rem;
    const bool closure = fits && (c_after <= gate);
    k += fits;
    if (fits) {
      c = c_after;
      tsd = 0.0;
    }
    // Device advance: no-start, split carry, or closure after a fit.  The
    // instance's live device count ends the row, not the padded width.
    if (!can_start || split || closure) {
      ++j;
      if (j >= nfe) {
        dead = k < nte;
        break;
      }
      c = ld<kGlobal>(slr + j);
      if constexpr (kGlobal) tcfg = __ldg(cfg + j);
    }
    if constexpr (kGlobal) {
      if (fits && k < nte) {
        ii = __ldg(iis + k);
        sh = __ldg(share + k);
      }
    }
  }
  return {(k >= nte) && !dead, k, ns, du};
}

// What a launch sweeps: the (B, R, n_t) stack and its tables, (B, n_t)
// and (B, n_f) row-major, counts (B,) or null (then the widths).
struct Stack {
  const double* shares;
  const double* iis;
  const double* t_slr;
  const double* t_cfg;
  const int* n_t_eff;
  const int* n_f_eff;
  long long rows;  // B * R
  long long R;     // rows an instance
  int n_t, n_f;
  double resume_cost;
  // kEps, from the parameters: a float64 instruction cannot hold a double
  // immediate, and the compiler would rebuild the constant every step.
  double eps;
  bool* feasible;
  int* placed;
  int* n_splits;
  int* devices_used;
};

// The launch, sized by the plan.  On the staged path a warp's shared
// memory holds its tile's rows (32 x stride doubles), then the tables and
// counts of the tile's instances.
struct Plan {
  int warps;           // warps a block
  int stride;          // doubles between staged rows
  int span;            // instances a tile may span
  int vec;             // 16 or 8: bytes a share copy
  int buffer_doubles;  // doubles of a warp's shared memory (even)
};

__device__ __forceinline__ void write_row(const Stack& s, long long row, const RowResult& r) {
  s.feasible[row] = r.feasible;
  s.placed[row] = r.placed;
  s.n_splits[row] = r.n_splits;
  s.devices_used[row] = r.devices_used;
}

__device__ __forceinline__ int clamp_count(int count, int width) {
  return min(max(count, 0), width);
}

// A lane's cursor over a tile's share copies: copy e = lane + 32 i moves
// `unit` doubles (vec / 8) from offset unit * e of the tile's contiguous
// shares to (row e / per_row, unit e % per_row) of the staged rows; the
// cursor steps by 32 copies without a division.
struct CopyCursor {
  int row0, col0;  // the lane's first copy: row and unit within it
  int drow, dcol;  // a step of 32 copies
  int per_row;     // copies a row
};

__device__ __forceinline__ CopyCursor copy_cursor(const Stack& s, const Plan& p, int lane) {
  const int per_row = s.n_t / (p.vec / 8);
  return {lane / per_row, lane % per_row, kTile / per_row, kTile % per_row, per_row};
}

// Start the copies of the shares of rows row0 .. row0 + nrows - 1.
__device__ __forceinline__ void stage_shares(const Stack& s, const Plan& p, const CopyCursor& cc,
                                             long long row0, int nrows, double* buf, int lane) {
  const double* src = s.shares + row0 * s.n_t;
  const int copies = nrows * cc.per_row;
  int r = cc.row0, u = cc.col0;
  if (p.vec == 16) {  // n_t even, the tile start 16-byte aligned, stride even
#pragma unroll 1
    for (int e = lane; e < copies; e += kTile) {
      cp_async_16(buf + r * p.stride + 2 * u, src + 2 * e);
      r += cc.drow;
      u += cc.dcol;
      if (u >= cc.per_row) {
        u -= cc.per_row;
        ++r;
      }
    }
  } else {
#pragma unroll 1
    for (int e = lane; e < copies; e += kTile) {
      cp_async_8(buf + r * p.stride + u, src + e);
      r += cc.drow;
      u += cc.dcol;
      if (u >= cc.per_row) {
        u -= cc.per_row;
        ++r;
      }
    }
  }
}

// Start the copies of the tables and counts of instances b0 .. b0 + nspan
// - 1 into `tab` (the warp's buffer past its staged rows).
template <class Instance>
__device__ __forceinline__ void stage_tables(const Stack& s, const Plan& p, long long b0,
                                             int nspan, double* tab, int lane) {
  double* t_slr = tab + p.span * s.n_t;
  double* t_cfg = t_slr + p.span * s.n_f;
#pragma unroll 1
  for (int e = lane; e < nspan * s.n_t; e += kTile) {
    cp_async_8(tab + e, s.iis + b0 * s.n_t + e);
  }
#pragma unroll 1
  for (int e = lane; e < nspan * s.n_f; e += kTile) {
    cp_async_8(t_slr + e, s.t_slr + b0 * s.n_f + e);
    cp_async_8(t_cfg + e, s.t_cfg + b0 * s.n_f + e);
  }
  if constexpr (Instance::kCounted) {
    int* t_cnt = reinterpret_cast<int*>(t_cfg + p.span * s.n_f);
#pragma unroll 1
    for (int e = lane; e < nspan; e += kTile) {
      cp_async_4(t_cnt + e, s.n_t_eff + b0 + e);
      cp_async_4(t_cnt + p.span + e, s.n_f_eff + b0 + e);
    }
  }
}

// Sweep this lane's row of tile `t` (at `pos`): staged, from the warp's
// `buf` (its shares, then its instance's tables past the rows), or
// directly from device memory.
template <bool kStaged, bool kRepay, class Instance>
__device__ __forceinline__ void sweep_lane(const Stack& s, const Plan& p, const Instance& inst,
                                           long long t, const typename Instance::Pos& pos,
                                           const double* buf, int lane) {
  const long long row = t * kTile + lane;
  if (row >= s.rows) return;
  const int lb = inst.within(pos, lane);  // the row's instance among the tile's
  const double *share, *iis, *slr, *cfg;
  int nte = s.n_t, nfe = s.n_f;
  if constexpr (kStaged) {
    const double* tab = buf + kTile * p.stride;
    share = buf + lane * p.stride;
    iis = tab + lb * s.n_t;
    slr = tab + p.span * s.n_t + lb * s.n_f;
    cfg = slr + p.span * s.n_f;
    if constexpr (Instance::kCounted) {
      const int* t_cnt = reinterpret_cast<const int*>(tab + p.span * (s.n_t + 2 * s.n_f));
      nte = clamp_count(t_cnt[lb], s.n_t);
      nfe = clamp_count(t_cnt[p.span + lb], s.n_f);
    }
  } else {
    const long long b = inst.first(pos) + lb;
    share = s.shares + row * s.n_t;
    iis = s.iis + b * s.n_t;
    slr = s.t_slr + b * s.n_f;
    cfg = s.t_cfg + b * s.n_f;
    if constexpr (Instance::kCounted) {
      nte = clamp_count(__ldg(s.n_t_eff + b), s.n_t);
      nfe = clamp_count(__ldg(s.n_f_eff + b), s.n_f);
    }
  }
  write_row(s, row, sweep_row<!kStaged, kRepay>(share, iis, slr, cfg, nte, nfe, s.resume_cost,
                                                   s.eps));
}

// The warp's tile, staged or direct: warp w of block i takes tile
// i * warps + w (the grid covers the stack, one tile a warp).
template <bool kStaged, bool kRepay, class Instance>
__device__ __forceinline__ void sweep_tile(const Stack& s, const Plan& p, const Instance& inst) {
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const long long t = static_cast<long long>(blockIdx.x) * p.warps + warp;
  const long long row0 = t * kTile;
  if (row0 >= s.rows) return;
  const typename Instance::Pos pos = inst.at(row0);
  if constexpr (kStaged) {
    extern __shared__ __align__(16) double smem[];
    double* buf = smem + warp * p.buffer_doubles;
    const int nrows = static_cast<int>(min(static_cast<long long>(kTile), s.rows - row0));
    stage_shares(s, p, copy_cursor(s, p, lane), row0, nrows, buf, lane);
    stage_tables<Instance>(s, p, inst.first(pos), inst.span(pos, nrows), buf + kTile * p.stride,
                           lane);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    sweep_lane<true, kRepay>(s, p, inst, t, pos, buf, lane);
  } else {
    sweep_lane<false, kRepay>(s, p, inst, t, pos, nullptr, lane);
  }
}

// Check a launch's sizes against what the kernel assumes; returns a CUDA
// error code (cudaErrorInvalidValue when they disagree).
inline cudaError_t check_plan(const Plan& p, const double* shares, long long rows, int n_t,
                              int n_f, int grid, int direct, size_t smem) {
  const bool aligned = reinterpret_cast<unsigned long long>(shares) % 16 == 0;
  const long long tables = static_cast<long long>(p.span) * (n_t + 2 * n_f + 1);
  const bool ok =
      rows >= 1 && n_t >= 1 && grid >= 1 && p.warps >= 1 && p.warps * kTile <= kMaxThreads &&
      p.span >= 1 && p.buffer_doubles % 2 == 0 &&
      smem == sizeof(double) * p.warps * static_cast<size_t>(p.buffer_doubles) &&
      (direct ? p.buffer_doubles == 0
              : p.stride >= n_t && p.buffer_doubles >= kTile * p.stride + tables &&
                    (p.vec == 8 || (p.vec == 16 && aligned && n_t % 2 == 0 && p.stride % 2 == 0)));
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace placement_sweep
