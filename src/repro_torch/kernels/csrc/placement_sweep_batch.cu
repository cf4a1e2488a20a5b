// Fleet-parallel Alg-2 placement sweep for Hopper (sm_90a), float64.
//
// Replaces the TPU kernel `_placement_sweep_batch_kernel` behind
// `placement_sweep_batch_pallas` in src/repro/kernels/placement_step.py.
//
// What it computes: the sweep of csrc/placement_sweep.cu over B independent
// instances at once.  `shares` is a (B, R, n_t) stack of the instances'
// blocks, zero-padded to common widths; each instance b has its own task
// table iis[b] (n_t), device tables t_slr[b] / t_cfg[b] (n_f), and live
// counts n_t_eff[b] <= n_t, n_f_eff[b] <= n_f.  Outputs are (B, R):
// feasible, placed tasks, splits, devices used.  Every row of the stack is
// computed, padded rows included, so the outputs can be compared whole with
// the plain version; the caller masks rows past each instance's n_rows.
//
// Exactness: the row loop of placement_sweep.cuh, in the scalar oracle's
// order (avail = (c - tcfg) - extra, gate, split, c_after, closure), built
// with -fmad=false and no fast-math: each instance's verdicts equal a solo
// sweep on its unpadded block and the plain version, bit for bit.  A row
// is live while k < n_t_eff; it dies when its device cursor reaches
// n_f_eff with tasks left.  Counts are clamped to the padded widths, so no
// gather can read outside the tables; an instance with n_f_eff == 0 reads
// the zero pad at slot 0 and its rows with live tasks die at the first
// step.
//
// Design (placement_sweep.cuh): the B x R rows are tiled flattened, not
// instance by instance: a warp takes 32 consecutive rows, which may belong
// to several instances (two at R = 16, 32 at R = 1), so a 64-instance
// round of 16 rows is 32 warps of 32 live rows, one an SM, where the
// earlier kernel ran 64 blocks of 256 threads with 16 live.  A lane's
// instance is row / R; on the staged path the tables and counts of the
// instances a tile spans are staged in shared memory beside its rows, in
// one cp.async group.  Row and table offsets are 64-bit (b R n_t can pass
// 2^31).  The launch's sizes (warps a block, row stride, instances a
// tile, copy width, path, grid) come from sweep_plan
// (kernels/placement_step.py).
//
// Bound on this card: each share is read once (8 n_t bytes a row), the
// tables once per instance, and 13 bytes a row are written; a row does ~12
// float64 operations per step and at most n_t_eff + n_f_eff steps, so at
// the fleet-parallel widths (n_t = 7, n_f = 4) the kernel is bound by
// memory traffic, not by float64 throughput.

#include <cuda_runtime.h>

#include "placement_sweep.cuh"

namespace {

using placement_sweep::Plan;
using placement_sweep::Stack;

// Flattened row `row` belongs to instance row / R.  A tile's position is
// its first row's instance b0 and place in it (into < R < 2^31): one
// 64-bit division a warp.  Lane `lane`'s instance among the tile's is
// (into + lane) / R, with into + lane < R + 32: at R >= 32 a compare,
// below it a float quotient that truncates exactly: (x + 0.5) / R for
// x < 64 lies at least 1 / 64 from an integer, and the correctly rounded
// float quotient errs by under 2^-18.
struct InstanceOfRow {
  static constexpr bool kCounted = true;
  long long R;
  struct Pos {
    long long b0;
    unsigned into;
  };
  __device__ Pos at(long long row0) const {
    const long long b = row0 / R;
    return {b, static_cast<unsigned>(row0 - b * R)};
  }
  __device__ long long first(const Pos& q) const { return q.b0; }
  __device__ int within(const Pos& q, int lane) const {
    const unsigned x = q.into + lane;
    if (R >= placement_sweep::kTile) return x >= R;
    return static_cast<int>(__float2uint_rz((static_cast<float>(x) + 0.5f) /
                                            static_cast<float>(R)));
  }
  // Instances a tile of `nrows` rows spans.
  __device__ int span(const Pos& q, int nrows) const { return within(q, nrows - 1) + 1; }
};

template <bool kStaged, bool kRepay>
__global__ void __launch_bounds__(placement_sweep::kMaxThreads, 4)
    placement_sweep_batch_kernel(Stack s, Plan p) {
  placement_sweep::sweep_tile<kStaged, kRepay>(s, p, InstanceOfRow{s.R});
}

template <bool kStaged, bool kRepay>
cudaError_t launch(const Stack& s, const Plan& p, int grid, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(placement_sweep_batch_kernel<kStaged, kRepay>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  placement_sweep_batch_kernel<kStaged, kRepay><<<grid, p.warps * placement_sweep::kTile, smem, st>>>(s, p);
  return cudaGetLastError();
}

}  // namespace

// Launches the sweep on `stream` at the plan's sizes (sweep_plan) and
// returns cudaGetLastError() as an int (0 on success).  B >= 1, R >= 1,
// n_t >= 1 and n_f >= 1 are the caller's checks.
extern "C" int placement_sweep_batch_f64(
    const double* shares, const double* iis, const double* t_slr,
    const double* t_cfg, const int* n_t_eff, const int* n_f_eff,
    double resume_cost, int repay_init, int B, int R, int n_t, int n_f,
    bool* feasible, int* placed, int* n_splits, int* devices_used, int grid,
    int warps, int stride, int span, int vec, int buffer_doubles, int direct,
    long long smem, void* stream) {
  const long long n = static_cast<long long>(B) * R;
  const Stack s{shares, iis, t_slr, t_cfg, n_t_eff, n_f_eff, n, R, n_t, n_f, resume_cost,
                placement_sweep::kEps, feasible, placed, n_splits, devices_used};
  const Plan p{warps, stride, span, vec, buffer_doubles};
  cudaError_t e =
      placement_sweep::check_plan(p, shares, n, n_t, n_f, grid, direct,
                                  static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  if (direct) {
    e = repay_init ? launch<false, true>(s, p, grid, 0, st) : launch<false, false>(s, p, grid, 0, st);
  } else {
    e = repay_init ? launch<true, true>(s, p, grid, bytes, st)
                   : launch<true, false>(s, p, grid, bytes, st);
  }
  return static_cast<int>(e);
}

extern "C" const char* placement_sweep_batch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
