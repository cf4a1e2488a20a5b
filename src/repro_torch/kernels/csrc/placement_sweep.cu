// Alg-2 TFS-block placement sweep for Hopper (sm_90a), float64.
//
// Replaces the TPU kernel `_placement_sweep_kernel` behind
// `placement_sweep_pallas` in src/repro/kernels/placement_step.py.
//
// What it computes: for every row of a (B, n_t) float64 shares block, the
// PADPS-FR carry/split placement simulation over the fleet's per-device
// capacities t_slr and reconfiguration costs t_cfg.  Per-row state is the
// device cursor j, task cursor k, remaining capacity c, carried share tsd,
// a dead flag, the split count and the device span.  Outputs: feasible,
// placed tasks, splits, devices used.
//
// Exactness: verdicts are bit-identical to the plain version, the scalar
// oracle and the JAX package's numpy engine.  The row loop lives in
// placement_sweep.cuh, which replays the oracle's float64 operations in
// its order (avail = (c - tcfg) - extra, gate, split, c_after, closure);
// this source builds with -fmad=false and no fast-math.  The TPU had no
// float64 and lowered this kernel at float32; the H100 does float64 in
// hardware.
//
// Design: the fleet-parallel kernel's tiles (placement_sweep.cuh) over a
// stack of one instance whose live counts are its widths: every row's
// instance is 0 and there are no count arrays.  A warp takes 32
// consecutive rows; a launch the card holds at once stages each warp's
// rows in shared memory by cp.async (coalesced, 16-byte copies where the
// block is 16-byte aligned and n_t even) and sweeps them there, a larger
// one reads device memory directly; the launch's sizes come from
// sweep_plan (kernels/placement_step.py).  The Pallas kernel's one-hot
// masked-sum gathers were a TPU lowering device; here every gather is an
// indexed load.
//
// Bound on this card: each share is read once (8 n_t bytes a row) and 13
// bytes a row are written; a row does ~12 float64 operations a step and at
// most n_t + n_f steps, so at the main path's widths the kernel is bound
// by memory traffic, not by float64 throughput.

#include <cuda_runtime.h>

#include "placement_sweep.cuh"

namespace {

using placement_sweep::Plan;
using placement_sweep::Stack;

// Kernel 1 has one instance: every row belongs to instance 0, whose live
// counts are the widths.
struct OneInstance {
  static constexpr bool kCounted = false;
  struct Pos {};
  __device__ Pos at(long long) const { return {}; }
  __device__ long long first(const Pos&) const { return 0; }
  __device__ int span(const Pos&, int) const { return 1; }
  __device__ int within(const Pos&, int) const { return 0; }
};

template <bool kStaged, bool kRepay>
__global__ void __launch_bounds__(placement_sweep::kMaxThreads, 4)
    placement_sweep_kernel(Stack s, Plan p) {
  placement_sweep::sweep_tile<kStaged, kRepay>(s, p, OneInstance{});
}

template <bool kStaged, bool kRepay>
cudaError_t launch(const Stack& s, const Plan& p, int grid, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(placement_sweep_kernel<kStaged, kRepay>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  placement_sweep_kernel<kStaged, kRepay><<<grid, p.warps * placement_sweep::kTile, smem, st>>>(s, p);
  return cudaGetLastError();
}

}  // namespace

// Launches the sweep on `stream` at the plan's sizes (sweep_plan) and
// returns cudaGetLastError() as an int (0 on success).  B >= 1, n_t >= 1
// and n_f >= 1 are the caller's checks.
extern "C" int placement_sweep_f64(
    const double* shares, const double* iis, const double* t_slr,
    const double* t_cfg, double resume_cost, int repay_init, long long B,
    int n_t, int n_f, bool* feasible, int* placed, int* n_splits,
    int* devices_used, int grid, int warps, int stride, int span, int vec,
    int buffer_doubles, int direct, long long smem, void* stream) {
  const Stack s{shares, iis, t_slr, t_cfg, nullptr, nullptr, B, B, n_t, n_f, resume_cost,
                placement_sweep::kEps, feasible, placed, n_splits, devices_used};
  const Plan p{warps, stride, span, vec, buffer_doubles};
  cudaError_t e =
      placement_sweep::check_plan(p, shares, B, n_t, n_f, grid, direct,
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

extern "C" const char* placement_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
