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
// Exactness: the verdicts must be bit-identical to the scalar oracle at
// float64, so the chain below replays its operations in the same order:
//   avail     = (c - tcfg) - extra
//   can_start = (c > (tcfg + ii) + EPS) && (avail > EPS)
//   split     = (rem - avail) > EPS
//   c_after   = avail - rem
//   closure   = c_after <= (tcfg + ii) + EPS
// There is no multiply to contract, and the build passes -fmad=false and
// no fast-math, so nothing reassociates or fuses.  The TPU had no float64
// and lowered this kernel at float32; the H100 does float64 in hardware.
//
// Design: one thread per row, 256 threads a block.  The Pallas kernel's
// one-hot masked-sum gathers were a TPU lowering device; here the
// per-task and per-device tables (n_t + 2 n_f doubles) sit in dynamic
// shared memory and every gather is a plain indexed load.  Each thread
// loops while its row is live; every live step advances j or k, so a row
// takes at most n_t + n_f steps, where the reference's fixed loop ends.
//
// Bound on this card: each share is read once (8 n_t bytes a row) and 13
// bytes a row are written; a row does ~12 float64 operations per step and
// at most n_t + n_f steps, so at the main path's widths the kernel is
// bound by memory traffic, not by float64 throughput.

#include <cuda_runtime.h>

namespace {

constexpr double kEps = 1e-9;  // == repro_torch.core.placement._EPS
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) placement_sweep_kernel(
    const double* __restrict__ shares,  // (B, n_t) row-major
    const double* __restrict__ iis,     // (n_t,)
    const double* __restrict__ t_slr,   // (n_f,)
    const double* __restrict__ t_cfg,   // (n_f,)
    double resume_cost, int repay_init, long long B, int n_t, int n_f,
    bool* __restrict__ feasible, int* __restrict__ placed,
    int* __restrict__ n_splits, int* __restrict__ devices_used) {
  extern __shared__ double tables[];
  double* s_iis = tables;
  double* s_slr = tables + n_t;
  double* s_cfg = s_slr + n_f;
  for (int i = threadIdx.x; i < n_t; i += blockDim.x) s_iis[i] = iis[i];
  for (int i = threadIdx.x; i < n_f; i += blockDim.x) {
    s_slr[i] = t_slr[i];
    s_cfg[i] = t_cfg[i];
  }
  __syncthreads();

  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const double* r = shares + row * n_t;

  int j = 0, k = 0, ns = 0, du = 0;
  double c = s_slr[0];
  double tsd = 0.0;
  bool dead = false;
  while (!dead && k < n_t) {
    const double ii = s_iis[k];
    const double tcfg = s_cfg[j];
    const bool carried = tsd > kEps;
    const double extra = carried ? (repay_init ? ii : resume_cost) : 0.0;
    const double rem = __ldg(r + k) - tsd;
    const double avail = (c - tcfg) - extra;
    const double gate = (tcfg + ii) + kEps;
    const bool can_start = (c > gate) && (avail > kEps);
    const bool split = can_start && ((rem - avail) > kEps);
    const bool fits = can_start && !split;

    // Any placement (split or full) occupies the current device.
    if (can_start && du < j + 1) du = j + 1;
    // Split: run `avail` here, carry the remainder to the next device.
    if (split) {
      tsd = tsd + avail;
      if (!carried) ++ns;
    }
    // Fits: consume cfg + extra + remaining share, advance the task.
    const double c_after = avail - rem;
    const bool closure = fits && (c_after <= gate);
    if (fits) {
      c = c_after;
      ++k;
      tsd = 0.0;
    }
    // Device advance: no-start, split carry, or closure after a fit.
    if (!can_start || split || closure) {
      ++j;
      if (j >= n_f) {
        dead = k < n_t;
        break;
      }
      c = s_slr[j];
    }
  }
  feasible[row] = (k >= n_t) && !dead;
  placed[row] = k;
  n_splits[row] = ns;
  devices_used[row] = du;
}

}  // namespace

// Launches the sweep on `stream` and returns cudaGetLastError() as an int
// (0 on success).  B >= 1, n_t >= 1 and n_f >= 1 are the caller's checks.
extern "C" int placement_sweep_f64(
    const double* shares, const double* iis, const double* t_slr,
    const double* t_cfg, double resume_cost, int repay_init, long long B,
    int n_t, int n_f, bool* feasible, int* placed, int* n_splits,
    int* devices_used, void* stream) {
  const size_t smem = sizeof(double) * (static_cast<size_t>(n_t) + 2 * static_cast<size_t>(n_f));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        placement_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  placement_sweep_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      shares, iis, t_slr, t_cfg, resume_cost, repay_init, B, n_t, n_f,
      feasible, placed, n_splits, devices_used);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* placement_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
