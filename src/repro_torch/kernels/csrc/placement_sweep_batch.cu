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
// Exactness: the chain is kernel 1's, in the scalar oracle's order:
//   avail     = (c - tcfg) - extra
//   can_start = (c > (tcfg + ii) + EPS) && (avail > EPS)
//   split     = (rem - avail) > EPS
//   c_after   = avail - rem
//   closure   = c_after <= (tcfg + ii) + EPS
// built with -fmad=false and no fast-math.  The only change is that the
// static widths become the instance's live counts: a row is live while
// k < n_t_eff; it dies when its device cursor reaches n_f_eff with tasks
// left; it refills capacity only while j < n_f_eff.  So padded task columns
// and device slots never enter a live decision, and each instance's
// verdicts equal a solo sweep on its unpadded block, bit for bit.  Gathers
// clamp to the padded widths, as the reference does, so no count can read
// outside the tables; an instance with n_f_eff == 0 reads the zero pad at
// slot 0 and its rows with live tasks die at the first step.
//
// Design: one thread per row, 256 threads a block, and each block holds
// row tile t of instance b.  The grid is one-dimensional over B x
// ceil(R / 256) tiles (blockIdx.x = b * tiles + t) rather than
// (tiles, B), because a grid's y extent stops at 65535 instances.  A block
// loads only its instance's tables (n_t + 2 n_f doubles) into dynamic
// shared memory; every gather is then an indexed load.  The Pallas
// kernel's one-hot masked sums were a TPU lowering device and are gone.
//
// Bound on this card: each share is read once (8 n_t bytes a row), the
// tables once per instance, and 13 bytes a row are written; a row does ~12
// float64 operations per step and at most n_t_eff + n_f_eff steps, so at
// the fleet-parallel widths (n_t = 7, n_f = 4) the kernel is bound by
// memory traffic, not by float64 throughput.

#include <cuda_runtime.h>

namespace {

constexpr double kEps = 1e-9;  // == repro_torch.core.placement._EPS
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) placement_sweep_batch_kernel(
    const double* __restrict__ shares,  // (B, R, n_t) row-major
    const double* __restrict__ iis,     // (B, n_t)
    const double* __restrict__ t_slr,   // (B, n_f)
    const double* __restrict__ t_cfg,   // (B, n_f)
    const int* __restrict__ n_t_eff,    // (B,)
    const int* __restrict__ n_f_eff,    // (B,)
    double resume_cost, int repay_init, int R, int tiles, int n_t, int n_f,
    bool* __restrict__ feasible, int* __restrict__ placed,
    int* __restrict__ n_splits, int* __restrict__ devices_used) {
  extern __shared__ double tables[];
  double* s_iis = tables;
  double* s_slr = tables + n_t;
  double* s_cfg = s_slr + n_f;
  const long long b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  for (int i = threadIdx.x; i < n_t; i += blockDim.x) s_iis[i] = iis[b * n_t + i];
  for (int i = threadIdx.x; i < n_f; i += blockDim.x) {
    s_slr[i] = t_slr[b * n_f + i];
    s_cfg[i] = t_cfg[b * n_f + i];
  }
  __syncthreads();

  const int row = tile * kThreads + threadIdx.x;
  if (row >= R) return;
  const int nte = n_t_eff[b];
  const int nfe = n_f_eff[b];
  const long long out = b * R + row;
  const double* r = shares + out * n_t;

  int j = 0, k = 0, ns = 0, du = 0;
  double c = s_slr[0];
  double tsd = 0.0;
  bool dead = false;
  while (!dead && k < nte) {
    const int kk = min(k, n_t - 1);
    const int jj = min(j, n_f - 1);
    const double ii = s_iis[kk];
    const double tcfg = s_cfg[jj];
    const bool carried = tsd > kEps;
    const double extra = carried ? (repay_init ? ii : resume_cost) : 0.0;
    const double rem = __ldg(r + kk) - tsd;
    const double avail = (c - tcfg) - extra;
    const double gate = (tcfg + ii) + kEps;
    const bool can_start = (c > gate) && (avail > kEps);
    const bool split = can_start && ((rem - avail) > kEps);
    const bool fits = can_start && !split;

    // Any placement (split or full) occupies the current device.
    if (can_start && du < jj + 1) du = jj + 1;
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
    // Device advance: no-start, split carry, or closure after a fit.  The
    // instance's live device count ends the row, not the padded width.
    if (!can_start || split || closure) {
      ++j;
      if (j >= nfe) {
        dead = k < nte;
        break;
      }
      c = s_slr[min(j, n_f - 1)];
    }
  }
  feasible[out] = (k >= nte) && !dead;
  placed[out] = k;
  n_splits[out] = ns;
  devices_used[out] = du;
}

}  // namespace

// Launches the sweep on `stream` and returns cudaGetLastError() as an int
// (0 on success).  B >= 1, R >= 1, n_t >= 1 and n_f >= 1 are the caller's
// checks.
extern "C" int placement_sweep_batch_f64(
    const double* shares, const double* iis, const double* t_slr,
    const double* t_cfg, const int* n_t_eff, const int* n_f_eff,
    double resume_cost, int repay_init, int B, int R, int n_t, int n_f,
    bool* feasible, int* placed, int* n_splits, int* devices_used,
    void* stream) {
  const size_t smem = sizeof(double) * (static_cast<size_t>(n_t) + 2 * static_cast<size_t>(n_f));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        placement_sweep_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = (R + kThreads - 1) / kThreads;
  const long long grid = static_cast<long long>(B) * tiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  placement_sweep_batch_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      shares, iis, t_slr, t_cfg, n_t_eff, n_f_eff, resume_cost, repay_init, R,
      tiles, n_t, n_f, feasible, placed, n_splits, devices_used);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* placement_sweep_batch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
