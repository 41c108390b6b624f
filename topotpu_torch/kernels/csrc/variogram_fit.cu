// Batched exponential-variogram fit, every fit of a batch in one launch.
//
//   variogram_fit_launch: for each of B binned empirical variograms (gamma, h, npairs: (B,
//   n_bins); cutoff: (B,)) the weighted least-squares fit of nugget + psill (1 - exp(-h / range))
//   with gstat's fit.method = 7 weights, by n_iters damped Gauss-Newton steps -> nugget, psill,
//   range, the weighted SSE and ok, each (B,).
//
// Replaces no TPU kernel: the JAX package leaves topotpu/stats/variogram.py::fit_exp_variogram to
// XLA, which compiles its loop whole. The port's plain version of it
// (topotpu_torch/kernels/variogram_fit.py::fit_exp_variogram_ref) runs each step as ~170 torch
// operations, ~110 of them kernel launches of a few microseconds each, so the station stage's 12
// months of 50 steps made ~65,000 launches a pass and its time was the host's. This kernel is
// the whole function in one launch: the weights, ok, the initial values and every step.
//
// Arithmetic: the plain version's, in float32, in the same order within each bin and each fit.
//   - w_j = N_j / max(h_j, 1e-3)^2 on the non-empty bins (N_j > 0), 0 elsewhere, over their sum
//     + 1e-30; ok = (number of non-empty bins) >= min_bins.
//   - Initial values: the nugget half the first non-empty bin's gamma (bin 0's where none is),
//     at most 0.9 of the sill; the sill the mean gamma of the non-empty bins from
//     int(n_bins * 0.5) on (of all non-empty bins where none is there), at least 1e-8; the psill
//     the rest, at least 1e-8; the range cutoff / 3, at least 1e-2; the range's box [1e-2,
//     max(10 x the widest non-empty bin's h, 1)].
//   - A step: J = (1, 1 - e, -(psill h / rg^2) e) with e = exp(-h / rg), rg = max(range, 1e-6);
//     r = gamma - model on the non-empty bins, 0 elsewhere; A = J^T W J, g = J^T W r; the
//     diagonal plus damping x trace(A) / 3 + 1e-30; the 3 x 3 solve by the adjugate, the
//     determinant replaced by 1e-30 where |det| <= 1e-30; the trial point clamped to nugget
//     >= 0, psill >= 1e-8 and the range's box; taken only if its SSE is strictly lower, the
//     damping then halved, else doubled, within [1e-8, 1e8]. Every fit runs all n_iters steps.
//   - Clamps and minima keep a NaN, as torch's do. expf and division are IEEE (no fast-math).
//     nvcc contracts a product and a sum into one FMA, as the cuBLAS GEMMs that build the plain
//     version's A and g do; sums over bins are taken in another order (a shuffle tree), and
//     x / 3 is a true division (torch on CUDA multiplies by 1 / 3), so the result agrees with
//     the plain version to rounding, not bit for bit; a step accepted or rejected on near-equal
//     SSEs can then end a fit elsewhere in a flat valley of the SSE.
//
// Design.
//   - A half-warp a fit (LANES = 16), FITS = 8 fits a block of 128 threads: 1,250 blocks at
//     10,000 fits, all resident at once on 132 SMs. The block stages its fits' bins in shared
//     memory once, as (gamma, h, w, non-empty) float4s; lane l takes bins l, l + 16, ..., so
//     any n_bins works up to the shared memory (FITS x n_bins x 16 bytes <= 227 KB: n_bins <=
//     1,816). The inputs are read once and the five outputs written once.
//   - A step: each lane computes its bins' exp, model, residual and Jacobian row and sums its
//     share of A's six distinct entries and g's three; xor-shuffle trees over the 16 lanes give
//     every lane the same sums, bit for bit (each level adds the same two numbers in both
//     lanes), so every lane solves the system itself and takes the same decision, with no
//     broadcast; one more tree sums the trial SSE. Parameters, SSE and damping stay in
//     registers through all the steps.
//   - A half-warp past the batch's last fit leaves after the staging; the shuffles name only
//     the lanes of their own half-warp.
//
// What bounds it on an H100: at 10,000 fits x 15 bins x 50 steps the bytes are ~1.8 MB read and
// 0.17 MB written (~0.6 us at 3.35 TB/s) and the operations ~0.36 GFLOP (~5.3 us at 67 TFLOP/s;
// chip_smoke.py's vfit_flops). Neither is the limit: the 50 steps are dependent, each a chain of
// two exp-and-divide passes, ten four-level shuffle trees and a 3 x 3 solve with three
// divisions, so a launch takes the latency of that chain times 50, tens of microseconds,
// whatever B up to one wave (132 SMs x 16 blocks x 8 fits = 16,896 fits).
//
// C interface: launches on the given stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for B < 0, n_bins < 1, n_iters < 0 or n_bins past the shared memory;
// B = 0 launches nothing. All arrays are row-major and contiguous: gamma, h, npairs (B, n_bins)
// float32, cutoff (B,) float32; outputs nugget, psill, rng, sse (B,) float32, ok (B,) bool.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int LANES = 16;  // a half-warp a fit
constexpr int FITS = 8;    // fits a block
constexpr int THREADS = LANES * FITS;
constexpr int MAX_SMEM = 227 * 1024;

// torch.maximum / torch.minimum (and so torch.clamp): a NaN in either operand gives NaN
__device__ __forceinline__ float tmax(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float tmin(float a, float b) { return (a != a || a < b) ? a : b; }

// Sum, minimum or maximum over the 16 lanes of the caller's half-warp, the same in every lane.
__device__ __forceinline__ float lane_sum(unsigned half, float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o /= 2) v += __shfl_xor_sync(half, v, o, LANES);
  return v;
}

__device__ __forceinline__ int lane_sum(unsigned half, int v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o /= 2) v += __shfl_xor_sync(half, v, o, LANES);
  return v;
}

__device__ __forceinline__ int lane_min(unsigned half, int v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o /= 2) v = min(v, __shfl_xor_sync(half, v, o, LANES));
  return v;
}

__device__ __forceinline__ float lane_max(unsigned half, float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o /= 2) v = tmax(v, __shfl_xor_sync(half, v, o, LANES));
  return v;
}

// This lane's share of the weighted SSE at (nug, ps, rg).
__device__ __forceinline__ float sse_part(const float4* bins, int n_bins, int lane, float nug,
                                          float ps, float rg) {
  const float rgc = tmax(rg, 1e-6f);
  float s = 0.0f;
  for (int j = lane; j < n_bins; j += LANES) {
    const float4 b = bins[j];  // (gamma, h, w, non-empty)
    const float e = expf(-b.y / rgc);
    const float r = b.w != 0.0f ? b.x - (nug + ps * (1.0f - e)) : 0.0f;
    s += b.z * r * r;
  }
  return s;
}

__global__ void __launch_bounds__(THREADS) variogram_fit_kernel(
    const float* __restrict__ gamma, const float* __restrict__ h,
    const float* __restrict__ npairs, const float* __restrict__ cutoff,
    float* __restrict__ nugget, float* __restrict__ psill, float* __restrict__ rng,
    float* __restrict__ sse_out, unsigned char* __restrict__ ok_out, int B, int n_bins,
    int n_iters, int min_bins) {
  extern __shared__ float4 smem[];  // [FITS][n_bins] (gamma, h, w, non-empty)
  const int f0 = blockIdx.x * FITS;
  const int nf = min(FITS, B - f0);
  // stage the block's fits, w not yet normalised
  for (int e = threadIdx.x; e < nf * n_bins; e += THREADS) {
    const size_t at = (size_t)f0 * n_bins + e;
    const float hh = h[at], n = npairs[at];
    const float hc = tmax(hh, 1e-3f);
    const bool full = n > 0.0f;
    smem[e] = make_float4(gamma[at], hh, full ? n / (hc * hc) : 0.0f, full ? 1.0f : 0.0f);
  }
  __syncthreads();
  const int fl = threadIdx.x / LANES;
  if (fl >= nf) return;
  const int lane = threadIdx.x % LANES;
  const unsigned half = 0xffffu << (threadIdx.x & 16);  // this half-warp's lanes
  const int fit = f0 + fl;
  float4* bins = smem + fl * n_bins;

  // weights, ok and the initial values
  const int tail0 = n_bins / 2;  // int(n_bins * 0.5)
  float wsum = 0.0f, tail_s = 0.0f, all_s = 0.0f, hmax = -INFINITY;
  int n_full = 0, tail_c = 0, first = n_bins;
  for (int j = lane; j < n_bins; j += LANES) {
    const float4 b = bins[j];
    const bool full = b.w != 0.0f;
    wsum += b.z;
    hmax = tmax(hmax, full ? b.y : 0.0f);
    if (full) {
      ++n_full;
      all_s += b.x;
      first = min(first, j);
      if (j >= tail0) {
        ++tail_c;
        tail_s += b.x;
      }
    }
  }
  const float wnorm = lane_sum(half, wsum) + 1e-30f;
  for (int j = lane; j < n_bins; j += LANES) bins[j].z = bins[j].z / wnorm;
  n_full = lane_sum(half, n_full);
  tail_c = lane_sum(half, tail_c);
  tail_s = lane_sum(half, tail_s);
  all_s = lane_sum(half, all_s);
  hmax = lane_max(half, hmax);
  first = lane_min(half, first);

  const float first_g = bins[first < n_bins ? first : 0].x;
  const float tail = tail_c > 0 ? tail_s / (float)max(tail_c, 1) : all_s / (float)max(n_full, 1);
  const float sill0 = tmax(tail, 1e-8f);
  float nug = tmin(tmax(first_g * 0.5f, 0.0f), 0.9f * sill0);
  float ps = tmax(sill0 - nug, 1e-8f);
  float rg = tmax(cutoff[fit] / 3.0f, 1e-2f);
  const float rg_hi = tmax(hmax * 10.0f, 1.0f);
  const float rg_lo = 1e-2f;
  float sse = lane_sum(half, sse_part(bins, n_bins, lane, nug, ps, rg));
  float lam = 1e-3f;

  for (int it = 0; it < n_iters; ++it) {
    const float rgc = tmax(rg, 1e-6f);
    const float rgc2 = rgc * rgc;
    float a00 = 0.0f, a01 = 0.0f, a02 = 0.0f, a11 = 0.0f, a12 = 0.0f, a22 = 0.0f;
    float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
    for (int j = lane; j < n_bins; j += LANES) {
      const float4 b = bins[j];
      const float e = expf(-b.y / rgc);
      const float j1 = 1.0f - e;
      const float j2 = -(ps * b.y / rgc2) * e;
      const float r = b.w != 0.0f ? b.x - (nug + ps * j1) : 0.0f;
      const float w1 = j1 * b.z, w2 = j2 * b.z;  // the row of J W; its first entry is w
      a00 += b.z;
      a01 += b.z * j1;
      a02 += b.z * j2;
      a11 += w1 * j1;
      a12 += w1 * j2;
      a22 += w2 * j2;
      g0 += b.z * r;
      g1 += w1 * r;
      g2 += w2 * r;
    }
    a00 = lane_sum(half, a00);
    a01 = lane_sum(half, a01);
    a02 = lane_sum(half, a02);
    a11 = lane_sum(half, a11);
    a12 = lane_sum(half, a12);
    a22 = lane_sum(half, a22);
    g0 = lane_sum(half, g0);
    g1 = lane_sum(half, g1);
    g2 = lane_sum(half, g2);
    const float damp = lam * ((a00 + a11 + a22) / 3.0f) + 1e-30f;
    a00 = a00 + damp;
    a11 = a11 + damp;
    a22 = a22 + damp;
    // the adjugate of the symmetric A (a10 = a01, a20 = a02, a21 = a12), as the plain _solve3
    const float c00 = a11 * a22 - a12 * a12;
    const float c01 = a02 * a12 - a01 * a22;
    const float c02 = a01 * a12 - a02 * a11;
    const float c10 = a12 * a02 - a01 * a22;
    const float c11 = a00 * a22 - a02 * a02;
    const float c12 = a02 * a01 - a00 * a12;
    const float c20 = a01 * a12 - a11 * a02;
    const float c21 = a01 * a02 - a00 * a12;
    const float c22 = a00 * a11 - a01 * a01;
    float det = a00 * c00 + a01 * c10 + a02 * c20;
    det = fabsf(det) > 1e-30f ? det : 1e-30f;
    const float d0 = (c00 * g0 + c01 * g1 + c02 * g2) / det;
    const float d1 = (c10 * g0 + c11 * g1 + c12 * g2) / det;
    const float d2 = (c20 * g0 + c21 * g1 + c22 * g2) / det;
    const float nug_n = tmax(nug + d0, 0.0f);
    const float ps_n = tmax(ps + d1, 1e-8f);
    const float rg_n = tmin(tmax(rg + d2, rg_lo), rg_hi);
    const float sse_n = lane_sum(half, sse_part(bins, n_bins, lane, nug_n, ps_n, rg_n));
    const bool better = sse_n < sse;
    if (better) {
      nug = nug_n;
      ps = ps_n;
      rg = rg_n;
      sse = sse_n;
    }
    lam = tmin(tmax(better ? lam * 0.5f : lam * 2.0f, 1e-8f), 1e8f);
  }
  if (lane == 0) {
    nugget[fit] = nug;
    psill[fit] = ps;
    rng[fit] = rg;
    sse_out[fit] = sse;
    ok_out[fit] = n_full >= min_bins ? 1 : 0;
  }
}

}  // namespace

extern "C" int variogram_fit_launch(const void* gamma, const void* h, const void* npairs,
                                    const void* cutoff, void* nugget, void* psill, void* rng,
                                    void* sse, void* ok, int B, int n_bins, int n_iters,
                                    int min_bins, void* stream) {
  const size_t smem = (size_t)FITS * n_bins * sizeof(float4);
  if (B < 0 || n_bins < 1 || n_iters < 0 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        variogram_fit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  variogram_fit_kernel<<<(B + FITS - 1) / FITS, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gamma), static_cast<const float*>(h),
      static_cast<const float*>(npairs), static_cast<const float*>(cutoff),
      static_cast<float*>(nugget), static_cast<float*>(psill), static_cast<float*>(rng),
      static_cast<float*>(sse), static_cast<unsigned char*>(ok), B, n_bins, n_iters, min_bins);
  return (int)cudaGetLastError();
}
