// Regression-kriging normals + anomaly-GWR gain rows, one warp per cell.
//
// Replaces: topotpu/kernels/pallas_krig.py::krig_normals_fused (body
// _normals_kernel). Same inputs, same (8 + k, B) output rows:
//   [normal, variance, ok, trend, nugget, psill, range, 0], then k gain rows.
// Per cell it runs the chain of topotpu/interp/normals.py::krig_normals:
// adaptive distance weights -> point-centred, weighted-std-scaled design ->
// (q+1)^2 WLS trend with a trace-scaled ridge -> residuals -> distance-weighted
// nugget/psill/range -> pair distances from unit-sphere xyz (exact asinf) ->
// exponential covariance (masked rows folded to identity, plus jitter) ->
// Cholesky and two triangular solves (c0 and ones) -> SK->OK reduction ->
// normal = trend + lambda . resid; then the gain row w * (X_a A_a^-1 e0).
//
// What bounds it on an H100: not device memory (about 13k + 16 floats read
// and 8 + k written per cell) but the dependent chain of the k-step
// factorisation and the 2k solve steps, each a shared-memory read, a shuffle
// and a few FMAs: latency. The design hides latency with many independent
// cells in flight: one warp owns one cell's k x k system in shared memory
// (row stride k + 1, so the 32 lanes hit 32 banks), lanes own rows (two rows
// per lane above k = 32), reductions over the neighbourhood are warp
// shuffles, and the tiny p x p WLS systems are solved by lane 0 in shared
// memory. Blocks hold as many warps as fit in 48 KB of shared memory (8 at
// k <= 32, 2 at k = 64). Exact fp32 throughout: no tensor cores, no TF32, no
// fast-math intrinsics.
//
// The covariance assembly, the factorisation with its two solves and the
// masked OK sums are the shared core in krig_core.cuh, which ok_solve.cu
// calls too.
//
// C interface: krig_normals_launch(...) launches on the given stream and
// returns cudaGetLastError(). Inputs are (rows, B) row-major float32, with the
// cell index contiguous: xyz3k (3k), dist (k), mask (k, 0/1), covs (q k),
// cell (8: trend rows 0..q-1, anomaly rows q..q+qa-1), norm (k), vario (3k),
// acovs (qa k). 1 <= k <= 64, q + qa <= 8.

#include <cuda_runtime.h>
#include <math.h>

#include "krig_core.cuh"

namespace {

using krig::warp_max;
using krig::warp_sum;

constexpr int MAXP = 8;  // largest (covariates + intercept) of a WLS design

// In-place Cholesky solve of a p x p SPD system held in shared memory (lower
// triangle of A, row stride MAXP); b is overwritten with x. One thread.
__device__ void solve_spd_small(float* A, float* b, int p) {
  for (int i = 0; i < p; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = A[i * MAXP + j];
      for (int t = 0; t < j; ++t) s -= A[i * MAXP + t] * A[j * MAXP + t];
      A[i * MAXP + j] = (i == j) ? sqrtf(fmaxf(s, 1e-20f)) : s / A[j * MAXP + j];
    }
  }
  for (int i = 0; i < p; ++i) {
    float s = b[i];
    for (int t = 0; t < i; ++t) s -= A[i * MAXP + t] * b[t];
    b[i] = s / A[i * MAXP + i];
  }
  for (int i = p - 1; i >= 0; --i) {
    float s = b[i];
    for (int t = i + 1; t < p; ++t) s -= A[t * MAXP + i] * b[t];
    b[i] = s / A[i * MAXP + i];
  }
}

// Centred, weighted-std-scaled design: X[0] = 1, X[i] = (cov_i - cell_i) /
// (weighted std + 1e-6) for the nq covariate rows of cov (rows i*k + slot).
template <int R>
__device__ __forceinline__ void design(
    const float* __restrict__ cov, const float* __restrict__ cell, int nq,
    int k, int B, int c, int lane, const float (&w)[R], float wsum,
    float (&X)[MAXP][R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) X[0][r] = 1.0f;
#pragma unroll
  for (int i = 1; i < MAXP; ++i) {
    if (i <= nq) {
      const float cv = cell[(i - 1) * B + c];
      float dc[R];
      float sw = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = lane + 32 * r;
        dc[r] = s < k ? cov[((i - 1) * k + s) * B + c] - cv : 0.0f;
        sw += w[r] * dc[r];
      }
      const float mean = warp_sum(sw) / wsum;
      float sv = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float e = dc[r] - mean;
        sv += w[r] * e * e;
      }
      const float scale = sqrtf(warp_sum(sv) / wsum) + 1e-6f;
#pragma unroll
      for (int r = 0; r < R; ++r) X[i][r] = dc[r] / scale;
    }
  }
}

// Lane 0 writes A = X^T W X + (ridge * mean diag + 1e-30) I into sA.
template <int R>
__device__ __forceinline__ void normal_eq(
    const float (&X)[MAXP][R], const float (&w)[R], int p, float ridge,
    float* sA, int lane) {
  float diag = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      if (i < p) {
        float a = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) a += w[r] * X[i][r] * X[j][r];
        a = warp_sum(a);
        if (lane == 0) sA[i * MAXP + j] = a;
        if (i == j) diag += a;
      }
    }
  }
  const float reg = ridge * (diag / p) + 1e-30f;
  if (lane == 0)
    for (int i = 0; i < p; ++i) sA[i * MAXP + i] += reg;
}

__host__ __device__ constexpr int floats_per_warp(int k) {
  return k * (k + 1) + 4 * k + MAXP * MAXP + MAXP;
}

template <int R, int WK>
__global__ void __launch_bounds__(256) krig_normals_kernel(
    const float* __restrict__ xyz3k, const float* __restrict__ dist,
    const float* __restrict__ mask, const float* __restrict__ covs,
    const float* __restrict__ cell, const float* __restrict__ norm,
    const float* __restrict__ vario, const float* __restrict__ acovs,
    float* __restrict__ out, int B, int k, int q, int qa, float ridge,
    float jitter_frac, int min_neighbors) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= B) return;  // whole warps only: no block-level barrier follows

  const int LD = k + 1;
  float* sC = smem + warp * floats_per_warp(k);  // k x k, row stride k + 1
  float* sx = sC + k * LD;
  float* sy = sx + k;
  float* sz = sy + k;
  float* sm = sz + k;
  float* sA = sm + k;          // MAXP x MAXP small system
  float* sb = sA + MAXP * MAXP;  // its right-hand side / solution

  // ---- 1. adaptive-bandwidth distance weights --------------------------
  float m[R], d[R], w[R];
  float dmax = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane + 32 * r;
    m[r] = s < k ? mask[s * B + c] : 0.0f;
    d[r] = s < k ? dist[s * B + c] : 0.0f;
    dmax = fmaxf(dmax, m[r] > 0.0f ? d[r] : 0.0f);
  }
  const float bw = fmaxf(warp_max(dmax), 1e-3f);
  float ws = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (WK == 0) {  // bisquare
      const float rr = fminf(d[r] / bw, 1.0f);
      const float b = 1.0f - rr * rr;
      w[r] = fmaxf(b * b, 1e-4f) * m[r];
    } else if (WK == 1) {  // gaussian
      const float rb = d[r] / bw;
      w[r] = expf(-0.5f * rb * rb) * m[r];
    } else {  // uniform
      w[r] = m[r];
    }
    ws += w[r];
  }
  const float wsum = warp_sum(ws) + 1e-30f;

  // ---- 2-4. GWR trend: design, WLS solve, residuals ---------------------
  float X[MAXP][R];
  const int p = q + 1;
  design<R>(covs, cell, q, k, B, c, lane, w, wsum, X);
  normal_eq<R>(X, w, p, ridge, sA, lane);
  float nrm[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane + 32 * r;
    nrm[r] = s < k ? norm[s * B + c] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i < p) {
      float bi = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) bi += w[r] * X[i][r] * nrm[r];
      bi = warp_sum(bi);
      if (lane == 0) sb[i] = bi;
    }
  }
  __syncwarp();
  if (lane == 0) solve_spd_small(sA, sb, p);
  __syncwarp();
  const float trend = sb[0];  // x0 = e0 after centring
  float resid[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float ta = sb[0] * X[0][r];
#pragma unroll
    for (int i = 1; i < MAXP; ++i)
      if (i < p) ta += sb[i] * X[i][r];
    resid[r] = (nrm[r] - ta) * m[r];
  }

  // ---- 5. variogram parameters interpolated to the cell -----------------
  float vn = 0.0f, vp = 0.0f, vr = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane + 32 * r;
    if (s < k) {
      vn += w[r] * vario[s * B + c];
      vp += w[r] * vario[(k + s) * B + c];
      vr += w[r] * vario[(2 * k + s) * B + c];
    }
  }
  const float nug = fmaxf(warp_sum(vn) / wsum, 0.0f);
  const float ps = fmaxf(warp_sum(vp) / wsum, 1e-6f);
  const float rg = fmaxf(fmaxf(warp_sum(vr) / wsum, 1e-2f), 1e-3f);
  const float sill = nug + ps;

  // ---- 6-7. pair distances and covariance (lower triangle) -------------
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane + 32 * r;
    if (s < k) {
      sx[s] = xyz3k[s * B + c];
      sy[s] = xyz3k[(k + s) * B + c];
      sz[s] = xyz3k[(2 * k + s) * B + c];
      sm[s] = m[r];
    }
  }
  __syncwarp();
  const float diag_add = nug + jitter_frac * sill;
  krig::assemble_exp_cov<R>(
      sC, LD, k, lane, m, sm, ps, rg, diag_add,
      [&](int i, int j) { return krig::chord_km(sx, sy, sz, i, j); });
  float c0[R], y0[R], y1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    c0[r] = ps * expf(-d[r] / rg) * m[r];
    y0[r] = c0[r];
    y1[r] = m[r];
  }
  __syncwarp();

  // ---- 8. right-looking Cholesky, then forward and back substitution ----
  krig::chol_two_solves<R>(sC, LD, k, lane, y0, y1);

  // ---- 9-10. SK -> OK reduction and the kriged normal -------------------
  float sa, su, nv;
  krig::masked_sums<R>(y0, y1, m, sa, su, nv);
  const bool ok = nv >= (float)min_neighbors && su > 1e-12f && isfinite(su);
  const float t = (1.0f - sa) / (ok ? su : 1.0f);
  float lc = 0.0f, lr = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float lam = y0[r] + t * y1[r];
    lc += lam * c0[r];
    lr += lam * resid[r];
  }
  const float var = fmaxf(sill - warp_sum(lc) + t, 0.0f);
  const float normal = trend + warp_sum(lr);
  if (lane == 0) {
    out[0 * B + c] = normal;
    out[1 * B + c] = var;
    out[2 * B + c] = ok ? 1.0f : 0.0f;
    out[3 * B + c] = trend;
    out[4 * B + c] = nug;
    out[5 * B + c] = ps;
    out[6 * B + c] = rg;
    out[7 * B + c] = 0.0f;
  }

  // ---- anomaly-GWR gain rows on the same neighbourhood and weights ------
  __syncwarp();  // all lanes are done reading sb before lane 0 reuses it
  const int pa = qa + 1;
  design<R>(acovs, cell + q * B, qa, k, B, c, lane, w, wsum, X);
  normal_eq<R>(X, w, pa, ridge, sA, lane);
  if (lane == 0) {
    for (int i = 0; i < pa; ++i) sb[i] = i == 0 ? 1.0f : 0.0f;
    solve_spd_small(sA, sb, pa);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane + 32 * r;
    if (s < k) {
      float gx = sb[0] * X[0][r];
#pragma unroll
      for (int i = 1; i < MAXP; ++i)
        if (i < pa) gx += sb[i] * X[i][r];
      out[(8 + s) * B + c] = w[r] * gx;
    }
  }
}

template <int R, int WK>
cudaError_t launch(const float* xyz3k, const float* dist, const float* mask,
                   const float* covs, const float* cell, const float* norm,
                   const float* vario, const float* acovs, float* out, int B,
                   int k, int q, int qa, float ridge, float jitter_frac,
                   int min_neighbors, cudaStream_t stream) {
  const size_t warp_bytes = sizeof(float) * floats_per_warp(k);
  int wpb = (int)((48 * 1024) / warp_bytes);
  wpb = wpb < 1 ? 1 : (wpb > 8 ? 8 : wpb);
  const dim3 block(32 * wpb);
  const dim3 grid((B + wpb - 1) / wpb);
  krig_normals_kernel<R, WK><<<grid, block, wpb * warp_bytes, stream>>>(
      xyz3k, dist, mask, covs, cell, norm, vario, acovs, out, B, k, q, qa,
      ridge, jitter_frac, min_neighbors);
  return cudaGetLastError();
}

}  // namespace

extern "C" int krig_normals_launch(
    const void* xyz3k, const void* dist, const void* mask, const void* covs,
    const void* cell, const void* norm, const void* vario, const void* acovs,
    void* out, int B, int k, int q, int qa, float ridge, float jitter_frac,
    int min_neighbors, int weight_kernel, void* stream) {
  if (k < 1 || k > 64 || q < 0 || qa < 0 || q + qa > MAXP || q >= MAXP ||
      qa >= MAXP ||
      B < 0 || weight_kernel < 0 || weight_kernel > 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
#define KN_ARGS                                                              \
  static_cast<const float*>(xyz3k), static_cast<const float*>(dist),         \
      static_cast<const float*>(mask), static_cast<const float*>(covs),      \
      static_cast<const float*>(cell), static_cast<const float*>(norm),      \
      static_cast<const float*>(vario), static_cast<const float*>(acovs),    \
      static_cast<float*>(out), B, k, q, qa, ridge, jitter_frac,             \
      min_neighbors, static_cast<cudaStream_t>(stream)
  cudaError_t err;
  if (k <= 32) {
    err = weight_kernel == 0   ? launch<1, 0>(KN_ARGS)
          : weight_kernel == 1 ? launch<1, 1>(KN_ARGS)
                               : launch<1, 2>(KN_ARGS);
  } else {
    err = weight_kernel == 0   ? launch<2, 0>(KN_ARGS)
          : weight_kernel == 1 ? launch<2, 1>(KN_ARGS)
                               : launch<2, 2>(KN_ARGS);
  }
#undef KN_ARGS
  return (int)err;
}
