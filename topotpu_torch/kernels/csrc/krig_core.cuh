// Ordinary-kriging solve core shared by krig_normals.cu and ok_solve.cu.
//
// One warp owns one system. Lanes own rows (slot s = lane + 32 r, r < R, so
// R = 2 above k = 32); the k x k covariance sits in shared memory with row
// stride k + 1, so the 32 lanes of a column access hit 32 banks. Steps:
//   assemble_exp_cov  exponential covariance, lower triangle, masked rows
//                     folded to identity (kernels/cholesky.py::assemble_exp_cov)
//   chol_two_solves   right-looking Cholesky with the guard
//                     sqrt(max(d_jj, 1e-20)), then L y = rhs and L^T x = y for
//                     two right-hand sides held in registers
//   masked_sums       the SK -> OK reduction's sums over the valid slots
// Exact fp32 throughout: no tensor cores, no fast-math intrinsics. The build
// key of each .cu that includes this header covers the header too
// (kernels/_build.py::library_path).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace krig {

constexpr float EARTH_RADIUS_KM = 6371.0087714f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Slot j's register value, broadcast from the lane that owns it (j uniform).
template <int R>
__device__ __forceinline__ float bcast(const float (&v)[R], int j) {
  float lo = __shfl_sync(FULL, v[0], j & 31);
  if (R == 1) return lo;
  float hi = __shfl_sync(FULL, v[R - 1], j & 31);
  return j < 32 ? lo : hi;
}

// Great-circle km between unit-sphere points i and j held in shared memory
// (chord form with exact asinf, as topotpu_torch/geo/distance.py).
__device__ __forceinline__ float chord_km(const float* sx, const float* sy,
                                          const float* sz, int i, int j) {
  const float dx = sx[i] - sx[j], dy = sy[i] - sy[j], dz = sz[i] - sz[j];
  const float d2 = dx * dx + dy * dy + dz * dz;
  const float half = fminf(fmaxf(0.5f * sqrtf(d2), 0.0f), 1.0f);
  return 2.0f * EARTH_RADIUS_KM * asinf(half);
}

// Lower triangle of C[i][j] = psill exp(-d_ij / rng) m_i m_j, plus
// m_i diag_add + (1 - m_i) on the diagonal. pair_km(i, j) gives d_ij; sm
// holds the 0/1 mask of every slot. The caller synchronises the warp after.
template <int R, class PairKm>
__device__ __forceinline__ void assemble_exp_cov(
    float* sC, int LD, int k, int lane, const float (&m)[R], const float* sm,
    float psill, float rng, float diag_add, PairKm pair_km) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < k) {
      const float mi = m[r];
      float* row = sC + i * LD;
      for (int j = 0; j <= i; ++j) {
        float cv = psill * expf(-pair_km(i, j) / rng) * (mi * sm[j]);
        if (j == i) cv += mi * diag_add + (1.0f - mi);
        row[j] = cv;
      }
    }
  }
}

// In-place Cholesky of the lower triangle of sC, then the two solves
// C x = y0 and C x = y1 (each lane's rows in registers, overwritten).
template <int R>
__device__ __forceinline__ void chol_two_solves(float* sC, int LD, int k,
                                                int lane, float (&y0)[R],
                                                float (&y1)[R]) {
  for (int j = 0; j < k; ++j) {
    const float dj = sqrtf(fmaxf(sC[j * LD + j], 1e-20f));
    const float inv = 1.0f / dj;
    __syncwarp();  // every lane has read C[j][j] before its owner rewrites it
    float lij[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      lij[r] = 0.0f;
      if (i == j) sC[j * LD + j] = dj;
      if (i > j && i < k) {
        lij[r] = sC[i * LD + j] * inv;
        sC[i * LD + j] = lij[r];
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i > j && i < k) {
        float* row = sC + i * LD;
        for (int cc = j + 1; cc <= i; ++cc) row[cc] -= lij[r] * sC[cc * LD + j];
      }
    }
    __syncwarp();
  }
  for (int j = 0; j < k; ++j) {  // L y = rhs
    const float inv = 1.0f / sC[j * LD + j];
    const float a = bcast<R>(y0, j) * inv;
    const float u = bcast<R>(y1, j) * inv;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i == j) {
        y0[r] = a;
        y1[r] = u;
      } else if (i > j && i < k) {
        const float l = sC[i * LD + j];
        y0[r] -= l * a;
        y1[r] -= l * u;
      }
    }
  }
  for (int j = k - 1; j >= 0; --j) {  // L^T x = y
    const float inv = 1.0f / sC[j * LD + j];
    const float a = bcast<R>(y0, j) * inv;
    const float u = bcast<R>(y1, j) * inv;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i == j) {
        y0[r] = a;
        y1[r] = u;
      } else if (i < j) {
        const float l = sC[j * LD + i];
        y0[r] -= l * a;
        y1[r] -= l * u;
      }
    }
  }
}

// Masks the two solutions in place (a = y0 m, u = y1 m) and returns the
// warp sums 1^T a, 1^T u and the valid-slot count.
template <int R>
__device__ __forceinline__ void masked_sums(float (&y0)[R], float (&y1)[R],
                                            const float (&m)[R], float& sa,
                                            float& su, float& nv) {
  sa = 0.0f;
  su = 0.0f;
  nv = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    y0[r] *= m[r];
    y1[r] *= m[r];
    sa += y0[r];
    su += y1[r];
    nv += m[r];
  }
  sa = warp_sum(sa);
  su = warp_sum(su);
  nv = warp_sum(nv);
}

}  // namespace krig
