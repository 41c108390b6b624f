// Ordinary-kriging solve core shared by krig_normals.cu and ok_solve.cu.
//
// One warp owns one k x k system, k <= 32 R (R = 1 or 2 slots a lane; the
// kernels are compiled for K = 32 and K = 64 and take any k up to K). The
// design follows what an H100's SM is short of, which is instruction slots and
// shared-memory round trips on a dependent chain, not memory:
//
//   fill_pair_km      evaluates the k (k - 1) / 2 pair distances once, spread
//                     evenly over the lanes (rows t and k - 1 - t together
//                     hold k - 1 pairs: one pass of the warp), into a packed
//                     "folded" array in shared memory, so that every later
//                     assembly reads them with unit stride;
//   assemble_exp_cov  exponential covariance of the lower triangle in the
//                     same folded order (every lane busy on every pass),
//                     masked rows folded to identity
//                     (kernels/cholesky.py::assemble_exp_cov);
//   load_rows         each lane takes its own rows (slot s = lane + 32 r)
//                     into registers with 16-byte loads;
//   chol_two_solves   right-looking Cholesky with the matrix in registers:
//                     at column j the lanes publish their l_ij to a
//                     double-buffered column in shared memory (one warp
//                     barrier a column), read the whole column back as
//                     16-byte broadcasts and update their register rows, all
//                     with compile-time indices (the column loop is unrolled).
//                     The forward substitution of the two right-hand sides
//                     rides along on the l_ij in registers; L goes to shared
//                     memory once for the back substitution, whose rows are
//                     contiguous. Pivot guard sqrt(max(d_jj, 1e-20));
//   masked_sums       the SK -> OK reduction's sums over the valid slots.
//
// Exact fp32 throughout: no tensor cores, no fast-math intrinsics. The build
// key of each .cu that includes this header covers the header too
// (kernels/_build.py::library_path).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace krig {

constexpr float EARTH_RADIUS_KM = 6371.0087714f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 4;

// Resident blocks asked of the compiler. At K = 32, 5 x 128 threads cap the
// kernels at 96 registers: some tens of bytes spill, and the fifth block
// buys 7 % (24 x 65,536 systems at k = 32 on an H100, the variants timed
// in turns on one card: 10.2-10.3 ms at 5 blocks, 11.1 ms at 4 with 99-126
// registers and no spill, 10.5 ms at 6 with 80). At K = 64 two rows of 64
// live in registers, so 2 x 128 threads at up to 255.
__host__ __device__ constexpr int min_blocks(int R) { return R == 1 ? 5 : 2; }

// One warp's workspace in shared memory, in floats from a 16-byte aligned
// base. Row stride K + 4 keeps rows 16-byte aligned and the 16-byte row
// loads of a quarter warp on distinct banks.
template <int R>
struct Layout {
  static constexpr int K = 32 * R;
  static constexpr int LD = K + 4;
  static constexpr int A = 0;                  // K x LD matrix (C, then L)
  static constexpr int D = A + K * LD;         // folded pair distances
  static constexpr int COL = D + (K / 2) * K;  // two column buffers of K
  static constexpr int M = COL + 2 * K;        // 0/1 mask of every slot
  static constexpr int FLOATS = M + K;         // a multiple of 4
};

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

// Calls f(e, row, col) once for every strictly-lower pair (row > col) of a
// k x k matrix, the pairs spread evenly over the lanes: pass t takes row t
// (t pairs) and row k - 1 - t (k - 1 - t pairs), k - 1 <= 32 R - 1 in all.
// e = t * 32 R + (lane + 32 r) is the pair's place in the folded array.
template <int R, class F>
__device__ __forceinline__ void for_each_pair(int k, int lane, F f) {
  const int half = (k + 1) >> 1;
  for (int t = 0; t < half; ++t) {
    const int rb = k - 1 - t;  // >= t
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int l = lane + 32 * r;
      const bool first = l < t;
      const int row = first ? t : rb;
      const int col = first ? l : l - t;
      if (first || (rb > t && col < rb)) f(t * 32 * R + l, row, col);
    }
  }
}

// Pair distances pair_km(i, j), i > j, into the folded array sD; each lane's
// own diagonal distances pair_km(i, i) into dd. The caller synchronises the
// warp after.
template <int R, class PairKm>
__device__ __forceinline__ void fill_pair_km(float* sD, int k, int lane,
                                             float (&dd)[R], PairKm pair_km) {
  for_each_pair<R>(k, lane, [&](int e, int row, int col) {
    sD[e] = pair_km(row, col);
  });
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    dd[r] = i < k ? pair_km(i, i) : 0.0f;
  }
}

// Lower triangle of C[i][j] = psill exp(-d_ij / rng) m_i m_j, plus
// m_i diag_add + (1 - m_i) on the diagonal, into sA (row stride LD) from the
// folded distances. sm holds the 0/1 mask of every slot. (Folding the mask
// into the distances as +inf saved the indexed kernel 2 % and cost the OK
// solve's pair-distance entry 40 %, H100; not kept.) The caller synchronises
// the warp after.
template <int R>
__device__ __forceinline__ void assemble_exp_cov(
    float* sA, const float* sD, const float* sm, const float (&dd)[R],
    const float (&m)[R], int k, int lane, float psill, float rng,
    float diag_add) {
  constexpr int LD = Layout<R>::LD;
  for_each_pair<R>(k, lane, [&](int e, int row, int col) {
    sA[row * LD + col] = psill * expf(-sD[e] / rng) * (sm[row] * sm[col]);
  });
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < k) {
      const float mi = m[r];
      float cv = psill * expf(-dd[r] / rng) * (mi * mi);
      cv += mi * diag_add + (1.0f - mi);
      sA[i * LD + i] = cv;
    }
  }
}

// This lane's rows of sA into registers: row lane + 32 r, columns below
// 32 (r + 1) (the rest lies above the diagonal). Entries above the diagonal
// and rows >= k come along as they are and are never used.
template <int R>
__device__ __forceinline__ void load_rows(const float* sA, int lane,
                                          float (&a)[R][32 * R]) {
  constexpr int LD = Layout<R>::LD;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4* row =
        reinterpret_cast<const float4*>(sA + (lane + 32 * r) * LD);
#pragma unroll
    for (int c4 = 0; c4 < 8 * (r + 1); ++c4) {
      const float4 v = row[c4];
      a[r][4 * c4 + 0] = v.x;
      a[r][4 * c4 + 1] = v.y;
      a[r][4 * c4 + 2] = v.z;
      a[r][4 * c4 + 3] = v.w;
    }
  }
}

// Cholesky of the matrix held by rows in registers (a), then the two solves
// C x = y0 and C x = y1 (each lane's slots in registers, overwritten). L is
// written to sL (row stride LD; sA may be reused once every lane has loaded
// its rows) and scol is the two-column buffer. Every lane of the warp must
// call it.
template <int R>
__device__ __forceinline__ void chol_two_solves(float (&a)[R][32 * R],
                                                float* sL, float* scol, int k,
                                                int lane, float (&y0)[R],
                                                float (&y1)[R]) {
  constexpr int K = Layout<R>::K;
  constexpr int LD = Layout<R>::LD;
  float dinv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dinv[r] = 1.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < k) {  // uniform over the warp
      const float ajj = __shfl_sync(FULL, a[j >> 5][j], j & 31);
      const float dj = sqrtf(fmaxf(ajj, 1e-20f));
      const float inv = 1.0f / dj;
      const float f0 = __shfl_sync(FULL, y0[j >> 5], j & 31) * inv;
      const float f1 = __shfl_sync(FULL, y1[j >> 5], j & 31) * inv;
      float* col = scol + (j & 1) * K;
      float lij[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + 32 * r;
        const bool below = j < 32 * (r + 1) && i > j && i < k;
        lij[r] = below ? a[r][j < 32 * (r + 1) ? j : 0] * inv : 0.0f;
        if (below) {
          col[i] = lij[r];
          sL[i * LD + j] = lij[r];
        }
        if (i == j) {  // L y = rhs, column j's step
          dinv[r] = inv;
          y0[r] = f0;
          y1[r] = f1;
        } else if (below) {
          y0[r] -= lij[r] * f0;
          y1[r] -= lij[r] * f1;
        }
      }
      __syncwarp();  // column j is published; the other buffer is free again
#pragma unroll
      for (int g = (j + 1) >> 4; g < K / 16; ++g) {
        if (k > 16 * g) {  // uniform over the warp: 16 columns a test
#pragma unroll
          for (int c4 = 16 * g; c4 < 16 * (g + 1); c4 += 4) {
            if (c4 + 3 > j) {  // compile-time: the chunk reaches past j
              const float4 v = *reinterpret_cast<const float4*>(col + c4);
              const float lc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                const int c = c4 + t;
#pragma unroll
                for (int r = 0; r < R; ++r)
                  if (c > j && c < 32 * (r + 1)) a[r][c] -= lij[r] * lc[t];
              }
            }
          }
        }
      }
    }
  }
  __syncwarp();  // L is complete in sL
#pragma unroll 4
  for (int j = k - 1; j >= 0; --j) {  // L^T x = y
    float p0[R], p1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p0[r] = y0[r] * dinv[r];
      p1[r] = y1[r] * dinv[r];
    }
    const float x0 = bcast<R>(p0, j);
    const float x1 = bcast<R>(p1, j);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i == j) {
        y0[r] = x0;
        y1[r] = x1;
      } else if (i < j) {
        const float l = sL[j * LD + i];
        y0[r] -= l * x0;
        y1[r] -= l * x1;
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

// Dynamic shared memory of a block of WARPS_PER_BLOCK warps; above 48 KB the
// kernel's limit is raised first (Hopper allows 227 KB a block).
template <int R, class Kernel>
inline cudaError_t shared_bytes(Kernel kernel, size_t* bytes) {
  *bytes = sizeof(float) * Layout<R>::FLOATS * WARPS_PER_BLOCK;
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

}  // namespace krig
