// Fused ordinary-kriging solve from per-cell variogram parameters: a group of
// G lanes per cell, several cells a warp.
//
// Replaces: topotpu/kernels/pallas_krig.py::ok_solve_fused and
// ::ok_solve_fused_xyz (bodies _krig_kernel / _krig_kernel_xyz ->
// _solve_body, launched by _launch). Per cell: exponential covariance from
// nugget, psill and range (range clamped to >= 1e-3, NaN kept) and the pair
// distances -> Cholesky with the guard sqrt(max(d_jj, 1e-20)) -> OK reduction
// with the rule n_valid >= min_neighbors and 1^T u > 1e-12 -> weights,
// variance max(sill - lambda . c0 + t, 0) (NaN kept, as jnp.maximum keeps
// it) and ok. Two entries: pair distances read from a (k, k, B) tensor (its
// diagonal and strict lower triangle only), or computed in the kernel from
// (3k, B) unit-sphere rows with exact asinf (the TPU kernel's Taylor series
// and its validity window are not carried over).
//
// Design. The chain is a dependent sequence of k column steps, each with a
// pivot (a shuffle, a square root, a reciprocal) that one lane needs and
// every lane waits for, so the kernel is bound by issued instructions and
// their latency more than by memory. The design before this one (one warp a
// system, rows in registers, krig_core.cuh's) spent most of its time there:
// every column step served one system, and half of each lane's updates lay
// above the diagonal. What this one does about it:
//
//   * G lanes hold one system, as folded rows: lane t of a group holds the
//     P = K / G rows t, 2G - 1 - t, 2G + t, ... (each in a register array as
//     long as the longest row of its slot), which balances the triangle over
//     the lanes. K = 16, 32, 64 runs G = 4, 8, 32: 8, 4 or 1 systems a warp,
//     so every shuffle, square root and reciprocal of a column step serves
//     that many systems; at K = 32 the update issues 920 fused multiply-adds
//     a warp for four systems, where one warp a system issued 496 for one.
//     Register indices stay compile-time: the column loop is unrolled, and a
//     lane's rows are runtime values that index shared memory only.
//   * The two right-hand sides ride along the factorisation as forward
//     solves, z = L^-1 c0 and w = L^-1 m; the OK sums are the group's dot
//     products (1^T a = w . z, 1^T u = w . w, lambda . c0 = z . z + t w . z),
//     so one back substitution, of z + t w, gives the weights. L's columns
//     are published once each to shared memory (the update reads them as
//     16-byte broadcasts) and stay there for that back substitution. The
//     pivot's 1 / sqrt is __frsqrt_rn, one correctly rounded operation.
//   * A block of 8 warps takes a tile of consecutive cells (64, 32 or 8)
//     and stages every input into shared memory with 4-byte cp.async copies
//     from rows of consecutive cells: the pair distances' diagonal and
//     strict lower triangle (the upper triangle is never read), or the x, y
//     and z rows, the point distances, the mask and the three parameters.
//     The xyz entry then computes each pair distance once into the place
//     where the pair entry stages them, so both assemble alike; the staged
//     distances are overwritten by L's columns (a cell takes about
//     K (K + 1) / 2 + 6 K floats). The weights leave through shared memory
//     as rows of consecutive cells. One kernel a K serves both entries (a
//     flag picks the staging): two a K took nvcc twice as long.
//
// Exact fp32 throughout: no tensor cores, no approximate intrinsics; -d / rng
// is a multiply by one reciprocal a cell.
//
// Read on an NVIDIA H100 80GB HBM3 at 700 W (python3 chip_smoke.py ok_solve,
// B = 65,536; pair / xyz entry at k = 32, then at k = 64; variants timed in
// turns with the tree they were cut from):
//   one warp a system (the design before)  0.50 / 0.48 ms, 3.08 / 2.94 ms
//     its pair reads from shared memory    0.40 ms, 2.29 ms (timing only)
//     its -d / rng as d * (1 / rng)        0.50 / 0.47 ms, 2.99 / 2.87 ms
//     4 or 6 resident blocks in place of 5 within 4 % at k = 32
//   one lane a system, the triangles interleaved in shared memory
//                                          0.59 / 1.14 ms at k = 32
//   this design, 1 / sqrtf(x)              0.20 / 0.27 ms, 1.39 / 1.55 ms
//     staging only (timing only)           0.07 / 0.06 ms, 0.39 / 0.09 ms
//     staging + assembly (timing only)     0.11 / 0.16 ms, 0.50 / 0.69 ms
//     G = 16 at K = 32                     0.30 / 0.36 ms
//     blocks of 4 warps                    0.21 / 0.37 ms, 1.74 / 2.01 ms
//     the next pivot ahead of the update   within 1.5 %
//     rsqrtf (approximate; timing only)    0.18 / 0.26 ms, 1.02 / 1.23 ms
//     __frsqrt_rn (kept)                   0.20 / 0.26 ms, 1.25 / 1.45 ms
//     krig::chord_km for an inline chord   within 1 % (kept)
//     one kernel a K for both entries      0.20 / 0.27 ms, 1.31 / 1.46 ms
//                                          (kept: nvcc 15.8 s against 31.6)
// What bounds it: at k = 32 the staging (0.07 ms against 0.05 ms of bytes
// for the pair entry) and the column chain's latency (16 warps an SM at 123-
// 128 registers); at k = 64 the column chain: one system a warp, and each
// of its 64 steps waits on a shuffle, the pivot and a round trip through
// shared memory. PERF.md section 6 has every reading.
//
// C interface: ok_solve_launch(...) launches on the given stream and returns
// cudaGetLastError(). Inputs are row-major float32 with the cell index
// contiguous: first is (k, k, B) pair distances (xyz = 0) or (3k, B) x rows,
// y rows, z rows (xyz = 1); dist_point (k, B); mask (k, B, 0/1); nugget,
// psill, rng (B). Outputs: weights (k, B) float32, variance (B) float32,
// ok (B) one byte 0/1 (a torch.bool tensor). 1 <= k <= 64, any B.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "krig_core.cuh"  // krig::chord_km, krig::FULL

namespace {

using krig::FULL;
constexpr int WARPS = 8;  // a block

// L's column j keeps the rows from col_start(j) on (16-byte aligned), and the
// columns lie one after the other: column j starts col_offset(K, j) floats
// into a cell's column store, which takes col_offset(K, K) floats.
__host__ __device__ constexpr int col_start(int j) { return 4 * ((j + 1) / 4); }
__host__ __device__ constexpr int col_offset(int K, int j) {
  // j K - 4 sum_{m = 1..j} floor(m / 4)
  return j * K - 4 * (2 * (j / 4) * (j / 4 - 1) + (j / 4) * (j % 4 + 1));
}

// A cell's workspace in shared memory, in floats from a 16-byte boundary.
template <int K, int G>
struct Cfg {
  static constexpr int P = K / G;          // rows a lane holds
  static constexpr int S = 32 / G;         // cells a warp
  static constexpr int CELLS = WARPS * S;  // cells a block, a power of two
  static constexpr int LC = 0;   // staged pair distances, then L's columns
  static constexpr int XY = col_offset(K, K);  // >= K (K + 1) / 2
  static constexpr int DP = XY + 3 * K;  // point distances, then the weights
  static constexpr int MK = DP + K;                   // mask
  static constexpr int DINV = MK + K;                 // 1 / L_jj
  static constexpr int PAR = DINV + K;                // nugget, psill, range
  static constexpr int STRIDE = (PAR + 3 + 3) / 4 * 4;
  static constexpr size_t BYTES = sizeof(float) * STRIDE * CELLS;
};

// Row of slot p of lane t in its group: slots alternate up and down so that
// the lane's rows together hold about (K + 1) P / 2 entries of the triangle.
template <int G>
__device__ __forceinline__ int slot_row(int p, int t) {
  return (p & 1) ? (p + 1) * G - 1 - t : p * G + t;
}

// The lane of the group that holds row j (in slot j / G).
template <int G>
__device__ __forceinline__ int row_lane(int j) {
  const int p = j / G;
  return (p & 1) ? (p + 1) * G - 1 - j : j - p * G;
}

// 4 bytes from global to shared memory without passing through registers;
// zero-filled when !valid (src must still be a mapped address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
#else
  *dst = valid ? *src : 0.0f;
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

template <int K, int G>
__global__ void __launch_bounds__(32 * WARPS, K == 16 ? 3 : 2)
ok_solve_kernel(
    const float* __restrict__ first, const float* __restrict__ dist_point,
    const float* __restrict__ mask, const float* __restrict__ nugget,
    const float* __restrict__ psill, const float* __restrict__ rng,
    float* __restrict__ weights, float* __restrict__ variance,
    unsigned char* __restrict__ ok_out, int B, int k, float jitter_frac,
    int min_neighbors, bool xyz) {
  using C = Cfg<K, G>;
  constexpr int P = C::P, CELLS = C::CELLS, ST = C::STRIDE;
  constexpr int NT = 32 * WARPS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const size_t cell0 = (size_t)blockIdx.x * CELLS;

  // Stage the tile's inputs, rows of CELLS consecutive cells.
  for (int idx = tid; idx < (2 * k + 3) * CELLS; idx += NT) {
    const int r = idx / CELLS, cl = idx % CELLS;
    const size_t c = cell0 + cl;
    const bool in = c < (size_t)B;
    const float* src;
    int off;
    if (r < k) {
      src = dist_point + (size_t)r * B;
      off = C::DP + r;
    } else if (r < 2 * k) {
      src = mask + (size_t)(r - k) * B;
      off = C::MK + r - k;
    } else {
      const int q = r - 2 * k;
      src = q == 0 ? nugget : q == 1 ? psill : rng;
      off = C::PAR + q;
    }
    cp_async4(smem + cl * ST + off, src + (in ? c : 0), in);
  }
  if (xyz) {
    for (int idx = tid; idx < 3 * k * CELLS; idx += NT) {
      const int r = idx / CELLS, cl = idx % CELLS;
      const int axis = (r >= k) + (r >= 2 * k);
      const size_t c = cell0 + cl;
      const bool in = c < (size_t)B;
      cp_async4(smem + cl * ST + C::XY + axis * K + (r - axis * k),
                first + (size_t)r * B + (in ? c : 0), in);
    }
  } else {
    for (int i = 0; i < k; ++i) {  // row i: columns 0..i
      const int tri = i * (i + 1) / 2;
      for (int idx = tid; idx < (i + 1) * CELLS; idx += NT) {
        const int j = idx / CELLS, cl = idx % CELLS;
        const size_t c = cell0 + cl;
        const bool in = c < (size_t)B;
        cp_async4(smem + cl * ST + C::LC + tri + j,
                  first + ((size_t)i * k + j) * B + (in ? c : 0), in);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = tid & 31;
  const int t = lane & (G - 1);
  const int cl = (tid >> 5) * C::S + lane / G;
  float* ws = smem + cl * ST;
  const float nug = ws[C::PAR], ps = ws[C::PAR + 1], rraw = ws[C::PAR + 2];
  const float rg = isnan(rraw) ? rraw : fmaxf(rraw, 1e-3f);
  const float rinv = 1.0f / rg;
  const float sill = nug + ps;
  const float diag_add = nug + jitter_frac * sill;

  if (xyz) {  // the lane's pair distances, each once, where the pair entry stages them
    int p = 0, r = slot_row<G>(0, t), c = 0, n = 0;
#pragma unroll
    for (int q = 0; q < P; ++q) n += slot_row<G>(q, t) < k ? slot_row<G>(q, t) + 1 : 0;
    for (int e = 0; e < n; ++e) {  // (r, c) walks the lane's rows below k
      while (c > r || r >= k) {
        r = slot_row<G>(++p, t);
        c = 0;
      }
      ws[C::LC + r * (r + 1) / 2 + c] =
          krig::chord_km(ws + C::XY, ws + C::XY + K, ws + C::XY + 2 * K, r, c);
      ++c;
    }
    __syncwarp();
  }

  // Assembly: slot p's entries (row[p], c) for c up to the slot's reach;
  // above the diagonal 0, rows >= k and masked rows of the identity.
  int row[P];
  float mr[P], y0[P], y1[P];
  float a[P][K];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    row[p] = slot_row<G>(p, t);
    const bool valid = row[p] < k && ws[C::MK + row[p]] > 0.5f;
    mr[p] = valid ? 1.0f : 0.0f;
    y0[p] = valid ? ps * expf(-ws[C::DP + row[p]] / rg) : 0.0f;  // c0
    y1[p] = mr[p];
    const float* pair = ws + C::LC + row[p] * (row[p] + 1) / 2;
#pragma unroll
    for (int c = 0; c < (p + 1) * G; ++c) {
      const float d = pair[c];  // past row[p]: another row's entry, not used
      const float cv = ps * expf(-d * rinv);
      const bool mc = c < k && ws[C::MK + c] > 0.5f;
      float v = (c < row[p] && valid && mc) ? cv : 0.0f;
      if (c == row[p]) v = valid ? cv + diag_add : 1.0f;
      a[p][c] = v;
    }
  }
  __syncwarp();  // the group has read its pair distances: L's columns go there

  // Right-looking Cholesky; z = L^-1 c0 and w = L^-1 m in y0, y1.
  float* Lc = ws + C::LC;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < k) {  // uniform over the block
      const int pj = j / G, tj = row_lane<G>(j);
      const float ajj = __shfl_sync(FULL, a[pj][j], tj, G);
      // 1 / sqrt(max(a_jj, 1e-20)), NaN kept, rounded once
      const float inv = __frsqrt_rn(ajj < 1e-20f ? 1e-20f : ajj);
      const float f0 = __shfl_sync(FULL, y0[pj], tj, G) * inv;
      const float f1 = __shfl_sync(FULL, y1[pj], tj, G) * inv;
      ws[C::DINV + j] = inv;
      float* col = Lc + (col_offset(K, j) - col_start(j));  // col[i] = L_ij
      float l[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        l[p] = 0.0f;
        if ((p + 1) * G - 1 > j) {  // the slot reaches below row j
          const bool below = row[p] > j;
          l[p] = below ? a[p][j] * inv : 0.0f;
          if (below) col[row[p]] = l[p];
          y0[p] -= l[p] * f0;  // row j itself: l = 0, finished below
          y1[p] -= l[p] * f1;
        }
      }
      __syncwarp();  // column j is published
#pragma unroll
      for (int c4 = col_start(j); c4 < K; c4 += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(col + c4);
        const float lc[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c4 + u;
#pragma unroll
          for (int p = 0; p < P; ++p)
            if (c > j && c < (p + 1) * G) a[p][c] -= l[p] * lc[u];
        }
      }
    }
  }
  __syncwarp();  // every 1 / L_jj is written

  // OK reduction from the forward solves.
  float dv[P], v[P];
  float zz = 0.0f, wz = 0.0f, ww = 0.0f, nv = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    dv[p] = row[p] < k ? ws[C::DINV + row[p]] : 0.0f;
    const float z = y0[p] * dv[p], w = y1[p] * dv[p];
    y0[p] = z;
    y1[p] = w;
    zz += z * z;
    wz += w * z;
    ww += w * w;
    nv += mr[p];
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    zz += __shfl_xor_sync(FULL, zz, o, G);
    wz += __shfl_xor_sync(FULL, wz, o, G);
    ww += __shfl_xor_sync(FULL, ww, o, G);
    nv += __shfl_xor_sync(FULL, nv, o, G);
  }
  const bool ok = nv >= (float)min_neighbors && ww > 1e-12f;
  const float tt = (1.0f - wz) / (ok ? ww : 1.0f);
  const float* lrow[P];  // lrow[p][j] = L_{j, row[p]}, j > row[p]
#pragma unroll
  for (int p = 0; p < P; ++p) {
    v[p] = y0[p] + tt * y1[p];
    lrow[p] = Lc + (col_offset(K, row[p]) - col_start(row[p]));
  }

  // Back substitution L^T x = z + t w, x_j broadcast from row j's lane.
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    if (j < k) {
      const int pj = j / G;
      const float xj = __shfl_sync(FULL, v[pj] * dv[pj], row_lane<G>(j), G);
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (p * G < j && row[p] < j) v[p] -= lrow[p][j] * xj;
    }
  }

  // Weights through shared memory (over the point distances), variance, ok.
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (row[p] < k) ws[C::DP + row[p]] = v[p] * dv[p] * mr[p];
  const float var = sill - (zz + tt * wz) + tt;
  const size_t c = cell0 + cl;
  if (t == 0 && c < (size_t)B) {
    variance[c] = isnan(var) ? var : fmaxf(var, 0.0f);
    ok_out[c] = ok ? 1 : 0;
  }
  __syncthreads();
  for (int idx = tid; idx < k * CELLS; idx += NT) {
    const int r = idx / CELLS, cw = idx % CELLS;
    if (cell0 + cw < (size_t)B)
      weights[(size_t)r * B + cell0 + cw] = smem[cw * ST + C::DP + r];
  }
}

template <int K, int G>
cudaError_t launch(const float* first, const float* dist_point,
                   const float* mask, const float* nugget, const float* psill,
                   const float* rng, float* weights, float* variance,
                   unsigned char* ok, int B, int k, float jitter_frac,
                   int min_neighbors, bool xyz, cudaStream_t stream) {
  using C = Cfg<K, G>;
  if (C::BYTES > 48 * 1024) {  // above 48 KB only after raising the limit
    const cudaError_t err = cudaFuncSetAttribute(
        ok_solve_kernel<K, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::BYTES);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((B + C::CELLS - 1) / C::CELLS));
  ok_solve_kernel<K, G><<<grid, 32 * WARPS, C::BYTES, stream>>>(
      first, dist_point, mask, nugget, psill, rng, weights, variance, ok, B, k,
      jitter_frac, min_neighbors, xyz);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ok_solve_launch(const void* first, const void* dist_point,
                               const void* mask, const void* nugget,
                               const void* psill, const void* rng,
                               void* weights, void* variance, void* ok, int B,
                               int k, float jitter_frac, int min_neighbors,
                               int xyz, void* stream) {
  if (k < 1 || k > 64 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
#define OK_ARGS                                                              \
  static_cast<const float*>(first), static_cast<const float*>(dist_point),   \
      static_cast<const float*>(mask), static_cast<const float*>(nugget),    \
      static_cast<const float*>(psill), static_cast<const float*>(rng),      \
      static_cast<float*>(weights), static_cast<float*>(variance),           \
      static_cast<unsigned char*>(ok), B, k, jitter_frac, min_neighbors,     \
      xyz != 0, static_cast<cudaStream_t>(stream)
  cudaError_t err;
  if (k <= 16) {
    err = launch<16, 4>(OK_ARGS);
  } else if (k <= 32) {
    err = launch<32, 8>(OK_ARGS);
  } else {
    err = launch<64, 32>(OK_ARGS);
  }
#undef OK_ARGS
  return (int)err;
}
