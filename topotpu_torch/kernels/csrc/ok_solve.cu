// Fused ordinary-kriging solve from per-cell variogram parameters, one warp
// per cell.
//
// Replaces: topotpu/kernels/pallas_krig.py::ok_solve_fused and
// ::ok_solve_fused_xyz (bodies _krig_kernel / _krig_kernel_xyz ->
// _solve_body, launched by _launch). Per cell: exponential covariance from
// nugget, psill and range (range clamped to >= 1e-3) and the pair distances
// -> Cholesky with the guard sqrt(max(d_jj, 1e-20)) and two solves (c0 and
// ones) -> SK -> OK reduction with the rule n_valid >= min_neighbors and
// 1^T u > 1e-12 -> weights, variance max(sill - lambda . c0 + t, 0) (NaN
// kept, as jnp.maximum keeps it) and ok. Two entries share the body: pair
// distances read from a (k, k, B) tensor, or computed in the kernel from
// (3k, B) unit-sphere rows with exact asinf (the TPU kernel's Taylor series
// and its validity window are not carried over).
//
// What bounds it on an H100: from xyz, instruction throughput and latency on the
// dependent chain of k factorisation steps, as krig_normals (about 4k + 3
// floats read per cell). From pair distances, also the k^2 floats per cell
// of the (k, k, B) input (1.07 GB at k = 64, B = 65,536): one warp reads its
// cell's column, and the warps of a block cover consecutive cells, so each
// 32-byte sector is shared by the block's warps through L1. The pair
// distances, the assembly, the register-resident factorisation with its
// solves and the masked sums are krig_core.cuh's, shared with
// krig_normals.cu; blocks are 4 warps, with 7 KB of shared memory a warp at
// k <= 32 and 26.4 KB above (limit raised with cudaFuncSetAttribute).
//
// C interface: ok_solve_launch(...) launches on the given stream and returns
// cudaGetLastError(). Inputs are row-major float32 with the cell index
// contiguous: first is (k, k, B) pair distances (xyz = 0) or (3k, B) x rows,
// y rows, z rows (xyz = 1); dist_point (k, B); mask (k, B, 0/1); nugget,
// psill, rng (B). Outputs: weights (k, B) float32, variance (B) float32,
// ok (B) one byte 0/1 (a torch.bool tensor). 1 <= k <= 64.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "krig_core.cuh"

namespace {

template <int R, bool XYZ>
__global__ void __launch_bounds__(32 * krig::WARPS_PER_BLOCK,
                                  krig::min_blocks(R))
ok_solve_kernel(
    const float* __restrict__ first, const float* __restrict__ dist_point,
    const float* __restrict__ mask, const float* __restrict__ nugget,
    const float* __restrict__ psill, const float* __restrict__ rng,
    float* __restrict__ weights, float* __restrict__ variance,
    unsigned char* __restrict__ ok_out, int B, int k, float jitter_frac,
    int min_neighbors) {
  extern __shared__ float4 smem4[];
  using L = krig::Layout<R>;
  constexpr int K = L::K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * krig::WARPS_PER_BLOCK + warp;
  if (c >= B) return;  // whole warps only: no block-level barrier follows

  float* ws = reinterpret_cast<float*>(smem4) + warp * L::FLOATS;
  float* sA = ws + L::A;  // the matrix; x, y, z rows before it is assembled
  float* sD = ws + L::D;
  float* scol = ws + L::COL;
  float* sm = ws + L::M;

  float m[R], d[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane + 32 * r;
    m[r] = s < k ? mask[(size_t)s * B + c] : 0.0f;
    d[r] = s < k ? dist_point[(size_t)s * B + c] : 0.0f;
    if (s < k) {
      sm[s] = m[r];
      if (XYZ) {
        sA[s] = first[(size_t)s * B + c];
        sA[K + s] = first[(size_t)(k + s) * B + c];
        sA[2 * K + s] = first[(size_t)(2 * k + s) * B + c];
      }
    }
  }
  const float nug = nugget[c];
  const float ps = psill[c];
  const float rg = fmaxf(rng[c], 1e-3f);
  const float sill = nug + ps;
  __syncwarp();

  float dd[R];
  if (XYZ) {
    krig::fill_pair_km<R>(sD, k, lane, dd, [&](int i, int j) {
      return krig::chord_km(sA, sA + K, sA + 2 * K, i, j);
    });
  } else {
    krig::fill_pair_km<R>(sD, k, lane, dd, [&](int i, int j) {
      return first[((size_t)i * k + j) * B + c];
    });
  }
  __syncwarp();
  const float diag_add = nug + jitter_frac * sill;
  krig::assemble_exp_cov<R>(sA, sD, sm, dd, m, k, lane, ps, rg, diag_add);
  __syncwarp();
  float a[R][K];
  krig::load_rows<R>(sA, lane, a);
  float c0[R], y0[R], y1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    c0[r] = ps * expf(-d[r] / rg) * m[r];
    y0[r] = c0[r];
    y1[r] = m[r];
  }
  __syncwarp();  // every lane holds its rows: sA becomes L's place

  krig::chol_two_solves<R>(a, sA, scol, k, lane, y0, y1);

  float sa, su, nv;
  krig::masked_sums<R>(y0, y1, m, sa, su, nv);
  const bool ok = nv >= (float)min_neighbors && su > 1e-12f;
  const float t = (1.0f - sa) / (ok ? su : 1.0f);
  float lc = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane + 32 * r;
    const float lam = y0[r] + t * y1[r];
    lc += lam * c0[r];
    if (s < k) weights[(size_t)s * B + c] = lam;
  }
  const float v = sill - krig::warp_sum(lc) + t;
  if (lane == 0) {
    variance[c] = isnan(v) ? v : fmaxf(v, 0.0f);
    ok_out[c] = ok ? 1 : 0;
  }
}

template <int R, bool XYZ>
cudaError_t launch(const float* first, const float* dist_point,
                   const float* mask, const float* nugget, const float* psill,
                   const float* rng, float* weights, float* variance,
                   unsigned char* ok, int B, int k, float jitter_frac,
                   int min_neighbors, cudaStream_t stream) {
  size_t bytes;
  cudaError_t err = krig::shared_bytes<R>(ok_solve_kernel<R, XYZ>, &bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + krig::WARPS_PER_BLOCK - 1) / krig::WARPS_PER_BLOCK);
  ok_solve_kernel<R, XYZ><<<grid, 32 * krig::WARPS_PER_BLOCK, bytes, stream>>>(
      first, dist_point, mask, nugget, psill, rng, weights, variance, ok, B, k,
      jitter_frac, min_neighbors);
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
      static_cast<cudaStream_t>(stream)
  cudaError_t err;
  if (k <= 32) {
    err = xyz ? launch<1, true>(OK_ARGS) : launch<1, false>(OK_ARGS);
  } else {
    err = xyz ? launch<2, true>(OK_ARGS) : launch<2, false>(OK_ARGS);
  }
#undef OK_ARGS
  return (int)err;
}
