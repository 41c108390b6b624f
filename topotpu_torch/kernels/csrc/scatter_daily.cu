// Daily-anomaly contraction as a gather-FMA:
//   out[c, d] = sum_j gains[j, c] * mask[j, c] * Y[idx[j, c], d]
//
// Replaces: topotpu/kernels/pallas_scatter.py::scatter_daily_matmul (body
// _scatter_matmul_kernel), which builds a dense (S, cells) gain matrix per
// block and contracts it with Y on the matrix unit. Here no dense matrix is
// built: each block loads the (idx, gain * mask) pairs of CELLS cells into
// shared memory, and each thread owns one day column d and sums the k
// neighbour rows of Y for each of those cells in a fixed j order. Duplicate
// indices accumulate; the order is fixed and there are no atomics, so the
// result is deterministic. Indices outside [0, S) contribute nothing, as in
// the TPU kernel's compare-and-accumulate scatter.
//
// What bounds it on an H100: the (C, D) float32 output is written once
// (C * D * 4 bytes, e.g. 195 MB at C = 65,536, D = 744) and that write is the
// floor. Y (S * D * 4 bytes, about 1.5 MB at S = 512, D = 744) stays in L2,
// so the k reads per output element are L2/L1 reads, coalesced along d;
// neighbouring cells share most neighbours, so a block's CELLS cells reuse
// the same Y rows from L1. Exact fp32 FMAs, no tensor cores.
//
// C interface: scatter_daily_launch(...) launches on the given stream and
// returns cudaGetLastError(). idx (k, C) int32, gains and mask (k, C) float32,
// Y (S, D) float32, out (C, D) float32, all row-major and contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int CELLS = 8;      // cells per block
constexpr int THREADS = 256;  // day columns per block

__global__ void __launch_bounds__(THREADS) scatter_daily_kernel(
    const int* __restrict__ idx, const float* __restrict__ gains,
    const float* __restrict__ mask, const float* __restrict__ Y,
    float* __restrict__ out, int C, int k, int S, int D) {
  extern __shared__ float smem[];
  int* sidx = reinterpret_cast<int*>(smem);
  float* sg = smem + CELLS * k;
  const int c0 = blockIdx.x * CELLS;
  const int nc = min(CELLS, C - c0);
  for (int t = threadIdx.x; t < nc * k; t += blockDim.x) {
    const int cl = t % nc, j = t / nc;  // neighbouring threads, neighbouring cells
    const size_t src = (size_t)j * C + c0 + cl;
    sidx[cl * k + j] = idx[src];
    sg[cl * k + j] = gains[src] * mask[src];
  }
  __syncthreads();
  const int d = blockIdx.y * THREADS + threadIdx.x;
  if (d >= D) return;
  for (int cl = 0; cl < nc; ++cl) {
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) {
      const int s = sidx[cl * k + j];
      if ((unsigned)s < (unsigned)S) acc += sg[cl * k + j] * Y[(size_t)s * D + d];
    }
    out[(size_t)(c0 + cl) * D + d] = acc;
  }
}

}  // namespace

extern "C" int scatter_daily_launch(const void* idx, const void* gains,
                                    const void* mask, const void* Y, void* out,
                                    int C, int k, int S, int D, void* stream) {
  const size_t smem = (size_t)CELLS * k * (sizeof(int) + sizeof(float));
  if (C < 0 || k < 1 || S < 1 || D < 0 || smem > 48 * 1024 ||
      (D + THREADS - 1) / THREADS > 65535)
    return (int)cudaErrorInvalidValue;
  if (C == 0 || D == 0) return 0;
  const dim3 grid((C + CELLS - 1) / CELLS, (D + THREADS - 1) / THREADS);
  scatter_daily_kernel<<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(gains),
      static_cast<const float*>(mask), static_cast<const float*>(Y),
      static_cast<float*>(out), C, k, S, D);
  return (int)cudaGetLastError();
}
