// Daily-anomaly contraction as a gather-FMA, two entries on one device function.
//
//   entry A, scatter_daily_launch:         out[c, d] = sum_j gains[c, j] * mask[c, j] * Y[idx[c, j], d]
//   entry B, scatter_daily_packed_launch:  the same sum for V variables over the 12 x dpm
//       month-grouped day slots, then + normal, the tmin <= tmax reconcile, the int16
//       quantisation on a fixed lattice and the calendar reorder, written straight into the
//       step's (V x (ndays + 24), C) int16 product (rows v x (ndays + 24) + t, t < ndays).
//
// Replaces: topotpu/kernels/pallas_scatter.py::scatter_daily_matmul (body
// _scatter_matmul_kernel), which builds a dense (S, cells) gain matrix per block and contracts
// it with Y on the matrix unit, and (entry B) the elementwise chain the JAX package leaves to
// XLA after it: add the normal, reconcile, quantise, permute, gather the calendar order,
// concatenate. Here no dense matrix is built and no float (C, D) array leaves the chip in
// entry B.
//
// Design.
// - Operands are read as select_neighbors and krig_normals_indexed leave them: idx, mask
//   (.., C, k) and gains (.., C, k) with a cell's k slots contiguous, idx int32 or int64, mask
//   bool. A block takes CELLS consecutive cells and stages their (row offset, gain x mask x
//   in-range) pairs in shared memory, interleaved, one 8-byte load a neighbour. An index
//   outside [0, S) contributes nothing (offset 0, gain 0), masked or not, as in the TPU
//   kernel's compare-and-accumulate scatter.
// - A thread owns four consecutive day slots of one cell (a quad): each neighbour costs one
//   shared-memory broadcast and one 16-byte read-only load of Y a variable for four FMAs a
//   variable, in a fixed j order (exact fp32 FMAs, no atomics, no tensor cores: duplicates
//   accumulate and the result is deterministic). Lanes of a warp run along quads, so a warp
//   reads runs of up to 16 quads (256 contiguous bytes) of a Y row. A Y row of 12 x dpm floats
//   is always a multiple of 16 bytes; entry A takes a scalar path (the thread's four columns a
//   chunk-quarter apart, still coalesced) when D is not a multiple of 4.
// - A block's items are (cell, quad) pairs over CELLS cells and at most MAX_QUADS quads, dealt
//   to the threads in turn, so any C, D and dpm fill the block. With one neighbourhood a month
//   (N = 12) a block takes one month's quads with that month's pairs; a quad that straddles
//   two months is computed for each and each keeps its own slots. The constants were read on
//   an H100: 16 quads a block beat 8, 24 and 32 (the block's Y rows stay in the L1 that its
//   shared memory leaves), 64 cells beat 32 with one neighbourhood a month, the j loop
//   unrolled by 8 beat 4.
// - Entry B stores through shared memory, transposed: threads run along days for the gather
//   but the product's fast axis is cells. The block stages its (variable, slot, cell) int16
//   tile (word index XORed with the quad so that neither side has bank conflicts) and each
//   warp then writes, for one (variable, calendar day), the block's cells as one contiguous
//   run of CELLS x 2 bytes. The calendar day of a slot is found from slot_of_day by the block
//   itself (pad slots and slots of another month have none and are not stored).
//
// What bounds it on an H100: Y (S x D x 4 bytes, 1.5 MB at S = 512, D = 744) lives in L2 and
// a block's rows in L1, so the k row reads of every (cell, quad) are L1 reads: C x D x k x 4
// bytes a variable through the SMs' L1 is the floor of this design, several times the bound
// of the work itself (entry A: the C x D x 4-byte output written once; entry B: 2 k C V 12 dpm
// operations). Going under it needs each Y value held in a register for several cells.
//
// C interface: both functions launch on the given stream and return cudaGetLastError(), or
// cudaErrorInvalidValue for what they do not take: k so large that the block's shared memory
// passes 227 KB (about k > 400 for entry A), V x S x D >= 2^31, more than 65,535 day chunks;
// entry B also V outside {1, 2}, G outside {1, V}, N outside {1, 12}. All arrays are
// row-major and contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CELLS = 64;      // cells a block: 128-byte runs of int16 in entry B
constexpr int MAX_QUADS = 16;  // quads (4 day slots) a block takes along the day axis
constexpr int MAX_SMEM = 227 * 1024;

// The block's cells' k slots -> pairs[cl * (k + 1) + j] = (idx * D, gain * mask * in-range);
// with G == 2 variable 1's gains go to gain1 at the same place. `base` is the element offset
// of the block's first cell in idx / mask / one variable's gains.
template <int G>
__device__ __forceinline__ void stage_pairs(
    int2* pairs, float* gain1, const void* __restrict__ idx, int idx64,
    const float* __restrict__ gains, size_t gain_var_stride,
    const unsigned char* __restrict__ mask, size_t base, int n_elems, int k, int S, int D) {
  for (int e = threadIdx.x; e < n_elems; e += THREADS) {
    const int cl = e / k, j = e - cl * k;
    const long long id = idx64 ? static_cast<const long long*>(idx)[base + e]
                               : (long long)static_cast<const int*>(idx)[base + e];
    const bool in_range = id >= 0 && id < S;
    const float inr = in_range ? 1.0f : 0.0f;
    const float mk = mask[base + e] ? 1.0f : 0.0f;
    const int at = cl * (k + 1) + j;
    pairs[at] = make_int2(in_range ? (int)id * D : 0,
                          __float_as_int(gains[base + e] * mk * inr));
    if (G == 2) gain1[at] = gains[gain_var_stride + base + e] * mk * inr;
  }
}

// The contraction of one (cell, quad) for V variables: acc[v][i] = sum_j g_v[j] * Y_v[row_j,
// column i]. VEC: the columns are col .. col + 3 (col a multiple of 4, rows 16-byte aligned);
// else they are col + i * cstep, read one by one and clamped into the row.
template <int V, int G, bool VEC>
__device__ __forceinline__ void gather_quad(
    const int2* pairs, const float* gain1, int k, const float* __restrict__ Y,
    size_t var_stride, int col, int cstep, int D, float (&acc)[V][4]) {
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[v][i] = 0.0f;
  int cols[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) cols[i] = VEC ? col + i : min(col + i * cstep, D - 1);
#pragma unroll 8
  for (int j = 0; j < k; ++j) {
    const int2 p = pairs[j];
    float g[V];
    g[0] = __int_as_float(p.y);
    if (V == 2) g[V - 1] = (G == 2) ? gain1[j] : g[0];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float* row = Y + v * var_stride + p.x;
      float y[4];
      if (VEC) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(row + col));
        y[0] = q.x; y[1] = q.y; y[2] = q.z; y[3] = q.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) y[i] = __ldg(row + cols[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[v][i] = fmaf(g[v], y[i], acc[v][i]);
    }
  }
}

// Entry A. grid.x: blocks of CELLS cells; grid.y: chunks of nq quads of the ceil(D / 4).
template <bool VEC>
__global__ void __launch_bounds__(THREADS) scatter_daily_kernel(
    const void* __restrict__ idx, int idx64, const float* __restrict__ gains,
    const unsigned char* __restrict__ mask, const float* __restrict__ Y,
    float* __restrict__ out, int C, int k, int S, int D, int nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* pairs = reinterpret_cast<int2*>(smem);
  const int q0 = blockIdx.y * nq;
  const int nqh = min(nq, (D + 3) / 4 - q0);
  if (nqh <= 0) return;
  const int c0 = blockIdx.x * CELLS;
  const int nc = min(CELLS, C - c0);
  stage_pairs<1>(pairs, nullptr, idx, idx64, gains, 0, mask, (size_t)c0 * k, nc * k, k, S, D);
  __syncthreads();
  for (int item = threadIdx.x; item < nc * nqh; item += THREADS) {
    const int cl = item / nqh, ql = item - cl * nqh;
    const int col = VEC ? 4 * (q0 + ql) : 4 * q0 + ql;
    float acc[1][4];
    gather_quad<1, 1, VEC>(pairs + cl * (k + 1), nullptr, k, Y, 0, col, nqh, D, acc);
    float* o = out + (size_t)(c0 + cl) * D;
    if (VEC) {
      *reinterpret_cast<float4*>(o + col) = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (col + i * nqh < D) o[col + i * nqh] = acc[0][i];
    }
  }
}

// Entry B. grid.x: blocks of CELLS cells; grid.y: (month group, chunk of nq quads). With
// N == 1 there is one group, the 3 x dpm quads of the year; with N == 12 group m holds the
// quads that touch month m's slots.
template <int V, int G>
__global__ void __launch_bounds__(THREADS) scatter_daily_packed_kernel(
    const void* __restrict__ idx, int idx64, const float* __restrict__ gains,
    const unsigned char* __restrict__ mask, const float* __restrict__ Y,
    const float* __restrict__ normal, const unsigned char* __restrict__ ok,
    const int* __restrict__ slot_of_day, const float* __restrict__ scales,
    short* __restrict__ out, int N, int C, int k, int S, int dpm, int ndays, int nq,
    int nchunks, int reconcile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = 12 * dpm;
  const int group = blockIdx.y / nchunks, chunk = blockIdx.y - group * nchunks;
  const int s_lo = N == 1 ? 0 : group * dpm;  // the group's slots [s_lo, s_hi)
  const int s_hi = N == 1 ? D : s_lo + dpm;
  const int q0 = s_lo / 4 + chunk * nq;
  const int nqh = min(nq, (s_hi + 3) / 4 - q0);
  if (nqh <= 0) return;
  const int c0 = blockIdx.x * CELLS;
  const int nc = min(CELLS, C - c0);
  const int KP = k + 1;
  int2* pairs = reinterpret_cast<int2*>(smem);
  float* gain1 = reinterpret_cast<float*>(pairs + CELLS * KP);
  int* sday = reinterpret_cast<int*>(gain1 + (G == 2 ? CELLS * KP : 0));
  short* stage = reinterpret_cast<short*>(sday + 4 * nq);  // [v][slot][cell ^ quad swizzle]

  const int n = N == 1 ? 0 : group;
  stage_pairs<G>(pairs, gain1, idx, idx64, gains, (size_t)N * C * k, mask,
                 ((size_t)n * C + c0) * k, nc * k, k, S, D);
  // the calendar day of each of the block's slots, -1 where there is none
  const int slot0 = 4 * q0, nslots = 4 * nqh;
  for (int i = threadIdx.x; i < nslots; i += THREADS) sday[i] = -1;
  __syncthreads();
  for (int t = threadIdx.x; t < ndays; t += THREADS) {
    const int s = slot_of_day[t];
    if (s >= s_lo && s < s_hi && s >= slot0 && s < slot0 + nslots) sday[s - slot0] = t;
  }
  __syncthreads();

  float scale[V], offset[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    scale[v] = scales[2 * v];
    offset[v] = scales[2 * v + 1];
  }
  for (int item = threadIdx.x; item < nc * nqh; item += THREADS) {
    const int cl = item / nqh, ql = item - cl * nqh;
    float acc[V][4];
    gather_quad<V, G, true>(pairs + cl * KP, gain1 + cl * KP, k, Y, (size_t)S * D,
                            4 * (q0 + ql), 0, D, acc);
    const int cell_sw = cl ^ ((ql & (CELLS / 2 - 1)) << 1);
    int mcur = -1;
    float nrm[V];
    bool okk[V];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sl = 4 * ql + i;
      if (sday[sl] < 0) continue;
      const int m = (slot0 + sl) / dpm;
      if (m != mcur) {
        mcur = m;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const size_t at = ((size_t)v * 12 + m) * C + c0 + cl;
          nrm[v] = normal[at];
          okk[v] = ok[at] != 0;
        }
      }
      float x[V];
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = nrm[v] + acc[v][i];
      if (V == 2 && reconcile && okk[0] && okk[V - 1] && x[V - 1] < x[0])
        x[0] = x[V - 1] = 0.5f * (x[0] + x[V - 1]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float q = rintf((x[v] - offset[v]) / scale[v]);
        q = fminf(fmaxf(q, -32767.0f), 32767.0f);
        stage[(v * nslots + sl) * CELLS + cell_sw] = okk[v] ? (short)(int)q : (short)-32768;
      }
    }
  }
  __syncthreads();

  // one (variable, slot) row a warp at a time: the block's cells, contiguous in the product
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool words = (C & 1) == 0;  // every row of the product starts on a 4-byte boundary
  for (int row = warp; row < V * nslots; row += THREADS / 32) {
    const int v = row / nslots, sl = row - v * nslots;
    const int t = sday[sl];
    if (t < 0) continue;
    short* dst = out + ((size_t)v * (ndays + 24) + t) * C + c0;
    const short* src = stage + (size_t)row * CELLS;
    const int sw = (sl >> 2) & (CELLS / 2 - 1);
    for (int w = lane; w < CELLS / 2; w += 32) {
      const int cl = 2 * (w ^ sw);
      if (words && cl + 1 < nc) {
        *reinterpret_cast<uint32_t*>(dst + cl) = *reinterpret_cast<const uint32_t*>(src + 2 * w);
      } else {
        if (cl < nc) dst[cl] = src[2 * w];
        if (cl + 1 < nc) dst[cl + 1] = src[2 * w + 1];
      }
    }
  }
}

// Quads a block takes so that `total` quads split evenly into chunks of at most MAX_QUADS.
inline void split_quads(int total, int* nq, int* nchunks) {
  *nchunks = (total + MAX_QUADS - 1) / MAX_QUADS;
  *nq = (total + *nchunks - 1) / *nchunks;
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename Kernel>
int launch_packed(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const void* idx,
                  int idx64, const void* gains, const void* mask, const void* Y,
                  const void* normal, const void* ok, const void* slot_of_day,
                  const void* scales, void* out, int N, int C, int k, int S, int dpm, int ndays,
                  int nq, int nchunks, int reconcile) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(
      idx, idx64, static_cast<const float*>(gains), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(Y), static_cast<const float*>(normal),
      static_cast<const unsigned char*>(ok), static_cast<const int*>(slot_of_day),
      static_cast<const float*>(scales), static_cast<short*>(out), N, C, k, S, dpm, ndays, nq,
      nchunks, reconcile);
  return (int)cudaGetLastError();
}

}  // namespace

// idx (C, k) int32 or int64 (idx64), gains (C, k) float32, mask (C, k) bool, Y (S, D) float32,
// out (C, D) float32.
extern "C" int scatter_daily_launch(const void* idx, int idx64, const void* gains,
                                    const void* mask, const void* Y, void* out, int C, int k,
                                    int S, int D, void* stream) {
  const size_t smem = (size_t)CELLS * (k + 1) * sizeof(int2);
  if (C < 0 || k < 1 || S < 1 || D < 0 || smem > MAX_SMEM || (long long)S * D >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (C == 0 || D == 0) return 0;
  int nq, nchunks;
  split_quads((D + 3) / 4, &nq, &nchunks);
  if (nchunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + CELLS - 1) / CELLS, nchunks);
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(Y) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  auto kernel = vec ? scatter_daily_kernel<true> : scatter_daily_kernel<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, idx64, static_cast<const float*>(gains), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(Y), static_cast<float*>(out), C, k, S, D, nq);
  return (int)cudaGetLastError();
}

// idx, mask (N, C, k); gains (G, N, C, k); Y (V, S, 12 dpm); normal float32 and ok bool
// (V, 12, C); slot_of_day (ndays,) int32; scales (V, 2) float32 (scale, offset);
// out (V (ndays + 24), C) int16, of which rows v (ndays + 24) + t, t < ndays, are written.
extern "C" int scatter_daily_packed_launch(
    const void* idx, int idx64, const void* gains, int G, const void* mask, int N,
    const void* Y, int V, const void* normal, const void* ok, const void* slot_of_day,
    const void* scales, void* out, int C, int k, int S, int dpm, int ndays, int reconcile,
    void* stream) {
  if (C < 0 || k < 1 || S < 1 || dpm < 1 || ndays < 0 || (V != 1 && V != 2) ||
      (G != 1 && G != V) || (N != 1 && N != 12) ||
      (long long)V * S * 12 * dpm >= (1LL << 31) || (reinterpret_cast<uintptr_t>(Y) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0 || ndays == 0) return 0;
  int nq, nchunks;
  split_quads(N == 1 ? 3 * dpm : (dpm + 3) / 4 + 1, &nq, &nchunks);
  if ((long long)N * nchunks > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)CELLS * (k + 1) * (sizeof(int2) + (G == 2 ? sizeof(float) : 0)) +
                      (size_t)4 * nq * sizeof(int) + (size_t)V * 4 * nq * CELLS * sizeof(short);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + CELLS - 1) / CELLS, N * nchunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TOPO_PACKED(VV, GG)                                                                   \
  launch_packed(scatter_daily_packed_kernel<VV, GG>, grid, smem, st, idx, idx64, gains, mask, \
                Y, normal, ok, slot_of_day, scales, out, N, C, k, S, dpm, ndays, nq, nchunks, \
                reconcile)
  if (V == 1) return TOPO_PACKED(1, 1);
  if (G == 1) return TOPO_PACKED(2, 1);
  return TOPO_PACKED(2, 2);
#undef TOPO_PACKED
}
