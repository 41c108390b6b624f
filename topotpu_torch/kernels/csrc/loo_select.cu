// Leave-one-out k-nearest-station selection over a station pool, every month of a call in one
// launch, with no score matrix in device memory.
//
//   loo_select_launch: for S stations with unit vectors xyz (S, 3) float32 and validity valid
//   (S, M) bool, for every month m and every station q as the query, the k stations j != q
//   valid in month m with the largest cosine score u_q . u_j -> score (M, S, k) float32 and idx
//   (M, S, k) int64, sorted by score descending. Slots past the month's valid count hold score
//   -inf and idx 0.
//
// Replaces no TPU kernel: the JAX package's topotpu/geo/neighbors.py::select_neighbors leaves the
// cosine branch to XLA (a matmul, masked scores and lax.top_k). The port's plain version of it
// (topotpu_torch/kernels/loo_select.py::loo_select_ref, the cosine branch of select_neighbors
// with exclude_idx = arange(S), one month at a time) writes an S x S float32 score matrix a
// month (400 MB at S = 10,000), copies it through two masked fills and runs torch.topk's
// multi-pass radix select over it: ~3 ms a month on an H100, to keep at most 128 indices a row.
//
// Arithmetic: score = fma(x_q, x_j, fma(y_q, y_j, z_q * z_j)) in float32 (no fast-math): within
// a few ulps of the plain version's matmul, whose sums cuBLAS orders its own way. Candidates
// are ranked by (score descending, index ascending), so the kept set and its order are the
// same whatever order the scan meets them in; torch.topk orders equal scores its own way. A NaN
// score (a NaN coordinate) is never kept.
//
// What bounds it on an H100: the operations, S^2 x 5 a month (three products and sums, the
// compare; 1e8 pairs x 5 = 5e8 at S = 10,000: 7.5 us at 67 TFLOP/s); the bytes are the outputs,
// M x S x k x 12 (6.9 MB a month at k = 48: 2.1 us at 3.35 TB/s), the inputs 16 bytes a station.
//
// Design.
//   - The pool in a spatial order: loo_select_order writes each station's Morton code (x, y, z
//     at 21 bits each), the caller sorts them (torch.sort), and the launch's first pass packs
//     the table in that order: (x, y, z, validity bits of every month) as one float4 a
//     station, 16 bytes, 160 KB at S = 10,000, which stays in L2.
//   - One warp a query, WARPS = 8 queries a block, taken in the table's order, so the block's
//     queries lie close together and read the same table lines; the grid's y walks the months,
//     MB of them a warp (MB = 4 for a call of several months, 1 for one): the warp computes
//     each candidate's score once for its MB months and tests it against each month's
//     validity bit.
//   - The warp scans the table outward from its query's position, chunks of 32 stations
//     forward and backward in turn, UNROLL chunks a step, each lane reading one station of a
//     chunk (coalesced). Nearby stations come first, so each month's threshold (below) is near
//     its final value after the first few chunks and the rest of the scan is the fast path: a
//     test of every station against every month's threshold and one warp reduction a step. In
//     a random order of 10,000 stations the threshold rises slowly and ~k (1 + ln(S / k)) hits
//     reach the buffer (~300 at k = 48), in this order a small multiple of k.
//   - Each month of a warp keeps, in shared memory, an array of P = 64, 128 or 256 (score,
//     index) pairs (the least power of two >= 2k, at least 64): slots [0, k) the best k met so
//     far, in no order, [k, P) a buffer of at least k. A candidate is a hit when it is valid,
//     not the query, and better than the k-th kept (the threshold, -inf until k are kept).
//     Where the fast path flags a chunk and month, a ballot appends its hits to that month's
//     buffer in lane order. Before a batch of hits would overflow the buffer, keep_best_k finds
//     the k-th best pair of the array exactly (its score's bits one at a time, each by a count
//     over the warp: 32 reductions, no sort), compacts the best k into [0, k) and takes the
//     k-th as the new threshold. At the end the kept k are sorted once, by a bitonic sort in
//     shared memory, and written to the query's own rows.
//   - Nothing reaches device memory but the codes, the table and the outputs, each row
//     written once. Measured against the alternatives on an H100 (S = 10,000, 12 months,
//     k = 48): the pool's own order with a warp sort of the whole array at every overflow 3.2
//     ms; tiles staged through shared memory for the whole block by cp.async 5.4 ms (each
//     tile's barrier made every warp wait for the busiest); the exact select by key bits 2.3
//     ms; this order 1.3 ms.
//
// C interface: both entries launch on the given stream and return cudaGetLastError(), or
// cudaErrorInvalidValue for S < 0 (and for loo_select_launch M outside [1, 32], k outside
// [1, 128] or months_per_warp other than 1 or 4); S = 0 launches nothing. loo_select_order:
// xyz (S, 3) float32 -> code (S,) int64. loo_select_launch: xyz, valid (S, M) bool, perm (S,)
// int64 (the stations in the order of their codes), table (S, 4) float32 scratch -> score
// (M, S, k) float32, idx (M, S, k) int64. All arrays row-major and contiguous.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;   // queries a block
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;  // chunks of 32 stations a lane loads before it tests them
constexpr int MAX_K = 128;
constexpr unsigned FULL = 0xffffffffu;

// The 21 bits of v spread to every third bit of a 64-bit word.
__device__ __forceinline__ unsigned long long spread3(unsigned v) {
  unsigned long long x = v & 0x1fffffu;
  x = (x | (x << 32)) & 0x1f00000000ffffull;
  x = (x | (x << 16)) & 0x1f0000ff0000ffull;
  x = (x | (x << 8)) & 0x100f00f00f00f00full;
  x = (x | (x << 4)) & 0x10c30c30c30c30c3ull;
  x = (x | (x << 2)) & 0x1249249249249249ull;
  return x;
}

// Each station's Morton code: x, y and z in [-1, 1] at 21 bits each (~6 m on the earth's
// surface), interleaved.
__global__ void morton_kernel(const float* __restrict__ xyz, int64_t* __restrict__ code, int S) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= S) return;
  unsigned long long c = 0;
  for (int a = 0; a < 3; ++a) {
    const float v = fminf(fmaxf((xyz[3 * j + a] + 1.0f) * 0.5f, 0.0f), 1.0f);
    c |= spread3(min((unsigned)(v * 2097152.0f), 2097151u)) << a;
  }
  code[j] = (int64_t)c;
}

// The table in the stations' Morton order: at position i, station perm[i]'s (x, y, z) and the
// validity bits of every month.
__global__ void pack_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ valid,
                            const int64_t* __restrict__ perm, float4* __restrict__ table, int S,
                            int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  const int64_t j = perm[i];
  unsigned bits = 0;
  for (int m = 0; m < M; ++m) bits |= (valid[j * M + m] ? 1u : 0u) << m;
  table[i] = make_float4(xyz[3 * j], xyz[3 * j + 1], xyz[3 * j + 2], __uint_as_float(bits));
}

// (s, j) ranks before (t, tj): a higher score, or the same score and a lower index
__device__ __forceinline__ bool better(float s, int j, float t, int tj) {
  return s > t || (s == t && j < tj);
}

// A score as an unsigned key in the same order (-0 as +0, as better() has them; not for NaN,
// which is never kept).
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(s + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

struct Kth {
  float s;  // the k-th kept pair, the threshold: -inf while fewer than k are kept
  int j;
};

// Shared memory: the lists' scores [WARPS * MB][P], then their indices [WARPS * MB][P].
template <int P, int MB>
__device__ __forceinline__ float* list_scores(float* smem, int list) {
  return smem + list * P;
}

template <int P, int MB>
__device__ __forceinline__ int* list_idx(float* smem, int list) {
  return reinterpret_cast<int*>(smem + WARPS * MB * P) + list * P;
}

// Keep the best k of list ``list``'s P pairs (-inf scores are empty slots) in its slots
// [0, k), in no order, every other slot empty; return the k-th kept. The k-th largest score
// key is built bit by bit, each bit decided by the warp's count of the keys at or above it
// (32 counts, each one reduction); the pairs tied at it are cut by index the same way.
template <int P, int MB>
__device__ __noinline__ Kth keep_best_k(int list, int k, int lane) {
  constexpr int R = P / 32;
  extern __shared__ float smem[];
  float* s = list_scores<P, MB>(smem, list);
  int* x = list_idx<P, MB>(smem, list);
  __syncwarp();
  float sv[R];
  int xv[R];
  unsigned key[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sv[r] = s[r * 32 + lane];
    xv[r] = x[r * 32 + lane];
    key[r] = order_key(sv[r]);
  }
  unsigned T = 0;  // the k-th largest key
#pragma unroll 1
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned cand = T | (1u << bit);
    unsigned c = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) c += key[r] >= cand ? 1u : 0u;
    if (__reduce_add_sync(FULL, c) >= (unsigned)k) T = cand;
  }
  const float ts = key_score(T);
  const bool full = ts != -INFINITY;  // else every finite pair is kept
  int J = 0;  // the greatest index kept at T
  if (full) {
    unsigned above = 0, tied = 0;
    int tied_max = -1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      above += key[r] > T ? 1u : 0u;
      tied += key[r] == T ? 1u : 0u;
      if (key[r] == T) tied_max = max(tied_max, xv[r]);
    }
    const unsigned need = k - __reduce_add_sync(FULL, above);
    if (__reduce_add_sync(FULL, tied) == need) {
      J = __reduce_max_sync(FULL, tied_max);
    } else {  // equal scores across the cut: the need lowest indices among them
#pragma unroll 1
      for (int bit = 30; bit >= 0; --bit) {
        const int cand = J | (1 << bit);
        unsigned c = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) c += (key[r] == T && xv[r] < cand) ? 1u : 0u;
        if (__reduce_add_sync(FULL, c) < need) J = cand;
      }
    }
  }
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  int at = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool keep = sv[r] != -INFINITY && (key[r] > T || (key[r] == T && xv[r] <= J));
    const unsigned m = __ballot_sync(FULL, keep);
    if (keep) {
      s[at + __popc(m & lower)] = sv[r];
      x[at + __popc(m & lower)] = xv[r];
    }
    at += __popc(m);
  }
  __syncwarp();
  for (int t = at + lane; t < P; t += 32) {  // the buffer emptied too: no pair twice
    s[t] = -INFINITY;
    x[t] = 0;
  }
  __syncwarp();
  return full ? Kth{ts, J} : Kth{-INFINITY, 0};
}

// Sort list ``list``'s first n pairs (n a power of two) best first: a bitonic sort in shared
// memory, the warp's lanes taking the n / 2 compare-exchanges of each stage in turn.
template <int P, int MB>
__device__ __noinline__ void sort_best_first(int list, int n, int lane) {
  extern __shared__ float smem[];
  float* s = list_scores<P, MB>(smem, list);
  int* x = list_idx<P, MB>(smem, list);
  __syncwarp();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < n / 2; t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const float a = s[i], b = s[j];
        const int ia = x[i], ib = x[j];
        const bool first = (i & size) == 0;  // this run is sorted best first
        if (first ? better(b, ib, a, ia) : better(a, ia, b, ib)) {
          s[i] = b;
          s[j] = a;
          x[i] = ib;
          x[j] = ia;
        }
      }
      __syncwarp();
    }
  }
}

template <int P, int MB>
__global__ void __launch_bounds__(THREADS) loo_select_kernel(
    const float4* __restrict__ table, const int64_t* __restrict__ perm,
    float* __restrict__ score_out, int64_t* __restrict__ idx_out, int S, int M, int k) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + warp;  // the query's position in the table
  if (p >= S) return;  // the whole warp: no block-wide barrier follows
  const int m0 = blockIdx.y * MB;
  float* sc[MB];
  int* ix[MB];
  Kth th[MB];
  int n[MB];  // pairs in the buffer
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    sc[mb] = list_scores<P, MB>(smem, warp * MB + mb);
    ix[mb] = list_idx<P, MB>(smem, warp * MB + mb);
    for (int t = lane; t < P; t += 32) {
      sc[mb][t] = -INFINITY;
      ix[mb][t] = 0;
    }
    th[mb] = Kth{-INFINITY, 0};
    n[mb] = 0;
  }
  __syncwarp();
  const float4 me = table[p];
  const int cap = P - k;
  const unsigned lower = (1u << lane) - 1u;
  // chunks of 32 positions outward from p, forward and backward in turn: [p + 32a, + 32),
  // then [p - 32(b + 1), + 32); when one side ends, the rest of the other
  const int nf = (S - p + 31) / 32, nb = (p + 31) / 32, both = min(nf, nb);

  for (int c0 = 0; c0 < nf + nb; c0 += UNROLL) {
    float sj[UNROLL];
    unsigned bits[UNROLL];
    int pos[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u;
      int base;
      if (c < 2 * both)
        base = (c & 1) ? p - 32 * ((c >> 1) + 1) : p + 32 * (c >> 1);
      else
        base = nf > nb ? p + 32 * (c - both) : p - 32 * (c - both + 1);
      pos[u] = base + lane;
      const bool in = c < nf + nb && pos[u] >= 0 && pos[u] < S && pos[u] != p;
      const float4 x = in ? __ldg(table + pos[u]) : make_float4(0.f, 0.f, 0.f, 0.f);
      sj[u] = fmaf(me.x, x.x, fmaf(me.y, x.y, me.z * x.z));
      bits[u] = __float_as_uint(x.w) >> m0;  // 0 for the query itself and past the ends
    }
    unsigned near = 0;  // bit u * MB + mb: station u at or above month mb's threshold
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
        near |= (((bits[u] >> mb) & 1u) && sj[u] >= th[mb].s) ? 1u << (u * MB + mb) : 0u;
    near = __reduce_or_sync(FULL, near);
    if (near == 0u) continue;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!(near & (((1u << MB) - 1u) << (u * MB)))) continue;
      // the station's own index: ties go to the lower, and the lists keep it
      const int j = (bits[u] & ((1u << MB) - 1u)) ? (int)perm[pos[u]] : 0;
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        if (!(near & (1u << (u * MB + mb)))) continue;
        bool hit = ((bits[u] >> mb) & 1u) && better(sj[u], j, th[mb].s, th[mb].j);
        unsigned mask = __ballot_sync(FULL, hit);
        if (mask == 0u) continue;
        if (n[mb] + __popc(mask) > cap) {
          th[mb] = keep_best_k<P, MB>(warp * MB + mb, k, lane);
          n[mb] = 0;
          hit = hit && better(sj[u], j, th[mb].s, th[mb].j);
          mask = __ballot_sync(FULL, hit);
        }
        if (hit) {
          const int at = k + n[mb] + __popc(mask & lower);
          sc[mb][at] = sj[u];
          ix[mb][at] = j;
        }
        n[mb] += __popc(mask);
      }
    }
  }

  const size_t q = (size_t)perm[p];  // the query's own index: its rows
  int n2 = 32;  // the least power of two >= k, at least 32: the span the final sort takes
  while (n2 < k) n2 <<= 1;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const int m = m0 + mb;
    if (m >= M) break;
    keep_best_k<P, MB>(warp * MB + mb, k, lane);  // the best k in [0, k), [k, P) empty
    sort_best_first<P, MB>(warp * MB + mb, n2, lane);
    const size_t row = ((size_t)m * S + q) * k;
    for (int t = lane; t < k; t += 32) {
      score_out[row + t] = sc[mb][t];
      idx_out[row + t] = ix[mb][t];
    }
  }
}

// The array a warp keeps a month: the least power of two >= 2k, at least 64 (room for k kept
// and a buffer of at least k, and so for a batch of 32 hits once k are kept).
int pick_p(int k) { return k <= 32 ? 64 : (k <= 64 ? 128 : 256); }

template <int P, int MB>
cudaError_t launch(const float4* table, const int64_t* perm, float* score, int64_t* idx, int S,
                   int M, int k, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * MB * P * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        loo_select_kernel<P, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + WARPS - 1) / WARPS, (M + MB - 1) / MB);
  loo_select_kernel<P, MB><<<grid, THREADS, smem, stream>>>(table, perm, score, idx, S, M, k);
  return cudaSuccess;
}

template <int MB>
cudaError_t launch_mb(const float4* table, const int64_t* perm, float* score, int64_t* idx,
                      int S, int M, int k, cudaStream_t stream) {
  switch (pick_p(k)) {
    case 64:
      return launch<64, MB>(table, perm, score, idx, S, M, k, stream);
    case 128:
      return launch<128, MB>(table, perm, score, idx, S, M, k, stream);
    default:
      return launch<256, MB>(table, perm, score, idx, S, M, k, stream);
  }
}

}  // namespace

extern "C" int loo_select_order(const void* xyz, void* code, int S, void* stream) {
  if (S < 0) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  morton_kernel<<<(S + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<int64_t*>(code), S);
  return (int)cudaGetLastError();
}

extern "C" int loo_select_launch(const void* xyz, const void* valid, const void* perm, void* table,
                                 void* score, void* idx, int S, int M, int k, int months_per_warp,
                                 void* stream) {
  if (S < 0 || M < 1 || M > 32 || k < 1 || k > MAX_K ||
      (months_per_warp != 1 && months_per_warp != 4))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* tab = static_cast<float4*>(table);
  const int64_t* order = static_cast<const int64_t*>(perm);
  pack_kernel<<<(S + 255) / 256, 256, 0, st>>>(static_cast<const float*>(xyz),
                                               static_cast<const unsigned char*>(valid), order,
                                               tab, S, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* sc = static_cast<float*>(score);
  int64_t* ix = static_cast<int64_t*>(idx);
  err = months_per_warp == 1 ? launch_mb<1>(tab, order, sc, ix, S, M, k, st)
                             : launch_mb<4>(tab, order, sc, ix, S, M, k, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
