// Regression-kriging normals + anomaly-GWR gain rows, one warp per cell and
// neighbourhood, every (month, variable) system of the cell in one launch.
//
// Replaces: topotpu/kernels/pallas_krig.py::krig_normals_fused (body
// _normals_kernel). Per system it runs the chain of
// topotpu/interp/normals.py::krig_normals:
// adaptive distance weights -> point-centred, weighted-std-scaled design ->
// (q+1)^2 WLS trend with a trace-scaled ridge -> residuals -> distance-weighted
// nugget/psill/range -> pair distances from unit-sphere xyz (exact asinf) ->
// exponential covariance (masked rows folded to identity, plus jitter) ->
// Cholesky and two triangular solves (c0 and ones) -> SK->OK reduction ->
// normal = trend + lambda . resid; then the gain row w * (X_a A_a^-1 e0).
// Head values per system: [normal, variance, ok, trend, nugget, psill, range, 0].
//
// What bounds it on an H100: not device memory (a cell's neighbourhood is
// 9 k bytes in, 4 k + 32 P bytes out for P systems, and the station table is
// a few hundred KB that stays in L2) but instruction throughput and latency on
// the dependent chain of k factorisation steps. The design spends as few
// instruction slots a system as it can and shares all it can between systems:
//
//   * One launch covers all P systems of a tile step. The warp that owns a
//     (neighbourhood, cell) computes once what does not depend on the month
//     or the variable: the distance weights, the k (k - 1) / 2 pair distances
//     (sqrtf + asinf each; kept in shared memory in the order the assembly
//     reads them), the system-invariant design columns, and the gain rows.
//     Per system it rebuilds only the varying design column (lst_m), the
//     normal equations, the covariance, the factorisation and the solves.
//   * The indexed entry reads the neighbourhood as select_neighbors leaves
//     it, (N, C, k) row-major idx / dist / mask: a warp's 32 lanes read 32
//     consecutive slots of one cell, one 128-byte line (256 for int64
//     indices, 32 for the mask). Each lane then gathers its station's
//     columns straight from the (S, F) table through the read-only path: the
//     table is at most a few MB, so it lives in L2 and its hot rows in L1,
//     and a row's columns are consecutive, so a lane's loads walk one or two
//     cache lines. Staging rows in shared memory, by cp.async or TMA, would
//     add a copy for no reuse (each column is read once per system by one
//     lane), and TMA moves dense tiles, not rows picked by a per-lane index.
//     Outputs: head (P, C, 8), one 32-byte sector a (system, cell) written by
//     lanes 0-7; gains (N, C, k), a 128-byte line a cell.
//   * The factorisation keeps the matrix in registers, a row a lane
//     (krig_core.cuh): every lane does the same k - 1 - j updates at column
//     j with compile-time register indices, one warp barrier a column. The
//     p x p WLS systems are solved redundantly by every lane in registers
//     (the butterfly sums leave A and b on all lanes): no shared memory, no
//     barrier, no waiting on lane 0.
//   * Blocks are 4 warps; shared memory a warp is 7 KB at k <= 32 and
//     26.4 KB above (limit raised with cudaFuncSetAttribute), so the
//     register file, not shared memory, sets the resident warps.
//
// Exact fp32 throughout, but for the p x p normal equations of the trend and
// the gain rows, accumulated and solved in fp64 (solve_spd_small): no tensor
// cores, no TF32, no fast-math intrinsics.
// The solve core (pair distances, assembly, factorisation with its two
// solves, masked OK sums) is krig_core.cuh, which ok_solve.cu uses too.
//
// The gathered entry computes the whole function of krig_normals_fused: one
// system a cell from operands the caller has gathered, (C, k, ...) row-major
// as topotpu/interp/normals.py takes them, with any q >= 1 trend and qa >= 1
// anomaly covariates, q + qa <= 8 (the TPU kernel's (8, B) cell-covariate
// block). It runs the same krig_cell with every design column fixed (one
// system) and q, qa read at run time; the covariate bound MAXP - 1 is a
// template argument (4 while q and qa are at most 3, else 8), since the
// design and the normal equations live in registers with compile-time
// indices. A warp's 32 lanes read 32 consecutive slots of its cell: one
// 128-byte line of dist, 32 bytes of mask, and 12 or 4 q consecutive
// floats a lane of xyz, vario and the covariates. It reads every input
// byte once (33 k + 4 (q + qa) (k + 1) bytes a cell) and writes 32 + 4 k:
// under 2 KB a cell at k = 32 against some 25,000 operations, so here too
// the dependent chain, not memory, bounds it.
//
// The C entries launch on the given stream and return cudaGetLastError():
//   krig_normals_indexed_launch  idx (N, C, k) int32 or int64, dist (N, C, k)
//       float32, mask (N, C, k) bytes, table (S, F) float32 with columns
//       [elev, tdi, x_km, y_km, xyz(3), lst(12), per variable: norm(12),
//       vario(12 x 3)], cell (C, 16) float32 [elev, tdi, x_km, y_km, lst(12)],
//       the systems as host arrays of months and variables. With shared != 0,
//       N = 1 and every system uses that neighbourhood; else neighbourhood n
//       serves the systems of month n. 1 <= k <= 64. The systems use the
//       first k_normal slots and the gain rows the first k_anom (each in
//       1..k, each slot range with its own bandwidth); a gain row is 0 from
//       slot k_anom on.
//   krig_normals_gathered_launch  dist (C, k) float32, mask (C, k) bytes,
//       xyz (C, k, 3), cov (C, k, q), cell_cov (C, q), norm (C, k),
//       vario (C, k, 3), acov (C, k, qa), cell_acov (C, qa), all float32;
//       head (C, 8) and gains (C, k) out. 1 <= k <= 64, q, qa >= 1,
//       q + qa <= 8.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "krig_core.cuh"

// The library is compiled in three parts, one nvcc process each, all at once,
// and linked (kernels/_build.py::PARTS): part 0 the indexed entry, part 1 the
// gathered entry and its kernels at covariate bound 4, part 2 its kernels at
// bound 8. Compiled without TOPOTPU_PART, the file holds all three.
#ifdef TOPOTPU_PART
#define KN_PART(i) (TOPOTPU_PART == (i))
#else
#define KN_PART(i) 1
#endif

// The gathered entry's operands and settings (see the entry below).
struct GatheredArgs {
  const float* dist;
  const unsigned char* mask;
  const float *xyz, *cov, *cell_cov, *norm, *vario, *acov, *cell_acov;
  float *head, *gains;
  int C, k, q, qa, weight_kernel;
  float ridge, jitter_frac;
  int min_neighbors;
};

// Its launches at covariate bound 4 (part 1) and 8 (part 2).
cudaError_t krig_normals_gathered_narrow(const GatheredArgs& a,
                                         cudaStream_t stream);
cudaError_t krig_normals_gathered_wide(const GatheredArgs& a,
                                       cudaStream_t stream);

namespace {

using krig::warp_max;
using krig::warp_sum;

constexpr int HEAD = 8;          // head values a system
constexpr int MAX_SYSTEMS = 96;  // systems a launch (12 months x 8 variables)

// columns of the station table and of the cell table
constexpr int T_ELEV = 0, T_TDI = 1, T_X = 2, T_Y = 3, T_XYZ = 4, T_LST = 7,
              T_VAR = 19, T_VAR_COLS = 48, T_VARIO = 12;
constexpr int C_ELEV = 0, C_TDI = 1, C_X = 2, C_Y = 3, C_LST = 4, C_COLS = 16;

struct Systems {
  int n;
  int month[MAX_SYSTEMS];
  int var[MAX_SYSTEMS];
};

__device__ __forceinline__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// In-place Cholesky solve of a p x p SPD system held in registers (lower
// triangle of A, packed by rows); b is overwritten with x. Every lane solves
// the same system. In float64, as the normal equations are formed: they
// square the condition number of the point-centred design, up to ~1e6 where
// a cell lies outside its stations' covariates, and in float32 that put a
// k = 16 trend 0.033 C from float64 on an H100.
template <int MAXP>
__device__ __forceinline__ void solve_spd_small(
    double (&A)[MAXP * (MAXP + 1) / 2], double (&b)[MAXP], int p) {
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i < p) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        double s = A[tri(i, j)];
#pragma unroll
        for (int t = 0; t < j; ++t) s -= A[tri(i, t)] * A[tri(j, t)];
        A[tri(i, j)] = (i == j) ? sqrt(fmax(s, 1e-20)) : s / A[tri(j, j)];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i < p) {
      double s = b[i];
#pragma unroll
      for (int t = 0; t < i; ++t) s -= A[tri(i, t)] * b[t];
      b[i] = s / A[tri(i, i)];
    }
  }
#pragma unroll
  for (int i = MAXP - 1; i >= 0; --i) {
    if (i < p) {
      double s = b[i];
#pragma unroll
      for (int t = i + 1; t < MAXP; ++t)
        if (t < p) s -= A[tri(t, i)] * b[t];
      b[i] = s / A[tri(i, i)];
    }
  }
}

// One centred, weighted-std-scaled design column: (cov - cell value) /
// (weighted std + 1e-6) over this lane's slots; cov(r) is read for slots < k.
template <int R, class Cov>
__device__ __forceinline__ void design_col(Cov cov, float cv, int k, int lane,
                                           const float (&w)[R], float wsum,
                                           float (&x)[R]) {
  float dc[R];
  float sw = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dc[r] = lane + 32 * r < k ? cov(r) - cv : 0.0f;
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
  for (int r = 0; r < R; ++r) x[r] = dc[r] / scale;
}

// A = X^T W X + (ridge * mean diag + 1e-30) I, on every lane, accumulated
// in float64 from the float32 design (see solve_spd_small).
template <int R, int MAXP>
__device__ __forceinline__ void normal_eq(const float (&X)[MAXP][R],
                                          const float (&w)[R], int p,
                                          float ridge,
                                          double (&A)[MAXP * (MAXP + 1) / 2]) {
  double diag = 0.0;
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      if (i < p) {
        double a = 0.0;
#pragma unroll
        for (int r = 0; r < R; ++r) a += (double)w[r] * X[i][r] * X[j][r];
        a = warp_sum_f64(a);
        A[tri(i, j)] = a;
        if (i == j) diag += a;
      }
    }
  }
  const double reg = (double)ridge * (diag / p) + 1e-30;
#pragma unroll
  for (int i = 0; i < MAXP; ++i)
    if (i < p) A[tri(i, i)] += reg;
}

__device__ __forceinline__ float distance_weight(int kind, float d, float bw,
                                                 float m) {
  if (kind == 0) {  // bisquare
    const float rr = fminf(d / bw, 1.0f);
    const float b = 1.0f - rr * rr;
    return fmaxf(b * b, 1e-4f) * m;
  }
  if (kind == 1) {  // gaussian
    const float rb = d / bw;
    return expf(-0.5f * rb * rb) * m;
  }
  return m;  // uniform
}

// Adaptive-bandwidth distance weights over the first n slots: the slot mask
// m (0 from slot n on), the weights w and their warp sum. The bandwidth is
// the largest masked distance of those slots.
template <int R, class Src>
__device__ __forceinline__ float prefix_weights(const Src& src,
                                                const float (&d)[R], int n,
                                                int lane, int weight_kernel,
                                                float (&m)[R], float (&w)[R]) {
  float dmax = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = lane + 32 * r < n ? src.mask(r) : 0.0f;
    dmax = fmaxf(dmax, m[r] > 0.0f ? d[r] : 0.0f);
  }
  const float bw = fmaxf(warp_max(dmax), 1e-3f);
  float ws = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    w[r] = distance_weight(weight_kernel, d[r], bw, m[r]);
    ws += w[r];
  }
  return warp_sum(ws) + 1e-30f;
}

// The whole chain for one (neighbourhood, cell), all its systems, by one
// warp. Src says where the inputs lie and where the results go; ws is the
// warp's workspace (krig::Layout<R>). MAXP - 1 bounds the covariates of a
// design. The systems read the first kn of the k slots and the gain rows the
// first ka (1 <= kn, ka <= k): a slot beyond is masked.
template <int R, int MAXP, class Src>
__device__ __forceinline__ void krig_cell(const Src& src, float* ws, int lane,
                                          int k, int kn, int ka,
                                          int weight_kernel, float ridge,
                                          float jitter_frac,
                                          int min_neighbors) {
  using L = krig::Layout<R>;
  constexpr int K = L::K;
  float* sA = ws + L::A;
  float* sD = ws + L::D;
  float* scol = ws + L::COL;
  float* sm = ws + L::M;

  // ---- once: adaptive-bandwidth distance weights -------------------------
  float m[R], d[R], w[R];
#pragma unroll
  for (int r = 0; r < R; ++r) d[r] = lane + 32 * r < k ? src.dist(r) : 0.0f;
  float wsum = prefix_weights<R>(src, d, kn, lane, weight_kernel, m, w);

  // ---- once: pair distances, folded (xyz staged in the matrix's place) ---
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane + 32 * r;
    if (s < k) {
      src.xyz(r, sA[s], sA[K + s], sA[2 * K + s]);
      sm[s] = m[r];
    }
  }
  __syncwarp();
  float dd[R];
  krig::fill_pair_km<R>(sD, k, lane, dd, [&](int i, int j) {
    return krig::chord_km(sA, sA + K, sA + 2 * K, i, j);
  });
  __syncwarp();

  // ---- once: the design columns no system changes ------------------------
  float X[MAXP][R];
#pragma unroll
  for (int r = 0; r < R; ++r) X[0][r] = 1.0f;
  const int q = src.q();
  const int p = q + 1;
  const int qf = src.q_fixed();
#pragma unroll
  for (int i = 1; i < MAXP; ++i)
    if (i <= qf)
      design_col<R>([&](int r) { return src.cov(0, i - 1, r); },
                    src.cell_cov(0, i - 1), k, lane, w, wsum, X[i]);

  for (int sy = 0; sy < src.n_systems(); ++sy) {
    if (!src.runs(sy)) continue;  // uniform over the warp

    // ---- GWR trend: varying columns, WLS solve, residuals ---------------
#pragma unroll
    for (int i = 1; i < MAXP; ++i)
      if (i > qf && i <= q)
        design_col<R>([&](int r) { return src.cov(sy, i - 1, r); },
                      src.cell_cov(sy, i - 1), k, lane, w, wsum, X[i]);
    double A[MAXP * (MAXP + 1) / 2], b[MAXP];
    normal_eq<R, MAXP>(X, w, p, ridge, A);
    float nrm[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      nrm[r] = lane + 32 * r < k ? src.norm(sy, r) : 0.0f;
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      b[i] = 0.0;
      if (i < p) {
        double bi = 0.0;
#pragma unroll
        for (int r = 0; r < R; ++r) bi += (double)w[r] * X[i][r] * nrm[r];
        b[i] = warp_sum_f64(bi);
      }
    }
    solve_spd_small<MAXP>(A, b, p);
    float beta[MAXP];
#pragma unroll
    for (int i = 0; i < MAXP; ++i) beta[i] = (float)b[i];
    const float trend = beta[0];  // x0 = e0 after centring
    float resid[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float ta = beta[0] * X[0][r];
#pragma unroll
      for (int i = 1; i < MAXP; ++i)
        if (i < p) ta += beta[i] * X[i][r];
      resid[r] = (nrm[r] - ta) * m[r];
    }

    // ---- variogram parameters interpolated to the cell -------------------
    float vn = 0.0f, vp = 0.0f, vr = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (lane + 32 * r < k) {
        vn += w[r] * src.vario(sy, r, 0);
        vp += w[r] * src.vario(sy, r, 1);
        vr += w[r] * src.vario(sy, r, 2);
      }
    }
    const float nug = fmaxf(warp_sum(vn) / wsum, 0.0f);
    const float ps = fmaxf(warp_sum(vp) / wsum, 1e-6f);
    const float rg = fmaxf(fmaxf(warp_sum(vr) / wsum, 1e-2f), 1e-3f);
    const float sill = nug + ps;

    // ---- covariance, factorisation, the two solves -----------------------
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

    // ---- SK -> OK reduction and the kriged normal ------------------------
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
    if (lane < HEAD) {
      const float h = lane == 0   ? normal
                      : lane == 1 ? var
                      : lane == 2 ? (ok ? 1.0f : 0.0f)
                      : lane == 3 ? trend
                      : lane == 4 ? nug
                      : lane == 5 ? ps
                      : lane == 6 ? rg
                                  : 0.0f;
      src.put_head(sy, lane, h);
    }
    __syncwarp();  // the back substitution has read L before sA is rebuilt
  }

  // ---- once: anomaly-GWR gain rows on the first ka slots -----------------
  // With ka == kn they take the systems' weights, else the prefix's own
  // (the branch is uniform over the warp).
  if (ka != kn) wsum = prefix_weights<R>(src, d, ka, lane, weight_kernel, m, w);
  const int qa = src.qa();
  const int pa = qa + 1;
#pragma unroll
  for (int i = 1; i < MAXP; ++i)
    if (i <= qa)
      design_col<R>([&](int r) { return src.acov(i - 1, r); },
                    src.cell_acov(i - 1), k, lane, w, wsum, X[i]);
  double A[MAXP * (MAXP + 1) / 2], b[MAXP];
  normal_eq<R, MAXP>(X, w, pa, ridge, A);
#pragma unroll
  for (int i = 0; i < MAXP; ++i) b[i] = i == 0 ? 1.0 : 0.0;
  solve_spd_small<MAXP>(A, b, pa);
  float beta[MAXP];
#pragma unroll
  for (int i = 0; i < MAXP; ++i) beta[i] = (float)b[i];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane + 32 * r < k) {
      float gx = beta[0] * X[0][r];
#pragma unroll
      for (int i = 1; i < MAXP; ++i)
        if (i < pa) gx += beta[i] * X[i][r];
      src.put_gain(r, lane + 32 * r < ka ? w[r] * gx : 0.0f);
    }
  }
}

// Inputs gathered by index from the station table: q = qa = 3, of which the
// trend's elev and tdi columns are the same for every system.
template <int R>
struct IndexedSrc {
  const float* trow[R];       // this lane's station rows (slots < k)
  const float* crow;          // this cell's row of the cell table
  const float* distp;         // this (neighbourhood, cell)'s k slots
  const unsigned char* maskp;
  const Systems* sys;
  float* head;                // (P, C, 8)
  float* gainp;               // this (neighbourhood, cell)'s k gains
  size_t C, c;
  int lane, nbr, shared;

  __device__ int q() const { return 3; }
  __device__ int qa() const { return 3; }
  __device__ int q_fixed() const { return 2; }
  __device__ int n_systems() const { return sys->n; }
  __device__ bool runs(int sy) const {
    return shared || sys->month[sy] == nbr;
  }
  __device__ float mask(int r) const {
    return maskp[lane + 32 * r] ? 1.0f : 0.0f;
  }
  __device__ float dist(int r) const { return distp[lane + 32 * r]; }
  __device__ void xyz(int r, float& x, float& y, float& z) const {
    x = __ldg(trow[r] + T_XYZ);
    y = __ldg(trow[r] + T_XYZ + 1);
    z = __ldg(trow[r] + T_XYZ + 2);
  }
  __device__ float cov(int sy, int i, int r) const {
    return __ldg(trow[r] + (i == 0   ? T_ELEV
                            : i == 1 ? T_TDI
                                     : T_LST + sys->month[sy]));
  }
  __device__ float cell_cov(int sy, int i) const {
    return __ldg(crow + (i == 0   ? C_ELEV
                         : i == 1 ? C_TDI
                                  : C_LST + sys->month[sy]));
  }
  __device__ float acov(int i, int r) const {
    return __ldg(trow[r] + (i == 0 ? T_ELEV : i == 1 ? T_X : T_Y));
  }
  __device__ float cell_acov(int i) const {
    return __ldg(crow + (i == 0 ? C_ELEV : i == 1 ? C_X : C_Y));
  }
  __device__ float norm(int sy, int r) const {
    return __ldg(trow[r] + T_VAR + T_VAR_COLS * sys->var[sy] + sys->month[sy]);
  }
  __device__ float vario(int sy, int r, int j) const {
    return __ldg(trow[r] + T_VAR + T_VAR_COLS * sys->var[sy] + T_VARIO +
                 3 * sys->month[sy] + j);
  }
  __device__ void put_head(int sy, int i, float v) const {
    head[((size_t)sy * C + c) * HEAD + i] = v;
  }
  __device__ void put_gain(int r, float g) const {
    gainp[lane + 32 * r] = g;
  }
};

// Inputs gathered by the caller, one system a cell: q and qa at run time,
// every design column fixed.
template <int R>
struct GatheredSrc {
  const float* distp;         // this cell's k slots, then 3 k, q k, qa k
  const unsigned char* maskp;
  const float* xyzp;
  const float* covp;
  const float* ccovp;         // this cell's q trend covariates
  const float* normp;
  const float* variop;
  const float* acovp;
  const float* cacovp;        // this cell's qa anomaly covariates
  float* headp;               // this cell's 8 head values
  float* gainp;               // this cell's k gains
  int lane, nq, nqa;

  __device__ int q() const { return nq; }
  __device__ int qa() const { return nqa; }
  __device__ int q_fixed() const { return nq; }
  __device__ int n_systems() const { return 1; }
  __device__ bool runs(int) const { return true; }
  __device__ float mask(int r) const {
    return maskp[lane + 32 * r] ? 1.0f : 0.0f;
  }
  __device__ float dist(int r) const { return __ldg(distp + lane + 32 * r); }
  __device__ void xyz(int r, float& x, float& y, float& z) const {
    const float* p = xyzp + 3 * (lane + 32 * r);
    x = __ldg(p);
    y = __ldg(p + 1);
    z = __ldg(p + 2);
  }
  __device__ float cov(int, int i, int r) const {
    return __ldg(covp + nq * (lane + 32 * r) + i);
  }
  __device__ float cell_cov(int, int i) const { return __ldg(ccovp + i); }
  __device__ float acov(int i, int r) const {
    return __ldg(acovp + nqa * (lane + 32 * r) + i);
  }
  __device__ float cell_acov(int i) const { return __ldg(cacovp + i); }
  __device__ float norm(int, int r) const {
    return __ldg(normp + lane + 32 * r);
  }
  __device__ float vario(int, int r, int j) const {
    return __ldg(variop + 3 * (lane + 32 * r) + j);
  }
  __device__ void put_head(int, int i, float v) const { headp[i] = v; }
  __device__ void put_gain(int r, float g) const {
    gainp[lane + 32 * r] = g;
  }
};

template <int R>
__global__ void __launch_bounds__(32 * krig::WARPS_PER_BLOCK,
                                  krig::min_blocks(R))
krig_normals_indexed_kernel(
    const void* __restrict__ idx, int idx64, const float* __restrict__ dist,
    const unsigned char* __restrict__ mask, const float* __restrict__ table,
    int S, int F, const float* __restrict__ cell,
    const __grid_constant__ Systems sys, int shared, float* __restrict__ head,
    float* __restrict__ gains, int N, int C, int k, int k_normal, int k_anom,
    int weight_kernel, float ridge, float jitter_frac, int min_neighbors) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t g = (size_t)blockIdx.x * krig::WARPS_PER_BLOCK + warp;
  if (g >= (size_t)N * C) return;  // whole warps only: no block barrier follows
  const int nbr = (int)(g / C);

  IndexedSrc<R> src;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane + 32 * r;
    long long id = 0;
    if (s < k)
      id = idx64 ? static_cast<const long long*>(idx)[g * k + s]
                 : static_cast<const int*>(idx)[g * k + s];
    // An index outside the table is clamped to its first or last row, as the
    // plain version clamps it: in a masked slot the row read is inert, in a
    // valid slot the system is solved with that row.
    id = id < 0 ? 0 : (id >= S ? S - 1 : id);
    src.trow[r] = table + (size_t)id * F;
  }
  src.c = g - (size_t)nbr * C;
  src.C = C;
  src.crow = cell + src.c * C_COLS;
  src.distp = dist + g * k;
  src.maskp = mask + g * k;
  src.sys = &sys;
  src.head = head;
  src.gainp = gains + g * k;
  src.lane = lane;
  src.nbr = nbr;
  src.shared = shared;
  krig_cell<R, 4>(src,
                  reinterpret_cast<float*>(smem4) + warp * krig::Layout<R>::FLOATS,
                  lane, k, k_normal, k_anom, weight_kernel, ridge, jitter_frac,
                  min_neighbors);
}

template <int R, int MAXP>
__global__ void __launch_bounds__(32 * krig::WARPS_PER_BLOCK,
                                  krig::min_blocks(R))
krig_normals_gathered_kernel(const __grid_constant__ GatheredArgs a) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t c = (size_t)blockIdx.x * krig::WARPS_PER_BLOCK + warp;
  if (c >= (size_t)a.C) return;  // whole warps only: no block barrier follows

  const size_t k = a.k;
  GatheredSrc<R> src;
  src.distp = a.dist + c * k;
  src.maskp = a.mask + c * k;
  src.xyzp = a.xyz + c * 3 * k;
  src.covp = a.cov + c * a.q * k;
  src.ccovp = a.cell_cov + c * a.q;
  src.normp = a.norm + c * k;
  src.variop = a.vario + c * 3 * k;
  src.acovp = a.acov + c * a.qa * k;
  src.cacovp = a.cell_acov + c * a.qa;
  src.headp = a.head + c * HEAD;
  src.gainp = a.gains + c * k;
  src.lane = lane;
  src.nq = a.q;
  src.nqa = a.qa;
  krig_cell<R, MAXP>(
      src, reinterpret_cast<float*>(smem4) + warp * krig::Layout<R>::FLOATS,
      lane, a.k, a.k, a.k, a.weight_kernel, a.ridge, a.jitter_frac,
      a.min_neighbors);
}

bool bad_common(int k, int weight_kernel) {
  return k < 1 || k > 64 || weight_kernel < 0 || weight_kernel > 2;
}

template <int R>
cudaError_t launch_indexed(const void* idx, int idx64, const float* dist,
                           const unsigned char* mask, const float* table,
                           int S, int F, const float* cell, const Systems& sys,
                           int shared, float* head, float* gains, int N, int C,
                           int k, int k_normal, int k_anom, int weight_kernel,
                           float ridge, float jitter_frac, int min_neighbors,
                           cudaStream_t stream) {
  size_t bytes;
  cudaError_t err =
      krig::shared_bytes<R>(krig_normals_indexed_kernel<R>, &bytes);
  if (err != cudaSuccess) return err;
  const size_t warps = (size_t)N * C;
  const dim3 grid((unsigned)((warps + krig::WARPS_PER_BLOCK - 1) /
                             krig::WARPS_PER_BLOCK));
  krig_normals_indexed_kernel<R>
      <<<grid, 32 * krig::WARPS_PER_BLOCK, bytes, stream>>>(
          idx, idx64, dist, mask, table, S, F, cell, sys, shared, head, gains,
          N, C, k, k_normal, k_anom, weight_kernel, ridge, jitter_frac,
          min_neighbors);
  return cudaGetLastError();
}

template <int R, int MAXP>
cudaError_t launch_gathered(const GatheredArgs& a, cudaStream_t stream) {
  size_t bytes;
  cudaError_t err =
      krig::shared_bytes<R>(krig_normals_gathered_kernel<R, MAXP>, &bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(((size_t)a.C + krig::WARPS_PER_BLOCK - 1) /
                             krig::WARPS_PER_BLOCK));
  krig_normals_gathered_kernel<R, MAXP>
      <<<grid, 32 * krig::WARPS_PER_BLOCK, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int MAXP>
cudaError_t launch_gathered_k(const GatheredArgs& a, cudaStream_t stream) {
  return a.k <= 32 ? launch_gathered<1, MAXP>(a, stream)
                   : launch_gathered<2, MAXP>(a, stream);
}

}  // namespace

#if KN_PART(0)
extern "C" int krig_normals_indexed_launch(
    const void* idx, int idx64, const void* dist, const void* mask,
    const void* table, int S, int F, const void* cell, const int* months,
    const int* vars, int n_systems, int shared, void* head, void* gains, int N,
    int C, int k, int k_normal, int k_anom, float ridge, float jitter_frac,
    int min_neighbors, int weight_kernel, void* stream) {
  if (bad_common(k, weight_kernel) || k_normal < 1 || k_normal > k ||
      k_anom < 1 || k_anom > k || N < 1 || C < 0 || S < 1 ||
      n_systems < 0 || n_systems > MAX_SYSTEMS || F < T_VAR ||
      (F - T_VAR) % T_VAR_COLS != 0 || (shared && N != 1) ||
      (!shared && N != 12))
    return (int)cudaErrorInvalidValue;
  Systems sys;
  sys.n = n_systems;
  for (int i = 0; i < MAX_SYSTEMS; ++i) {
    sys.month[i] = i < n_systems ? months[i] : 0;
    sys.var[i] = i < n_systems ? vars[i] : 0;
    if (sys.month[i] < 0 || sys.month[i] > 11 || sys.var[i] < 0 ||
        T_VAR + T_VAR_COLS * (sys.var[i] + 1) > F)
      return (int)cudaErrorInvalidValue;
  }
  if (C == 0) return 0;
#define KI_ARGS                                                              \
  idx, idx64, static_cast<const float*>(dist),                               \
      static_cast<const unsigned char*>(mask),                               \
      static_cast<const float*>(table), S, F,                                \
      static_cast<const float*>(cell), sys, shared,                          \
      static_cast<float*>(head), static_cast<float*>(gains), N, C, k,        \
      k_normal, k_anom, weight_kernel, ridge, jitter_frac, min_neighbors,    \
      static_cast<cudaStream_t>(stream)
  const cudaError_t err =
      k <= 32 ? launch_indexed<1>(KI_ARGS) : launch_indexed<2>(KI_ARGS);
#undef KI_ARGS
  return (int)err;
}

#endif

#if KN_PART(1)
cudaError_t krig_normals_gathered_narrow(const GatheredArgs& a,
                                         cudaStream_t stream) {
  return launch_gathered_k<4>(a, stream);
}

extern "C" int krig_normals_gathered_launch(
    const void* dist, const void* mask, const void* xyz, const void* cov,
    const void* cell_cov, const void* norm, const void* vario,
    const void* acov, const void* cell_acov, void* head, void* gains, int C,
    int k, int q, int qa, float ridge, float jitter_frac, int min_neighbors,
    int weight_kernel, void* stream) {
  if (bad_common(k, weight_kernel) || C < 0 || q < 1 || qa < 1 || q + qa > 8)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const GatheredArgs a{static_cast<const float*>(dist),
                       static_cast<const unsigned char*>(mask),
                       static_cast<const float*>(xyz),
                       static_cast<const float*>(cov),
                       static_cast<const float*>(cell_cov),
                       static_cast<const float*>(norm),
                       static_cast<const float*>(vario),
                       static_cast<const float*>(acov),
                       static_cast<const float*>(cell_acov),
                       static_cast<float*>(head),
                       static_cast<float*>(gains),
                       C, k, q, qa, weight_kernel, ridge, jitter_frac,
                       min_neighbors};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // MAXP - 1 bounds q and qa
  const cudaError_t err = q > 3 || qa > 3 ? krig_normals_gathered_wide(a, st)
                                          : krig_normals_gathered_narrow(a, st);
  return (int)err;
}
#endif

#if KN_PART(2)
cudaError_t krig_normals_gathered_wide(const GatheredArgs& a,
                                       cudaStream_t stream) {
  return launch_gathered_k<8>(a, stream);
}
#endif
