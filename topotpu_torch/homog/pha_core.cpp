// Pairwise-homogenization numeric core.
//
// Parity target: the role of NCEI's PHA v52i Fortran executable in the
// reference pipeline (SURVEY.md §2.7, §3.5): detect changepoints in
// pairwise monthly difference series and estimate step adjustments. The
// reference serializes its station DB to PHA's input tree and shells out;
// here the detector is an in-process C library (host-side: this stage is
// serial and data-small) driven from topotpu_torch/homog/pha.py via ctypes.
// The port's own copy of the JAX package's homog/pha_core.cpp.
//
// Implemented: batched SNHT (standard normal homogeneity test) changepoint
// detection with binary segmentation over NaN-tolerant monthly difference
// series, segment-mean step estimation, and Lund–Reeves/minbic-style break
// model selection (const / trend / step / sloped step / two independent
// trends, chosen by BIC) with a t-statistic on the step so significance is
// amplitude-dependent. The attribution voting and adjustment application
// live in Python (cheap, and easier to audit).
//
// Build: g++ -O3 -march=native -shared -fPIC pha_core.cpp -o libpha.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// SNHT critical value ~95% as a function of series length n (Khaliq &
// Ouarda 2007 interpolation; asymptote near 9.9 for large n).
double snht_crit(int n) {
    if (n < 10) return 1e30;  // too short to test
    static const int    ns[]   = {10,  20,  30,  40,  50,  70,  100, 150, 250, 500, 1000, 5000};
    static const double crit[] = {5.7, 6.95, 7.65, 8.1, 8.45, 8.8, 9.15, 9.55, 9.7, 10.0, 10.2, 10.5};
    if (n >= ns[11]) return crit[11];
    int i = 0;
    while (n > ns[i + 1]) ++i;
    double f = double(n - ns[i]) / double(ns[i + 1] - ns[i]);
    return crit[i] + f * (crit[i + 1] - crit[i]);
}

// One SNHT scan over x[lo:hi) using only finite entries.
// Returns best split index (absolute, in [lo+minseg, hi-minseg)) or -1.
int snht_scan(const float* x, int lo, int hi, int minseg, double* stat_out) {
    std::vector<double> vals;
    std::vector<int> idx;
    vals.reserve(hi - lo);
    for (int t = lo; t < hi; ++t) {
        if (std::isfinite(x[t])) { vals.push_back(x[t]); idx.push_back(t); }
    }
    int n = (int)vals.size();
    if (n < 2 * minseg) { *stat_out = 0.0; return -1; }

    double mean = 0.0;
    for (double v : vals) mean += v;
    mean /= n;
    double var = 0.0;
    for (double v : vals) var += (v - mean) * (v - mean);
    var /= n;
    if (var < 1e-12) { *stat_out = 0.0; return -1; }
    double sd = std::sqrt(var);

    // prefix sums of standardized values
    double best = 0.0;
    int best_k = -1;
    double cum = 0.0;
    for (int k = 1; k < n; ++k) {
        cum += (vals[k - 1] - mean) / sd;
        if (k < minseg || n - k < minseg) continue;
        double z1 = cum / k;
        double z2 = -cum / (n - k);
        double T = k * z1 * z1 + (n - k) * z2 * z2;
        if (T > best) { best = T; best_k = k; }
    }
    *stat_out = best;
    if (best_k < 0 || best < snht_crit(n)) return -1;
    // split AFTER observation best_k-1: first month of the new segment
    return idx[best_k];
}

void segment_recurse(const float* x, int lo, int hi, int minseg, int max_breaks,
                     int* breaks, double* stats, int* n_found) {
    if (*n_found >= max_breaks) return;
    double stat;
    int split = snht_scan(x, lo, hi, minseg, &stat);
    if (split < 0) return;
    breaks[*n_found] = split;
    stats[*n_found] = stat;
    (*n_found)++;
    segment_recurse(x, lo, split, minseg, max_breaks, breaks, stats, n_found);
    segment_recurse(x, split, hi, minseg, max_breaks, breaks, stats, n_found);
}

// Simple linear regression of v on t over a point list. Returns false if
// degenerate (n < 3 or no time spread). Outputs intercept a, slope b, SSE,
// plus n, tbar and Sxx (= sum (t-tbar)^2) for fitted-value variance.
struct LinFit {
    double a, b, sse, tbar, sxx;
    int n;
};

bool lin_fit(const std::vector<double>& ts, const std::vector<double>& vs,
             int lo, int hi, LinFit* out) {
    int n = hi - lo;
    if (n < 3) return false;
    double st = 0.0, sv = 0.0;
    for (int i = lo; i < hi; ++i) { st += ts[i]; sv += vs[i]; }
    double tbar = st / n, vbar = sv / n;
    double sxx = 0.0, sxy = 0.0;
    for (int i = lo; i < hi; ++i) {
        double dt = ts[i] - tbar;
        sxx += dt * dt;
        sxy += dt * (vs[i] - vbar);
    }
    if (sxx < 1e-12) return false;
    double b = sxy / sxx;
    double a = vbar - b * tbar;
    double sse = 0.0;
    for (int i = lo; i < hi; ++i) {
        double r = vs[i] - (a + b * ts[i]);
        sse += r * r;
    }
    *out = {a, b, sse, tbar, sxx, n};
    return true;
}

constexpr double kBicInf = 1e30;

double bic(double sse, int n, int p) {
    // n*ln(SSE/n) + p*ln(n); variance term common to all models, dropped.
    double ms = sse / n;
    if (ms < 1e-12) ms = 1e-12;  // perfect fits: floor, still wins
    return n * std::log(ms) + p * std::log((double)n);
}

}  // namespace

extern "C" {

// Lund–Reeves / PHA-minbic break model selection at a candidate break.
// Fits five mean-function models to the finite points of x[lo:hi) with the
// break between months brk-1 and brk:
//   0  constant mean, no break
//   1  single linear trend, no break       (trend contamination, NOT a step)
//   2  step: two constant means            (TPR0)
//   3  step + common slope                 (TPR1; step unbiased by trend)
//   4  two independent linear segments     (TPR2; step = offset at brk)
// Picks the minimum-BIC model. *step_out is the fitted offset at the break
// (0 for models 0/1); *tstat_out the t-statistic of that offset, making
// retention amplitude-dependent: a small step in noisy/short segments gets
// a small t and is rejected by the Python caller's threshold.
// Returns the chosen model id, or -1 if either side has < min_side finite
// months (models 2-4 excluded; then returns 0/1 best-of with step 0).
int pha_break_model(const float* x, int T, int brk, int lo, int hi,
                    int min_side, double* step_out, double* tstat_out) {
    *step_out = 0.0;
    *tstat_out = 0.0;
    if (lo < 0 || hi > T || brk <= lo || brk >= hi) return -1;

    std::vector<double> ts, vs;
    ts.reserve(hi - lo);
    int n1 = 0;  // finite points strictly before brk
    for (int t = lo; t < hi; ++t) {
        if (!std::isfinite(x[t])) continue;
        if (t < brk) ++n1;
        ts.push_back((double)t);
        vs.push_back((double)x[t]);
    }
    int n = (int)ts.size();
    int n2 = n - n1;
    if (n < 8) return -1;

    double best_bic = kBicInf;
    int best_model = -1;
    double best_step = 0.0, best_t = 0.0;

    // --- model 0: constant mean
    {
        double sv = 0.0;
        for (double v : vs) sv += v;
        double m = sv / n, sse = 0.0;
        for (double v : vs) sse += (v - m) * (v - m);
        best_bic = bic(sse, n, 1);
        best_model = 0;
    }

    // --- model 1: single trend
    {
        LinFit f;
        if (lin_fit(ts, vs, 0, n, &f)) {
            double b1 = bic(f.sse, n, 2);
            if (b1 < best_bic) { best_bic = b1; best_model = 1; }
        }
    }

    bool sides_ok = n1 >= min_side && n2 >= min_side;

    // --- model 2: step, two constant means
    if (sides_ok) {
        double s1 = 0.0, s2 = 0.0;
        for (int i = 0; i < n1; ++i) s1 += vs[i];
        for (int i = n1; i < n; ++i) s2 += vs[i];
        double m1 = s1 / n1, m2 = s2 / n2, sse = 0.0;
        for (int i = 0; i < n1; ++i) sse += (vs[i] - m1) * (vs[i] - m1);
        for (int i = n1; i < n; ++i) sse += (vs[i] - m2) * (vs[i] - m2);
        double b2 = bic(sse, n, 2);
        if (b2 < best_bic) {
            best_bic = b2;
            best_model = 2;
            best_step = m2 - m1;
            double s2e = sse / std::max(n - 2, 1);
            double se = std::sqrt(s2e * (1.0 / n1 + 1.0 / n2));
            best_t = se > 0 ? best_step / se : 0.0;
        }
    }

    // --- model 3: step + common slope  v = a + b*t + c*1[t>=brk]
    if (sides_ok && n >= 10) {
        // Normal equations for design [1, t, d]; solve 3x3 by elimination.
        double Sd = n2, St = 0.0, Std = 0.0, Stt = 0.0;
        double Sv = 0.0, Stv = 0.0, Sdv = 0.0;
        for (int i = 0; i < n; ++i) {
            double t = ts[i], d = (i >= n1) ? 1.0 : 0.0, v = vs[i];
            St += t; Stt += t * t; Std += t * d;
            Sv += v; Stv += t * v; Sdv += d * v;
        }
        double A[3][4] = {
            {(double)n, St,  Sd,  Sv},
            {St,        Stt, Std, Stv},
            {Sd,        Std, Sd,  Sdv},
        };
        // Gaussian elimination with partial pivoting; also invert for se(c)
        // via adjugate of the 3x3 (cheap closed form).
        double M[3][3] = {{A[0][0], A[0][1], A[0][2]},
                          {A[1][0], A[1][1], A[1][2]},
                          {A[2][0], A[2][1], A[2][2]}};
        double det = M[0][0] * (M[1][1] * M[2][2] - M[1][2] * M[2][1])
                   - M[0][1] * (M[1][0] * M[2][2] - M[1][2] * M[2][0])
                   + M[0][2] * (M[1][0] * M[2][1] - M[1][1] * M[2][0]);
        if (std::fabs(det) > 1e-9) {
            bool ok = true;
            for (int col = 0; col < 3; ++col) {
                int piv = col;
                for (int r = col + 1; r < 3; ++r)
                    if (std::fabs(A[r][col]) > std::fabs(A[piv][col])) piv = r;
                if (std::fabs(A[piv][col]) < 1e-12) { ok = false; break; }
                for (int c2 = 0; c2 < 4; ++c2) std::swap(A[col][c2], A[piv][c2]);
                for (int r = 0; r < 3; ++r) {
                    if (r == col) continue;
                    double f = A[r][col] / A[col][col];
                    for (int c2 = col; c2 < 4; ++c2) A[r][c2] -= f * A[col][c2];
                }
            }
            if (ok) {
                double a = A[0][3] / A[0][0];
                double b = A[1][3] / A[1][1];
                double c = A[2][3] / A[2][2];
                double sse = 0.0;
                for (int i = 0; i < n; ++i) {
                    double d = (i >= n1) ? 1.0 : 0.0;
                    double r = vs[i] - (a + b * ts[i] + c * d);
                    sse += r * r;
                }
                double b3 = bic(sse, n, 3);
                if (b3 < best_bic) {
                    best_bic = b3;
                    best_model = 3;
                    best_step = c;
                    // [(X'X)^{-1}]_{cc} = cofactor_22 / det
                    double cof22 = M[0][0] * M[1][1] - M[0][1] * M[1][0];
                    double invcc = cof22 / det;
                    double s2e = sse / std::max(n - 3, 1);
                    double se = invcc > 0 ? std::sqrt(s2e * invcc) : 0.0;
                    best_t = se > 0 ? c / se : 0.0;
                }
            }
        }
    }

    // --- model 4: two independent linear segments; step = offset at brk
    if (sides_ok && n1 >= 6 && n2 >= 6) {
        LinFit f1, f2;
        if (lin_fit(ts, vs, 0, n1, &f1) && lin_fit(ts, vs, n1, n, &f2)) {
            double sse = f1.sse + f2.sse;
            double b4 = bic(sse, n, 4);
            if (b4 < best_bic) {
                double tb = (double)brk - 0.5;  // between last-before, first-after
                double step = (f2.a + f2.b * tb) - (f1.a + f1.b * tb);
                double s2e = sse / std::max(n - 4, 1);
                double v1 = s2e * (1.0 / f1.n + (tb - f1.tbar) * (tb - f1.tbar) / f1.sxx);
                double v2 = s2e * (1.0 / f2.n + (tb - f2.tbar) * (tb - f2.tbar) / f2.sxx);
                double se = std::sqrt(v1 + v2);
                best_bic = b4;
                best_model = 4;
                best_step = step;
                best_t = se > 0 ? step / se : 0.0;
            }
        }
    }

    *step_out = best_step;
    *tstat_out = best_t;
    return best_model;
}

// Detect changepoints in a batch of difference series.
//   series:  (n_series, T) row-major float32, NaN = missing
//   breaks:  (n_series, max_breaks) int32 out, -1 padded
//   stats:   (n_series, max_breaks) float64 out
// Returns 0.
int pha_detect_breaks(const float* series, int n_series, int T, int minseg,
                      int max_breaks, int32_t* breaks, double* stats) {
    for (int s = 0; s < n_series; ++s) {
        const float* x = series + (size_t)s * T;
        int32_t* b = breaks + (size_t)s * max_breaks;
        double* st = stats + (size_t)s * max_breaks;
        for (int i = 0; i < max_breaks; ++i) { b[i] = -1; st[i] = 0.0; }
        int n_found = 0;
        std::vector<int> tmp(max_breaks, -1);
        std::vector<double> tst(max_breaks, 0.0);
        segment_recurse(x, 0, T, minseg, max_breaks, tmp.data(), tst.data(), &n_found);
        for (int i = 0; i < n_found; ++i) { b[i] = tmp[i]; st[i] = tst[i]; }
    }
    return 0;
}


}  // extern "C"
