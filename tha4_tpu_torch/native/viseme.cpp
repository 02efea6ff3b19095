// Native viseme decomposition: the pose converter's fixed 300-step projected
// gradient of ||d @ M - p||_2 + 0.01 ||d||_1 over d in [0,1]^4
// (tha4_tpu_torch/mocap/ifacialmocap_pose_converter.py,
// solve_viseme_decomposition) in one call instead of a Python loop of numpy
// calls, with the same bits.
//
// Bit equality comes from doing what numpy does, step for step:
//   * the two vector-matrix products and the dot product go through the very
//     cblas_dgemv and cblas_ddot that numpy's matmul and dot call, with the
//     argument tuples numpy passes; their addresses are resolved in numpy's
//     own BLAS library by the caller (whose kernels, and so whose order of
//     summation, depend on the CPU), never re-derived here;
//   * every elementwise step is one IEEE operation, in numpy's order, and
//     clip and sign follow numpy's float64 loops (NaN included).
// It must be built with -ffp-contract=off, so that no multiply and add is
// fused where FMA is baseline (aarch64); the loader does.
//
// Exposed as a plain C ABI consumed via ctypes, built by
// tha4_tpu_torch/native/loader.py.

#include <cmath>
#include <cstdint>

namespace {

// cblas.h's enum values.
constexpr int kRowMajor = 101;
constexpr int kColMajor = 102;
constexpr int kTrans = 112;

template <typename Int>
using Dgemv = void (*)(int, int, Int, Int, double, const double*, Int, const double*, Int, double, double*, Int);
template <typename Int>
using Ddot = double (*)(Int, const double*, Int, const double*, Int);

// numpy's float64 maximum/minimum inside clip, and sign.
inline double np_max(double a, double b) { return std::isnan(a) ? a : (a > b ? a : b); }
inline double np_min(double a, double b) { return std::isnan(a) ? a : (a < b ? a : b); }
inline double np_sign(double x) { return x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : (x == 0.0 ? 0.0 : x)); }

template <typename Int>
void solve(const void* dgemv_fn, const void* ddot_fn, const double* m, const double* p, int64_t iterations,
           double lr, double* out) {
    const auto dgemv = reinterpret_cast<Dgemv<Int>>(const_cast<void*>(dgemv_fn));
    const auto ddot = reinterpret_cast<Ddot<Int>>(const_cast<void*>(ddot_fn));
    alignas(64) double d[4] = {0.0, 0.0, 0.0, 0.0};
    alignas(64) double r[4];
    alignas(64) double g[4];
    for (int64_t it = 0; it < iterations; ++it) {
        // r = d @ M - p: numpy's vector @ C-ordered matrix is a row-major,
        // transposed gemv.
        dgemv(kRowMajor, kTrans, 4, 4, 1.0, m, 4, d, 1, 0.0, r, 1);
        for (int j = 0; j < 4; ++j) r[j] = r[j] - p[j];
        // np.linalg.norm(r) = sqrt(r.dot(r)); numpy's dot adds the BLAS
        // result to a zero.
        double sq = 0.0;
        sq += ddot(4, r, 1, r, 1);
        const double norm = std::sqrt(sq);
        if (norm > 1e-12) {
            // r @ M.T: M.T is Fortran-ordered, so numpy calls a column-major,
            // transposed gemv on M's buffer.
            dgemv(kColMajor, kTrans, 4, 4, 1.0, m, 4, r, 1, 0.0, g, 1);
            for (int i = 0; i < 4; ++i) g[i] = g[i] / norm;
        } else {
            for (int i = 0; i < 4; ++i) g[i] = 0.0;
        }
        for (int i = 0; i < 4; ++i) g[i] = g[i] + 0.01 * np_sign(d[i]);
        for (int i = 0; i < 4; ++i) d[i] = np_min(np_max(d[i] - lr * g[i], 0.0), 1.0);
    }
    for (int i = 0; i < 4; ++i) out[i] = d[i];
}

}  // namespace

extern "C" {

// d (4 doubles) = the solve for the point p (4 doubles) and the row-major 4x4
// matrix m.  ilp64 says whether the BLAS routines take 64-bit integers.
void tha4_viseme_solve(const void* dgemv_fn, const void* ddot_fn, int ilp64, const double* m, const double* p,
                       int64_t iterations, double lr, double* d) {
    if (ilp64) {
        solve<int64_t>(dgemv_fn, ddot_fn, m, p, iterations, lr, d);
    } else {
        solve<int32_t>(dgemv_fn, ddot_fn, m, p, iterations, lr, d);
    }
}

}  // extern "C"
