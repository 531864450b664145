// Native float64 Newton-Raphson power-flow oracle.
//
// C++ equivalent of the de-facto native layer the reference delegates to:
// pandapower.runpp's newtonpf (scipy/numba, reference
// voltage_control_env.py:124,165,557).  Used host-side for parity testing
// and baseline measurement; the production path is the batched solvers of
// mapdn_torch/pf.
//
// Same mathematical formulation as mapdn_torch/pf/reference.py (MATPOWER-style
// polar dSbus_dV Jacobian, power-mismatch convergence, bus 0 slack, all
// other buses PQ), implemented with an in-house partial-pivot LU and an
// OpenMP batch farm over independent injection sets.
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

using cx = std::complex<double>;

namespace {

// Dense partial-pivot LU solve: a (m x m, row-major, overwritten), b (m).
// Returns false on numerical singularity.
bool lu_solve(std::vector<double>& a, std::vector<double>& b, int m) {
    std::vector<int> piv(m);
    for (int i = 0; i < m; ++i) piv[i] = i;
    for (int k = 0; k < m; ++k) {
        int p = k;
        double best = std::fabs(a[k * m + k]);
        for (int i = k + 1; i < m; ++i) {
            double v = std::fabs(a[i * m + k]);
            if (v > best) { best = v; p = i; }
        }
        if (best < 1e-300) return false;
        if (p != k) {
            for (int j = 0; j < m; ++j) std::swap(a[k * m + j], a[p * m + j]);
            std::swap(b[k], b[p]);
        }
        const double inv = 1.0 / a[k * m + k];
        for (int i = k + 1; i < m; ++i) {
            const double f = a[i * m + k] * inv;
            if (f == 0.0) continue;
            a[i * m + k] = f;
            for (int j = k + 1; j < m; ++j) a[i * m + j] -= f * a[k * m + j];
            b[i] -= f * b[k];
        }
    }
    for (int i = m - 1; i >= 0; --i) {
        double s = b[i];
        for (int j = i + 1; j < m; ++j) s -= a[i * m + j] * b[j];
        b[i] = s / a[i * m + i];
    }
    return true;
}

// One NR solve; ybus row-major (n x n), slack = bus 0, buses 1..n-1 PQ.
void nr_one(const cx* ybus, int n, const double* p, const double* q,
            double slack_vm, double tol, int max_iter,
            double* vm_out, double* va_out,
            int32_t* conv_out, int32_t* iters_out) {
    const int m = n - 1;
    std::vector<cx> v(n, cx(1.0, 0.0));
    v[0] = cx(slack_vm, 0.0);
    std::vector<cx> ibus(n);
    std::vector<double> jac(4 * m * m), f(2 * m);

    int it = 0;
    bool converged = false;
    for (; it <= max_iter; ++it) {
        for (int i = 0; i < n; ++i) {
            cx acc(0.0, 0.0);
            const cx* row = ybus + (size_t)i * n;
            for (int k = 0; k < n; ++k) acc += row[k] * v[k];
            ibus[i] = acc;
        }
        double maxmis = 0.0;
        for (int i = 1; i < n; ++i) {
            const cx mis = v[i] * std::conj(ibus[i]) - cx(p[i], q[i]);
            f[i - 1] = mis.real();
            f[m + i - 1] = mis.imag();
            maxmis = std::max(maxmis, std::max(std::fabs(mis.real()),
                                               std::fabs(mis.imag())));
        }
        if (maxmis < tol) { converged = true; break; }
        if (it == max_iter) break;

        // dS_dVa[i,k] = j v_i conj(d_ik ibus_i - Y[i,k] v_k)
        // dS_dVm[i,k] = v_i conj(Y[i,k] vnorm_k) + d_ik conj(ibus_i) vnorm_i
        for (int i = 1; i < n; ++i) {
            const cx vi = v[i];
            const cx* row = ybus + (size_t)i * n;
            for (int k = 1; k < n; ++k) {
                const cx vnk = v[k] / std::abs(v[k]);
                cx dva = cx(0.0, 1.0) * vi * std::conj(-row[k] * v[k]);
                cx dvm = vi * std::conj(row[k] * vnk);
                if (i == k) {
                    dva += cx(0.0, 1.0) * vi * std::conj(ibus[i]);
                    dvm += std::conj(ibus[i]) * vnk;
                }
                jac[(size_t)(i - 1) * 2 * m + (k - 1)] = dva.real();
                jac[(size_t)(i - 1) * 2 * m + m + (k - 1)] = dvm.real();
                jac[(size_t)(m + i - 1) * 2 * m + (k - 1)] = dva.imag();
                jac[(size_t)(m + i - 1) * 2 * m + m + (k - 1)] = dvm.imag();
            }
        }
        if (!lu_solve(jac, f, 2 * m)) break;
        for (int i = 1; i < n; ++i) {
            const double va = std::arg(v[i]) - f[i - 1];
            const double vm = std::abs(v[i]) - f[m + i - 1];
            v[i] = std::polar(vm, va);
        }
    }
    for (int i = 0; i < n; ++i) {
        vm_out[i] = std::abs(v[i]);
        va_out[i] = std::arg(v[i]);
    }
    *conv_out = converged ? 1 : 0;
    *iters_out = it;
}

}  // namespace

extern "C" {

// Batched NR: g/b (n*n), p/q (batch*n), outputs vm/va (batch*n),
// conv/iters (batch).  Farms lanes over OpenMP threads.
void mapdn_nr_solve_batch(const double* g, const double* b, int n,
                          const double* p, const double* q, int batch,
                          double slack_vm, double tol, int max_iter,
                          double* vm_out, double* va_out,
                          int32_t* conv_out, int32_t* iters_out) {
    std::vector<cx> ybus((size_t)n * n);
    for (size_t i = 0; i < (size_t)n * n; ++i) ybus[i] = cx(g[i], b[i]);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int l = 0; l < batch; ++l) {
        nr_one(ybus.data(), n, p + (size_t)l * n, q + (size_t)l * n,
               slack_vm, tol, max_iter,
               vm_out + (size_t)l * n, va_out + (size_t)l * n,
               conv_out + l, iters_out + l);
    }
}

int mapdn_native_abi_version() { return 1; }

}  // extern "C"
