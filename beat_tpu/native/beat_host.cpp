// Native host kernels: eikonal fast-sweeping rupture-onset solver and
// brute-force nearest-Voronoi-node assignment.
//
// Framework note: the on-device implementations live in
// beat_tpu/ops (JAX/XLA); these C++ versions are the host-side
// counterparts of the reference's C extensions
// (beat/fast_sweeping/fast_sweep_ext.c, beat/voronoi/voronoi_ext.c) used
// for host-path fault preprocessing and as an independent
// cross-validation reference.  Built via g++ -O3 -shared (no Python C
// API; consumed through ctypes).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Gauss-Seidel fast sweeping (Zhao 2004): four directional sweep orders
// per iteration, monotone upwind update, iterate until the summed
// squared change drops below epsilon.
void fast_sweep(const double* slowness, double patch_size,
                int64_t nuc_dip, int64_t nuc_strike,
                int64_t n_dip, int64_t n_strike,
                double epsilon, double* times) {
    const double INIT = 1e8;
    const int64_t n = n_dip * n_strike;
    for (int64_t i = 0; i < n; ++i) times[i] = INIT;
    times[nuc_dip * n_strike + nuc_strike] = 0.0;

    auto solve_cell = [&](int64_t i, int64_t j) {
        const int64_t up = std::max<int64_t>(i - 1, 0);
        const int64_t dn = std::min<int64_t>(i + 1, n_dip - 1);
        const int64_t lf = std::max<int64_t>(j - 1, 0);
        const int64_t rt = std::min<int64_t>(j + 1, n_strike - 1);
        const double a = std::min(times[up * n_strike + j], times[dn * n_strike + j]);
        const double b = std::min(times[i * n_strike + lf], times[i * n_strike + rt]);
        const double f = slowness[i * n_strike + j] * patch_size;
        double cand;
        if (std::fabs(a - b) >= f) {
            cand = std::min(a, b) + f;
        } else {
            const double rad = 2.0 * f * f - (a - b) * (a - b);
            cand = 0.5 * (a + b + std::sqrt(std::max(rad, 0.0)));
        }
        double& t = times[i * n_strike + j];
        if (cand < t) t = cand;
    };

    double err = 1e30;
    std::vector<double> old(n);
    while (err > epsilon) {
        std::copy(times, times + n, old.begin());
        for (int sweep = 0; sweep < 4; ++sweep) {
            const bool dip_fwd = (sweep == 0 || sweep == 3);
            const bool strike_fwd = (sweep == 0 || sweep == 1);
            for (int64_t ii = 0; ii < n_dip; ++ii) {
                const int64_t i = dip_fwd ? ii : n_dip - 1 - ii;
                for (int64_t jj = 0; jj < n_strike; ++jj) {
                    const int64_t j = strike_fwd ? jj : n_strike - 1 - jj;
                    if (i == nuc_dip && j == nuc_strike) continue;
                    solve_cell(i, j);
                }
            }
        }
        err = 0.0;
        for (int64_t k = 0; k < n; ++k) {
            const double d = times[k] - old[k];
            err += d * d;
        }
    }
}

// Brute-force nearest-node assignment: for each patch center the index
// of the closest Voronoi node (O(N*M), like the reference C extension).
void voronoi_nearest(const double* node_strike, const double* node_dip,
                     int64_t n_nodes,
                     const double* patch_strike, const double* patch_dip,
                     int64_t n_patches, int32_t* out_idx) {
    for (int64_t p = 0; p < n_patches; ++p) {
        double best = 1e300;
        int32_t best_i = 0;
        for (int64_t m = 0; m < n_nodes; ++m) {
            const double ds = patch_strike[p] - node_strike[m];
            const double dd = patch_dip[p] - node_dip[m];
            const double d2 = ds * ds + dd * dd;
            if (d2 < best) { best = d2; best_i = static_cast<int32_t>(m); }
        }
        out_idx[p] = best_i;
    }
}

}  // extern "C"
