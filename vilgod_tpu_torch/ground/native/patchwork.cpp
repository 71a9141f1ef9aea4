// Native (CPU) ground segmentation — Patchwork++-style algorithm.
//
// Fresh C++ implementation of the algorithm used by the reference's
// adapted Patchwork++ fork (third_party/patchwork-plusplus of the reference,
// Lee et al., IROS 2022): RNR, concentric-zone binning, per-patch z-sort,
// R-VPF/R-GPF PCA plane fits, GLE gating, TGR revert, A-GLE adaptive
// thresholds. No Eigen dependency: plane fits use a hand-rolled 3x3
// symmetric Jacobi eigensolver. Exposed through a C ABI for ctypes.
//
// Role in the framework: CPU oracle for the JAX/TPU kernel
// (vilgod_tpu/ground/patchwork.py) and the native runtime path when no
// accelerator is attached.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

struct Params {
    bool enable_rnr = true;
    bool enable_rvpf = true;
    bool enable_tgr = true;
    int num_iter = 3;
    int num_lpr = 20;
    int num_min_pts = 10;
    int num_rings_of_interest = 4;
    double rnr_ver_angle_thr = -15.0;
    double rnr_intensity_thr = 0.2;
    double sensor_height = 1.723;
    double th_seeds = 0.125;
    double th_dist = 0.125;
    double th_seeds_v = 0.25;
    double th_dist_v = 0.1;
    double max_range = 80.0;
    double min_range = 1.5;
    double uprightness_thr = 0.707;
    double adaptive_seed_selection_margin = -1.2;
    int max_storage = 1000;
    std::vector<int> sectors{16, 32, 54, 32};
    std::vector<int> rings{2, 4, 4, 4};
};

struct Plane {
    double n[3] = {0, 0, 1};
    double mean[3] = {0, 0, 0};
    double d = 0;
    double eig[3] = {0, 0, 0};  // ascending
    int count = 0;
};

// 3x3 symmetric Jacobi eigensolver: A -> eigenvalues (ascending) + vectors.
void eig3_sym(const double a_in[3][3], double vals[3], double vecs[3][3]) {
    double a[3][3];
    std::memcpy(a, a_in, sizeof(a));
    double v[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
    for (int sweep = 0; sweep < 32; ++sweep) {
        double off = std::fabs(a[0][1]) + std::fabs(a[0][2]) + std::fabs(a[1][2]);
        if (off < 1e-15) break;
        for (int p = 0; p < 2; ++p) {
            for (int q = p + 1; q < 3; ++q) {
                if (std::fabs(a[p][q]) < 1e-18) continue;
                double theta = (a[q][q] - a[p][p]) / (2.0 * a[p][q]);
                double t = (theta >= 0 ? 1.0 : -1.0) /
                           (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
                double c = 1.0 / std::sqrt(t * t + 1.0), s = t * c;
                for (int k = 0; k < 3; ++k) {
                    double akp = a[k][p], akq = a[k][q];
                    a[k][p] = c * akp - s * akq;
                    a[k][q] = s * akp + c * akq;
                }
                for (int k = 0; k < 3; ++k) {
                    double apk = a[p][k], aqk = a[q][k];
                    a[p][k] = c * apk - s * aqk;
                    a[q][k] = s * apk + c * aqk;
                }
                for (int k = 0; k < 3; ++k) {
                    double vkp = v[k][p], vkq = v[k][q];
                    v[k][p] = c * vkp - s * vkq;
                    v[k][q] = s * vkp + c * vkq;
                }
            }
        }
    }
    int order[3] = {0, 1, 2};
    double diag[3] = {a[0][0], a[1][1], a[2][2]};
    std::sort(order, order + 3, [&](int i, int j) { return diag[i] < diag[j]; });
    for (int i = 0; i < 3; ++i) {
        vals[i] = diag[order[i]];
        for (int k = 0; k < 3; ++k) vecs[k][i] = v[k][order[i]];
    }
}

struct PatchPoint {
    float x, y, z;
    int idx;  // original cloud index
};

class Patchwork {
  public:
    explicit Patchwork(const Params& p) : prm_(p) {
        double mn = prm_.min_range, mx = prm_.max_range;
        min_ranges_ = {mn, (7 * mn + mx) / 8.0, (3 * mn + mx) / 4.0, (mn + mx) / 2.0};
        ring_sizes_ = {
            (min_ranges_[1] - min_ranges_[0]) / prm_.rings[0],
            (min_ranges_[2] - min_ranges_[1]) / prm_.rings[1],
            (min_ranges_[3] - min_ranges_[2]) / prm_.rings[2],
            (mx - min_ranges_[3]) / prm_.rings[3]};
        for (int z = 0; z < 4; ++z) sector_sizes_.push_back(2 * M_PI / prm_.sectors[z]);
        int r = prm_.num_rings_of_interest;
        elev_hist_.resize(r);
        flat_hist_.resize(r);
        elevation_thr_.assign(r, 0.0);
        flatness_thr_.assign(r, 0.0);
    }

    double sensor_height() const { return prm_.sensor_height; }

    // pts: N x 4 (x, y, z, intensity); ground_out: N bytes (0/1).
    void segment(const float* pts, int n, unsigned char* ground_out) {
        std::fill(ground_out, ground_out + n, 0);

        // ---- RNR ----
        std::vector<char> noise(n, 0);
        if (prm_.enable_rnr) {
            for (int i = 0; i < n; ++i) {
                double x = pts[i * 4], y = pts[i * 4 + 1], z = pts[i * 4 + 2];
                double inten = pts[i * 4 + 3];
                double r = std::sqrt(x * x + y * y);
                double ang = std::atan2(z, r) * 180.0 / M_PI;
                if (ang < prm_.rnr_ver_angle_thr &&
                    z < -prm_.sensor_height - 0.8 &&
                    inten < prm_.rnr_intensity_thr)
                    noise[i] = 1;
            }
        }

        // ---- CZM binning ----
        int num_patches = 0;
        std::vector<int> zone_of_patch, conc_of_patch, patch_offset(4);
        for (int z = 0; z < 4; ++z) {
            patch_offset[z] = num_patches;
            num_patches += prm_.rings[z] * prm_.sectors[z];
        }
        zone_of_patch.resize(num_patches);
        conc_of_patch.resize(num_patches);
        {
            int conc = 0, pid = 0;
            for (int z = 0; z < 4; ++z)
                for (int r = 0; r < prm_.rings[z]; ++r, ++conc)
                    for (int s = 0; s < prm_.sectors[z]; ++s, ++pid) {
                        zone_of_patch[pid] = z;
                        conc_of_patch[pid] = conc;
                    }
        }

        std::vector<std::vector<PatchPoint>> patches(num_patches);
        for (int i = 0; i < n; ++i) {
            if (noise[i]) continue;
            float x = pts[i * 4], y = pts[i * 4 + 1], z = pts[i * 4 + 2];
            double r = std::sqrt((double)x * x + (double)y * y);
            if (r <= prm_.min_range || r > prm_.max_range) continue;
            double theta = std::atan2((double)y, (double)x);
            if (theta <= 0) theta += 2 * M_PI;
            int zone = 3;
            if (r < min_ranges_[1]) zone = 0;
            else if (r < min_ranges_[2]) zone = 1;
            else if (r < min_ranges_[3]) zone = 2;
            int ring = std::min((int)((r - min_ranges_[zone]) / ring_sizes_[zone]),
                                prm_.rings[zone] - 1);
            int sec = std::min((int)(theta / sector_sizes_[zone]),
                               prm_.sectors[zone] - 1);
            int pid = patch_offset[zone] + ring * prm_.sectors[zone] + sec;
            patches[pid].push_back({x, y, z, i});
        }

        // ---- per-patch extraction + GLE + TGR bookkeeping ----
        struct Candidate {
            int pid;
            double flatness, line_variable;
            long n_ground;
            std::vector<int> ground_idx;
        };
        int prev_conc = -1;
        std::vector<Candidate> candidates;
        std::vector<double> ring_flatness;
        std::vector<std::vector<double>> new_elev(prm_.num_rings_of_interest),
            new_flat(prm_.num_rings_of_interest);

        auto flush_ring = [&]() {
            if (candidates.empty()) { ring_flatness.clear(); return; }
            if (prm_.enable_tgr) {
                double mean = 0, stdev = 0;
                calc_mean_stdev(ring_flatness, mean, stdev);
                for (auto& c : candidates) {
                    double mu = mean + 1.5 * stdev;
                    double probf =
                        mu > 0 ? 1.0 / (1.0 + std::exp((c.flatness - mu) / (mu / 10.0)))
                               : 0.0;
                    if (c.n_ground > 1500 && c.flatness < prm_.th_dist * prm_.th_dist)
                        probf = 1.0;
                    double probl = c.line_variable > 8.0 ? 0.0 : 1.0;
                    if (probl * probf > 0.5)
                        for (int idx : c.ground_idx) ground_out[idx] = 1;
                }
            }
            candidates.clear();
            ring_flatness.clear();
        };

        for (int pid = 0; pid < num_patches; ++pid) {
            int conc = conc_of_patch[pid];
            if (conc != prev_conc) { flush_ring(); prev_conc = conc; }
            auto& pp = patches[pid];
            if ((int)pp.size() < prm_.num_min_pts) continue;
            std::sort(pp.begin(), pp.end(),
                      [](const PatchPoint& a, const PatchPoint& b) { return a.z < b.z; });

            std::vector<char> removed(pp.size(), 0);
            Plane plane;
            extract_piecewise(pp, zone_of_patch[pid] == 0, removed, plane);

            std::vector<int> ground_idx;
            for (size_t i = 0; i < pp.size(); ++i) {
                if (removed[i]) continue;
                double dist = plane.n[0] * pp[i].x + plane.n[1] * pp[i].y +
                              plane.n[2] * pp[i].z + plane.d;
                if (dist < prm_.th_dist) ground_idx.push_back(pp[i].idx);
            }

            double uprightness = plane.n[2];
            double elevation = plane.mean[2];
            double flatness = plane.eig[0];
            double line_variable =
                plane.eig[1] > 0 ? plane.eig[2] / plane.eig[1]
                                 : std::numeric_limits<double>::max();
            double heading = plane.mean[0] * plane.n[0] + plane.mean[1] * plane.n[1] +
                             plane.mean[2] * plane.n[2];

            bool is_upright = uprightness > prm_.uprightness_thr;
            bool is_near = conc < prm_.num_rings_of_interest;
            bool heading_out = heading < 0.0;
            bool is_not_elevated = is_near && elevation < elevation_thr_[conc];
            bool is_flat = is_near && flatness < flatness_thr_[conc];

            if (is_upright && is_not_elevated && is_near) {
                new_elev[conc].push_back(elevation);
                new_flat[conc].push_back(flatness);
                ring_flatness.push_back(flatness);
            }

            if (!is_upright) {
                // nonground
            } else if (!is_near) {
                for (int idx : ground_idx) ground_out[idx] = 1;
            } else if (!heading_out) {
                // nonground
            } else if (is_not_elevated || is_flat) {
                for (int idx : ground_idx) ground_out[idx] = 1;
            } else {
                Candidate c;
                c.pid = pid;
                c.flatness = flatness;
                c.line_variable = line_variable;
                c.n_ground = (long)ground_idx.size();
                c.ground_idx = std::move(ground_idx);
                candidates.push_back(std::move(c));
            }
        }
        flush_ring();

        // ---- A-GLE threshold update ----
        for (int r = 0; r < prm_.num_rings_of_interest; ++r) {
            auto& hist = elev_hist_[r];
            hist.insert(hist.end(), new_elev[r].begin(), new_elev[r].end());
            if (hist.size() > (size_t)prm_.max_storage)
                hist.erase(hist.begin(), hist.end() - prm_.max_storage);
            if (hist.size() >= 2) {
                double mean = 0, stdev = 0;
                calc_mean_stdev(hist, mean, stdev);
                elevation_thr_[r] = mean + (r == 0 ? 3.0 : 2.0) * stdev;
                if (r == 0) prm_.sensor_height = -mean;
            }
            auto& fh = flat_hist_[r];
            fh.insert(fh.end(), new_flat[r].begin(), new_flat[r].end());
            if (fh.size() > (size_t)prm_.max_storage)
                fh.erase(fh.begin(), fh.end() - prm_.max_storage);
            if (fh.size() >= 2) {
                double mean = 0, stdev = 0;
                calc_mean_stdev(fh, mean, stdev);
                flatness_thr_[r] = mean + stdev;
            }
        }
    }

  private:
    static void calc_mean_stdev(const std::vector<double>& v, double& mean,
                                double& stdev) {
        mean = 0;
        stdev = 0;
        if (v.size() <= 1) return;
        mean = std::accumulate(v.begin(), v.end(), 0.0) / v.size();
        for (double x : v) stdev += (x - mean) * (x - mean);
        stdev = std::sqrt(stdev / (v.size() - 1));
    }

    void fit_plane(const std::vector<PatchPoint>& pp, const std::vector<char>& removed,
                   const std::vector<char>& sel, Plane& plane) {
        double mean[3] = {0, 0, 0};
        int cnt = 0;
        for (size_t i = 0; i < pp.size(); ++i) {
            if (removed[i] || !sel[i]) continue;
            mean[0] += pp[i].x;
            mean[1] += pp[i].y;
            mean[2] += pp[i].z;
            ++cnt;
        }
        if (cnt == 0) return;  // keep previous plane (reference early-return)
        for (double& m : mean) m /= cnt;
        double cov[3][3] = {{0}};
        for (size_t i = 0; i < pp.size(); ++i) {
            if (removed[i] || !sel[i]) continue;
            double d[3] = {pp[i].x - mean[0], pp[i].y - mean[1], pp[i].z - mean[2]};
            for (int a = 0; a < 3; ++a)
                for (int b = 0; b < 3; ++b) cov[a][b] += d[a] * d[b];
        }
        double denom = std::max(cnt - 1, 1);
        for (int a = 0; a < 3; ++a)
            for (int b = 0; b < 3; ++b) cov[a][b] /= denom;
        double vals[3], vecs[3][3];
        eig3_sym(cov, vals, vecs);
        double nx = vecs[0][0], ny = vecs[1][0], nz = vecs[2][0];
        if (nz < 0) { nx = -nx; ny = -ny; nz = -nz; }
        plane.n[0] = nx; plane.n[1] = ny; plane.n[2] = nz;
        std::memcpy(plane.mean, mean, sizeof(mean));
        plane.d = -(nx * mean[0] + ny * mean[1] + nz * mean[2]);
        for (int i = 0; i < 3; ++i) plane.eig[i] = std::max(vals[i], 0.0);
        plane.count = cnt;
    }

    void select_seeds(const std::vector<PatchPoint>& pp, const std::vector<char>& removed,
                      bool zone0, double th_seed, std::vector<char>& seeds) {
        seeds.assign(pp.size(), 0);
        double margin = prm_.adaptive_seed_selection_margin * prm_.sensor_height;
        double sum = 0;
        int cnt = 0;
        for (size_t i = 0; i < pp.size() && cnt < prm_.num_lpr; ++i) {
            if (removed[i]) continue;
            if (zone0 && pp[i].z < margin) continue;  // skip too-low prefix
            sum += pp[i].z;
            ++cnt;
        }
        double lpr = cnt ? sum / cnt : 0.0;
        for (size_t i = 0; i < pp.size(); ++i)
            if (!removed[i] && pp[i].z < lpr + th_seed) seeds[i] = 1;
    }

    void extract_piecewise(const std::vector<PatchPoint>& pp, bool zone0,
                           std::vector<char>& removed, Plane& plane) {
        std::vector<char> seeds;
        // R-VPF
        if (prm_.enable_rvpf) {
            for (int it = 0; it < prm_.num_iter; ++it) {
                select_seeds(pp, removed, zone0, prm_.th_seeds_v, seeds);
                Plane vp;
                fit_plane(pp, removed, seeds, vp);
                if (!(zone0 && vp.count > 0 && vp.n[2] < prm_.uprightness_thr)) break;
                for (size_t i = 0; i < pp.size(); ++i) {
                    if (removed[i]) continue;
                    double dist = vp.n[0] * pp[i].x + vp.n[1] * pp[i].y +
                                  vp.n[2] * pp[i].z + vp.d;
                    if (std::fabs(dist) < prm_.th_dist_v) removed[i] = 1;
                }
            }
        }
        // R-GPF
        select_seeds(pp, removed, zone0, prm_.th_seeds, seeds);
        fit_plane(pp, removed, seeds, plane);
        std::vector<char> ground(pp.size(), 0);
        for (int it = 0; it < prm_.num_iter; ++it) {
            for (size_t i = 0; i < pp.size(); ++i) {
                if (removed[i]) { ground[i] = 0; continue; }
                double dist = plane.n[0] * pp[i].x + plane.n[1] * pp[i].y +
                              plane.n[2] * pp[i].z + plane.d;
                ground[i] = dist < prm_.th_dist;
            }
            fit_plane(pp, removed, ground, plane);
        }
    }

    Params prm_;
    std::vector<double> min_ranges_, ring_sizes_, sector_sizes_;
    std::vector<std::vector<double>> elev_hist_, flat_hist_;
    std::vector<double> elevation_thr_, flatness_thr_;
};

}  // namespace

extern "C" {

void* pw_create(const double* fparams, int n_fparams) {
    Params p;
    if (n_fparams >= 16) {
        p.enable_rnr = fparams[0] > 0.5;
        p.enable_rvpf = fparams[1] > 0.5;
        p.enable_tgr = fparams[2] > 0.5;
        p.num_iter = (int)fparams[3];
        p.num_lpr = (int)fparams[4];
        p.num_min_pts = (int)fparams[5];
        p.num_rings_of_interest = (int)fparams[6];
        p.rnr_ver_angle_thr = fparams[7];
        p.rnr_intensity_thr = fparams[8];
        p.sensor_height = fparams[9];
        p.th_seeds = fparams[10];
        p.th_dist = fparams[11];
        p.th_seeds_v = fparams[12];
        p.th_dist_v = fparams[13];
        p.max_range = fparams[14];
        p.min_range = fparams[15];
        if (n_fparams >= 18) {
            p.uprightness_thr = fparams[16];
            p.adaptive_seed_selection_margin = fparams[17];
        }
    }
    return new Patchwork(p);
}

void pw_destroy(void* h) { delete static_cast<Patchwork*>(h); }

void pw_segment(void* h, const float* pts, int n, unsigned char* ground_out) {
    static_cast<Patchwork*>(h)->segment(pts, n, ground_out);
}

double pw_sensor_height(void* h) {
    return static_cast<Patchwork*>(h)->sensor_height();
}

}  // extern "C"
