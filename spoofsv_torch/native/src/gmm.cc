// Diagonal and full-covariance GMM (UBM) estimation via EM.
//
// Native equivalent of Kaldi's gmm-global-* / fgmm-global-* UBM training used
// by the reference (kaldi_ivectors/run.sh:105-118: diag UBM-1024 → full UBM).

#include "common.h"

namespace spoofkit {

struct DiagGmm {
  int num_comp = 0, dim = 0;
  Vec weights;       // (C)
  Mat means;         // (C, D)
  Mat vars;          // (C, D) diagonal variances
};

// log N(x; mu, diag var) + log w, vectorized helper tables
struct DiagGmmScorer {
  const DiagGmm& gmm;
  Vec gconst;        // per-component constant
  Mat inv_vars;
  Mat mean_invvar;
  explicit DiagGmmScorer(const DiagGmm& g) : gmm(g),
      inv_vars(g.num_comp, g.dim), mean_invvar(g.num_comp, g.dim) {
    gconst.resize(g.num_comp);
    for (int c = 0; c < g.num_comp; ++c) {
      double gc = std::log(std::max(g.weights[c], 1e-20))
                  - 0.5 * g.dim * std::log(2.0 * M_PI);
      for (int d = 0; d < g.dim; ++d) {
        double v = std::max(g.vars[c][d], 1e-6);
        inv_vars[c][d] = 1.0 / v;
        mean_invvar[c][d] = g.means[c][d] / v;
        gc -= 0.5 * std::log(v);
        gc -= 0.5 * g.means[c][d] * g.means[c][d] / v;
      }
      gconst[c] = gc;
    }
  }
  // loglikes per component for frame x: gconst + x·(mu/var) - 0.5 x²·(1/var)
  void loglikes(const double* x, Vec* out) const {
    out->resize(gmm.num_comp);
    for (int c = 0; c < gmm.num_comp; ++c) {
      double s = gconst[c];
      const double* iv = inv_vars[c];
      const double* miv = mean_invvar[c];
      for (int d = 0; d < gmm.dim; ++d)
        s += x[d] * miv[d] - 0.5 * x[d] * x[d] * iv[d];
      (*out)[c] = s;
    }
  }
};

inline double log_sum_exp(const Vec& v) {
  double m = v[0];
  for (double x : v) m = std::max(m, x);
  double s = 0.0;
  for (double x : v) s += std::exp(x - m);
  return m + std::log(s);
}

// Train a diagonal UBM on pooled frames (N, D) with binary-split + EM
// (kaldi gmm-global-init-from-feats style: start from 1 Gaussian, split).
DiagGmm train_diag_ubm(const Mat& frames, int num_comp, int num_iters,
                       uint64_t seed = 0, int verbose = 0) {
  int N = frames.rows, D = frames.cols;
  std::mt19937_64 rng(seed);
  DiagGmm gmm;
  gmm.dim = D;
  gmm.num_comp = 1;
  gmm.weights = {1.0};
  gmm.means = Mat(1, D);
  gmm.vars = Mat(1, D);
  for (int i = 0; i < N; ++i)
    for (int d = 0; d < D; ++d) gmm.means[0][d] += frames[i][d];
  for (int d = 0; d < D; ++d) gmm.means[0][d] /= std::max(N, 1);
  for (int i = 0; i < N; ++i)
    for (int d = 0; d < D; ++d) {
      double z = frames[i][d] - gmm.means[0][d];
      gmm.vars[0][d] += z * z;
    }
  for (int d = 0; d < D; ++d)
    gmm.vars[0][d] = std::max(gmm.vars[0][d] / std::max(N, 1), 1e-4);

  std::normal_distribution<double> gauss(0.0, 1.0);
  auto em_iterations = [&](int iters) {
    for (int it = 0; it < iters; ++it) {
      DiagGmmScorer scorer(gmm);
      Vec occ(gmm.num_comp, 0.0);
      Mat acc_m(gmm.num_comp, D), acc_v(gmm.num_comp, D);
      Vec ll(gmm.num_comp);
      double total_ll = 0.0;
      for (int i = 0; i < N; ++i) {
        scorer.loglikes(frames[i], &ll);
        double lse = log_sum_exp(ll);
        total_ll += lse;
        for (int c = 0; c < gmm.num_comp; ++c) {
          double post = std::exp(ll[c] - lse);
          if (post < 1e-8) continue;
          occ[c] += post;
          for (int d = 0; d < D; ++d) {
            acc_m[c][d] += post * frames[i][d];
            acc_v[c][d] += post * frames[i][d] * frames[i][d];
          }
        }
      }
      for (int c = 0; c < gmm.num_comp; ++c) {
        double o = std::max(occ[c], 1e-10);
        gmm.weights[c] = o / N;
        for (int d = 0; d < D; ++d) {
          double mu = acc_m[c][d] / o;
          gmm.means[c][d] = mu;
          gmm.vars[c][d] = std::max(acc_v[c][d] / o - mu * mu, 1e-4);
        }
      }
      if (verbose) {
        fprintf(stderr, "[diag-ubm] comps=%d iter=%d avg loglike %.4f\n",
                gmm.num_comp, it, total_ll / std::max(N, 1));
      }
    }
  };

  while (gmm.num_comp < num_comp) {
    int target = std::min(num_comp, gmm.num_comp * 2);
    DiagGmm bigger;
    bigger.dim = D;
    bigger.num_comp = target;
    bigger.weights.assign(target, 0.0);
    bigger.means = Mat(target, D);
    bigger.vars = Mat(target, D);
    std::uniform_int_distribution<int> pick(0, N - 1);
    auto min_dist2 = [&](const double* f, const Mat& means, int upto) {
      double best = 1e300;
      for (int c = 0; c < upto; ++c) {
        double d2 = 0.0;
        for (int d = 0; d < D; ++d) {
          double z = f[d] - means[c][d];
          d2 += z * z;
        }
        best = std::min(best, d2);
      }
      return best;
    };
    for (int c = 0; c < target; ++c) {
      int src = c % gmm.num_comp;
      bigger.weights[c] = gmm.weights[src] / ((target + gmm.num_comp - 1) / gmm.num_comp);
      if (c >= gmm.num_comp) {
        // new components: k-means++-style seeding — among a handful of random
        // frames, take the one farthest from the means chosen so far. A small
        // gaussian perturbation of the parent mean collapses back in EM.
        int best_i = pick(rng);
        double best_d = min_dist2(frames[best_i], bigger.means, c);
        for (int trial = 0; trial < 8; ++trial) {
          int i = pick(rng);
          double d2 = min_dist2(frames[i], bigger.means, c);
          if (d2 > best_d) {
            best_d = d2;
            best_i = i;
          }
        }
        const double* f = frames[best_i];
        for (int d = 0; d < D; ++d) {
          bigger.means[c][d] = f[d];
          bigger.vars[c][d] = gmm.vars[src][d];
        }
      } else {
        for (int d = 0; d < D; ++d) {
          bigger.means[c][d] = gmm.means[src][d];
          bigger.vars[c][d] = gmm.vars[src][d];
        }
      }
    }
    double wsum = 0.0;
    for (double w : bigger.weights) wsum += w;
    for (double& w : bigger.weights) w /= wsum;
    gmm = bigger;
    em_iterations(2);
  }
  em_iterations(num_iters);
  return gmm;
}

struct FullGmm {
  int num_comp = 0, dim = 0;
  Vec weights;
  Mat means;                       // (C, D)
  std::vector<Mat> covs;           // per-component covariance (D, D)
  std::vector<Mat> inv_covs;      // per-component inverse covariance (D, D)
  Vec logdets;                     // log|Sigma_c|

  void refresh_inverses() {
    inv_covs.resize(num_comp);
    logdets.assign(num_comp, 0.0);
    for (int c = 0; c < num_comp; ++c)
      inv_covs[c] = spd_inverse(covs[c], &logdets[c]);
  }
};

// One-pass full-covariance re-estimation from diag-UBM posteriors
// (kaldi gmm-global-to-fgmm + fgmm-global-acc-stats style, few iterations).
FullGmm train_full_ubm(const Mat& frames, const DiagGmm& diag, int num_iters,
                       int verbose = 0) {
  int N = frames.rows, D = frames.cols, C = diag.num_comp;
  FullGmm full;
  full.num_comp = C;
  full.dim = D;
  full.weights = diag.weights;
  full.means = diag.means;
  full.inv_covs.resize(C);
  full.logdets.assign(C, 0.0);
  // init covariances from diag
  std::vector<Mat> covs(C, Mat(D, D));
  for (int c = 0; c < C; ++c)
    for (int d = 0; d < D; ++d) covs[c][d][d] = diag.vars[c][d];

  for (int it = 0; it < num_iters; ++it) {
    // build scorer from current full covs
    for (int c = 0; c < C; ++c)
      full.inv_covs[c] = spd_inverse(covs[c], &full.logdets[c]);
    Vec occ(C, 0.0);
    Mat acc_m(C, D);
    std::vector<Mat> acc_s(C, Mat(D, D));
    Vec ll(C);
    for (int i = 0; i < N; ++i) {
      const double* x = frames[i];
      for (int c = 0; c < C; ++c) {
        double q = 0.0;
        Vec diff(D);
        for (int d = 0; d < D; ++d) diff[d] = x[d] - full.means[c][d];
        for (int a = 0; a < D; ++a) {
          const double* row = full.inv_covs[c][a];
          double s = 0.0;
          for (int b = 0; b < D; ++b) s += row[b] * diff[b];
          q += diff[a] * s;
        }
        ll[c] = std::log(std::max(full.weights[c], 1e-20)) -
                0.5 * (D * std::log(2.0 * M_PI) + full.logdets[c] + q);
      }
      double lse = log_sum_exp(ll);
      for (int c = 0; c < C; ++c) {
        double post = std::exp(ll[c] - lse);
        if (post < 1e-8) continue;
        occ[c] += post;
        for (int d = 0; d < D; ++d) acc_m[c][d] += post * x[d];
        for (int a = 0; a < D; ++a)
          for (int b = 0; b <= a; ++b) acc_s[c][a][b] += post * x[a] * x[b];
      }
    }
    double wsum = 0.0;
    for (int c = 0; c < C; ++c) {
      double o = std::max(occ[c], 1e-10);
      full.weights[c] = o;
      wsum += o;
      for (int d = 0; d < D; ++d) full.means[c][d] = acc_m[c][d] / o;
      for (int a = 0; a < D; ++a)
        for (int b = 0; b <= a; ++b) {
          double v = acc_s[c][a][b] / o - full.means[c][a] * full.means[c][b];
          if (a == b) v = std::max(v, 1e-4);
          covs[c][a][b] = covs[c][b][a] = v;
        }
    }
    for (int c = 0; c < C; ++c) full.weights[c] /= wsum;
    if (verbose) fprintf(stderr, "[full-ubm] iter %d done\n", it);
  }
  full.covs = covs;
  full.refresh_inverses();
  return full;
}

// Frame log-likelihoods under the full-covariance GMM (precomputed constants).
struct FullGmmScorer {
  const FullGmm& gmm;
  Vec logconst;  // log w_c − ½(D·log 2π + log|Σ_c|)

  explicit FullGmmScorer(const FullGmm& g) : gmm(g), logconst(g.num_comp) {
    for (int c = 0; c < g.num_comp; ++c)
      logconst[c] = std::log(std::max(g.weights[c], 1e-20)) -
                    0.5 * (g.dim * std::log(2.0 * M_PI) + g.logdets[c]);
  }

  void loglikes(const double* x, Vec* ll) const {
    int C = gmm.num_comp, D = gmm.dim;
    Vec diff(D);
    for (int c = 0; c < C; ++c) {
      for (int d = 0; d < D; ++d) diff[d] = x[d] - gmm.means[c][d];
      double q = 0.0;
      for (int a = 0; a < D; ++a) {
        const double* row = gmm.inv_covs[c][a];
        double s = 0.0;
        for (int b = 0; b < D; ++b) s += row[b] * diff[b];
        q += diff[a] * s;
      }
      (*ll)[c] = logconst[c] - 0.5 * q;
    }
  }
};

// Baum-Welch stats against the full UBM (kaldi fgmm-global-gselect-to-post →
// ivector-extractor-acc-stats path of run.sh:119-129).
void accumulate_stats_full(const FullGmmScorer& scorer, const Mat& feats,
                           Vec* N_c, Mat* F_c) {
  int C = scorer.gmm.num_comp, D = scorer.gmm.dim;
  N_c->assign(C, 0.0);
  *F_c = Mat(C, D);
  Vec ll(C);
  for (int t = 0; t < feats.rows; ++t) {
    scorer.loglikes(feats[t], &ll);
    double lse = log_sum_exp(ll);
    for (int c = 0; c < C; ++c) {
      double post = std::exp(ll[c] - lse);
      if (post < 1e-6) continue;
      (*N_c)[c] += post;
      for (int d = 0; d < D; ++d) (*F_c)[c][d] += post * feats[t][d];
    }
  }
}

// Zeroth/first-order Baum-Welch stats of an utterance against the diag UBM
// (used by the i-vector extractor; kaldi ivector-extractor-acc-stats).
void accumulate_stats(const DiagGmmScorer& scorer, const Mat& feats,
                      Vec* N_c, Mat* F_c) {
  int C = scorer.gmm.num_comp, D = scorer.gmm.dim;
  N_c->assign(C, 0.0);
  *F_c = Mat(C, D);
  Vec ll(C);
  for (int t = 0; t < feats.rows; ++t) {
    scorer.loglikes(feats[t], &ll);
    double lse = log_sum_exp(ll);
    for (int c = 0; c < C; ++c) {
      double post = std::exp(ll[c] - lse);
      if (post < 1e-6) continue;
      (*N_c)[c] += post;
      for (int d = 0; d < D; ++d) (*F_c)[c][d] += post * feats[t][d];
    }
  }
}

}  // namespace spoofkit
