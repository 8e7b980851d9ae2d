// i-vector (total variability) extractor: EM training + posterior extraction.
//
// Native equivalent of Kaldi's ivector-extractor-init/-acc-stats/-est and
// ivector-extract (kaldi_ivectors/run.sh:119-129,141-147). Model:
//   M(u) = m + T w(u),  w ~ N(0, I)
// with supervector M stacked over UBM components; per-component residual
// covariance taken from the (diagonalized) UBM.

#include "common.h"

namespace spoofkit {

struct DiagGmm;              // from gmm.cc
struct DiagGmmScorer;

struct IvectorExtractor {
  int num_comp = 0, dim = 0, ivec_dim = 0;
  std::vector<Mat> T;        // per-component (D, R) factor loading blocks
  Mat ubm_means;             // (C, D)
  Mat ubm_inv_vars;          // (C, D) diagonal precision
};

// Posterior of w given utterance stats: precision L = I + Σ_c N_c T_cᵀ Σ_c⁻¹ T_c,
// mean = L⁻¹ Σ_c T_cᵀ Σ_c⁻¹ (F_c − N_c m_c).
static void ivector_posterior(const IvectorExtractor& ext, const Vec& N_c,
                              const Mat& F_c, Vec* mean, Mat* L_out) {
  int R = ext.ivec_dim, C = ext.num_comp, D = ext.dim;
  Mat L(R, R);
  for (int i = 0; i < R; ++i) L[i][i] = 1.0;
  Vec rhs(R, 0.0);
  for (int c = 0; c < C; ++c) {
    if (N_c[c] < 1e-8) continue;
    const Mat& Tc = ext.T[c];
    // precompute Σ_c^{-1} T_c rows scaled
    for (int a = 0; a < D; ++a) {
      double iv = ext.ubm_inv_vars[c][a];
      double fres = F_c[c][a] - N_c[c] * ext.ubm_means[c][a];
      const double* trow = Tc[a];
      double w_n = N_c[c] * iv;
      for (int i = 0; i < R; ++i) {
        rhs[i] += trow[i] * iv * fres;
        double ti = trow[i] * w_n;
        for (int j = 0; j <= i; ++j) L[i][j] += ti * trow[j];
      }
    }
  }
  for (int i = 0; i < R; ++i)
    for (int j = i + 1; j < R; ++j) L[i][j] = L[j][i];
  *mean = chol_solve(L, rhs);
  if (L_out) *L_out = L;
}

// EM training of T from per-utterance stats.
IvectorExtractor train_ivector_extractor(
    const Mat& ubm_means, const Mat& ubm_vars, int ivec_dim,
    const std::vector<Vec>& all_N, const std::vector<Mat>& all_F,
    int num_iters, uint64_t seed = 0, int verbose = 0) {
  int C = ubm_means.rows, D = ubm_means.cols;
  IvectorExtractor ext;
  ext.num_comp = C;
  ext.dim = D;
  ext.ivec_dim = ivec_dim;
  ext.ubm_means = ubm_means;
  ext.ubm_inv_vars = Mat(C, D);
  for (int c = 0; c < C; ++c)
    for (int d = 0; d < D; ++d)
      ext.ubm_inv_vars[c][d] = 1.0 / std::max(ubm_vars[c][d], 1e-6);

  std::mt19937_64 rng(seed);
  std::normal_distribution<double> gauss(0.0, 1.0);
  ext.T.assign(C, Mat(D, ivec_dim));
  for (int c = 0; c < C; ++c)
    for (int d = 0; d < D; ++d) {
      double sigma = std::sqrt(std::max(ubm_vars[c][d], 1e-6));
      for (int r = 0; r < ivec_dim; ++r)
        ext.T[c][d][r] = 0.1 * sigma * gauss(rng);
    }

  int U = (int)all_N.size();
  for (int it = 0; it < num_iters; ++it) {
    // accumulators per component: A_c = Σ_u N_c(u) E[w wᵀ], B_c = Σ_u resid_c E[w]ᵀ
    std::vector<Mat> A(C, Mat(ivec_dim, ivec_dim));
    std::vector<Mat> B(C, Mat(D, ivec_dim));
    for (int u = 0; u < U; ++u) {
      Vec w_mean;
      Mat L;
      ivector_posterior(ext, all_N[u], all_F[u], &w_mean, &L);
      Mat Linv = spd_inverse(L);
      // E[w wᵀ] = L⁻¹ + w̄ w̄ᵀ
      Mat Eww(ivec_dim, ivec_dim);
      for (int i = 0; i < ivec_dim; ++i)
        for (int j = 0; j < ivec_dim; ++j)
          Eww[i][j] = Linv[i][j] + w_mean[i] * w_mean[j];
      for (int c = 0; c < C; ++c) {
        double n = all_N[u][c];
        if (n < 1e-8) continue;
        for (int i = 0; i < ivec_dim; ++i)
          for (int j = 0; j < ivec_dim; ++j) A[c][i][j] += n * Eww[i][j];
        for (int d = 0; d < D; ++d) {
          double fres = all_F[u][c][d] - n * ext.ubm_means[c][d];
          for (int i = 0; i < ivec_dim; ++i) B[c][d][i] += fres * w_mean[i];
        }
      }
    }
    // M-step: per component solve T_c A_c = B_c  (row-wise: A_c symmetric)
    for (int c = 0; c < C; ++c) {
      Mat Ainv = spd_inverse(A[c]);
      for (int d = 0; d < D; ++d) {
        for (int i = 0; i < ivec_dim; ++i) {
          double s = 0.0;
          for (int j = 0; j < ivec_dim; ++j) s += B[c][d][j] * Ainv[j][i];
          ext.T[c][d][i] = s;
        }
      }
    }
    if (verbose) fprintf(stderr, "[ivector] EM iter %d/%d done\n", it + 1, num_iters);
  }
  return ext;
}

Vec extract_ivector(const IvectorExtractor& ext, const Vec& N_c, const Mat& F_c) {
  Vec mean;
  ivector_posterior(ext, N_c, F_c, &mean, nullptr);
  return mean;
}

// ----------------------------------------------------------------------
// Full-covariance extractor (kaldi ivector-extractor-init on the FULL UBM,
// run.sh:119-121): residual covariances are the full UBM covariances.
// Per-component projections Σ_c⁻¹T_c and Gram matrices T_cᵀΣ_c⁻¹T_c are
// precomputed after every T update, making the per-utterance posterior
// O(C·(D·R + R²)) instead of O(C·D·R²).
// ----------------------------------------------------------------------

struct IvectorExtractorFull {
  int num_comp = 0, dim = 0, ivec_dim = 0;
  std::vector<Mat> T;        // (D, R) per component
  Mat ubm_means;             // (C, D)
  std::vector<Mat> inv_covs; // (D, D) per component
  std::vector<Mat> SinvT;    // (D, R) = Σ_c⁻¹ T_c
  std::vector<Mat> G;        // (R, R) = T_cᵀ Σ_c⁻¹ T_c

  void refresh() {
    int C = num_comp, D = dim, R = ivec_dim;
    SinvT.assign(C, Mat(D, R));
    G.assign(C, Mat(R, R));
    for (int c = 0; c < C; ++c) {
      for (int a = 0; a < D; ++a) {
        const double* prow = inv_covs[c][a];
        double* out = SinvT[c][a];
        for (int r = 0; r < R; ++r) {
          double s = 0.0;
          for (int b = 0; b < D; ++b) s += prow[b] * T[c][b][r];
          out[r] = s;
        }
      }
      for (int i = 0; i < R; ++i)
        for (int j = 0; j <= i; ++j) {
          double s = 0.0;
          for (int a = 0; a < dim; ++a) s += T[c][a][i] * SinvT[c][a][j];
          G[c][i][j] = G[c][j][i] = s;
        }
    }
  }
};

static void ivector_posterior_full(const IvectorExtractorFull& ext,
                                   const Vec& N_c, const Mat& F_c, Vec* mean,
                                   Mat* L_out) {
  int R = ext.ivec_dim, C = ext.num_comp, D = ext.dim;
  Mat L(R, R);
  for (int i = 0; i < R; ++i) L[i][i] = 1.0;
  Vec rhs(R, 0.0);
  Vec fres(D);
  for (int c = 0; c < C; ++c) {
    double n = N_c[c];
    if (n < 1e-8) continue;
    for (int i = 0; i < R; ++i) {
      const double* grow = ext.G[c][i];
      for (int j = 0; j <= i; ++j) L[i][j] += n * grow[j];
    }
    for (int d = 0; d < D; ++d) fres[d] = F_c[c][d] - n * ext.ubm_means[c][d];
    for (int a = 0; a < D; ++a) {
      const double* srow = ext.SinvT[c][a];
      double fa = fres[a];
      for (int i = 0; i < R; ++i) rhs[i] += srow[i] * fa;
    }
  }
  for (int i = 0; i < R; ++i)
    for (int j = i + 1; j < R; ++j) L[i][j] = L[j][i];
  *mean = chol_solve(L, rhs);
  if (L_out) *L_out = L;
}

IvectorExtractorFull train_ivector_extractor_full(
    const Mat& ubm_means, const std::vector<Mat>& inv_covs, int ivec_dim,
    const std::vector<Vec>& all_N, const std::vector<Mat>& all_F,
    int num_iters, uint64_t seed = 0, int verbose = 0) {
  int C = ubm_means.rows, D = ubm_means.cols;
  IvectorExtractorFull ext;
  ext.num_comp = C;
  ext.dim = D;
  ext.ivec_dim = ivec_dim;
  ext.ubm_means = ubm_means;
  ext.inv_covs = inv_covs;

  std::mt19937_64 rng(seed);
  std::normal_distribution<double> gauss(0.0, 1.0);
  ext.T.assign(C, Mat(D, ivec_dim));
  for (int c = 0; c < C; ++c)
    for (int d = 0; d < D; ++d) {
      double sigma = std::sqrt(std::max(1.0 / std::max(inv_covs[c][d][d], 1e-8),
                                        1e-6));
      for (int r = 0; r < ivec_dim; ++r)
        ext.T[c][d][r] = 0.1 * sigma * gauss(rng);
    }
  ext.refresh();

  int U = (int)all_N.size();
  for (int it = 0; it < num_iters; ++it) {
    std::vector<Mat> A(C, Mat(ivec_dim, ivec_dim));
    std::vector<Mat> B(C, Mat(D, ivec_dim));
    for (int u = 0; u < U; ++u) {
      Vec w_mean;
      Mat L;
      ivector_posterior_full(ext, all_N[u], all_F[u], &w_mean, &L);
      Mat Linv = spd_inverse(L);
      Mat Eww(ivec_dim, ivec_dim);
      for (int i = 0; i < ivec_dim; ++i)
        for (int j = 0; j < ivec_dim; ++j)
          Eww[i][j] = Linv[i][j] + w_mean[i] * w_mean[j];
      for (int c = 0; c < C; ++c) {
        double n = all_N[u][c];
        if (n < 1e-8) continue;
        for (int i = 0; i < ivec_dim; ++i)
          for (int j = 0; j < ivec_dim; ++j) A[c][i][j] += n * Eww[i][j];
        for (int d = 0; d < D; ++d) {
          double fres = all_F[u][c][d] - n * ext.ubm_means[c][d];
          for (int i = 0; i < ivec_dim; ++i) B[c][d][i] += fres * w_mean[i];
        }
      }
    }
    // M-step: gradient Σ_c⁻¹(B_c − T_c A_c) = 0 → T_c = B_c A_c⁻¹
    // (independent of Σ_c, same as the diag case)
    for (int c = 0; c < C; ++c) {
      Mat Ainv = spd_inverse(A[c]);
      for (int d = 0; d < D; ++d)
        for (int i = 0; i < ivec_dim; ++i) {
          double s = 0.0;
          for (int j = 0; j < ivec_dim; ++j) s += B[c][d][j] * Ainv[j][i];
          ext.T[c][d][i] = s;
        }
    }
    ext.refresh();
    if (verbose)
      fprintf(stderr, "[ivector-full] EM iter %d/%d done\n", it + 1, num_iters);
  }
  return ext;
}

Vec extract_ivector_full(const IvectorExtractorFull& ext, const Vec& N_c,
                         const Mat& F_c) {
  Vec mean;
  ivector_posterior_full(ext, N_c, F_c, &mean, nullptr);
  return mean;
}

}  // namespace spoofkit
