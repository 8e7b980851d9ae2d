// PLDA (two-covariance) training and scoring + EER.
//
// Native equivalent of Kaldi's ivector-compute-plda / ivector-plda-scoring /
// compute-eer (kaldi_ivectors/run.sh:119-158). Kaldi-style recipe: center and
// length-normalize i-vectors, estimate between-/within-class covariances from
// speaker-labelled data, simultaneously diagonalize, score trials with the
// same-vs-different-speaker log-likelihood ratio (averaged enrollment,
// n-utterance normalization as in Kaldi's Plda::LogLikelihoodRatio).

#include "common.h"

namespace spoofkit {

struct Plda {
  int dim = 0;
  Vec mean;        // global mean (pre-transform space)
  Mat transform;   // simultaneous diagonalizer: x' = A (x - mean)
  Vec psi;         // between-class variance in transformed space (within = I)
};

// Train from class-labelled vectors: ivecs (N, D), labels (N) in [0, S).
Plda train_plda(const Mat& ivecs, const std::vector<int>& labels, int num_spk,
                int verbose = 0) {
  int N = ivecs.rows, D = ivecs.cols;
  Plda plda;
  plda.dim = D;
  plda.mean.assign(D, 0.0);
  for (int i = 0; i < N; ++i)
    for (int d = 0; d < D; ++d) plda.mean[d] += ivecs[i][d];
  for (int d = 0; d < D; ++d) plda.mean[d] /= std::max(N, 1);

  // per-speaker means and within-class scatter
  std::vector<Vec> spk_sum(num_spk, Vec(D, 0.0));
  std::vector<int> spk_cnt(num_spk, 0);
  for (int i = 0; i < N; ++i) {
    for (int d = 0; d < D; ++d) spk_sum[labels[i]][d] += ivecs[i][d];
    spk_cnt[labels[i]]++;
  }
  Mat Sw(D, D), Sb(D, D);
  int used_spk = 0;
  for (int s = 0; s < num_spk; ++s) {
    if (spk_cnt[s] == 0) continue;
    ++used_spk;
    Vec mu(D);
    for (int d = 0; d < D; ++d) mu[d] = spk_sum[s][d] / spk_cnt[s];
    for (int d = 0; d < D; ++d) {
      double z = mu[d] - plda.mean[d];
      for (int e = 0; e <= d; ++e) {
        double z2 = mu[e] - plda.mean[e];
        Sb[d][e] += z * z2;
      }
    }
  }
  for (int i = 0; i < N; ++i) {
    int s = labels[i];
    for (int d = 0; d < D; ++d) {
      double z = ivecs[i][d] - spk_sum[s][d] / spk_cnt[s];
      for (int e = 0; e <= d; ++e) {
        double z2 = ivecs[i][e] - spk_sum[s][e] / spk_cnt[s];
        Sw[d][e] += z * z2;
      }
    }
  }
  for (int d = 0; d < D; ++d)
    for (int e = d + 1; e < D; ++e) {
      Sw[d][e] = Sw[e][d];
      Sb[d][e] = Sb[e][d];
    }
  for (int d = 0; d < D; ++d)
    for (int e = 0; e < D; ++e) {
      Sw[d][e] /= std::max(N - used_spk, 1);
      Sb[d][e] /= std::max(used_spk - 1, 1);
      if (d == e) {
        Sw[d][e] += 1e-6;
        Sb[d][e] = std::max(Sb[d][e], 0.0) + (d == e ? 1e-8 : 0.0);
      }
    }

  // Simultaneous diagonalization: W = L Lᵀ; A1 = L⁻¹; diagonalize A1 Sb A1ᵀ = U Ψ Uᵀ;
  // transform = Uᵀ A1 → within-cov = I, between-cov = diag(psi).
  Mat L;
  Mat Swj = Sw;
  double jitter = 1e-8;
  while (!cholesky(Swj, &L)) {
    for (int d = 0; d < D; ++d) Swj[d][d] += jitter;
    jitter *= 10;
  }
  // A1 = L^{-1}
  Mat A1(D, D);
  for (int i = 0; i < D; ++i) {
    A1[i][i] = 1.0 / L[i][i];
    for (int j = 0; j < i; ++j) {
      double s = 0.0;
      for (int k = j; k < i; ++k) s -= L[i][k] * A1[k][j];
      A1[i][j] = s / L[i][i];
    }
  }
  Mat M = matmul(matmul(A1, Sb), transpose(A1));
  Vec w;
  Mat U;
  sym_eig(M, &w, &U);  // ascending
  // descending order for psi
  plda.psi.assign(D, 0.0);
  Mat Ut(D, D);
  for (int i = 0; i < D; ++i) {
    int src = D - 1 - i;
    plda.psi[i] = std::max(w[src], 0.0);
    for (int k = 0; k < D; ++k) Ut[i][k] = U[k][src];
  }
  plda.transform = matmul(Ut, A1);
  if (verbose) fprintf(stderr, "[plda] trained on %d vecs / %d speakers\n", N, used_spk);
  return plda;
}

inline void plda_transform(const Plda& p, const double* x, Vec* out) {
  int D = p.dim;
  out->assign(D, 0.0);
  Vec centered(D);
  for (int d = 0; d < D; ++d) centered[d] = x[d] - p.mean[d];
  for (int i = 0; i < D; ++i) {
    double s = 0.0;
    const double* row = p.transform[i];
    for (int d = 0; d < D; ++d) s += row[d] * centered[d];
    (*out)[i] = s;
  }
}

// Kaldi Plda::LogLikelihoodRatio: enrollment = mean of n examples (transformed,
// then scaled by the "simple length norm" handled by the caller).
double plda_llr(const Plda& p, const Vec& enroll_mean, int n, const Vec& test) {
  int D = p.dim;
  double loglike_given = 0.0, loglike_not = 0.0;
  for (int d = 0; d < D; ++d) {
    double psi = p.psi[d];
    // given same speaker: mean = n psi/(n psi + 1) * enroll_mean; var = 1 + psi/(n psi + 1)
    double m = n * psi / (n * psi + 1.0) * enroll_mean[d];
    double v = 1.0 + psi / (n * psi + 1.0);
    double z = test[d] - m;
    loglike_given += -0.5 * (std::log(2.0 * M_PI * v) + z * z / v);
    double v0 = 1.0 + psi;
    loglike_not += -0.5 * (std::log(2.0 * M_PI * v0) + test[d] * test[d] / v0);
  }
  return loglike_given - loglike_not;
}

// compute-eer equivalent: EER from target / nontarget score arrays.
double compute_eer(const Vec& target, const Vec& nontarget, double* threshold) {
  Vec all = target;
  all.insert(all.end(), nontarget.begin(), nontarget.end());
  std::sort(all.begin(), all.end());
  double best_diff = 1e9, eer = 1.0, thr = 0.0;
  for (double t : all) {
    double frr = 0.0, far = 0.0;
    for (double s : target)
      if (s < t) frr += 1.0;
    for (double s : nontarget)
      if (s >= t) far += 1.0;
    frr /= std::max<size_t>(target.size(), 1);
    far /= std::max<size_t>(nontarget.size(), 1);
    double diff = std::fabs(frr - far);
    if (diff < best_diff) {
      best_diff = diff;
      eer = (frr + far) / 2.0;
      thr = t;
    }
  }
  if (threshold) *threshold = thr;
  return eer;
}

}  // namespace spoofkit
