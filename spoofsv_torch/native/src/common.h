// Small dense linear-algebra helpers for the spoofkit native library.
//
// This library is the TPU-framework's native replacement for the external
// Kaldi C++ binaries the reference shells out to (kaldi_ivectors/run.sh:92-158):
// MFCC + energy VAD + diagonal/full UBM EM + i-vector extractor + PLDA + EER.
// Row-major float64 matrices in flat std::vector storage; no external deps.

#pragma once

#include <algorithm>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace spoofkit {

using Vec = std::vector<double>;

struct Mat {
  int rows = 0, cols = 0;
  Vec data;
  Mat() = default;
  Mat(int r, int c) : rows(r), cols(c), data((size_t)r * c, 0.0) {}
  double* operator[](int r) { return data.data() + (size_t)r * cols; }
  const double* operator[](int r) const { return data.data() + (size_t)r * cols; }
  double& at(int r, int c) { return data[(size_t)r * cols + c]; }
  double at(int r, int c) const { return data[(size_t)r * cols + c]; }
  void setZero() { std::fill(data.begin(), data.end(), 0.0); }
};

// C = A * B
inline Mat matmul(const Mat& A, const Mat& B) {
  assert(A.cols == B.rows);
  Mat C(A.rows, B.cols);
  for (int i = 0; i < A.rows; ++i) {
    for (int k = 0; k < A.cols; ++k) {
      double a = A[i][k];
      if (a == 0.0) continue;
      const double* brow = B[k];
      double* crow = C[i];
      for (int j = 0; j < B.cols; ++j) crow[j] += a * brow[j];
    }
  }
  return C;
}

// C = A^T * B
inline Mat matmul_tn(const Mat& A, const Mat& B) {
  assert(A.rows == B.rows);
  Mat C(A.cols, B.cols);
  for (int k = 0; k < A.rows; ++k) {
    const double* arow = A[k];
    const double* brow = B[k];
    for (int i = 0; i < A.cols; ++i) {
      double a = arow[i];
      if (a == 0.0) continue;
      double* crow = C[i];
      for (int j = 0; j < B.cols; ++j) crow[j] += a * brow[j];
    }
  }
  return C;
}

inline Mat transpose(const Mat& A) {
  Mat T(A.cols, A.rows);
  for (int i = 0; i < A.rows; ++i)
    for (int j = 0; j < A.cols; ++j) T[j][i] = A[i][j];
  return T;
}

// Cholesky decomposition of symmetric positive-definite A (in place lower L).
// Returns false if not PD (after jitter attempts the caller may retry).
inline bool cholesky(const Mat& A, Mat* L) {
  int n = A.rows;
  *L = Mat(n, n);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = A[i][j];
      for (int k = 0; k < j; ++k) s -= (*L)[i][k] * (*L)[j][k];
      if (i == j) {
        if (s <= 0.0) return false;
        (*L)[i][i] = std::sqrt(s);
      } else {
        (*L)[i][j] = s / (*L)[j][j];
      }
    }
  }
  return true;
}

// Solve A x = b for SPD A via Cholesky. Returns x.
inline Vec chol_solve(const Mat& A, const Vec& b) {
  Mat L;
  Mat Aj = A;
  double jitter = 1e-10;
  while (!cholesky(Aj, &L)) {
    for (int i = 0; i < Aj.rows; ++i) Aj[i][i] += jitter;
    jitter *= 10.0;
  }
  int n = A.rows;
  Vec y(n), x(n);
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = y[i];
    for (int k = i + 1; k < n; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  return x;
}

// Inverse of SPD matrix via Cholesky; also returns log determinant.
inline Mat spd_inverse(const Mat& A, double* logdet = nullptr) {
  int n = A.rows;
  Mat L;
  Mat Aj = A;
  double jitter = 1e-10;
  while (!cholesky(Aj, &L)) {
    for (int i = 0; i < Aj.rows; ++i) Aj[i][i] += jitter;
    jitter *= 10.0;
  }
  if (logdet) {
    double ld = 0.0;
    for (int i = 0; i < n; ++i) ld += 2.0 * std::log(L[i][i]);
    *logdet = ld;
  }
  // invert L (lower triangular)
  Mat Linv(n, n);
  for (int i = 0; i < n; ++i) {
    Linv[i][i] = 1.0 / L[i][i];
    for (int j = 0; j < i; ++j) {
      double s = 0.0;
      for (int k = j; k < i; ++k) s -= L[i][k] * Linv[k][j];
      Linv[i][j] = s / L[i][i];
    }
  }
  // A^-1 = Linv^T Linv
  Mat Ainv(n, n);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      double s = 0.0;
      for (int k = std::max(i, j); k < n; ++k) s += Linv[k][i] * Linv[k][j];
      Ainv[i][j] = s;
    }
  return Ainv;
}

// Jacobi eigendecomposition of a symmetric matrix. A = V diag(w) V^T.
// Eigenvalues ascending. Good enough for PLDA dims (~100-400).
inline void sym_eig(const Mat& A_in, Vec* w, Mat* V) {
  int n = A_in.rows;
  Mat A = A_in;
  *V = Mat(n, n);
  for (int i = 0; i < n; ++i) (*V)[i][i] = 1.0;
  for (int sweep = 0; sweep < 100; ++sweep) {
    double off = 0.0;
    for (int p = 0; p < n; ++p)
      for (int q = p + 1; q < n; ++q) off += A[p][q] * A[p][q];
    if (off < 1e-20) break;
    for (int p = 0; p < n; ++p) {
      for (int q = p + 1; q < n; ++q) {
        if (std::fabs(A[p][q]) < 1e-300) continue;
        double theta = (A[q][q] - A[p][p]) / (2.0 * A[p][q]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
        double c = 1.0 / std::sqrt(t * t + 1.0);
        double s = t * c;
        for (int k = 0; k < n; ++k) {
          double akp = A[k][p], akq = A[k][q];
          A[k][p] = c * akp - s * akq;
          A[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < n; ++k) {
          double apk = A[p][k], aqk = A[q][k];
          A[p][k] = c * apk - s * aqk;
          A[q][k] = s * apk + c * aqk;
        }
        for (int k = 0; k < n; ++k) {
          double vkp = (*V)[k][p], vkq = (*V)[k][q];
          (*V)[k][p] = c * vkp - s * vkq;
          (*V)[k][q] = s * vkp + c * vkq;
        }
      }
    }
  }
  w->resize(n);
  for (int i = 0; i < n; ++i) (*w)[i] = A[i][i];
  // sort ascending with eigenvectors
  std::vector<int> idx(n);
  for (int i = 0; i < n; ++i) idx[i] = i;
  std::sort(idx.begin(), idx.end(), [&](int a, int b) { return (*w)[a] < (*w)[b]; });
  Vec w2(n);
  Mat V2(n, n);
  for (int i = 0; i < n; ++i) {
    w2[i] = (*w)[idx[i]];
    for (int k = 0; k < n; ++k) V2[k][i] = (*V)[k][idx[i]];
  }
  *w = w2;
  *V = V2;
}

}  // namespace spoofkit
