// C API for libspoofkit — ctypes-facing surface of the native speaker-ID stack.
//
// Single translation unit: includes the implementation files directly so the
// whole library builds with one `g++ -shared` invocation (see ../Makefile).

#include "common.h"
#include "mfcc.cc"
#include "gmm.cc"
#include "ivector.cc"
#include "plda.cc"
#include "flac.cc"
#include "webrtc_vad.cc"

#include <cstdio>

using namespace spoofkit;

extern "C" {

// ---------------- MFCC ----------------
void* sk_mfcc_new(int sample_rate, int num_mel, int num_ceps) {
  MfccConfig cfg;
  cfg.sample_rate = sample_rate;
  cfg.num_mel = num_mel;
  cfg.num_ceps = num_ceps;
  if (sample_rate > 16000) cfg.high_freq = sample_rate / 2.0 - 400.0;
  return new MfccComputer(cfg);
}

void sk_mfcc_free(void* h) { delete (MfccComputer*)h; }

int sk_mfcc_num_frames(void* h, int n_samples) {
  return ((MfccComputer*)h)->num_frames(n_samples);
}

void sk_mfcc_compute(void* h, const float* wav, int n, double* feats_out,
                     double* log_e_out) {
  Mat feats;
  Vec log_e;
  ((MfccComputer*)h)->compute(wav, n, &feats, &log_e);
  std::memcpy(feats_out, feats.data.data(), feats.data.size() * sizeof(double));
  std::memcpy(log_e_out, log_e.data(), log_e.size() * sizeof(double));
}

void sk_energy_vad(const double* log_e, int T, double threshold,
                   double mean_scale, int context, double proportion,
                   uint8_t* out) {
  Vec e(log_e, log_e + T);
  std::vector<uint8_t> voiced;
  energy_vad(e, threshold, mean_scale, context, proportion, &voiced);
  std::memcpy(out, voiced.data(), T);
}

// out must hold T * D * (order+1) doubles.
void sk_add_deltas(const double* feats, int T, int D, int order, int window,
                   double* out) {
  Mat in(T, D);
  std::memcpy(in.data.data(), feats, (size_t)T * D * sizeof(double));
  Mat d;
  compute_deltas(in, order, window, &d);
  std::memcpy(out, d.data.data(), d.data.size() * sizeof(double));
}

void sk_cmvn_sliding(double* feats, int T, int D, int window) {
  Mat m(T, D);
  std::memcpy(m.data.data(), feats, (size_t)T * D * sizeof(double));
  cmvn_sliding(&m, window);
  std::memcpy(feats, m.data.data(), (size_t)T * D * sizeof(double));
}

// ---------------- diag UBM ----------------
void* sk_train_diag_ubm(const double* frames, int N, int D, int C, int iters,
                        uint64_t seed, int verbose) {
  Mat f(N, D);
  std::memcpy(f.data.data(), frames, (size_t)N * D * sizeof(double));
  return new DiagGmm(train_diag_ubm(f, C, iters, seed, verbose));
}

void sk_diag_ubm_get(void* h, double* weights, double* means, double* vars) {
  DiagGmm* g = (DiagGmm*)h;
  std::memcpy(weights, g->weights.data(), g->num_comp * sizeof(double));
  std::memcpy(means, g->means.data.data(),
              g->means.data.size() * sizeof(double));
  std::memcpy(vars, g->vars.data.data(), g->vars.data.size() * sizeof(double));
}

void* sk_diag_ubm_from(const double* weights, const double* means,
                       const double* vars, int C, int D) {
  DiagGmm* g = new DiagGmm();
  g->num_comp = C;
  g->dim = D;
  g->weights.assign(weights, weights + C);
  g->means = Mat(C, D);
  g->vars = Mat(C, D);
  std::memcpy(g->means.data.data(), means, (size_t)C * D * sizeof(double));
  std::memcpy(g->vars.data.data(), vars, (size_t)C * D * sizeof(double));
  return g;
}

void sk_diag_ubm_free(void* h) { delete (DiagGmm*)h; }

void sk_acc_stats(void* ubm, const double* feats, int T, int D, double* N_out,
                  double* F_out) {
  DiagGmm* g = (DiagGmm*)ubm;
  Mat f(T, D);
  std::memcpy(f.data.data(), feats, (size_t)T * D * sizeof(double));
  DiagGmmScorer scorer(*g);
  Vec N_c;
  Mat F_c;
  accumulate_stats(scorer, f, &N_c, &F_c);
  std::memcpy(N_out, N_c.data(), N_c.size() * sizeof(double));
  std::memcpy(F_out, F_c.data.data(), F_c.data.size() * sizeof(double));
}

// ---------------- full-covariance UBM ----------------
void* sk_train_full_ubm(void* diag_handle, const double* frames, int N, int D,
                        int iters, int verbose) {
  Mat f(N, D);
  std::memcpy(f.data.data(), frames, (size_t)N * D * sizeof(double));
  return new FullGmm(train_full_ubm(f, *(DiagGmm*)diag_handle, iters, verbose));
}

void sk_full_ubm_get(void* h, double* weights, double* means, double* covs) {
  FullGmm* g = (FullGmm*)h;
  int C = g->num_comp, D = g->dim;
  std::memcpy(weights, g->weights.data(), C * sizeof(double));
  std::memcpy(means, g->means.data.data(), (size_t)C * D * sizeof(double));
  for (int c = 0; c < C; ++c)
    std::memcpy(covs + (size_t)c * D * D, g->covs[c].data.data(),
                (size_t)D * D * sizeof(double));
}

void* sk_full_ubm_from(const double* weights, const double* means,
                       const double* covs, int C, int D) {
  FullGmm* g = new FullGmm();
  g->num_comp = C;
  g->dim = D;
  g->weights.assign(weights, weights + C);
  g->means = Mat(C, D);
  std::memcpy(g->means.data.data(), means, (size_t)C * D * sizeof(double));
  g->covs.assign(C, Mat(D, D));
  for (int c = 0; c < C; ++c)
    std::memcpy(g->covs[c].data.data(), covs + (size_t)c * D * D,
                (size_t)D * D * sizeof(double));
  g->refresh_inverses();
  return g;
}

void sk_full_ubm_free(void* h) { delete (FullGmm*)h; }

void sk_full_acc_stats(void* fubm, const double* feats, int T, int D,
                       double* N_out, double* F_out) {
  FullGmm* g = (FullGmm*)fubm;
  Mat f(T, D);
  std::memcpy(f.data.data(), feats, (size_t)T * D * sizeof(double));
  FullGmmScorer scorer(*g);
  Vec N_c;
  Mat F_c;
  accumulate_stats_full(scorer, f, &N_c, &F_c);
  std::memcpy(N_out, N_c.data(), N_c.size() * sizeof(double));
  std::memcpy(F_out, F_c.data.data(), F_c.data.size() * sizeof(double));
}

// ---------------- i-vector extractor ----------------
void* sk_train_ivector(const double* means, const double* vars, int C, int D,
                       int R, const double* allN, const double* allF, int U,
                       int iters, uint64_t seed, int verbose) {
  Mat m(C, D), v(C, D);
  std::memcpy(m.data.data(), means, (size_t)C * D * sizeof(double));
  std::memcpy(v.data.data(), vars, (size_t)C * D * sizeof(double));
  std::vector<Vec> N_list(U, Vec(C));
  std::vector<Mat> F_list(U, Mat(C, D));
  for (int u = 0; u < U; ++u) {
    std::memcpy(N_list[u].data(), allN + (size_t)u * C, C * sizeof(double));
    std::memcpy(F_list[u].data.data(), allF + (size_t)u * C * D,
                (size_t)C * D * sizeof(double));
  }
  return new IvectorExtractor(train_ivector_extractor(
      m, v, R, N_list, F_list, iters, seed, verbose));
}

int sk_ivector_dim(void* h) { return ((IvectorExtractor*)h)->ivec_dim; }

void sk_extract_ivector(void* h, const double* Nc, const double* Fc,
                        double* out) {
  IvectorExtractor* ext = (IvectorExtractor*)h;
  Vec N(Nc, Nc + ext->num_comp);
  Mat F(ext->num_comp, ext->dim);
  std::memcpy(F.data.data(), Fc,
              (size_t)ext->num_comp * ext->dim * sizeof(double));
  Vec iv = extract_ivector(*ext, N, F);
  std::memcpy(out, iv.data(), iv.size() * sizeof(double));
}

void sk_ivector_free(void* h) { delete (IvectorExtractor*)h; }

// Serialization (model caching across runs — the reference trains the
// extractor on the first run only, kaldi_ivectors/run.sh:105-129).
// T laid out (C, D, R); means (C, D); inv_vars (C, D).
void sk_ivector_get(void* h, double* T_out, double* means_out,
                    double* inv_vars_out) {
  IvectorExtractor* e = (IvectorExtractor*)h;
  size_t DR = (size_t)e->dim * e->ivec_dim;
  for (int c = 0; c < e->num_comp; ++c)
    std::memcpy(T_out + c * DR, e->T[c].data.data(), DR * sizeof(double));
  std::memcpy(means_out, e->ubm_means.data.data(),
              e->ubm_means.data.size() * sizeof(double));
  std::memcpy(inv_vars_out, e->ubm_inv_vars.data.data(),
              e->ubm_inv_vars.data.size() * sizeof(double));
}

void* sk_ivector_from(const double* T, const double* means,
                      const double* inv_vars, int C, int D, int R) {
  IvectorExtractor* e = new IvectorExtractor();
  e->num_comp = C;
  e->dim = D;
  e->ivec_dim = R;
  e->T.assign(C, Mat(D, R));
  size_t DR = (size_t)D * R;
  for (int c = 0; c < C; ++c)
    std::memcpy(e->T[c].data.data(), T + c * DR, DR * sizeof(double));
  e->ubm_means = Mat(C, D);
  e->ubm_inv_vars = Mat(C, D);
  std::memcpy(e->ubm_means.data.data(), means, (size_t)C * D * sizeof(double));
  std::memcpy(e->ubm_inv_vars.data.data(), inv_vars,
              (size_t)C * D * sizeof(double));
  return e;
}

// ---------------- full-covariance i-vector extractor ----------------
void* sk_train_ivector_full(void* fubm, int R, const double* allN,
                            const double* allF, int U, int iters,
                            uint64_t seed, int verbose) {
  FullGmm* g = (FullGmm*)fubm;
  int C = g->num_comp, D = g->dim;
  std::vector<Vec> N_list(U, Vec(C));
  std::vector<Mat> F_list(U, Mat(C, D));
  for (int u = 0; u < U; ++u) {
    std::memcpy(N_list[u].data(), allN + (size_t)u * C, C * sizeof(double));
    std::memcpy(F_list[u].data.data(), allF + (size_t)u * C * D,
                (size_t)C * D * sizeof(double));
  }
  return new IvectorExtractorFull(train_ivector_extractor_full(
      g->means, g->inv_covs, R, N_list, F_list, iters, seed, verbose));
}

int sk_ivector_full_dim(void* h) { return ((IvectorExtractorFull*)h)->ivec_dim; }

void sk_extract_ivector_full(void* h, const double* Nc, const double* Fc,
                             double* out) {
  IvectorExtractorFull* ext = (IvectorExtractorFull*)h;
  Vec N(Nc, Nc + ext->num_comp);
  Mat F(ext->num_comp, ext->dim);
  std::memcpy(F.data.data(), Fc,
              (size_t)ext->num_comp * ext->dim * sizeof(double));
  Vec iv = extract_ivector_full(*ext, N, F);
  std::memcpy(out, iv.data(), iv.size() * sizeof(double));
}

void sk_ivector_full_free(void* h) { delete (IvectorExtractorFull*)h; }

// T laid out (C, D, R); means (C, D); inv_covs (C, D, D).
void sk_ivector_full_get(void* h, double* T_out, double* means_out,
                         double* inv_covs_out) {
  IvectorExtractorFull* e = (IvectorExtractorFull*)h;
  size_t DR = (size_t)e->dim * e->ivec_dim;
  size_t DD = (size_t)e->dim * e->dim;
  for (int c = 0; c < e->num_comp; ++c) {
    std::memcpy(T_out + c * DR, e->T[c].data.data(), DR * sizeof(double));
    std::memcpy(inv_covs_out + c * DD, e->inv_covs[c].data.data(),
                DD * sizeof(double));
  }
  std::memcpy(means_out, e->ubm_means.data.data(),
              e->ubm_means.data.size() * sizeof(double));
}

void* sk_ivector_full_from(const double* T, const double* means,
                           const double* inv_covs, int C, int D, int R) {
  IvectorExtractorFull* e = new IvectorExtractorFull();
  e->num_comp = C;
  e->dim = D;
  e->ivec_dim = R;
  e->T.assign(C, Mat(D, R));
  e->inv_covs.assign(C, Mat(D, D));
  size_t DR = (size_t)D * R;
  size_t DD = (size_t)D * D;
  for (int c = 0; c < C; ++c) {
    std::memcpy(e->T[c].data.data(), T + c * DR, DR * sizeof(double));
    std::memcpy(e->inv_covs[c].data.data(), inv_covs + c * DD,
                DD * sizeof(double));
  }
  e->ubm_means = Mat(C, D);
  std::memcpy(e->ubm_means.data.data(), means, (size_t)C * D * sizeof(double));
  e->refresh();
  return e;
}

// ---------------- PLDA ----------------
void* sk_train_plda(const double* ivecs, int N, int D, const int* labels,
                    int num_spk, int verbose) {
  Mat m(N, D);
  std::memcpy(m.data.data(), ivecs, (size_t)N * D * sizeof(double));
  std::vector<int> lab(labels, labels + N);
  return new Plda(train_plda(m, lab, num_spk, verbose));
}

void sk_plda_transform(void* h, const double* x, double* out) {
  Plda* p = (Plda*)h;
  Vec o;
  plda_transform(*p, x, &o);
  std::memcpy(out, o.data(), o.size() * sizeof(double));
}

double sk_plda_llr(void* h, const double* enroll_mean_t, int n,
                   const double* test_t) {
  Plda* p = (Plda*)h;
  Vec e(enroll_mean_t, enroll_mean_t + p->dim);
  Vec t(test_t, test_t + p->dim);
  return plda_llr(*p, e, n, t);
}

void sk_plda_free(void* h) { delete (Plda*)h; }

// mean (D); transform (D, D); psi (D).
void sk_plda_get(void* h, double* mean, double* transform, double* psi) {
  Plda* p = (Plda*)h;
  std::memcpy(mean, p->mean.data(), p->dim * sizeof(double));
  std::memcpy(transform, p->transform.data.data(),
              (size_t)p->dim * p->dim * sizeof(double));
  std::memcpy(psi, p->psi.data(), p->dim * sizeof(double));
}

void* sk_plda_from(const double* mean, const double* transform,
                   const double* psi, int D) {
  Plda* p = new Plda();
  p->dim = D;
  p->mean.assign(mean, mean + D);
  p->transform = Mat(D, D);
  std::memcpy(p->transform.data.data(), transform,
              (size_t)D * D * sizeof(double));
  p->psi.assign(psi, psi + D);
  return p;
}

double sk_compute_eer(const double* target, int nt, const double* nontarget,
                      int nn, double* threshold) {
  Vec t(target, target + nt), n(nontarget, nontarget + nn);
  return compute_eer(t, n, threshold);
}

// ---------------- FLAC codec ----------------
static std::vector<uint8_t> _read_file(const char* path) {
  std::vector<uint8_t> buf;
  FILE* f = std::fopen(path, "rb");
  if (!f) return buf;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize((size_t)std::max(0L, n));
  if (n > 0 && std::fread(buf.data(), 1, (size_t)n, f) != (size_t)n)
    buf.clear();
  std::fclose(f);
  return buf;
}

// Probe: fills (n_samples per channel, sample_rate, channels, bits).
// Returns 0 on success.
int sk_flac_probe(const char* path, int64_t* n_samples, int* sr, int* ch,
                  int* bits) {
  std::vector<uint8_t> buf = _read_file(path);
  FlacInfo info;
  if (buf.empty() || !flac_parse_header(buf.data(), buf.size(), &info))
    return -1;
  *n_samples = info.total_samples;
  *sr = info.sample_rate;
  *ch = info.channels;
  *bits = info.bits;
  return 0;
}

// Decode whole file into interleaved int32. `out` must hold
// n_samples*channels entries (from sk_flac_probe). Returns samples per
// channel actually decoded, or -1.
int64_t sk_flac_decode(const char* path, int32_t* out, int64_t capacity) {
  std::vector<uint8_t> buf = _read_file(path);
  if (buf.empty()) return -1;
  FlacInfo info;
  std::vector<int32_t> pcm;
  int64_t n = flac_decode_buffer(buf.data(), buf.size(), &info, &pcm);
  if (n < 0) return -1;
  int64_t count = std::min<int64_t>((int64_t)pcm.size(), capacity);
  std::memcpy(out, pcm.data(), (size_t)count * sizeof(int32_t));
  return n;
}

// Encode interleaved int32 PCM to a FLAC file. Returns 0 on success.
int sk_flac_encode(const char* path, const int32_t* pcm, int64_t n_per_ch,
                   int channels, int sample_rate, int bits) {
  std::vector<uint8_t> out;
  flac_encode(pcm, n_per_ch, channels, sample_rate, bits, &out);
  if (out.empty()) return -1;  // unsupported bit width
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t wrote = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return wrote == out.size() ? 0 : -1;
}

// Decode with C-side allocation — handles legal unknown-length streams
// (STREAMINFO total_samples == 0). Returns an opaque buffer handle (or NULL)
// and fills the metadata out-params; copy with sk_flac_pcm_copy, release
// with sk_flac_pcm_free.
void* sk_flac_decode_alloc(const char* path, int64_t* n_per_ch, int* sr,
                           int* ch, int* bits) {
  std::vector<uint8_t> buf = _read_file(path);
  if (buf.empty()) return nullptr;
  FlacInfo info;
  auto* pcm = new std::vector<int32_t>();
  int64_t n = flac_decode_buffer(buf.data(), buf.size(), &info, pcm);
  if (n < 0) { delete pcm; return nullptr; }
  *n_per_ch = n;
  *sr = info.sample_rate;
  *ch = info.channels;
  *bits = info.bits;
  return pcm;
}

void sk_flac_pcm_copy(void* h, int32_t* out) {
  auto* pcm = (std::vector<int32_t>*)h;
  std::memcpy(out, pcm->data(), pcm->size() * sizeof(int32_t));
}

void sk_flac_pcm_free(void* h) { delete (std::vector<int32_t>*)h; }

// ---------------- WebRTC VAD (fixed-point GMM transcription) ----------------

// New detector at aggressiveness |mode| (0-3, webrtcvad.Vad(mode)).
void* sk_vad_new(int mode) {
  auto* inst = new webrtcvad::VadInst();
  webrtcvad::InitCore(inst);
  if (webrtcvad::SetMode(inst, mode) != 0) {
    delete inst;
    return nullptr;
  }
  return inst;
}

void sk_vad_free(void* h) { delete (webrtcvad::VadInst*)h; }

// One frame decision: 1 speech, 0 non-speech, -1 invalid input. Stateful —
// feed frames in stream order (models adapt). Valid frames: 10/20/30 ms at
// 8 or 16 kHz (the reference feeds 20 ms @ 16 kHz, VAD_segments.py:135).
int sk_vad_process(void* h, const int16_t* frame, int n, int sample_rate) {
  auto* inst = (webrtcvad::VadInst*)h;
  int vad;
  if (sample_rate == 8000) {
    if (n != 80 && n != 160 && n != 240) return -1;
    vad = webrtcvad::CalcVad8khz(inst, frame, (size_t)n);
  } else if (sample_rate == 16000) {
    if (n != 160 && n != 320 && n != 480) return -1;
    vad = webrtcvad::CalcVad16khz(inst, frame, (size_t)n);
  } else {
    return -1;
  }
  return vad > 0 ? 1 : 0;
}

// Batch helper: classify every complete frame of |audio| (one detector,
// stream order), writing 0/1 flags under the reference's strict
// offset + n < len frame rule (VAD_segments.py:57). Returns frame count.
int sk_vad_frames(int mode, const int16_t* audio, int64_t n_samples,
                  int frame_len, int sample_rate, uint8_t* flags_out) {
  void* h = sk_vad_new(mode);
  if (!h) return -1;
  int count = 0;
  for (int64_t off = 0; off + frame_len < n_samples; off += frame_len) {
    int v = sk_vad_process(h, audio + off, frame_len, sample_rate);
    if (v < 0) {
      sk_vad_free(h);
      return -1;
    }
    flags_out[count++] = (uint8_t)v;
  }
  sk_vad_free(h);
  return count;
}

// Introspection for invariant tests: the six Q4 band log-energies and the
// total-energy gate of one 8 kHz frame (fresh filterbank state).
int sk_vad_features(const int16_t* frame8k, int n, int16_t* features_out) {
  webrtcvad::VadInst inst;
  webrtcvad::InitCore(&inst);
  return webrtcvad::CalculateFeatures(&inst, frame8k, (size_t)n,
                                      features_out);
}

}  // extern "C"
