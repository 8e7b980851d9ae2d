// MFCC feature extraction + energy VAD + sliding CMVN.
//
// Native equivalent of the Kaldi front-end the reference invokes
// (kaldi_ivectors/run.sh:92-103 with conf/mfcc.conf: 16 kHz, 40 mel bins,
// 20 cepstra; sid/compute_vad_decision.sh energy VAD). Kaldi-style processing:
// dither-free, pre-emphasis 0.97, 25 ms povey window / 10 ms shift, radix-2
// real FFT (512), mel filterbank, DCT-II with ortho scaling, cepstral liftering,
// C0 replaced by log energy.

#include "common.h"

namespace spoofkit {

static void fft_radix2(Vec& re, Vec& im) {
  int n = (int)re.size();
  // bit reversal
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (int len = 2; len <= n; len <<= 1) {
    double ang = -2.0 * M_PI / len;
    double wr = std::cos(ang), wi = std::sin(ang);
    for (int i = 0; i < n; i += len) {
      double cr = 1.0, ci = 0.0;
      for (int k = 0; k < len / 2; ++k) {
        double ur = re[i + k], ui = im[i + k];
        double vr = re[i + k + len / 2] * cr - im[i + k + len / 2] * ci;
        double vi = re[i + k + len / 2] * ci + im[i + k + len / 2] * cr;
        re[i + k] = ur + vr;
        im[i + k] = ui + vi;
        re[i + k + len / 2] = ur - vr;
        im[i + k + len / 2] = ui - vi;
        double ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr;
        cr = ncr;
      }
    }
  }
}

static double mel_scale(double f) { return 1127.0 * std::log(1.0 + f / 700.0); }

struct MfccConfig {
  int sample_rate = 16000;
  int num_mel = 40;
  int num_ceps = 20;
  double frame_ms = 25.0;
  double shift_ms = 10.0;
  double preemph = 0.97;
  double low_freq = 20.0;
  double high_freq = 7600.0;
  double lifter = 22.0;
  int n_fft = 512;
};

class MfccComputer {
 public:
  explicit MfccComputer(const MfccConfig& cfg) : cfg_(cfg) {
    win_len_ = (int)(cfg.sample_rate * cfg.frame_ms / 1000.0);
    shift_ = (int)(cfg.sample_rate * cfg.shift_ms / 1000.0);
    while (cfg_.n_fft < win_len_) cfg_.n_fft <<= 1;
    // povey window (kaldi default): (0.5 - 0.5 cos)^0.85
    window_.resize(win_len_);
    for (int i = 0; i < win_len_; ++i) {
      double h = 0.5 - 0.5 * std::cos(2.0 * M_PI * i / (win_len_ - 1));
      window_[i] = std::pow(h, 0.85);
    }
    build_mel_banks();
    // DCT-II matrix (ortho) and lifter coefficients
    dct_ = Mat(cfg.num_ceps, cfg.num_mel);
    for (int k = 0; k < cfg.num_ceps; ++k) {
      double norm = std::sqrt((k == 0 ? 1.0 : 2.0) / cfg.num_mel);
      for (int m = 0; m < cfg.num_mel; ++m)
        dct_[k][m] = norm * std::cos(M_PI * k * (m + 0.5) / cfg.num_mel);
    }
    lifter_.resize(cfg.num_ceps);
    for (int k = 0; k < cfg.num_ceps; ++k)
      lifter_[k] = 1.0 + 0.5 * cfg.lifter * std::sin(M_PI * k / cfg.lifter);
  }

  int num_frames(int n_samples) const {
    if (n_samples < win_len_) return 0;
    return 1 + (n_samples - win_len_) / shift_;
  }

  // features out: (num_frames, num_ceps); log_energy out: (num_frames)
  void compute(const float* wav, int n, Mat* feats, Vec* log_energy) const {
    int T = num_frames(n);
    *feats = Mat(T, cfg_.num_ceps);
    log_energy->assign(T, 0.0);
    int nfft = cfg_.n_fft;
    int nbins = nfft / 2 + 1;
    Vec re(nfft), im(nfft), mel(cfg_.num_mel);
    for (int t = 0; t < T; ++t) {
      const float* frame = wav + (size_t)t * shift_;
      std::fill(re.begin(), re.end(), 0.0);
      std::fill(im.begin(), im.end(), 0.0);
      // dc offset removal + raw energy (kaldi --raw-energy default: energy
      // BEFORE preemphasis/windowing) + preemphasis + window
      double mean = 0.0;
      for (int i = 0; i < win_len_; ++i) mean += frame[i];
      mean /= win_len_;
      double energy = 0.0;
      for (int i = 0; i < win_len_; ++i) {
        double s = frame[i] - mean;
        energy += s * s;
        double prev = (i == 0 ? s : frame[i - 1] - mean);
        re[i] = (s - cfg_.preemph * prev) * window_[i];
      }
      (*log_energy)[t] = std::log(std::max(energy, 1e-15));
      fft_radix2(re, im);
      // power spectrum → mel energies → log → DCT → lifter
      std::fill(mel.begin(), mel.end(), 0.0);
      for (int m = 0; m < cfg_.num_mel; ++m) {
        double acc = 0.0;
        for (int b = bank_lo_[m]; b < bank_hi_[m]; ++b) {
          double p = re[b] * re[b] + im[b] * im[b];
          acc += p * banks_[m][b];
        }
        mel[m] = std::log(std::max(acc, 1e-15));
      }
      for (int k = 0; k < cfg_.num_ceps; ++k) {
        double s = 0.0;
        for (int m = 0; m < cfg_.num_mel; ++m) s += dct_[k][m] * mel[m];
        (*feats)[t][k] = s * lifter_[k];
      }
      // replace C0 with log energy (kaldi --use-energy=true default)
      (*feats)[t][0] = (*log_energy)[t];
    }
  }

 private:
  void build_mel_banks() {
    int nbins = cfg_.n_fft / 2 + 1;
    banks_.assign(cfg_.num_mel, Vec(nbins, 0.0));
    bank_lo_.assign(cfg_.num_mel, nbins);
    bank_hi_.assign(cfg_.num_mel, 0);
    double mel_lo = mel_scale(cfg_.low_freq);
    double mel_hi = mel_scale(std::min(cfg_.high_freq, cfg_.sample_rate / 2.0));
    for (int m = 0; m < cfg_.num_mel; ++m) {
      double left = mel_lo + (mel_hi - mel_lo) * m / (cfg_.num_mel + 1);
      double center = mel_lo + (mel_hi - mel_lo) * (m + 1) / (cfg_.num_mel + 1);
      double right = mel_lo + (mel_hi - mel_lo) * (m + 2) / (cfg_.num_mel + 1);
      for (int b = 0; b < nbins; ++b) {
        double freq = (double)b * cfg_.sample_rate / cfg_.n_fft;
        double melf = mel_scale(freq);
        double w = 0.0;
        if (melf > left && melf < right)
          w = (melf <= center) ? (melf - left) / (center - left)
                               : (right - melf) / (right - center);
        if (w > 0.0) {
          banks_[m][b] = w;
          bank_lo_[m] = std::min(bank_lo_[m], b);
          bank_hi_[m] = std::max(bank_hi_[m], b + 1);
        }
      }
    }
  }

  MfccConfig cfg_;
  int win_len_ = 0, shift_ = 0;
  Vec window_, lifter_;
  std::vector<Vec> banks_;
  std::vector<int> bank_lo_, bank_hi_;
  Mat dct_;
};

// Kaldi-style energy VAD (sid/compute_vad_decision.sh → vad-energy):
// frame voiced if log_energy > threshold + mean_scale * mean(log_energy),
// with ±context majority voting (proportion_threshold).
void energy_vad(const Vec& log_energy, double threshold, double mean_scale,
                int context, double proportion, std::vector<uint8_t>* voiced) {
  int T = (int)log_energy.size();
  voiced->assign(T, 0);
  double mean = 0.0;
  for (double e : log_energy) mean += e;
  mean /= std::max(T, 1);
  double cut = threshold + mean_scale * mean;
  for (int t = 0; t < T; ++t) {
    int num = 0, den = 0;
    for (int c = -context; c <= context; ++c) {
      int i = t + c;
      if (i < 0 || i >= T) continue;
      ++den;
      if (log_energy[i] > cut) ++num;
    }
    (*voiced)[t] = (num >= proportion * den) ? 1 : 0;
  }
}

// Kaldi add-deltas (feat/feature-functions.cc DeltaFeatures): order-o deltas
// via repeated linear regression over a ±window context, edge frames clamped.
// The sid/ scripts the reference drives (kaldi_ivectors/run.sh:108-118 →
// sid/train_diag_ubm.sh etc.) apply this with --delta-order=2
// --delta-window=3 before sliding CMVN, turning 20 cepstra into 60-dim
// features. Output is (T, D*(order+1)) with [static | d | dd] blocks.
void compute_deltas(const Mat& in, int order, int window, Mat* out) {
  int T = in.rows, D = in.cols;
  // Regression-coefficient pyramid: scales[0] = [1]; scales[i] is the
  // convolution of scales[i-1] with the normalized ramp j/sum(j^2),
  // j in [-window, window].
  std::vector<Vec> scales(order + 1);
  scales[0] = Vec{1.0};
  for (int i = 1; i <= order; ++i) {
    const Vec& prev = scales[i - 1];
    int prev_offset = ((int)prev.size() - 1) / 2;
    int cur_offset = prev_offset + window;
    Vec cur(prev.size() + 2 * (size_t)window, 0.0);
    double normalizer = 0.0;
    for (int j = -window; j <= window; ++j) {
      normalizer += (double)j * j;
      for (int k = -prev_offset; k <= prev_offset; ++k)
        cur[j + k + cur_offset] += (double)j * prev[k + prev_offset];
    }
    for (double& v : cur) v /= normalizer;
    scales[i] = cur;
  }
  *out = Mat(T, D * (order + 1));
  for (int t = 0; t < T; ++t) {
    for (int i = 0; i <= order; ++i) {
      const Vec& sc = scales[i];
      int max_offset = ((int)sc.size() - 1) / 2;
      double* dst = &(*out)[t][i * D];
      for (int j = -max_offset; j <= max_offset; ++j) {
        double s = sc[j + max_offset];
        if (s == 0.0) continue;
        int src = std::min(std::max(t + j, 0), T - 1);
        for (int d = 0; d < D; ++d) dst[d] += s * in[src][d];
      }
    }
  }
}

// Sliding-window cepstral mean normalization (kaldi apply-cmvn-sliding,
// window 300, center).
void cmvn_sliding(Mat* feats, int window) {
  int T = feats->rows, D = feats->cols;
  Mat out(T, D);
  for (int t = 0; t < T; ++t) {
    int lo = std::max(0, t - window / 2);
    int hi = std::min(T, lo + window);
    lo = std::max(0, hi - window);
    for (int d = 0; d < D; ++d) {
      double m = 0.0;
      for (int i = lo; i < hi; ++i) m += (*feats)[i][d];
      m /= (hi - lo);
      out[t][d] = (*feats)[t][d] - m;
    }
  }
  *feats = out;
}

}  // namespace spoofkit
