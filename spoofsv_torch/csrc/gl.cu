// K2 (Griffin-Lim phase init) and K3 (Griffin-Lim iterations) for sm_90a.
//
// K2 replaces spoofsv_tpu/ops/pallas_gl.py::_spsi_angles_kernel and the
// init branches of ::_gl_kernel (random hash, advance, spsi). One thread per
// (utterance, bin) walks the frames in order, so the SPSI frame-axis cumsum
// is a running sum in a register; a block is one (utterance, 128-bin chunk).
// Bound: one read of the f32 magnitudes and one write of the f32 (cos, sin)
// pair; the design reads each magnitude three times from L1 (bin neighbours)
// and nothing else.
//
// K3 replaces spoofsv_tpu/ops/pallas_gl.py::_gl_kernel. On the TPU one
// utterance's whole GL state stays in VMEM; on Hopper it does not fit a
// block's shared memory (the f32 carries alone are ~5 MB at T=1300), so the
// state lives in device memory and each iteration is two launches over frames:
//   synthesis  fsyn[t] = w * irfft(mag * ang)[t]
//   analysis   frame t of the centre-padded ISTFT signal, gathered from
//              fsyn[t-3 .. t+3] (overlap-add / window_sumsquare, librosa
//              reflect padding at both ends), windowed, rfft, then momentum
//              and a / (|a| + 1e-16).
// and a final overlap-add epilogue writes the audio. Bound: the per-frame
// 1024-point transforms (f32 radix-2 FFT in shared memory, one block per
// frame) and the device-memory traffic of fsyn and the angle/rebuilt state
// (~3 GB per iteration at B=64, T=1300). The int8 DFT-matmul of the TPU kernel
// is not carried over: everything here is f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INIT_THREADS = 128;
constexpr int FFT_THREADS = 256;
constexpr float WSS_FLOOR = 1e-11f;

enum InitMode { INIT_RANDOM = 0, INIT_ADVANCE = 1, INIT_SPSI = 2 };

// murmur3-style mixer over (frame, bin, seed); pallas_gl.py::_hash_mix in uint32
__device__ __forceinline__ uint32_t hash_mix(uint32_t t, uint32_t k, uint32_t seed) {
  uint32_t h = (t * 73856093u) ^ (k * 19349663u) ^ (seed * 83492791u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float log_mag(const float* row, int k) {
  return logf(fmaxf(row[k], 1e-10f));
}

struct InitConsts {
  float two_pi_over_n;   // float32(2*pi/N)
  float two_pi_over_24;  // float32(2*pi/2^24)
  float hop_over_n;      // float32(hop/N)
  float two_pi;          // float32(2*pi)
  float lock_c;          // float32(lock*pi*(N-1)/N)
};

__global__ void __launch_bounds__(INIT_THREADS)
gl_init_kernel(int mode, const float* __restrict__ mag, const int* __restrict__ seeds,
               float* __restrict__ out_re, float* __restrict__ out_im, int T, int F,
               int n_fft, int hop, InitConsts cst) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * INIT_THREADS + threadIdx.x;
  if (k >= F) return;
  const int hk = (k * hop) % n_fft;
  const uint32_t seed = seeds ? (uint32_t)seeds[b] : 0u;
  const int km = k > 0 ? k - 1 : k, kp = k < F - 1 ? k + 1 : k;
  float cum = 0.f;
  for (int t = 0; t < T; ++t) {
    const size_t o = ((size_t)b * T + t) * F + k;
    float ph;
    if (mode == INIT_RANDOM) {
      ph = (float)(hash_mix((uint32_t)t, (uint32_t)k, seed) & 0xFFFFFFu) * cst.two_pi_over_24;
      out_re[o] = cosf(ph);
      out_im[o] = sinf(ph);
      continue;
    }
    ph = (float)((t * hk) % n_fft) * cst.two_pi_over_n;
    const float b_re = cosf(ph), b_im = sinf(ph);
    if (mode == INIT_ADVANCE) {
      out_re[o] = b_re;
      out_im[o] = b_im;
      continue;
    }
    // spsi: delta from the log-magnitude parabola over (k-1, k, k+1)
    const float* row = mag + ((size_t)b * T + t) * F;
    const float lb = log_mag(row, k), la = log_mag(row, km), lc = log_mag(row, kp);
    const float denom = __fadd_rn(__fsub_rn(la, __fmul_rn(2.f, lb)), lc);
    float delta = 0.f;
    if (denom < -1e-6f) delta = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(la, lc)), denom);
    delta = fminf(fmaxf(delta, -0.5f), 0.5f);
    cum = __fadd_rn(cum, delta);
    const float cyc = __fmul_rn(__fsub_rn(cum, delta), cst.hop_over_n);  // exclusive cumsum
    float frac = __fmul_rn(__fsub_rn(cyc, rintf(cyc)), cst.two_pi);
    frac = __fadd_rn(frac, __fmul_rn(delta, cst.lock_c));
    const float c_f = cosf(frac), s_f = sinf(frac);
    out_re[o] = b_re * c_f - b_im * s_f;
    out_im[o] = b_re * s_f + b_im * c_f;
  }
}

// ---------------------------------------------------------------------------
// In-place radix-2 complex FFT of n points in shared memory.
// tw[m] = exp(-2*pi*i*m/n), m < n/2; inverse uses the conjugate (unscaled).
// ---------------------------------------------------------------------------
__device__ void fft_inplace(float2* buf, const float2* __restrict__ tw, int n, int log2n,
                            bool inverse) {
  for (int len = 2, stride = n / 2; len <= n; len <<= 1, stride >>= 1) {
    const int half = len >> 1;
    for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
      const int pos = i % half;
      const int i0 = (i / half) * len + pos, i1 = i0 + half;
      float2 w = tw[pos * stride];
      if (inverse) w.y = -w.y;
      const float2 u = buf[i0], v0 = buf[i1];
      const float2 v = make_float2(v0.x * w.x - v0.y * w.y, v0.x * w.y + v0.y * w.x);
      buf[i0] = make_float2(u.x + v.x, u.y + v.y);
      buf[i1] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int bitrev(int i, int log2n) { return (int)(__brev((unsigned)i) >> (32 - log2n)); }

// fsyn[b, t, :] = window * irfft(mag * ang)[b, t, :]; one block per frame.
__global__ void __launch_bounds__(FFT_THREADS)
gl_synth_kernel(const float* __restrict__ mag, const float* __restrict__ ang_re,
                const float* __restrict__ ang_im, const float* __restrict__ window,
                const float2* __restrict__ tw, float* __restrict__ fsyn, int F, int n_fft,
                int log2n) {
  extern __shared__ float2 buf[];
  const size_t frame = blockIdx.x;
  const float* m = mag + frame * F;
  const float* ar = ang_re + frame * F;
  const float* ai = ang_im + frame * F;
  // Hermitian spectrum, written in bit-reversed order for the DIT passes
  for (int k = threadIdx.x; k < n_fft; k += blockDim.x) {
    float2 x;
    if (k < F) {
      x = make_float2(m[k] * ar[k], m[k] * ai[k]);
    } else {
      const int kk = n_fft - k;
      x = make_float2(m[kk] * ar[kk], -(m[kk] * ai[kk]));
    }
    buf[bitrev(k, log2n)] = x;
  }
  __syncthreads();
  fft_inplace(buf, tw, n_fft, log2n, true);
  const float inv_n = 1.0f / (float)n_fft;
  float* out = fsyn + frame * n_fft;
  for (int j = threadIdx.x; j < n_fft; j += blockDim.x) out[j] = buf[j].x * inv_n * window[j];
}

// ISTFT signal sample at OLA coordinate u (the centre-padded signal index):
// overlap-add of the synthesis frames, divided by window_sumsquare.
__device__ __forceinline__ float ola_sample(const float* __restrict__ fs, const float* __restrict__ wss,
                                            int u, int T, int n_fft, int hop) {
  int t_hi = u / hop;
  if (t_hi > T - 1) t_hi = T - 1;
  int t_lo = u - n_fft + 1;
  t_lo = t_lo <= 0 ? 0 : (t_lo + hop - 1) / hop;
  float acc = 0.f;
  for (int tp = t_lo; tp <= t_hi; ++tp) acc += fs[(size_t)tp * n_fft + (u - hop * tp)];
  const float w = wss[u];
  return w > WSS_FLOOR ? acc / w : acc;
}

// Analysis of frame (b, t): STFT frame of the ISTFT signal (librosa centre +
// reflect padding), momentum and normalise; updates ang and reb in place.
__global__ void __launch_bounds__(FFT_THREADS)
gl_analysis_kernel(const float* __restrict__ fsyn, const float* __restrict__ wss,
                   const float* __restrict__ window, const float2* __restrict__ tw,
                   float* __restrict__ ang_re, float* __restrict__ ang_im,
                   float* __restrict__ reb_re, float* __restrict__ reb_im, int T, int F,
                   int n_fft, int log2n, int hop, float alpha) {
  extern __shared__ float2 buf[];
  const int b = blockIdx.x / T, t = blockIdx.x % T;
  const float* fs = fsyn + (size_t)b * T * n_fft;
  const int L = hop * (T - 1), half = n_fft / 2;
  for (int j = threadIdx.x; j < n_fft; j += blockDim.x) {
    int s = hop * t + j - half;              // index into the un-padded signal
    if (s < 0) s = -s;                       // reflect (no edge repeat)
    else if (s >= L) s = 2 * (L - 1) - s;
    const float v = ola_sample(fs, wss, s + half, T, n_fft, hop) * window[j];
    buf[bitrev(j, log2n)] = make_float2(v, 0.f);
  }
  __syncthreads();
  fft_inplace(buf, tw, n_fft, log2n, false);
  const size_t o = ((size_t)b * T + t) * F;
  for (int k = threadIdx.x; k < F; k += blockDim.x) {
    const float r_re = buf[k].x, r_im = buf[k].y;
    const float a_re = r_re - alpha * reb_re[o + k];
    const float a_im = r_im - alpha * reb_im[o + k];
    const float norm = sqrtf(a_re * a_re + a_im * a_im) + 1e-16f;
    ang_re[o + k] = a_re / norm;
    ang_im[o + k] = a_im / norm;
    reb_re[o + k] = r_re;
    reb_im[o + k] = r_im;
  }
}

// audio[b, s] = ISTFT signal sample s (the n_fft/2 centre crop).
__global__ void gl_ola_kernel(const float* __restrict__ fsyn, const float* __restrict__ wss,
                              float* __restrict__ audio, int T, int n_fft, int hop) {
  const int b = blockIdx.y;
  const int L = hop * (T - 1);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= L) return;
  audio[(size_t)b * L + s] =
      ola_sample(fsyn + (size_t)b * T * n_fft, wss, s + n_fft / 2, T, n_fft, hop);
}

int log2_exact(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return (1 << l) == n ? l : -1;
}

}  // namespace

extern "C" {

// K2: (cos, sin) phase init, f32 (B, T, F). mode 0 random hash (seeds), 1 advance, 2 spsi (mag).
int spoofsv_gl_init_launch(int mode, const float* mag, const int* seeds, float* out_re,
                           float* out_im, int B, int T, int F, int n_fft, int hop,
                           float two_pi_over_n, float two_pi_over_24, float hop_over_n,
                           float two_pi, float lock_c, void* stream) {
  if (mode < 0 || mode > 2 || F != n_fft / 2 + 1) return (int)cudaErrorInvalidValue;
  InitConsts c{two_pi_over_n, two_pi_over_24, hop_over_n, two_pi, lock_c};
  dim3 grid((F + INIT_THREADS - 1) / INIT_THREADS, B);
  gl_init_kernel<<<grid, INIT_THREADS, 0, (cudaStream_t)stream>>>(mode, mag, seeds, out_re,
                                                                  out_im, T, F, n_fft, hop, c);
  return (int)cudaGetLastError();
}

// K3: n_iter momentum iterations from (ang_re, ang_im), then the audio epilogue.
// ang_* are updated in place; reb_* (zeroed by the caller) and fsyn (B, T, n_fft)
// are scratch; wss has n_fft + hop*(T-1) entries; tw has n_fft/2 complex twiddles.
int spoofsv_gl_run(const float* mag, float* ang_re, float* ang_im, float* reb_re, float* reb_im,
                   float* fsyn, const float* wss, const float* window, const float* tw,
                   float* audio, int B, int T, int F, int n_fft, int hop, int n_iter,
                   float alpha, void* stream) {
  const int log2n = log2_exact(n_fft);
  if (log2n < 4 || n_fft > 2048 || F != n_fft / 2 + 1 || hop * (T - 1) <= n_fft / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = sizeof(float2) * n_fft;
  const float2* tw2 = (const float2*)tw;
  for (int it = 0; it <= n_iter; ++it) {
    gl_synth_kernel<<<B * T, FFT_THREADS, smem, s>>>(mag, ang_re, ang_im, window, tw2, fsyn, F,
                                                     n_fft, log2n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (it == n_iter) break;
    gl_analysis_kernel<<<B * T, FFT_THREADS, smem, s>>>(fsyn, wss, window, tw2, ang_re, ang_im,
                                                        reb_re, reb_im, T, F, n_fft, log2n,
                                                        hop, alpha);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int L = hop * (T - 1);
  dim3 grid((L + 255) / 256, B);
  gl_ola_kernel<<<grid, 256, 0, s>>>(fsyn, wss, audio, T, n_fft, hop);
  return (int)cudaGetLastError();
}

const char* spoofsv_gl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
