// K2 (Griffin-Lim phase init) and K3 (Griffin-Lim iterations) for sm_90a.
//
// K2 replaces spoofsv_tpu/ops/pallas_gl.py::_spsi_angles_kernel and the
// init branches of ::_gl_kernel (random hash, advance, spsi). Its bound is
// bytes: one read of the f32 magnitudes and one write of the f32 (cos, sin)
// pair (512 MB at B=64, T=1300: 0.153 ms at 3.35 TB/s). The SPSI phase needs
// a cumsum of δ along frames per bin, which the first port walked in series
// (one thread per (utterance, bin) over all T frames: latency-bound at ~10
// warps an SM). Here each utterance's frames are cut into 32 segments of
// ⌈T/32⌉, and a block owns one segment over all bins (17 warps of 32 bins
// at n_fft 1024), so it reads and writes whole rows: one contiguous span of
// |S| and one of each angle plane (a block over a strip of bins and all
// frames wrote 32 scattered 128-byte pieces at a time, and its writes alone
// took 2.4 times a fill of the same planes). One pass, a scan with
// look-back:
//   1. the block computes δ for its frames (the log-magnitude parabola over
//      bins k−1, k, k+1: the neighbours by warp shuffle, each warp's two
//      edge bins loaded for 16 frames at a time by its lanes, the sequence's
//      edge bins replicated), keeps it in shared memory, and publishes its
//      per-bin totals and then a flag (release);
//   2. it waits for the flags of the utterance's earlier segments (acquire)
//      and sums their totals in segment order, so the result does not
//      depend on timing; blocks take their segment from an atomic counter,
//      so a block only waits for blocks that are already running;
//   3. it walks its frames again from that prefix: the running sum, the
//      wrapped cycles and cos/sin of the advanced, refined phase, written
//      once. The advance phase 2π·((t·hk) mod N)/N comes from a table of the
//      N angles, built by each block with the same cosf/sinf.
// δ stays in shared memory (89 KB at T=1300: two blocks share an SM; past
// ~3300 frames it goes through the output plane, which the same thread
// overwrites). "random" and "advance" are elementwise over (b, t, k),
// bit-for-bit the first port's.
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

constexpr int INIT_SEGS = 32;    // K2: segments of frames an utterance is cut into
constexpr int INIT_WARPS = 17;   // a block's warps, 32 bins each (513 bins: n_fft 1024)
constexpr int INIT_THREADS = 32 * INIT_WARPS;
constexpr int INIT_BATCH = 16;   // frames a warp loads before it computes on them
constexpr int SMEM_LIMIT = 232448;
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

__device__ __forceinline__ float log_mag(float m) { return logf(fmaxf(m, 1e-10f)); }

// δ ∈ [−0.5, 0.5] from the log-magnitudes of bins k−1, k, k+1 where the
// triple is concave, else 0 (torchdsp.gl_if_deltas, operation for operation)
__device__ __forceinline__ float spsi_delta(float la, float lb, float lc) {
  const float denom = __fadd_rn(__fsub_rn(la, __fmul_rn(2.f, lb)), lc);
  float delta = 0.f;
  if (denom < -1e-6f) delta = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(la, lc)), denom);
  return fminf(fmaxf(delta, -0.5f), 0.5f);
}

struct InitConsts {
  float two_pi_over_n;   // float32(2*pi/N)
  float two_pi_over_24;  // float32(2*pi/2^24)
  float hop_over_n;      // float32(hop/N)
  float two_pi;          // float32(2*pi)
  float lock_c;          // float32(lock*pi*(N-1)/N)
};

// Dynamic shared memory of K2: the advance table (N float2, not for
// "random") and δ of the segment's frames over its bins rounded up to 32
// (SPSI_SMEM)
__host__ __device__ inline size_t init_smem(int mode, int n_fft, int T, int F, bool spsi_smem) {
  const size_t L = (T + INIT_SEGS - 1) / INIT_SEGS, W = 32 * ((F + 31) / 32);
  return (mode == INIT_RANDOM ? 0 : (size_t)n_fft * 8) + (spsi_smem ? L * W * 4 : 0);
}

__device__ __forceinline__ void flag_release(int* p) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(1) : "memory");
}
__device__ __forceinline__ int flag_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// K2: a block computes segment `seg` (frames [seg·L, seg·L + L), L =
// ⌈T/32⌉) of utterance b over all F bins, warp w bins 32w + lane (and
// 32·(w + 17) + lane, ... past 544 bins). spsi: (b, seg) from the counter
// sync[0]; its δ totals to agg[b][seg], then the flag sync[1 + 32b + seg].
// SPSI_SMEM: δ kept in shared memory (else in out_re, overwritten in place).
template <int MODE, bool SPSI_SMEM>
__global__ void __launch_bounds__(INIT_THREADS, 2)
gl_init_kernel(const float* __restrict__ mag, const int* __restrict__ seeds,
               float* __restrict__ out_re, float* __restrict__ out_im, float* __restrict__ agg,
               int* __restrict__ sync, int T, int F, int n_fft, int hop, InitConsts cst) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_tile;
  constexpr unsigned FULL = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int nsl = (F + 31) / 32, W = 32 * nsl;  // 32-bin slices; bins rounded up
  int tile = blockIdx.x;
  if constexpr (MODE == INIT_SPSI) {
    if (threadIdx.x == 0) s_tile = atomicAdd(sync, 1);
    __syncthreads();
    tile = s_tile;
  }
  const int b = tile / INIT_SEGS, seg = tile % INIT_SEGS;
  const int L = (T + INIT_SEGS - 1) / INIT_SEGS, t0 = seg * L;
  const int nt = max(0, min(L, T - t0));  // frames of this segment
  const size_t row0 = (size_t)b * T + t0;  // its first row

  if constexpr (MODE == INIT_RANDOM) {
    const uint32_t seed = (uint32_t)seeds[b];
    for (int sl = warp; sl < nsl; sl += nwarps) {
      const int k = 32 * sl + lane;
      if (k < F)
        for (int i = 0; i < nt; ++i) {
          const size_t o = (row0 + i) * F + k;
          const float ph = (float)(hash_mix((uint32_t)(t0 + i), (uint32_t)k, seed) & 0xFFFFFFu) *
                           cst.two_pi_over_24;
          out_re[o] = cosf(ph);
          out_im[o] = sinf(ph);
        }
    }
    return;
  } else {
    float2* tab = reinterpret_cast<float2*>(smem);  // the advance angle of (t·hk) mod N
    float* dl = reinterpret_cast<float*>(tab + n_fft);  // [frame i][bin] δ
    for (int p = threadIdx.x; p < n_fft; p += blockDim.x) {
      const float ph = (float)p * cst.two_pi_over_n;
      tab[p] = make_float2(cosf(ph), sinf(ph));
    }
    if constexpr (MODE == INIT_SPSI) {
      // 1. δ of this segment's frames, and its totals
      const float* mb = mag + row0 * F;
      for (int sl = warp; sl < nsl; sl += nwarps) {
        const int k0 = 32 * sl, k = k0 + lane, kc = min(k, F - 1);
        const int km = max(k0 - 1, 0), kp = min(k0 + 32, F - 1);  // the slice's edges
        float sum = 0.f;
        for (int ib = 0; ib < nt; ib += INIT_BATCH) {
          const int nb = min(INIT_BATCH, nt - ib);
          float v[INIT_BATCH];
#pragma unroll
          for (int i = 0; i < INIT_BATCH; ++i)
            v[i] = i < nb ? __ldg(mb + (size_t)(ib + i) * F + kc) : 1.f;
          // lane j < 16: bin k0 − 1 of frame ib + j; lane 16 + j: bin k0 + 32
          const int j = lane & 15;
          const float e =
              log_mag(j < nb ? __ldg(mb + (size_t)(ib + j) * F + (lane < 16 ? km : kp)) : 1.f);
#pragma unroll
          for (int i = 0; i < INIT_BATCH; ++i) {
            if (i < nb) {  // the same in every lane
              const float lb = log_mag(v[i]);
              float la = __shfl_up_sync(FULL, lb, 1), lc = __shfl_down_sync(FULL, lb, 1);
              const float el = __shfl_sync(FULL, e, i), er = __shfl_sync(FULL, e, 16 + i);
              if (lane == 0) la = el;
              if (lane == 31) lc = er;
              const float d = spsi_delta(la, lb, lc);
              if constexpr (SPSI_SMEM) dl[(ib + i) * W + k] = d;
              else if (k < F) out_re[(row0 + ib + i) * F + k] = d;
              sum = __fadd_rn(sum, d);
            }
          }
        }
        if (k < F) agg[((size_t)b * INIT_SEGS + seg) * F + k] = sum;
      }
      // 2. publish the totals; wait for the earlier segments' (lane s of
      // warp 0 polls segment s) and sum them in segment order
      __syncthreads();  // every total stored (and δ, and the table)
      if (threadIdx.x == 0) {
        __threadfence();
        flag_release(sync + 1 + b * INIT_SEGS + seg);
      }
      if (warp == 0) {
        const int* flags = sync + 1 + b * INIT_SEGS;
        while (!__all_sync(FULL, lane >= seg || flag_acquire(flags + lane) != 0))
          __nanosleep(100);
        __threadfence();
      }
      __syncthreads();  // the earlier totals are visible to every thread
      // 3. the angles: cum is the exclusive sum of δ before frame t
      for (int sl = warp; sl < nsl; sl += nwarps) {
        const int k = 32 * sl + lane, kc = min(k, F - 1);
        float cum = 0.f;
        for (int s2 = 0; s2 < seg; ++s2)
          cum = __fadd_rn(cum, __ldcg(agg + ((size_t)b * INIT_SEGS + s2) * F + kc));
        const int hk = (kc * hop) % n_fft;
        int p = (int)(((long long)t0 * hk) % n_fft);  // (t·hk) mod N, advanced frame by frame
        for (int i = 0; i < nt; ++i) {
          const size_t o = (row0 + i) * F + k;
          float d = 0.f;
          if constexpr (SPSI_SMEM) d = dl[i * W + k];
          else if (k < F) d = out_re[o];
          const float cyc = __fmul_rn(cum, cst.hop_over_n);
          cum = __fadd_rn(cum, d);
          float frac = __fmul_rn(__fsub_rn(cyc, rintf(cyc)), cst.two_pi);
          frac = __fadd_rn(frac, __fmul_rn(d, cst.lock_c));
          float s_f, c_f;
          __sincosf(frac, &s_f, &c_f);
          const float2 base = tab[p];
          if (k < F) {
            out_re[o] = base.x * c_f - base.y * s_f;
            out_im[o] = base.x * s_f + base.y * c_f;
          }
          p += hk;
          p -= p >= n_fft ? n_fft : 0;
        }
      }
    } else {  // advance
      __syncthreads();  // the table
      for (int sl = warp; sl < nsl; sl += nwarps) {
        const int k = 32 * sl + lane, hk = (k * hop) % n_fft;
        int p = (int)(((long long)t0 * hk) % n_fft);
        if (k < F)
          for (int i = 0; i < nt; ++i) {
            const float2 v = tab[p];
            const size_t o = (row0 + i) * F + k;
            out_re[o] = v.x;
            out_im[o] = v.y;
            p += hk;
            p -= p >= n_fft ? n_fft : 0;
          }
      }
    }
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

template <int MODE, bool SPSI_SMEM>
int init_launch(const float* mag, const int* seeds, float* out_re, float* out_im, float* agg,
                int* sync, int B, int T, int F, int n_fft, int hop, InitConsts c, cudaStream_t s) {
  const size_t smem = init_smem(MODE, n_fft, T, F, SPSI_SMEM);
  auto fn = gl_init_kernel<MODE, SPSI_SMEM>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nsl = (F + 31) / 32, threads = 32 * (nsl < INIT_WARPS ? nsl : INIT_WARPS);
  fn<<<B * INIT_SEGS, threads, smem, s>>>(mag, seeds, out_re, out_im, agg, sync, T, F, n_fft, hop,
                                          c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2: (cos, sin) phase init, f32 (B, T, F). mode 0 random hash (seeds), 1
// advance, 2 spsi (mag; agg: B·32·F floats of scratch, sync: 1 + 32·B int32
// zeroed by the caller). The advance table of n_fft angles sits in shared
// memory: n_fft up to ~29,000.
int spoofsv_gl_init_launch(int mode, const float* mag, const int* seeds, float* out_re,
                           float* out_im, float* agg, int* sync, int B, int T, int F, int n_fft,
                           int hop, float two_pi_over_n, float two_pi_over_24, float hop_over_n,
                           float two_pi, float lock_c, void* stream) {
  if (mode < 0 || mode > 2 || F != n_fft / 2 + 1 || B < 0 || T < 0 || hop < 1 ||
      init_smem(mode, n_fft, 0, F, false) > (size_t)SMEM_LIMIT || (mode == INIT_RANDOM && !seeds) ||
      (mode == INIT_SPSI && (!mag || !agg || !sync)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  InitConsts c{two_pi_over_n, two_pi_over_24, hop_over_n, two_pi, lock_c};
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == INIT_RANDOM)
    return init_launch<INIT_RANDOM, false>(mag, seeds, out_re, out_im, agg, sync, B, T, F, n_fft,
                                           hop, c, s);
  if (mode == INIT_ADVANCE)
    return init_launch<INIT_ADVANCE, false>(mag, seeds, out_re, out_im, agg, sync, B, T, F, n_fft,
                                            hop, c, s);
  if (init_smem(mode, n_fft, T, F, true) <= (size_t)SMEM_LIMIT)
    return init_launch<INIT_SPSI, true>(mag, seeds, out_re, out_im, agg, sync, B, T, F, n_fft, hop,
                                        c, s);
  return init_launch<INIT_SPSI, false>(mag, seeds, out_re, out_im, agg, sync, B, T, F, n_fft, hop,
                                       c, s);
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
