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
// and a final overlap-add epilogue writes the audio. Bound: device memory.
// A launch moves ~10 KB a frame (synthesis: |S| and both angle planes in,
// fsyn out) or ~16 KB (analysis: fsyn and both rebuilt planes in, angles and
// rebuilt out): 2.1 and 3.4 GB at B=160, T=1300, 0.64 and 1.02 ms at
// 3.35 TB/s; the transforms' arithmetic (2.5·n·log2 n a frame) is ~0.08 ms
// at the f32 rate. One frame a block through ten radix-2 passes in shared
// memory, each behind a block barrier, is latency-bound (~4.2 ms a launch at
// that shape). Here a frame's real transform is a half-size complex one
// held in registers by one warp or less, several frames a block, and a
// block's run of consecutive frames reads and writes whole spans of the
// planes; analysis stages the run's synthesis frames and window_sumsquare
// and builds the run's stretch of the ISTFT signal in shared memory once,
// instead of gathering every sample from ~n/hop frames in device memory for
// each frame (see "K3 f32" below). The int8 DFT-matmul of the TPU kernel is
// not carried over: everything here is f32.

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef SPOOFSV_GL_PROBE
// the global timer (ns) at each phase boundary of the middle block (thread 0)
// of the last launch of each K3 kernel: [0] synthesis, [1] analysis
__device__ unsigned long long g_gl_probe[2][16];
#define GL_MARK(kernel, i)                                                          \
  if (blockIdx.x == gridDim.x / 2 && threadIdx.x == 0)                             \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_gl_probe[kernel][i]) :: "memory")
#else
#define GL_MARK(kernel, i)
#endif

namespace {

constexpr int INIT_SEGS = 32;    // K2: segments of frames an utterance is cut into
constexpr int INIT_WARPS = 17;   // a block's warps, 32 bins each (513 bins: n_fft 1024)
constexpr int INIT_THREADS = 32 * INIT_WARPS;
constexpr int INIT_BATCH = 16;   // frames a warp loads before it computes on them
constexpr int SMEM_LIMIT = 232448;
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
// K3 f32: a frame's n-point real transform as an N2 = n/2 point complex one,
// z[m] = x[2m] + i·x[2m+1], with a split pass after it (analysis) or a merge
// pass before it (synthesis). The complex transform is a Stockham plan
// (GlPlan): radix-16 passes and one smaller last pass, run by a group of P
// lanes that each hold E values in registers and take E/R butterflies of a
// pass; the group exchanges its values through shared memory between passes
// (twice at n 1024 and 2048) under a warp barrier, so a warp holds one frame
// (n ≥ 1024) or 32/P of them. Pass twiddles come from a table of
// W_n^k = exp(−2πik/n), k < N2, in shared memory; the butterflies' W_16
// powers are literals. A block owns a run of consecutive frames of one
// utterance: its rows of the (B, T, F) planes are one contiguous span each,
// staged through shared memory with 16-byte copies.
// ---------------------------------------------------------------------------

constexpr int GL_WARPS = 8;
constexpr int GL_THREADS = 32 * GL_WARPS;

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x >> 1); }
__host__ __device__ constexpr int brev(int r, int bits) {
  int o = 0;
  for (int i = 0; i < bits; ++i) o |= ((r >> i) & 1) << (bits - 1 - i);
  return o;
}

// The plan of an n = 2^LOGN point transform, chosen from n alone.
template <int LOGN>
struct GlPlan {
  static constexpr int N = 1 << LOGN, N2 = N / 2, F = N2 + 1;
  static constexpr int E = N2 >= 1024 ? 32 : (N2 < 16 ? N2 : 16);  // complex values a lane
  static constexpr int P = N2 / E;             // lanes a frame
  static constexpr int G = 32 / P;             // frames a warp
  static constexpr int FRAMES = GL_WARPS * G;  // frames a block at most
  static constexpr int A = (LOGN - 1) / 4;     // radix-16 passes
  static constexpr int REM = N2 >> (4 * A);    // the last pass's radix (1: no such pass)
  static constexpr int PASSES = A + (REM > 1 ? 1 : 0);
  static constexpr int R0 = A > 0 ? 16 : REM;  // the first pass's radix
  static constexpr int RL = REM > 1 ? REM : 16;  // the last pass's
  // floats of a staged plane: FRAMES rows of F, shifted by up to 3 (stage_in)
  static constexpr int PLANE = (FRAMES * F + 6) & ~3;
};

// cos(2πq/16); q is a constant once the callers are unrolled
__device__ __forceinline__ float cos16(int q) {
  q &= 15;
  int a = q <= 8 ? q : 16 - q;
  const bool neg = a > 4;
  if (neg) a = 8 - a;
  const float c = a == 0   ? 1.f
                  : a == 1 ? 0.92387953251128674f
                  : a == 2 ? 0.70710678118654752f
                  : a == 3 ? 0.38268343236508977f
                           : 0.f;
  return neg ? -c : c;
}

// (x + iy)·exp(∓2πiq/16), the + sign for the inverse
template <bool INV>
__device__ __forceinline__ void rot16(int q, float& x, float& y) {
  q &= 15;
  if (q == 0) return;
  if (q == 8) {
    x = -x;
    y = -y;
    return;
  }
  if ((q & 3) == 0) {  // a quarter turn
    const float t = x;
    if ((q == 4) != INV) {  // ·(−i)
      x = y;
      y = -t;
    } else {  // ·(+i)
      x = -y;
      y = t;
    }
    return;
  }
  const float c = cos16(q), s = INV ? -cos16(q - 4) : cos16(q - 4);  // ·(c − i·s)
  const float xr = x * c + y * s;
  y = y * c - x * s;
  x = xr;
}

// (x + iy)·w, or ·conj(w) for the inverse
template <bool INV>
__device__ __forceinline__ void cmul(float2 w, float& x, float& y) {
  const float wi = INV ? -w.y : w.y;
  const float xr = x * w.x - y * wi;
  y = x * wi + y * w.x;
  x = xr;
}

// W_n^e, 0 ≤ e < n = 2·N2, from the table of W_n^k, k < N2 (W_n^{k+N2} = −W_n^k)
template <int N2>
__device__ __forceinline__ float2 tw_n(const float2* tab, int e) {
  const float2 w = tab[e & (N2 - 1)];
  return (e & N2) ? make_float2(-w.x, -w.y) : w;
}

// Where element i of a group's exchange arrays lives: the low five bits
// XORed with bits 4-8, so that each pass's stores and loads by 32 lanes
// fall in 32 banks
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 31); }

// An R-point DFT (R ≤ 16) of registers in natural order, decimation in
// frequency from the stage of half-span H down: the result is in
// bit-reversed order
template <int R, bool INV, int H = R / 2>
__device__ __forceinline__ void dft_reg(float* re, float* im) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i & H) continue;
    const float ar = re[i], ai = im[i], br = re[i + H], bi = im[i + H];
    re[i] = ar + br;
    im[i] = ai + bi;
    float dr = ar - br, di = ai - bi;
    rot16<INV>((i & (H - 1)) * (8 / H), dr, di);  // W_{2H}^{i mod H}
    re[i + H] = dr;
    im[i + H] = di;
  }
  if constexpr (H > 1) dft_reg<R, INV, H / 2>(re, im);
}

// Pass PASS (and the later ones) of a frame's N2-point transform by its
// group's lane g. On entry to pass 0, slot b·R0 + r holds input element
// g + P·b + r·N2/R0; on return, slot b·RL + brev(r) holds output element
// g + P·b + r·N2/RL. xr/xi: the group's exchange arrays, N2 floats each.
template <int LOGN, bool INV, int PASS>
__device__ __forceinline__ void fft_pass(float* re, float* im, float* xr, float* xi, int g,
                                         const float2* tab) {
  using Pl = GlPlan<LOGN>;
  constexpr int N2 = Pl::N2, E = Pl::E, P = Pl::P;
  constexpr int R = PASS < Pl::A ? 16 : Pl::REM, NB = E / R;
  constexpr int NS = 1 << (4 * PASS);  // the product of the earlier radices
  if constexpr (PASS > 0) {
    // the previous (radix-16) pass's outputs out, this pass's inputs in
    constexpr int NSP = NS / 16;
#pragma unroll
    for (int b = 0; b < E / 16; ++b)
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int j = g + P * b;
        const int o = swz((j / NSP) * NSP * 16 + j % NSP + r * NSP);
        xr[o] = re[b * 16 + brev(r, 4)];
        xi[o] = im[b * 16 + brev(r, 4)];
      }
    __syncwarp();
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = swz(g + P * b + r * (N2 / R));
        re[b * R + r] = xr[i];
        im[b * R + r] = xi[i];
      }
    __syncwarp();
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if constexpr (NS > 1) {
      const int jm = (g + P * b) % NS;
#pragma unroll
      for (int r = 1; r < R; ++r)  // W_{NS·R}^{r·(j mod NS)}
        cmul<INV>(tw_n<N2>(tab, r * jm * (2 * N2 / (NS * R))), re[b * R + r], im[b * R + r]);
    }
    dft_reg<R, INV>(re + b * R, im + b * R);
  }
  if constexpr (PASS + 1 < Pl::PASSES) fft_pass<LOGN, INV, PASS + 1>(re, im, xr, xi, g, tab);
}

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// A span of floats at g sits in shared memory at s + span_shift(g), so that
// 16-byte aligned device addresses meet 16-byte aligned shared ones.
__device__ __forceinline__ int span_shift(const float* g) {
  return (int)((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
}

// Stage n floats from g: 16-byte cp.async for the aligned body (waited for
// by cp_async_wait_all), single floats at the ends. Returns the shift.
__device__ __forceinline__ int stage_in(const float* __restrict__ g, int n, float* s) {
  const int a = span_shift(g), head = min(n, (4 - a) & 3), body = (n - head) >> 2;
  for (int i = threadIdx.x; i < body; i += GL_THREADS)
    cp_async16(s + a + head + 4 * i, g + head + 4 * i);
  if ((int)threadIdx.x < head) s[a + threadIdx.x] = g[threadIdx.x];
  for (int i = head + 4 * body + threadIdx.x; i < n; i += GL_THREADS) s[a + i] = g[i];
  return a;
}

// The reverse: n floats from s + a (a = span_shift(g)) to g, 16-byte stores
__device__ __forceinline__ void stage_out(const float* s, int a, float* __restrict__ g, int n) {
  const int head = min(n, (4 - a) & 3), body = (n - head) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(s + a + head);
  float4* g4 = reinterpret_cast<float4*>(g + head);
  for (int i = threadIdx.x; i < body; i += GL_THREADS) g4[i] = s4[i];
  if ((int)threadIdx.x < head) g[threadIdx.x] = s[a + threadIdx.x];
  for (int i = head + 4 * body + threadIdx.x; i < n; i += GL_THREADS) g[i] = s[a + i];
}

// fsyn[b, t, :] = window · irfft(mag · ang)[b, t, :] for a run of
// FRAMES frames (fewer at an utterance's end); runs: runs an utterance.
template <int LOGN>
__global__ void __launch_bounds__(GL_THREADS, LOGN >= 11 ? 1 : 2)
gl_synth_kernel(const float* __restrict__ mag, const float* __restrict__ ang_re,
                const float* __restrict__ ang_im, const float* __restrict__ window,
                const float2* __restrict__ tw, float* __restrict__ fsyn, int T, int runs) {
  using Pl = GlPlan<LOGN>;
  constexpr int N = Pl::N, N2 = Pl::N2, F = Pl::F, E = Pl::E, P = Pl::P, R0 = Pl::R0,
                RL = Pl::RL, LRL = ilog2(RL);
  extern __shared__ __align__(16) float gsm[];
  float2* tab = reinterpret_cast<float2*>(gsm);
  float* s_mag = gsm + 2 * N2;
  float* s_re = s_mag + Pl::PLANE;
  float* s_im = s_re + Pl::PLANE;
  GL_MARK(0, 0);
  const int b = blockIdx.x / runs, t0 = (blockIdx.x % runs) * Pl::FRAMES;
  const int nf = min(Pl::FRAMES, T - t0);
  const size_t o = ((size_t)b * T + t0) * F;
  const int am = stage_in(mag + o, nf * F, s_mag);
  const int ar = stage_in(ang_re + o, nf * F, s_re);
  const int ai = stage_in(ang_im + o, nf * F, s_im);
  for (int i = threadIdx.x; i < N2; i += GL_THREADS) tab[i] = tw[i];
  cp_async_wait_all();
  __syncthreads();
  GL_MARK(0, 1);
  // the group's frame f of the run (past nf: a spare group, computing on its own rows, storing nothing)
  const int lane = threadIdx.x & 31, g = lane % P;
  const int f = (threadIdx.x >> 5) * Pl::G + lane / P;
  const float* m = s_mag + am + f * F;
  const float* cr = s_re + ar + f * F;
  const float* ci = s_im + ai + f * F;
  float re[E], im[E];
  // merge: Z[k] = (X[k] + conj X[N2−k]) + i·conj(W_n^k)·(X[k] − conj X[N2−k]), X = mag·ang
  // with the imaginary parts of bins 0 and N2 dropped
#pragma unroll
  for (int bb = 0; bb < E / R0; ++bb)
#pragma unroll
    for (int r = 0; r < R0; ++r) {
      const int k = g + P * bb + r * (N2 / R0), kc = N2 - k;
      const float xa = m[k] * cr[k], ya = k ? m[k] * ci[k] : 0.f;
      const float xb = m[kc] * cr[kc], yb = k ? m[kc] * ci[kc] : 0.f;
      float dr = xa - xb, di = ya + yb;
      cmul<true>(tab[k], dr, di);
      re[bb * R0 + r] = (xa + xb) - di;
      im[bb * R0 + r] = (ya - yb) + dr;
    }
  __syncwarp();  // the group's bins are read before its angle rows take the exchange
  GL_MARK(0, 2);
  fft_pass<LOGN, true, 0>(re, im, s_re + ar + f * F, s_im + ai + f * F, g, tab);
  GL_MARK(0, 3);
  if (f < nf) {
    float2* out = reinterpret_cast<float2*>(fsyn + ((size_t)b * T + t0 + f) * N);
    const float2* w2 = reinterpret_cast<const float2*>(window);
    const float inv_n = 1.0f / (float)N;
#pragma unroll
    for (int bb = 0; bb < E / RL; ++bb)
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int mm = g + P * bb + r * (N2 / RL), sl = bb * RL + brev(r, LRL);
        const float2 w = __ldg(w2 + mm);
        out[mm] = make_float2(re[sl] * inv_n * w.x, im[sl] * inv_n * w.y);
      }
  }
  GL_MARK(0, 4);
}

// ⌊a / d⌋ for 0 ≤ a, a / d < 2^22 and d ≥ 1, from rd = 1/d: the float
// quotient is within one of it, then corrected
__device__ __forceinline__ int div_floor(int a, int d, float rd) {
  const int q = __float2int_rz((float)a * rd), r = a - q * d;
  return q + (r >= d) - (r < 0);
}

// Overlap-add of the synthesis frames at OLA coordinate u (the centre-padded
// signal index); frame tp's samples are at fs + (tp − t_first)·n_fft (device
// or shared memory). The ISTFT signal is this over window_sumsquare (wss_div).
__device__ __forceinline__ float ola_sum(const float* __restrict__ fs, int t_first, int u, int T,
                                         int n_fft, int hop) {
  const float rh = 1.0f / (float)hop;
  const int t_hi = min(div_floor(u, hop, rh), T - 1);
  const int t_lo = u - n_fft + 1 <= 0 ? 0 : div_floor(u - n_fft + hop, hop, rh);
  float acc = 0.f;
  for (int tp = t_lo; tp <= t_hi; ++tp) acc += fs[(size_t)(tp - t_first) * n_fft + (u - hop * tp)];
  return acc;
}

__device__ __forceinline__ float wss_div(float acc, float w) { return w > WSS_FLOOR ? acc / w : acc; }

// librosa's reflect padding of an index into a signal of L samples
__device__ __forceinline__ int reflect(int s, int L) {
  return s < 0 ? -s : (s >= L ? 2 * (L - 1) - s : s);
}

// momentum, then a / (|a| + 1e-16), for bin k of X: the angle and the rebuilt
// value into the staged rows
__device__ __forceinline__ void gl_update(float* rr, float* ri, float* ar, float* ai, int k,
                                          float x_re, float x_im, float alpha) {
  const float a_re = x_re - alpha * rr[k];
  const float a_im = x_im - alpha * ri[k];
  const float norm = sqrtf(a_re * a_re + a_im * a_im) + 1e-16f;
  ar[k] = a_re / norm;
  ai[k] = a_im / norm;
  rr[k] = x_re;
  ri[k] = x_im;
}

// Analysis of a run of `frames` frames (fewer at an utterance's end): the
// run's rebuilt rows, the synthesis frames that reach it and their
// window_sumsquare into shared memory by cp.async, the run's stretch of the
// ISTFT signal (librosa centre + reflect padding) from them once, then per
// frame the windowed rfft, momentum and normalisation; ang and reb are
// updated in place. xcap: floats of the region that holds the synthesis
// frames, then the angle rows.
template <int LOGN>
__global__ void __launch_bounds__(GL_THREADS, LOGN >= 11 ? 1 : 2)
gl_analysis_kernel(const float* __restrict__ fsyn, const float* __restrict__ wss,
                   const float* __restrict__ window, const float2* __restrict__ tw,
                   float* __restrict__ ang_re, float* __restrict__ ang_im,
                   float* __restrict__ reb_re, float* __restrict__ reb_im, int T, int hop,
                   int frames, int runs, int xcap, float alpha) {
  using Pl = GlPlan<LOGN>;
  constexpr int N = Pl::N, N2 = Pl::N2, F = Pl::F, E = Pl::E, P = Pl::P, R0 = Pl::R0,
                RL = Pl::RL, LRL = ilog2(RL);
  extern __shared__ __align__(16) float gsm[];
  float2* tab = reinterpret_cast<float2*>(gsm);
  float* s_rr = gsm + 2 * N2;
  float* s_ri = s_rr + Pl::PLANE;
  float* s_x = s_ri + Pl::PLANE;  // the synthesis frames tA..tB, later the angle rows
  float* s_ar = s_x;
  float* s_ai = s_x + Pl::PLANE;
  float* sig = s_x + xcap;
  GL_MARK(1, 0);
  const int b = blockIdx.x / runs, t0 = (blockIdx.x % runs) * frames;
  const int nf = min(frames, T - t0), len = nf * F;
  const size_t o = ((size_t)b * T + t0) * F;
  const int arr = stage_in(reb_re + o, len, s_rr);
  const int ari = stage_in(reb_im + o, len, s_ri);
  const int aar = span_shift(ang_re + o), aai = span_shift(ang_im + o);
  // the synthesis frames whose windows reach the run's samples
  const int H = (N - 1) / hop, tA = max(0, t0 - H), tB = min(T - 1, t0 + nf - 1 + H);
  const float* fs = fsyn + (size_t)b * T * N;
  const float* fr = s_x + stage_in(fs + (size_t)tA * N, (tB - tA + 1) * N, s_x);
  // signal samples [u0, u1): the run's frames' and one sample each side, which
  // the reflected ends of frames 0 and T−1 read (those two from device memory);
  // their window_sumsquare staged where the signal goes
  const int L = hop * (T - 1);
  const int u0 = max(0, hop * t0 - 1), u1 = min(N + L, hop * (t0 + nf - 1) + N + 1);
  sig += stage_in(wss + u0, u1 - u0, sig);
  for (int i = threadIdx.x; i < N2; i += GL_THREADS) tab[i] = tw[i];
  cp_async_wait_all();
  __syncthreads();
  GL_MARK(1, 1);
  for (int v = threadIdx.x; v < u1 - u0; v += GL_THREADS) {
    const int u = u0 + v;
    const float acc = u < hop * t0 || u >= hop * (t0 + nf - 1) + N ? ola_sum(fs, 0, u, T, N, hop)
                                                                   : ola_sum(fr, tA, u, T, N, hop);
    sig[v] = wss_div(acc, sig[v]);
  }
  __syncthreads();  // the frames read before the angle rows take their place
  GL_MARK(1, 2);
  const int lane = threadIdx.x & 31, g = lane % P;
  const int f = (threadIdx.x >> 5) * Pl::G + lane / P;
  const int t = t0 + min(f, nf - 1);
  float re[E], im[E];
  const float2* w2 = reinterpret_cast<const float2*>(window);
  // z[i] = x[2i] + i·x[2i+1], x[j] = window[j] · the signal at hop·t + j − N/2
#pragma unroll
  for (int bb = 0; bb < E / R0; ++bb)
#pragma unroll
    for (int r = 0; r < R0; ++r) {
      const int i = g + P * bb + r * (N2 / R0);
      const float2 w = __ldg(w2 + i);
      re[bb * R0 + r] = sig[reflect(hop * t + 2 * i - N2, L) + N2 - u0] * w.x;
      im[bb * R0 + r] = sig[reflect(hop * t + 2 * i + 1 - N2, L) + N2 - u0] * w.y;
    }
  float* xr = s_ar + aar + f * F;
  float* xi = s_ai + aai + f * F;
  GL_MARK(1, 3);
  fft_pass<LOGN, false, 0>(re, im, xr, xi, g, tab);
  GL_MARK(1, 4);
#pragma unroll
  for (int bb = 0; bb < E / RL; ++bb)
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const int mm = g + P * bb + r * (N2 / RL), sl = bb * RL + brev(r, LRL);
      xr[mm] = re[sl];
      xi[mm] = im[sl];
    }
  __syncwarp();
  // split: X[k] = E + W_n^k·O, X[N2−k] = conj(E − W_n^k·O) with E = (Z[k] + conj Z[N2−k])/2,
  // O = (Z[k] − conj Z[N2−k])/2i; bins k and N2−k by the lane that reads Z[k] and Z[N2−k]
  float* rr = s_rr + arr + f * F;
  float* ri = s_ri + ari + f * F;
  for (int k = g; k <= N2 / 2; k += P) {
    const int kc = (N2 - k) & (N2 - 1);
    const float zr = xr[k], zi = xi[k], cr = xr[kc], ci = xi[kc];
    const float er = 0.5f * (zr + cr), ei = 0.5f * (zi - ci);
    float o_r = 0.5f * (zi + ci), o_i = -0.5f * (zr - cr);
    cmul<false>(tab[k], o_r, o_i);
    gl_update(rr, ri, xr, xi, k, er + o_r, ei + o_i, alpha);
    if (k != N2 - k) gl_update(rr, ri, xr, xi, N2 - k, er - o_r, o_i - ei, alpha);
  }
  GL_MARK(1, 5);
  __syncthreads();
  GL_MARK(1, 6);
  stage_out(s_ar, aar, ang_re + o, len);
  stage_out(s_ai, aai, ang_im + o, len);
  stage_out(s_rr, arr, reb_re + o, len);
  stage_out(s_ri, ari, reb_im + o, len);
  GL_MARK(1, 7);
}

// audio[b, s] = ISTFT signal sample s (the n_fft/2 centre crop).
__global__ void gl_ola_kernel(const float* __restrict__ fsyn, const float* __restrict__ wss,
                              float* __restrict__ audio, int T, int n_fft, int hop) {
  const int b = blockIdx.y;
  const int L = hop * (T - 1);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= L) return;
  audio[(size_t)b * L + s] =
      wss_div(ola_sum(fsyn + (size_t)b * T * n_fft, 0, s + n_fft / 2, T, n_fft, hop),
              wss[s + n_fft / 2]);
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

// K3's shared memory in floats: the twiddle table and the staged planes (3
// for synthesis); for analysis 2 rebuilt planes, the region that holds the
// run's synthesis frames and then 2 angle planes (gl_xcap), the run's signal
template <int LOGN>
long long gl_xcap(long long frames, long long hop) {
  using Pl = GlPlan<LOGN>;
  const long long raw = (Pl::N * (frames + 2 * ((Pl::N - 1) / hop)) + 6) & ~3LL;
  return raw > 2LL * Pl::PLANE ? raw : 2LL * Pl::PLANE;
}

template <int LOGN>
size_t gl_smem(bool analysis, long long frames, long long hop) {
  using Pl = GlPlan<LOGN>;
  if (!analysis) return sizeof(float) * (2 * Pl::N2 + 3LL * Pl::PLANE);
  const long long sig = (hop * (frames - 1) + Pl::N + 2 + 6) & ~3LL;
  return sizeof(float) * (2 * Pl::N2 + 2LL * Pl::PLANE + gl_xcap<LOGN>(frames, hop) + sig);
}

template <typename K>
cudaError_t gl_smem_attr(K fn, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

// The iterations at n = 2^LOGN. Synthesis runs are FRAMES frames; analysis
// runs as many of them as leave the run's signal room in shared memory
// (FRAMES unless hop is large against n).
template <int LOGN>
int gl_run(const float* mag, float* ang_re, float* ang_im, float* reb_re, float* reb_im,
           float* fsyn, const float* wss, const float* window, const float* tw, float* audio,
           int B, int T, int hop, int n_iter, float alpha, cudaStream_t s) {
  using Pl = GlPlan<LOGN>;
  int frames = Pl::FRAMES;
  while (frames > 1 && gl_smem<LOGN>(true, frames, hop) > (size_t)SMEM_LIMIT) --frames;
  const size_t syn_smem = gl_smem<LOGN>(false, 0, 0), ana_smem = gl_smem<LOGN>(true, frames, hop);
  if (ana_smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = gl_smem_attr(gl_synth_kernel<LOGN>, syn_smem);
  if (err == cudaSuccess) err = gl_smem_attr(gl_analysis_kernel<LOGN>, ana_smem);
  if (err != cudaSuccess) return (int)err;
  const int syn_runs = (T + Pl::FRAMES - 1) / Pl::FRAMES, ana_runs = (T + frames - 1) / frames;
  const float2* tw2 = (const float2*)tw;
  for (int it = 0; it <= n_iter; ++it) {
    gl_synth_kernel<LOGN><<<B * syn_runs, GL_THREADS, syn_smem, s>>>(mag, ang_re, ang_im, window,
                                                                     tw2, fsyn, T, syn_runs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (it == n_iter) break;
    gl_analysis_kernel<LOGN><<<B * ana_runs, GL_THREADS, ana_smem, s>>>(
        fsyn, wss, window, tw2, ang_re, ang_im, reb_re, reb_im, T, hop, frames, ana_runs,
        (int)gl_xcap<LOGN>(frames, hop), alpha);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int L = hop * (T - 1);
  dim3 grid((L + 255) / 256, B);
  gl_ola_kernel<<<grid, 256, 0, s>>>(fsyn, wss, audio, T, Pl::N, hop);
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
// are scratch; wss has n_fft + hop*(T-1) entries; tw has n_fft/2 complex twiddles
// W_n^k = exp(-2*pi*i*k/n_fft).
int spoofsv_gl_run(const float* mag, float* ang_re, float* ang_im, float* reb_re, float* reb_im,
                   float* fsyn, const float* wss, const float* window, const float* tw,
                   float* audio, int B, int T, int F, int n_fft, int hop, int n_iter,
                   float alpha, void* stream) {
  const int log2n = log2_exact(n_fft);
  if (log2n < 4 || n_fft > 2048 || F != n_fft / 2 + 1 || hop * (T - 1) <= n_fft / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define GL_RUN(LOGN)                                                                             \
  case LOGN:                                                                                     \
    return gl_run<LOGN>(mag, ang_re, ang_im, reb_re, reb_im, fsyn, wss, window, tw, audio, B, T, \
                        hop, n_iter, alpha, s);
  switch (log2n) {
    GL_RUN(4)
    GL_RUN(5)
    GL_RUN(6)
    GL_RUN(7)
    GL_RUN(8)
    GL_RUN(9)
    GL_RUN(10)
    GL_RUN(11)
  }
#undef GL_RUN
  return (int)cudaErrorInvalidValue;
}

#ifdef SPOOFSV_GL_PROBE
// the phase times of the last launches (2 × 16 uint64) into host memory
int spoofsv_gl_probe_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_gl_probe, sizeof(g_gl_probe));
}
#endif

const char* spoofsv_gl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
