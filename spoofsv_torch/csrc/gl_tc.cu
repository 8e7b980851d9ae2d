// K3, the Griffin-Lim iterations, on Hopper's tensor cores (sm_90a).
//
// Replaces spoofsv_tpu/ops/pallas_gl.py::_gl_kernel with its int8_fwd
// arithmetic (griffin_lim_int8, the shipping default) or its bf16 one, for
// n_fft = 1024, hop = 256. Per iteration each frame's inverse DFT of
// mag·ang and the forward DFT of its analysis frame are products against
// fixed DFT matrices: int8 operands (mma.sync m16n8k32, int32 sums) or bf16
// ones (m16n8k16, f32 sums). What is quantised and how is the TPU kernel's:
// the magnitudes' scale qm = bf16(mag·w_k·126.5/rowmax) is hoisted out of
// the loop (computed by the first launch), each analysis frame takes its own
// row scale, the Nyquist bin is a rank-1 f32 term, the angles are bf16, the
// rebuilt spectra f32, and the final synthesis is bf16, never quantised.
//
// Bound: 4·1024² int8 operations a frame an iteration (plus the final bf16
// synthesis) at 1,979 TOP/s against the ~0.6 GB that must move (|S| and the
// initial angles in, the audio out). The old route (csrc/gl.cu) ran a
// 1024-point complex FFT per frame on the CUDA cores and moved ~3 GB an
// iteration through device memory in two launches.
//
// Design, one launch an iteration and one final launch:
//  * A CTA owns up to 58 consecutive analysis frames of one utterance and
//    synthesises them and 3 halo frames each side (64 rows, as analysis
//    frame t reads synthesis frames t-3..t+3 when hop = n_fft/4). The
//    synthesis output is taken in 4 column chunks of 256 = hop: chunk r of
//    frame f is added into signal chunk f+r of a shared-memory buffer (61
//    chunks of 256 f32), so the rows of one column chunk never collide. The
//    CTA then analyses its frames from that buffer: frames, signal and
//    spectra never reach device memory.
//  * Halo frames read their neighbours' angles of the previous iteration, so
//    the angles are ping-ponged between two buffers; the rebuilt spectra and
//    the hoisted scale belong to their frame's CTA.
//  * The B operands (the DFT matrices, 1 MB an iteration each in int8, 2 MB
//    in bf16) are packed by the host in mma.sync fragment order, one 16 KB
//    stage after another, and streamed from L2 by one producer thread with
//    cp.async.bulk into an mbarrier ring; the stream runs ahead across the
//    synthesis, the analysis and their elementwise phases. A consumer warp
//    releases a stage after a proxy fence: its reads are generic, the next
//    copy into the stage is not. A operands are
//    built in shared memory in fragment order by the consumer warps: from
//    qm·ang (synthesis) and from the windowed signal, scaled by each row's
//    max and rounded (analysis).
//  * Shared memory, bytes: ring 4 (int8) or 2 (bf16) stages of 16,384; A,
//    64 rows x 1,024 (int8) or 2,048 (bf16); signal 61 x 1,024; row scales
//    1,024; barriers. 194,624 (int8) and 227,360 (bf16) of the 232,448 a CTA
//    may use: the bf16 A operand is what keeps the tile at 64 rows. Six int8
//    stages were measured no faster: the products run at mma.sync's rate.
// The reads of data written earlier in the same launch (the A operand, the
// signal, the row scales) are plain loads after a barrier: a hoisted __ldcg
// read stale values in K5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int N = 1024, HOP = 256, FA = 512, F = 513;
constexpr int ROWS = 64, HALO = 3, MAX_FRAMES = ROWS - 2 * HALO, CHUNKS = MAX_FRAMES + 3;
constexpr int WARPS = 8, THREADS = 32 * WARPS;  // consumer warps; one producer warp more
constexpr int STAGE = 16384;
constexpr float Q_SCALE = 126.5f;

enum Mode { ITER_INT8 = 0, ITER_BF16 = 1, FINAL = 2 };

template <int MODE>
struct Cfg {
  static constexpr bool Q8 = MODE == ITER_INT8;  // int8 operands
  static constexpr int KB = Q8 ? 1024 : 2048;    // operand bytes a row
  static constexpr int SPC = KB / 64;            // stages a 256-column chunk
  static constexpr int STAGES = Q8 ? 4 : 2;
  static constexpr int GEMMS = MODE == FINAL ? 1 : 2;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + (size_t)ROWS * KB +
                                 (size_t)CHUNKS * HOP * 4 + 4 * ROWS * 4 + 2 * STAGES * 8;
};

struct Args {
  const float* mag;                  // (B, T, F) f32
  const float* a0re;                 // (B, T, F) f32 initial angles, read when first
  const float* a0im;
  const __nv_bfloat16* ang_in;       // [B·T][1024]: (cos, sin) of bin k at 2k, 2k+1
  __nv_bfloat16* ang_out;
  const __nv_bfloat16* angn_in;      // [B·T] the Nyquist bin's cos
  __nv_bfloat16* angn_out;
  float* reb;                        // [B·T][1024] rebuilt spectrum, (re, im) of bin k
  float* rebn;                       // [B·T] its Nyquist bin
  __nv_bfloat16* qm;                 // [B·T][512] hoisted int8 scale of the magnitudes
  float* deq;                        // [B·T] its dequantisation
  const unsigned char* stream_syn;   // B operand streams (see gl_kernel.pack_operand_stream)
  const unsigned char* stream_ana;
  const float* window;               // [1024] periodic Hann
  const float* invw;                 // [12][256] 1/window_sumsquare: chunks 0-5, T-3..T+2
  float* audio;                      // (B, 256·(T−1)), written by the final launch
  long long* prof;                   // phase times of CTA (1, 0), probe builds only
  int T, tf, first;
  float alpha;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile("{\n.reg .pred p;\nWAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               "@!p bra WAIT;\n}\n" ::"r"(bar),
               "r"(parity)
               : "memory");
}
// 1-D bulk copy global → shared memory, completing `bytes` on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// orders this thread's plain (generic-proxy) shared-memory accesses before
// later async-proxy ones, such as the next cp.async.bulk into the same stage
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the consumer warps' barrier (the producer warp does not take part)
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

__device__ __forceinline__ void mma(int (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bfr(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
// four values rounded (half to even) to int8, packed low byte first
__device__ __forceinline__ uint32_t pack_q4(float a, float b, float c, float d) {
  return ((uint32_t)__float2int_rn(a) & 0xFFu) | (((uint32_t)__float2int_rn(b) & 0xFFu) << 8) |
         (((uint32_t)__float2int_rn(c) & 0xFFu) << 16) | ((uint32_t)__float2int_rn(d) << 24);
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// The u32 of the A operand holding row `row`, k bytes kb..kb+3 (kb % 4 == 0):
// 32-byte k unit, 16-row m-tile, lane, then the mma.sync A fragment register
// (a0 rows 0-7 bytes 0-15, a1 rows 8-15, a2 and a3 bytes 16-31). The same map
// for int8 (32 values a unit) and bf16 (16). gl_kernel.a_word mirrors it.
__device__ __forceinline__ int a_word(int row, int kb) {
  const int u = kb >> 5, kin = kb & 31, mt = row >> 4, rin = row & 15;
  const int lane = (rin & 7) * 4 + ((kin & 15) >> 2);
  return ((u * 4 + mt) * 32 + lane) * 4 + (rin >> 3) + 2 * (kin >> 4);
}

// One 256-column chunk of a 64-row product over the whole k, from the A
// operand in shared memory and the ring's next SPC stages. Warp (wm, wn)
// takes rows 32·wm.. +31 and columns 64·wn.. +63: 2 x 8 mma tiles.
template <int MODE, typename Acc>
__device__ __forceinline__ void product_chunk(Acc (&acc)[2][8][4], const unsigned char* As,
                                              const unsigned char* ring, uint32_t full0,
                                              uint32_t empty0, unsigned& gc, int wm, int wn,
                                              int lane) {
  using C = Cfg<MODE>;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
  for (int st = 0; st < C::SPC; ++st, ++gc) {
    const int s = gc % C::STAGES;
    mbar_wait(full0 + 8 * s, (gc / C::STAGES) & 1);
    const unsigned char* stage = ring + s * STAGE;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int u = 2 * st + kk;
      uint4 af[2], bf[4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        af[mt] = *reinterpret_cast<const uint4*>(As + ((u * 4 + wm * 2 + mt) * 32 + lane) * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np)
        bf[np] = *reinterpret_cast<const uint4*>(stage + ((kk * 16 + wn * 4 + np) * 32 + lane) * 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma(acc[mt][2 * np], af[mt], bf[np].x, bf[np].y);
          mma(acc[mt][2 * np + 1], af[mt], bf[np].z, bf[np].w);
        }
    }
    // the producer's next copy into this stage is an async-proxy write: each
    // lane fences its plain reads of the stage before the warp releases it.
    // Without the fence the copy could land on a stage still being read, and
    // two calls on the same input parted by whole tiles.
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }
}

// The synthesis A operand: row i is frame f = t0 − 3 + i, zero outside
// [0, T). int8: round(qm·cos), round(qm·sin) of bins 2p, 2p+1 in one u32;
// bf16: bf16(mag·cos), bf16(mag·sin) of bin k. Also each row's
// dequantisation and Nyquist product mag·cos. The first launch reads the f32
// initial angles (and computes the hoisted scale) one row at a time; the
// others keep the loads of RB rows in flight together, then store: a store
// through a generic pointer would otherwise order each later load after it,
// one memory latency a row.
template <int MODE>
__device__ void build_synthesis(const Args& a, uint32_t* Aw, float* deqS, float* nyqS, int b,
                                int t0, int warp, int lane) {
  using C = Cfg<MODE>;
  constexpr int RPW = ROWS / WARPS, RB = C::Q8 ? 4 : 2;
  const int T = a.T;
  for (int q = 0; q < RPW; q += RB) {
    int rows[RB];
    bool live[RB];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      rows[j] = warp + WARPS * (q + j);
      const int f = t0 - HALO + rows[j];
      live[j] = f >= 0 && f < T;
      if (!live[j]) {
        for (int kb = 4 * lane; kb < C::KB; kb += 128) Aw[a_word(rows[j], kb)] = 0u;
        if (lane == 0) deqS[rows[j]] = nyqS[rows[j]] = 0.f;
      }
    }
    float nyq[RB];  // the Nyquist products, loaded with the rows' other values
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const size_t fr = (size_t)b * T + (live[j] ? t0 - HALO + rows[j] : 0);
      const float re_n = a.first ? bfr(a.a0re[fr * F + FA]) : __bfloat162float(a.angn_in[fr]);
      nyq[j] = bfr(a.mag[fr * F + FA]) * re_n;
    }
    if constexpr (C::Q8) {
      if (a.first) {
        // the hoisted scale, computed once and kept by the frame's own CTA
#pragma unroll 1
        for (int j = 0; j < RB; ++j) {
          if (!live[j]) continue;
          const int f = t0 - HALO + rows[j];
          const size_t fr = (size_t)b * T + f;
          const float* m = a.mag + fr * F;
          float qm[16], cs[32], mx = 0.f;
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            const int k = 2 * (lane + 32 * g);
            qm[2 * g] = bfr(m[k]) * (k == 0 ? 1.f : 2.f);
            qm[2 * g + 1] = bfr(m[k + 1]) * 2.f;
            mx = fmaxf(mx, fmaxf(qm[2 * g], qm[2 * g + 1]));
            cs[4 * g] = bfr(a.a0re[fr * F + k]);
            cs[4 * g + 1] = bfr(a.a0im[fr * F + k]);
            cs[4 * g + 2] = bfr(a.a0re[fr * F + k + 1]);
            cs[4 * g + 3] = bfr(a.a0im[fr * F + k + 1]);
          }
          const float amax = warp_max(mx) + 1e-20f;
          const float sc = __fdiv_rn(Q_SCALE, amax);
          const float dq = amax * (float)(1.0 / (126.5 * 127.0 * 1024.0));
          const bool own = f >= t0 && f < t0 + a.tf;
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            qm[2 * g] = bfr(qm[2 * g] * sc);
            qm[2 * g + 1] = bfr(qm[2 * g + 1] * sc);
            if (own)
              reinterpret_cast<uint32_t*>(a.qm + fr * FA)[lane + 32 * g] =
                  pack_bf2(qm[2 * g], qm[2 * g + 1]);
            Aw[a_word(rows[j], 4 * (lane + 32 * g))] =
                pack_q4(qm[2 * g] * cs[4 * g], qm[2 * g] * cs[4 * g + 1],
                        qm[2 * g + 1] * cs[4 * g + 2], qm[2 * g + 1] * cs[4 * g + 3]);
          }
          if (lane == 0) {
            deqS[rows[j]] = dq;
            nyqS[rows[j]] = nyq[j];
            if (own) a.deq[fr] = dq;
          }
        }
      } else {
        uint32_t qv[RB][8];
        uint2 av[RB][8];
        float dq[RB];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const size_t fr = (size_t)b * T + (live[j] ? t0 - HALO + rows[j] : 0);
          dq[j] = a.deq[fr];
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            qv[j][g] = reinterpret_cast<const uint32_t*>(a.qm + fr * FA)[lane + 32 * g];
            av[j][g] = reinterpret_cast<const uint2*>(a.ang_in + fr * N)[lane + 32 * g];
          }
        }
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          if (!live[j]) continue;
          if (lane == 0) deqS[rows[j]] = dq[j], nyqS[rows[j]] = nyq[j];
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            const float2 qm = unpack_bf2(qv[j][g]);
            const float2 x = unpack_bf2(av[j][g].x), y = unpack_bf2(av[j][g].y);
            Aw[a_word(rows[j], 4 * (lane + 32 * g))] =
                pack_q4(qm.x * x.x, qm.x * x.y, qm.y * y.x, qm.y * y.y);
          }
        }
      }
    } else {
      float mk[RB][16], cs[RB][16], sn[RB][16];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const size_t fr = (size_t)b * T + (live[j] ? t0 - HALO + rows[j] : 0);
#pragma unroll
        for (int g = 0; g < 16; ++g) {
          const int k = lane + 32 * g;
          mk[j][g] = a.mag[fr * F + k];
          if (a.first) {
            cs[j][g] = a.a0re[fr * F + k];
            sn[j][g] = a.a0im[fr * F + k];
          } else {
            const float2 x =
                unpack_bf2(reinterpret_cast<const uint32_t*>(a.ang_in + fr * N)[k]);
            cs[j][g] = x.x, sn[j][g] = x.y;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        if (!live[j]) continue;
        if (lane == 0) deqS[rows[j]] = 1.f, nyqS[rows[j]] = nyq[j];
#pragma unroll
        for (int g = 0; g < 16; ++g) {
          const float m = bfr(mk[j][g]);  // bfr: the f32 initial angles; exact on bf16 ones
          Aw[a_word(rows[j], 4 * (lane + 32 * g))] =
              pack_bf2(m * bfr(cs[j][g]), m * bfr(sn[j][g]));
        }
      }
    }
  }
}

// The analysis A operand: row i is frame t = t0 + i (zero for i ≥ tf or
// t ≥ T), the signal's samples [256t, 256t + 1024) times w/1.5, or on the six
// edge frames the exact 1/window_sumsquare and librosa's reflect padding.
// int8: rounded to 126.5/rowmax; bf16: rounded to bf16. Also each row's
// dequantisation and its Nyquist sum Σ ana·(−1)^j.
template <int MODE>
__device__ void build_analysis(const Args& a, uint32_t* Aw, const float* sig, float* deqA,
                               float* nyqA, int t0, int warp, int lane) {
  using C = Cfg<MODE>;
  const int T = a.T, L = HOP * (T - 1);
  const float inv15 = (float)(1.0 / 1.5);
  float ws[32];  // w/1.5 at this lane's samples, the same in every row
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const float4 w4 = __ldg(reinterpret_cast<const float4*>(a.window) + lane + 32 * g);
    ws[4 * g] = __fmul_rn(w4.x, inv15), ws[4 * g + 1] = __fmul_rn(w4.y, inv15);
    ws[4 * g + 2] = __fmul_rn(w4.z, inv15), ws[4 * g + 3] = __fmul_rn(w4.w, inv15);
  }
  for (int i = warp; i < ROWS; i += WARPS) {
    const int t = t0 + i;
    if (i >= a.tf || t >= T) {
      for (int kb = 4 * lane; kb < C::KB; kb += 128) Aw[a_word(i, kb)] = 0u;
      if (lane == 0) deqA[i] = nyqA[i] = 0.f;
      continue;
    }
    const bool edge = t < 3 || t >= T - 3;
    float v[32];
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int j0 = 4 * (lane + 32 * g);
      if (!edge) {
        const float4 s4 = *reinterpret_cast<const float4*>(sig + i * HOP + j0);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[4 * g + e] = C::Q8 ? sv[e] * ws[4 * g + e] : bfr(bfr(sv[e]) * bfr(ws[4 * g + e]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + e;
          int s = HOP * t + j - N / 2;
          s = s < 0 ? -s : (s >= L ? 2 * (L - 1) - s : s);
          const int u = s + N / 2, c = u / HOP, o = u % HOP;
          const int tab = t < 3 ? c : 6 + c - (T - 3);
          const float x = (sig[(c - t0) * HOP + o] * __ldg(a.invw + tab * HOP + o)) *
                          __ldg(a.window + j);
          v[4 * g + e] = C::Q8 ? x : bfr(x);
        }
      }
    }
    float nq = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) nq += (e & 1) ? -v[e] : v[e];
    nq = warp_sum(nq);
    if constexpr (C::Q8) {
      float mx = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) mx = fmaxf(mx, fabsf(v[e]));
      const float amax = warp_max(mx) + 1e-20f;
      const float sc = __fdiv_rn(Q_SCALE, amax);
#pragma unroll
      for (int g = 0; g < 8; ++g)
        Aw[a_word(i, 4 * (lane + 32 * g))] =
            pack_q4(v[4 * g] * sc, v[4 * g + 1] * sc, v[4 * g + 2] * sc, v[4 * g + 3] * sc);
      if (lane == 0) deqA[i] = amax * (float)(1.0 / (126.5 * 127.0));
    } else {
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int kb = 8 * (lane + 32 * g);
        Aw[a_word(i, kb)] = pack_bf2(v[4 * g], v[4 * g + 1]);
        Aw[a_word(i, kb + 4)] = pack_bf2(v[4 * g + 2], v[4 * g + 3]);
      }
      if (lane == 0) deqA[i] = 1.f;
    }
    if (lane == 0) nyqA[i] = nq;
  }
}

// The probe build (-DSPOOFSV_GLTC_PROBE, spoofsv_torch/ops/gl_tc_probe.py)
// records the global timer at each phase boundary of one CTA's thread 0 (and
// when its producer has issued its last copy); other builds record nothing.
#ifdef SPOOFSV_GLTC_PROBE
#define MARK(i)                                                                 \
  do {                                                                          \
    if (probing) {                                                              \
      long long t_;                                                             \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)::"memory");          \
      a.prof[i] = t_;                                                           \
    }                                                                           \
  } while (0)
#else
#define MARK(i) \
  do {          \
  } while (0)
#endif

template <int MODE>
__global__ void __launch_bounds__(THREADS + 32, 1) gl_tc_kernel(Args a) {
  using C = Cfg<MODE>;
  using Acc = typename std::conditional<C::Q8, int, float>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* As = ring + C::STAGES * STAGE;
  uint32_t* Aw = reinterpret_cast<uint32_t*>(As);
  float* sig = reinterpret_cast<float*>(As + ROWS * C::KB);  // [CHUNKS][HOP]
  float* deqS = sig + CHUNKS * HOP;
  float* nyqS = deqS + ROWS;
  float* deqA = nyqS + ROWS;
  float* nyqA = deqA + ROWS;
  const uint32_t full0 = smem_addr(nyqA + ROWS), empty0 = full0 + 8 * C::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, t0 = blockIdx.x * a.tf, T = a.T;
#ifdef SPOOFSV_GLTC_PROBE
  const bool probe_cta = a.prof != nullptr && blockIdx.x == 1 && blockIdx.y == 0;
  bool probing = probe_cta && tid == 0;
#endif

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);       // the producer's expect_tx
      mbar_init(empty0 + 8 * s, WARPS);  // each consumer warp done with the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  MARK(0);

  if (warp == WARPS) {
    // the producer: lane 0 walks the synthesis stream, then the analysis
    // one, into the ring's stages as the consumers free them
    if (lane == 0) {
      unsigned g = 0;
      for (int p = 0; p < C::GEMMS; ++p) {
        const unsigned char* src = p == 0 ? a.stream_syn : a.stream_ana;
        for (int i = 0; i < 4 * C::SPC; ++i, ++g) {
          const int s = g % C::STAGES;
          if (g >= (unsigned)C::STAGES) mbar_wait(empty0 + 8 * s, ((g / C::STAGES) - 1) & 1);
          mbar_expect_tx(full0 + 8 * s, STAGE);
          bulk_copy(smem_addr(ring + s * STAGE), src + (size_t)i * STAGE, STAGE, full0 + 8 * s);
        }
      }
#ifdef SPOOFSV_GLTC_PROBE
      probing = probe_cta;
#endif
      MARK(21);
    }
    return;
  }

  const int wm = warp & 1, wn = warp >> 1;
  unsigned gc = 0;  // stages consumed (the same count in every consumer thread)
  Acc acc[2][8][4];

  // ---- synthesis: frames t0−3 .. t0+60, overlap-added into the signal ----
  build_synthesis<MODE>(a, Aw, deqS, nyqS, b, t0, warp, lane);
  csync();
  MARK(1);
  for (int r = 0; r < 4; ++r) {
    product_chunk<MODE>(acc, As, ring, full0, empty0, gc, wm, wn, lane);
    MARK(2 + r);
    csync();  // chunk r−1's signal updates are done
    float2 win[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      win[nt] = __ldg(reinterpret_cast<const float2*>(a.window + r * HOP + wn * 64 + nt * 8) +
                      (lane & 3));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mt * 16 + (lane >> 2) + 8 * h;
        const int sc = row - HALO + r;  // signal chunk (t0 − 3 + row) + r, less t0
        if (sc < 0 || sc >= a.tf + 3) continue;
        const float dq = deqS[row], ny = nyqS[row] * (1.f / N);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int off = wn * 64 + nt * 8 + 2 * (lane & 3);
          const float fr0 = (C::Q8 ? (float)acc[mt][nt][2 * h] * dq : (float)acc[mt][nt][2 * h]) + ny;
          const float fr1 =
              (C::Q8 ? (float)acc[mt][nt][2 * h + 1] * dq : (float)acc[mt][nt][2 * h + 1]) - ny;
          const float v0 = bfr(fr0 * win[nt].x), v1 = bfr(fr1 * win[nt].y);
          float2* p = reinterpret_cast<float2*>(sig + sc * HOP + off);
          if (r == 0) {
            *p = make_float2(v0, v1);
          } else {
            const float2 o = *p;
            *p = make_float2(o.x + v0, o.y + v1);
          }
        }
      }
    MARK(6 + r);
  }
  csync();
  MARK(10);

  if constexpr (MODE == FINAL) {
    // audio chunk q = signal chunk q+2 (the n_fft/2 crop) · 1/window_sumsquare;
    // this CTA writes chunks [t0, t0+tf), the last CTA up to chunk T
    const int c_lo = t0 > 2 ? t0 : 2, c_hi = t0 + a.tf >= T ? T + 1 : t0 + a.tf;
    float* out = a.audio + (size_t)b * (T - 1) * HOP;
    for (int e = tid; e < (c_hi - c_lo) * HOP; e += THREADS) {
      const int c = c_lo + e / HOP, j = e % HOP;
      const float scale = c == 2 ? a.invw[2 * HOP + j]
                                 : (c == T ? a.invw[9 * HOP + j] : (float)(1.0 / 1.5));
      out[(size_t)(c - 2) * HOP + j] = sig[(c - t0) * HOP + j] * scale;
    }
    MARK(11);
    return;
  } else {
    // ---- analysis of this CTA's frames: forward DFT, momentum, normalise ----
    build_analysis<MODE>(a, Aw, sig, deqA, nyqA, t0, warp, lane);
    csync();
    MARK(11);
    if (tid < a.tf && t0 + tid < T) {  // the Nyquist bin (its sine part is 0)
      const size_t fr = (size_t)b * T + t0 + tid;
      const float rn = nyqA[tid], xn = rn - a.alpha * (a.first ? 0.f : a.rebn[fr]);
      a.angn_out[fr] = __float2bfloat16_rn(xn * rsqrtf(xn * xn + 1e-32f));
      a.rebn[fr] = rn;
    }
    for (int nc = 0; nc < 4; ++nc) {
      // the previous rebuilt spectra of this thread's 32 bins, loaded before
      // the product (their latency hides behind it) and before any update (a
      // store would otherwise order each following load after it)
      float2 prev[2][2][8];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = wm * 32 + mt * 16 + (lane >> 2) + 8 * h, t = t0 + i;
          const bool live = i < a.tf && t < T && !a.first;
          const float2* rp = reinterpret_cast<const float2*>(a.reb + ((size_t)b * T + t) * N);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            prev[mt][h][nt] =
                live ? rp[nc * 128 + wn * 32 + nt * 4 + (lane & 3)] : make_float2(0.f, 0.f);
        }
      product_chunk<MODE>(acc, As, ring, full0, empty0, gc, wm, wn, lane);
      MARK(12 + nc);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = wm * 32 + mt * 16 + (lane >> 2) + 8 * h, t = t0 + i;
          if (i >= a.tf || t >= T) continue;
          const size_t fr = (size_t)b * T + t;
          const float dq = deqA[i];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int bin = nc * 128 + wn * 32 + nt * 4 + (lane & 3);
            const float rr = (float)acc[mt][nt][2 * h] * dq, ri = (float)acc[mt][nt][2 * h + 1] * dq;
            const float xr = rr - a.alpha * prev[mt][h][nt].x, xi = ri - a.alpha * prev[mt][h][nt].y;
            const float inv = rsqrtf(xr * xr + xi * xi + 1e-32f);
            reinterpret_cast<uint32_t*>(a.ang_out + fr * N)[bin] = pack_bf2(xr * inv, xi * inv);
            reinterpret_cast<float2*>(a.reb + fr * N)[bin] = make_float2(rr, ri);
          }
        }
      MARK(16 + nc);
    }
  }
}

template <int MODE>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t s) {
  static bool ready = false;  // the shared-memory opt-in, once per process
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        gl_tc_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg<MODE>::SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  gl_tc_kernel<MODE><<<grid, THREADS + 32, Cfg<MODE>::SMEM, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3: n_iter iterations from the f32 angles (a0re, a0im), then the final
// synthesis into audio. int8 selects the operands (streams syn/ana int8, fin
// the bf16 synthesis; else syn = fin = bf16). ang: 2 x B·T x 1024 bf16; angn:
// 2 x B·T bf16; reb: B·T x 1024 f32; rebn, deq: B·T f32; qm: B·T x 512 bf16;
// tf analysis frames a CTA; prof (probe builds: 32 int64 a launch) or null.
// n_iter + 1 launches on `stream`.
int spoofsv_gl_tc_run(int int8, const float* mag, const float* a0re, const float* a0im,
                      void* ang, void* angn, float* reb, float* rebn, void* qm, float* deq,
                      const void* syn, const void* ana, const void* fin, const float* window,
                      const float* invw, float* audio, long long* prof, int B, int T, int tf,
                      int n_iter, float alpha, void* stream) {
  const int tiles = (T + tf - 1) / (tf > 0 ? tf : 1);
  if (tf < 3 || tf > MAX_FRAMES || T < 16 || T - (tiles - 1) * tf < 3 || B < 1 || n_iter < 0)
    return (int)cudaErrorInvalidValue;
  const size_t bt = (size_t)B * T;
  __nv_bfloat16* angs = static_cast<__nv_bfloat16*>(ang);
  __nv_bfloat16* angns = static_cast<__nv_bfloat16*>(angn);
  Args a{mag, a0re, a0im, nullptr, nullptr, nullptr, nullptr, reb, rebn,
         static_cast<__nv_bfloat16*>(qm), deq, static_cast<const unsigned char*>(syn),
         static_cast<const unsigned char*>(ana), window, invw, audio, nullptr, T, tf, 1, alpha};
  const dim3 grid(tiles, B);
  cudaStream_t s = (cudaStream_t)stream;
  for (int it = 0; it <= n_iter; ++it) {
    a.first = it == 0;
    a.prof = prof ? prof + 32 * it : nullptr;   // 32 slots a launch
    a.ang_in = angs + (size_t)(it & 1) * bt * N;
    a.angn_in = angns + (size_t)(it & 1) * bt;
    a.ang_out = angs + (size_t)((it + 1) & 1) * bt * N;
    a.angn_out = angns + (size_t)((it + 1) & 1) * bt;
    cudaError_t e;
    if (it == n_iter) {
      a.stream_syn = static_cast<const unsigned char*>(fin);
      e = launch<FINAL>(a, grid, s);
    } else {
      e = int8 ? launch<ITER_INT8>(a, grid, s) : launch<ITER_BF16>(a, grid, s);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

const char* spoofsv_gl_tc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
