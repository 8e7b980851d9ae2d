// The Tacotron 2 decoder step between its two LSTM gate products, for sm_90a,
// bf16 operands and f32 arithmetic. Replaces no TPU kernel (the JAX package
// has no Tacotron 2); ops/t2_kernel.py launches both kernels, between two
// cuBLAS products, four launches a step, and captures the 1000 steps of a
// call into one CUDA graph.
//
// t2_att_step_kernel, a block per ROWS_ATT batch rows:
//   the attention LSTM cell's pointwise update (gates i, f, g, o; cell state
//   f32) → h; query q = W_q h; location features: the K-tap convolution over
//   [w, Σw] (zero padded) and its dense layer; energies
//   e_n = v·tanh(q + dense(loc)_n + pm_n), −inf past the row's length; the
//   softmax in f32; Σw += w; the context Σ_n w_n memory_n. h and the context
//   go in bf16 into the next products' operand rows.
// t2_dec_step_kernel, a block per ROWS_DEC rows:
//   the decoder cell's pointwise update → h; [h, context] through the
//   projection and the gate (one matrix of n_mel + 1 rows) → the frame and
//   its stop logit; the next step's prenet (two layers, ReLU, dropout kept
//   at inference with masks hashed from (step, unit, row seed, layer)) →
//   the attention cell's next operand row.
//
// What bounds it: latency. A step is two products of B × 4096 over
// 2048 / 2816 inputs (6.6 GFLOP at B=160), then these kernels, each a few µs
// of f32 work over weights read from L2 (W_q 256 KB, the projection 287 KB,
// the prenet 172 KB) and the memory (B·N·768 bf16, 12 MB at B=160 N=49).
// What this design does about it: one launch for everything between two
// products, nothing staged through device memory but the operand rows;
// 16-byte loads of bf16 weights, a warp's lanes along a weight row, several
// rows' loads issued before any arithmetic (a first version that loaded as
// it went waited on L2 latency: 118 and 98 µs a step), shuffled sums; the
// small per-row state (h, query, [w, Σw], location features, energies) in
// shared memory; the block's rows share each weight load; the host
// launches nothing a step (a CUDA graph replays the call).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifdef SPOOFSV_T2_PROBE
// clock64 at each phase boundary of block 0 (thread 0), per kernel
__device__ long long g_t2_probe[2][16];
#define T2_MARK(kernel, i) \
  if (blockIdx.x == 0 && threadIdx.x == 0) g_t2_probe[kernel][i] = clock64()
#else
#define T2_MARK(kernel, i)
#endif

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_ATT = 2;   // batch rows a block of t2_att_step_kernel
constexpr int ROWS_DEC = 4;   // of t2_dec_step_kernel
constexpr int NF = 32;        // location filters (the published 32, kept in registers)
constexpr int M_MAX = 1024;   // the memory's width at most (the context's halves)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x, f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint2 pack4(float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ops/t2_kernel.py::mask_hash_plain, in uint32 arithmetic
__device__ __forceinline__ uint32_t mask_hash(uint32_t step, uint32_t unit, uint32_t seed,
                                              uint32_t layer) {
  uint32_t h = (step * 73856093u) ^ (unit * 19349663u) ^ (seed * 83492791u) ^
               (layer * 0x27D4EB2Fu);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// f32 global → shared, n floats (n and both pointers multiples of 4 / 16 bytes)
__device__ __forceinline__ void copy_f32(float* dst, const float* __restrict__ src, int n) {
#pragma unroll 4
  for (int i = threadIdx.x * 4; i < n; i += THREADS * 4)
    *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(src + i);
}

// An LSTM cell's pointwise update for the block's rows, four units a thread
// (16-byte loads): gates g (B, 4H) f32 plus the summed bias; the cell state
// c (B, H) f32 in place; h to shared memory (row r at sh + r·sh_stride) and,
// in bf16, to out1[b·ld1 + j] and (where given) out2[b·ld2 + j]. H, ld1,
// ld2 multiples of 4.
template <int ROWS>
__device__ void lstm_rows(const float* __restrict__ g, const float* __restrict__ bias,
                          float* __restrict__ c, float* sh, int sh_stride, bf16* out1, int ld1,
                          bf16* out2, int ld2, int r0, int B, int H) {
  const int H4 = H / 4;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < ROWS * H4; idx += THREADS) {
    const int r = idx / H4, j = (idx - r * H4) * 4, b = r0 + r;
    if (b >= B) continue;
    const float* gr = g + (size_t)b * 4 * H;
    float4 x[4], bb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[q] = *reinterpret_cast<const float4*>(gr + q * H + j);
      bb[q] = *reinterpret_cast<const float4*>(bias + q * H + j);
    }
    const float4 cv = *reinterpret_cast<const float4*>(c + (size_t)b * H + j);
    float cc[4] = {cv.x, cv.y, cv.z, cv.w}, h[4];
    const float gi[4] = {x[0].x + bb[0].x, x[0].y + bb[0].y, x[0].z + bb[0].z, x[0].w + bb[0].w};
    const float gf[4] = {x[1].x + bb[1].x, x[1].y + bb[1].y, x[1].z + bb[1].z, x[1].w + bb[1].w};
    const float gg[4] = {x[2].x + bb[2].x, x[2].y + bb[2].y, x[2].z + bb[2].z, x[2].w + bb[2].w};
    const float go[4] = {x[3].x + bb[3].x, x[3].y + bb[3].y, x[3].z + bb[3].z, x[3].w + bb[3].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cc[k] = sigmoid(gf[k]) * cc[k] + sigmoid(gi[k]) * tanhf(gg[k]);
      h[k] = sigmoid(go[k]) * tanhf(cc[k]);
    }
    *reinterpret_cast<float4*>(c + (size_t)b * H + j) = make_float4(cc[0], cc[1], cc[2], cc[3]);
    *reinterpret_cast<float4*>(sh + r * sh_stride + j) = make_float4(h[0], h[1], h[2], h[3]);
    const uint2 hb = pack4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint2*>(out1 + (size_t)b * ld1 + j) = hb;
    if (out2 != nullptr) *reinterpret_cast<uint2*>(out2 + (size_t)b * ld2 + j) = hb;
  }
}

// y[r·y_stride + o] = W[o] · x[r·x_stride : +K] (+ bias[o]) for the block's
// rows and o < n_out, W (n_out, K) bf16 row-major, x f32 in shared memory
// (x_stride and K multiples of 8, K ≤ NCH·256). A warp takes OUTS outputs
// at once, its lanes along the rows in 8-wide chunks: it issues every
// weight load of those outputs first (NCH·OUTS 16-byte loads in flight a
// lane: the step's weights come from device memory, the gate products
// having passed 40 MB through the L2 since), then reads each chunk of x from
// shared memory once for the OUTS outputs.
template <int ROWS, int NCH, int OUTS>
__device__ void matvec_rows(const bf16* __restrict__ W, int K, int n_out, const float* x,
                            int x_stride, float* y, int y_stride,
                            const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o0 = warp * OUTS; o0 < n_out; o0 += WARPS * OUTS) {
    uint4 wv[NCH][OUTS];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int q = 0; q < OUTS; ++q) {
        const int k0 = (c * 32 + lane) * 8;
        wv[c][q] = o0 + q < n_out && k0 < K
                       ? *reinterpret_cast<const uint4*>(W + (size_t)(o0 + q) * K + k0)
                       : make_uint4(0u, 0u, 0u, 0u);
      }
    float acc[OUTS][ROWS] = {};
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int k0 = (c * 32 + lane) * 8;
      if (k0 >= K) continue;
      float xv[ROWS][8];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 x0 = *reinterpret_cast<const float4*>(x + r * x_stride + k0);
        const float4 x1 = *reinterpret_cast<const float4*>(x + r * x_stride + k0 + 4);
        xv[r][0] = x0.x, xv[r][1] = x0.y, xv[r][2] = x0.z, xv[r][3] = x0.w;
        xv[r][4] = x1.x, xv[r][5] = x1.y, xv[r][6] = x1.z, xv[r][7] = x1.w;
      }
#pragma unroll
      for (int q = 0; q < OUTS; ++q) {
        float w8[8];
        unpack8(wv[c][q], w8);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[q][r] += w8[k] * xv[r][k];
      }
    }
#pragma unroll
    for (int q = 0; q < OUTS; ++q)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float s = warp_sum(acc[q][r]);
        if (lane == 0 && o0 + q < n_out)
          y[r * y_stride + o0 + q] = s + (bias != nullptr ? bias[o0 + q] : 0.f);
      }
  }
}

__host__ __device__ int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ int imax(int a, int b) { return a > b ? a : b; }

// shared memory of t2_att_step_kernel, in floats; the bf16 processed memory last
size_t att_smem_floats(int N, int A, int AT, int K) {
  return (size_t)ROWS_ATT * A + (size_t)ROWS_ATT * AT + round8(ROWS_ATT * 2 * (N + K - 1)) +
         round8(ROWS_ATT * NF * N) + round8(ROWS_ATT * N) + (size_t)AT * NF +
         round8(NF * 2 * K) + (size_t)AT +
         imax(round8(4 * ROWS_ATT * N), round8(2 * ROWS_ATT * M_MAX)) +
         (size_t)ROWS_ATT * N * AT / 2;
}

size_t dec_smem_floats(int D, int M, int P, int NM) {
  return (size_t)ROWS_DEC * (D + M) + (size_t)ROWS_DEC * round8(NM + 1) +
         2 * (size_t)ROWS_DEC * P;
}

// a_buf row: [prenet (P) | context (M) | attention h (A)]; d_buf row:
// [attention h (A) | decoder h (D) | context (M)]. wloc_t is the location
// convolution as (2, K, NF), wdense_t the dense layer as (NF, AT), pm the
// processed memory as (B, AT, N).
__global__ void __launch_bounds__(THREADS)
t2_att_step_kernel(const float* __restrict__ g, const float* __restrict__ bias,
                   float* __restrict__ c, bf16* __restrict__ abuf, bf16* __restrict__ dbuf,
                   const bf16* __restrict__ wq, const float* __restrict__ wloc_t,
                   const float* __restrict__ wdense_t, const float* __restrict__ v,
                   const bf16* __restrict__ pm, const bf16* __restrict__ mem,
                   const int* __restrict__ lengths, float* __restrict__ w,
                   float* __restrict__ cum, float* __restrict__ att_out, int B, int N, int T,
                   int t, int A, int P, int M, int D, int AT, int K) {
  constexpr int ROWS = ROWS_ATT;
  extern __shared__ __align__(16) float smem[];
  const int NP = N + K - 1, pad = (K - 1) / 2;
  const int LA = P + M + A, LD = A + D + M;
  float* sh = smem;                                // ROWS × A: attention h
  float* sq = sh + ROWS * A;                       // ROWS × AT: query
  float* swc = sq + ROWS * AT;                     // ROWS × 2 × NP: [w, Σw], zero padded
  float* sloc = swc + round8(ROWS * 2 * NP);       // ROWS × NF × N: location features
  float* se = sloc + round8(ROWS * NF * N);        // ROWS × N: energies, then weights
  float* sdense = se + round8(ROWS * N);           // NF × AT: the dense layer, transposed
  float* swloc = sdense + AT * NF;                 // 2 × K × NF: the location convolution
  float* sv = swloc + round8(NF * 2 * K);          // AT: v
  float* spart = sv + AT;   // 4 × ROWS × N: the energies' quarters; then 2 × ROWS × M
  bf16* spm = reinterpret_cast<bf16*>(spart + imax(round8(4 * ROWS * N), round8(2 * ROWS * M)));
  const int r0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // everything this block reads from device memory, its loads issued together
  T2_MARK(0, 0);
  lstm_rows<ROWS>(g, bias, c, sh, A, abuf + P + M, LA, dbuf, LD, r0, B, A);
  copy_f32(sdense, wdense_t, AT * NF);
  copy_f32(swloc, wloc_t, NF * 2 * K);
  copy_f32(sv, v, AT);
  const int nrows = min(ROWS, B - r0);
#pragma unroll 4
  for (int i = tid * 8; i < nrows * AT * N; i += THREADS * 8)
    *reinterpret_cast<uint4*>(spm + i) =
        *reinterpret_cast<const uint4*>(pm + (size_t)r0 * AT * N + i);
  for (int i = tid; i < ROWS * 2 * NP; i += THREADS) {
    const int r = i / (2 * NP), rem = i - r * 2 * NP, ch = rem / NP, n = rem - ch * NP - pad;
    const int b = r0 + r;
    float x = 0.f;
    if (b < B && n >= 0 && n < N) x = (ch == 0 ? w : cum)[(size_t)b * N + n];
    swc[i] = x;
  }
  __syncthreads();
  T2_MARK(0, 1);

  matvec_rows<ROWS, 4, 4>(wq, A, AT, sh, A, sq, AT, nullptr);   // the query (A ≤ 1024)
  T2_MARK(0, 2);
  // the location convolution over [w, Σw]: a thread per (row, position, 8
  // filters), the filters' taps read as broadcast 16-byte words
  const int NF8 = NF / 8;
  for (int i = tid; i < ROWS * N * NF8; i += THREADS) {
    const int f0 = (i / (ROWS * N)) * 8, rn = i - (f0 / 8) * ROWS * N, r = rn / N, n = rn - r * N;
    const float* x0 = swc + r * 2 * NP + n;
    const float* x1 = x0 + NP;
    float acc[8] = {};
    for (int k = 0; k < K; ++k) {
      const float a0 = x0[k], a1 = x1[k];
      const float4 w0 = *reinterpret_cast<const float4*>(swloc + k * NF + f0);
      const float4 w1 = *reinterpret_cast<const float4*>(swloc + k * NF + f0 + 4);
      const float4 v0 = *reinterpret_cast<const float4*>(swloc + (K + k) * NF + f0);
      const float4 v1 = *reinterpret_cast<const float4*>(swloc + (K + k) * NF + f0 + 4);
      acc[0] += w0.x * a0 + v0.x * a1, acc[1] += w0.y * a0 + v0.y * a1;
      acc[2] += w0.z * a0 + v0.z * a1, acc[3] += w0.w * a0 + v0.w * a1;
      acc[4] += w1.x * a0 + v1.x * a1, acc[5] += w1.y * a0 + v1.y * a1;
      acc[6] += w1.z * a0 + v1.z * a1, acc[7] += w1.w * a0 + v1.w * a1;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) sloc[(r * NF + f0 + q) * N + n] = acc[q];
  }
  __syncthreads();
  T2_MARK(0, 3);

  // the energies: a thread per (row, position) and quarter of the attention
  // width (a warp's lanes on neighbouring positions, one quarter), the
  // location features in registers, the dense layer's columns read as
  // broadcast 16-byte words; the quarters' sums added after
  {
    const int g = tid / (THREADS / 4), AQ = AT / 4;
    for (int pidx = tid % (THREADS / 4); pidx < ROWS * N; pidx += THREADS / 4) {
      const int r = pidx / N, n = pidx - r * N;
      float lf[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) lf[f] = sloc[(r * NF + f) * N + n];
      const bf16* pmr = spm + r * AT * N + n;
      float s = 0.f;
      for (int a = g * AQ; a < (g + 1) * AQ; a += 4) {
        float pa[4] = {};
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const float4 d = *reinterpret_cast<const float4*>(sdense + f * AT + a);
          pa[0] += d.x * lf[f], pa[1] += d.y * lf[f], pa[2] += d.z * lf[f], pa[3] += d.w * lf[f];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s += sv[a + q] * tanhf(pa[q] + sq[r * AT + a + q] + __bfloat162float(pmr[(a + q) * N]));
      }
      spart[g * ROWS * N + pidx] = s;
    }
  }
  __syncthreads();
  T2_MARK(0, 4);
  for (int pidx = tid; pidx < ROWS * N; pidx += THREADS) {
    const int r = pidx / N, n = pidx - r * N, b = r0 + r;
    se[pidx] = b < B && n < lengths[b]
                   ? spart[pidx] + spart[ROWS * N + pidx] + spart[2 * ROWS * N + pidx] +
                         spart[3 * ROWS * N + pidx]
                   : -INFINITY;
  }
  __syncthreads();

  // the softmax over the row's length: a warp a row
  if (warp < ROWS) {
    const int r = warp, b = r0 + r;
    if (b < B) {
      const int L = lengths[b];
      float* er = se + r * N;
      float m = -INFINITY;
      for (int n = lane; n < L; n += 32) m = fmaxf(m, er[n]);
      m = warp_max(m);
      float sum = 0.f;
      for (int n = lane; n < L; n += 32) {
        const float e = expf(er[n] - m);
        er[n] = e;
        sum += e;
      }
      const float inv = 1.f / warp_sum(sum);
      for (int n = lane; n < N; n += 32) {
        const float wn = n < L ? er[n] * inv : 0.f;
        er[n] = wn;
        w[(size_t)b * N + n] = wn;
        cum[(size_t)b * N + n] += wn;
        att_out[((size_t)b * N + n) * T + t] = wn;
      }
    }
  }
  __syncthreads();
  T2_MARK(0, 5);

  // the context: a thread per 8 memory columns of a row and half of its
  // positions, 8 positions' loads in flight; the halves added after
  const int MV = M / 8;
  float* sctx = spart;   // 2 × ROWS × M: the halves' sums (the energies' quarters are spent)
  for (int i = tid; i < 2 * ROWS * MV; i += THREADS) {
    const int half = i / (ROWS * MV), ri = i - half * ROWS * MV, r = ri / MV;
    const int d0 = (ri - r * MV) * 8, b = r0 + r;
    float acc[8] = {};
    if (b < B) {
      const int L = lengths[b], n_mid = (L + 1) / 2;
      const int n_lo = half ? n_mid : 0, n_hi = half ? L : n_mid;
      const bf16* mr = mem + (size_t)b * N * M + d0;
      const float* wr = se + r * N;
      for (int n0 = n_lo; n0 < n_hi; n0 += 8) {
        uint4 mv[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          mv[q] = n0 + q < n_hi ? *reinterpret_cast<const uint4*>(mr + (size_t)(n0 + q) * M)
                                : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float wn = n0 + q < n_hi ? wr[n0 + q] : 0.f;
          float m8[8];
          unpack8(mv[q], m8);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] += wn * m8[k];
        }
      }
    }
    float* dst = sctx + (half * ROWS + r) * M + d0;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();
  for (int i = tid; i < ROWS * MV; i += THREADS) {
    const int r = i / MV, d0 = (i - r * MV) * 8, b = r0 + r;
    if (b >= B) continue;
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = sctx[r * M + d0 + k] + sctx[(ROWS + r) * M + d0 + k];
    const uint4 o = pack8(acc);
    *reinterpret_cast<uint4*>(abuf + (size_t)b * LA + P + d0) = o;
    *reinterpret_cast<uint4*>(dbuf + (size_t)b * LD + A + D + d0) = o;
  }
  T2_MARK(0, 6);
}

__global__ void __launch_bounds__(THREADS)
t2_dec_step_kernel(const float* __restrict__ g, const float* __restrict__ bias,
                   float* __restrict__ c, bf16* __restrict__ dbuf, bf16* __restrict__ abuf,
                   const bf16* __restrict__ wproj, const float* __restrict__ bproj,
                   const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                   const int* __restrict__ seeds, float* __restrict__ mel,
                   float* __restrict__ gate, int B, int T, int t, int A, int P, int M, int D,
                   int NM, uint32_t thresh, float scale) {
  constexpr int ROWS = ROWS_DEC;
  extern __shared__ __align__(16) float smem[];
  const int K = D + M, O = NM + 1, OS = round8(O);
  const int LA = P + M + A, LD = A + D + M;
  float* sx = smem;              // ROWS × K: [decoder h | context]
  float* so = sx + ROWS * K;     // ROWS × OS: the frame and the stop logit
  float* sy = so + ROWS * OS;    // ROWS × P: the prenet's first layer
  float* sz = sy + ROWS * P;     // ROWS × P: its second
  const int r0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;

  T2_MARK(1, 0);
  lstm_rows<ROWS>(g, bias, c, sx, K, dbuf + A, LD, nullptr, 0, r0, B, D);
  const int MV = M / 8;
  for (int i = tid; i < ROWS * MV; i += THREADS) {
    const int r = i / MV, d0 = (i - r * MV) * 8, b = r0 + r;
    float x[8] = {};
    if (b < B) unpack8(*reinterpret_cast<const uint4*>(dbuf + (size_t)b * LD + A + D + d0), x);
    float* dst = sx + r * K + D + d0;
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4], x[5], x[6], x[7]);
  }
  __syncthreads();
  T2_MARK(1, 1);

  matvec_rows<ROWS, 8, 2>(wproj, K, O, sx, K, so, OS, bproj);   // the projection and the gate
  __syncthreads();
  T2_MARK(1, 2);
  for (int i = tid; i < ROWS * O; i += THREADS) {
    const int r = i / O, o = i - r * O, b = r0 + r;
    if (b >= B) continue;
    if (o < NM)
      mel[((size_t)b * T + t) * NM + o] = so[r * OS + o];
    else
      gate[(size_t)b * T + t] = so[r * OS + o];
  }

  // the next step's prenet: ReLU, then the inference dropout's hashed mask
  matvec_rows<ROWS, 1, 8>(w1, NM, P, so, OS, sy, P, nullptr);
  __syncthreads();
  T2_MARK(1, 3);
  for (int i = tid; i < ROWS * P; i += THREADS) {
    const int r = i / P, u = i - r * P, b = r0 + r;
    const bool keep = b < B && (mask_hash(t + 1, u, (uint32_t)seeds[b], 0) & 0xFFFFFFu) >= thresh;
    sy[i] = keep ? fmaxf(sy[i], 0.f) * scale : 0.f;
  }
  __syncthreads();
  matvec_rows<ROWS, 1, 8>(w2, P, P, sy, P, sz, P, nullptr);
  __syncthreads();
  T2_MARK(1, 4);
  for (int i = tid; i < ROWS * P; i += THREADS) {
    const int r = i / P, u = i - r * P, b = r0 + r;
    if (b >= B) continue;
    const bool keep = (mask_hash(t + 1, u, (uint32_t)seeds[b], 1) & 0xFFFFFFu) >= thresh;
    abuf[(size_t)b * LA + u] = __float2bfloat16(keep ? fmaxf(sz[i], 0.f) * scale : 0.f);
  }
  T2_MARK(1, 5);
}

// the largest dynamic shared memory each kernel has been allowed so far
size_t att_smem_set = 48 * 1024, dec_smem_set = 48 * 1024;

}  // namespace

extern "C" {

int spoofsv_t2_att_step(void* g, void* bias, void* c, void* abuf, void* dbuf, void* wq,
                        void* wloc_t, void* wdense_t, void* v, void* pm, void* mem, void* lengths,
                        void* w, void* cum, void* att_out, int B, int N, int T, int t, int A,
                        int P, int M, int D, int AT, int NF_in, int K, void* stream) {
  if (NF_in != NF || M > M_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = att_smem_floats(N, A, AT, K) * sizeof(float);
  if (smem > att_smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        t2_att_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    att_smem_set = smem;
  }
  t2_att_step_kernel<<<(B + ROWS_ATT - 1) / ROWS_ATT, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)bias, (float*)c, (bf16*)abuf, (bf16*)dbuf,
      (const bf16*)wq, (const float*)wloc_t, (const float*)wdense_t, (const float*)v,
      (const bf16*)pm, (const bf16*)mem, (const int*)lengths, (float*)w, (float*)cum,
      (float*)att_out, B, N, T, t, A, P, M, D, AT, K);
  return (int)cudaGetLastError();
}

int spoofsv_t2_dec_step(void* g, void* bias, void* c, void* dbuf, void* abuf, void* wproj,
                        void* bproj, void* w1, void* w2, void* seeds, void* mel, void* gate,
                        int B, int T, int t, int A, int P, int M, int D, int NM, int thresh,
                        float scale, void* stream) {
  const size_t smem = dec_smem_floats(D, M, P, NM) * sizeof(float);
  if (smem > dec_smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        t2_dec_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dec_smem_set = smem;
  }
  t2_dec_step_kernel<<<(B + ROWS_DEC - 1) / ROWS_DEC, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)bias, (float*)c, (bf16*)dbuf, (bf16*)abuf,
      (const bf16*)wproj, (const float*)bproj, (const bf16*)w1, (const bf16*)w2,
      (const int*)seeds, (float*)mel, (float*)gate, B, T, t, A, P, M, D, NM,
      (uint32_t)thresh, scale);
  return (int)cudaGetLastError();
}

const char* spoofsv_t2_rollout_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

#ifdef SPOOFSV_T2_PROBE
// the phase clocks of the last launches (2 × 16 int64) into host memory
int spoofsv_t2_probe_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_t2_probe, sizeof(g_t2_probe));
}
#endif

}  // extern "C"
