// K4 (whole highway block) and K6 (highway gate) for sm_90a, in f32 or
// bf16 storage with f32 arithmetic.
//
// A highway block computes, per frame t of x (B, T, C):
//   [h1, h2] = conv(x)[t] + bias             (K taps at dilation d, 2C wide)
//   y[t]     = s(LN1(h1))·LN2(h2) + (1 − s(LN1(h1)))·x[t],  s = sigmoid
// with both LayerNorms in f32 and the two-pass variance mean((v − μ)²).
//
// K6 replaces spoofsv_tpu/ops/pallas_ops.py::_gate_kernel: the conv is done
// elsewhere and the kernel reads h and x once and writes y once, one warp per
// row with the row's values in registers. Bound: device-memory bytes.
//
// K4 replaces spoofsv_tpu/ops/pallas_conv.py::_hconv_kernel. One block per
// (utterance, tile of BM frames) computes the tile's full 2C-wide h in
// registers: the conv is a product of the (BM, K·C) tap-shifted operand with
// the (K·C, 2C) weight, accumulated in f32 by FMA loops in this file, BK
// reduction rows at a time through shared memory. Each thread owns RPT
// consecutive frames and four columns of h1 together with the same four
// columns of h2, so the gate pairs h1 and h2 in registers; the LayerNorm
// statistics are warp shuffles plus a small shared-memory sum across the
// warps of a row. h never reaches device memory. The halo'd x tile
// (BM + d·(K−1) frames, zero outside [0, T): SAME or causal offsets) is not
// staged whole: each reduction chunk stages the (BM, BK) operand slice of one
// tap, read from L2 at its shifted frames, so x costs a few KB of shared
// memory against the MB of weight each block streams. Bound: the weight
// stream from L2 (each block reads the whole (K·C, 2C) weight once) and
// CUDA-core FMAs; tensor cores (wgmma) are a later step. K5, the pair of
// blocks, is csrc/hconv_pair.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPB = 256;       // K4 threads per block
constexpr int RPT = 8;         // K4 frames per thread
constexpr int BK = 16;         // reduction rows per shared-memory chunk
constexpr int GATE_WARPS = 8;  // K6 rows per block (one warp per row)
constexpr int GATE_MAXV = 32;  // K6 values per lane per half: C <= 1024

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// K6: one warp per row of h (rows, 2C) and x (rows, C); ln is (4, C) f32:
// LN1 scale, LN1 bias, LN2 scale, LN2 bias.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(GATE_WARPS * 32)
gate_kernel(const T* __restrict__ h, const T* __restrict__ x, const float* __restrict__ ln,
            T* __restrict__ out, int rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * GATE_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nv = C >> 5;
  const T* h1 = h + (size_t)row * 2 * C;
  const T* h2 = h1 + C;
  float a[GATE_MAXV], b[GATE_MAXV];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < GATE_MAXV; ++j) {
    if (j < nv) {
      a[j] = to_f(h1[lane + 32 * j]);
      b[j] = to_f(h2[lane + 32 * j]);
      s1 += a[j];
      s2 += b[j];
    }
  }
  const float mu1 = warp_sum(s1) / C, mu2 = warp_sum(s2) / C;
  float q1 = 0.f, q2 = 0.f;
#pragma unroll
  for (int j = 0; j < GATE_MAXV; ++j) {
    if (j < nv) {
      a[j] -= mu1;
      b[j] -= mu2;
      q1 += a[j] * a[j];
      q2 += b[j] * b[j];
    }
  }
  const float r1 = rsqrtf(warp_sum(q1) / C + eps), r2 = rsqrtf(warp_sum(q2) / C + eps);
  const T* xr = x + (size_t)row * C;
  T* yr = out + (size_t)row * C;
#pragma unroll
  for (int j = 0; j < GATE_MAXV; ++j) {
    if (j < nv) {
      const int c = lane + 32 * j;
      const float g = sigmoid(a[j] * r1 * ln[c] + ln[C + c]);
      const float n2 = b[j] * r2 * ln[2 * C + c] + ln[3 * C + c];
      yr[c] = from_f<T>(g * n2 + (1.f - g) * to_f(xr[c]));
    }
  }
}

// ---------------------------------------------------------------------------
// K4 building blocks. Thread layout of a block: G = C/4 column groups,
// R = TPB/G row groups, BM = R·RPT frames. Thread t owns column group
// cg = t % G (h1 columns 4cg..4cg+3 in acc[i][0..3], the same h2 columns in
// acc[i][4..7]) and frames r0..r0+RPT-1 of the tile, r0 = (t / G)·RPT.
// ---------------------------------------------------------------------------
struct Layout {
  int C, G, R, BM, cg, rg, r0;
  __device__ explicit Layout(int c) : C(c), G(c >> 2), R(TPB / (c >> 2)), BM(R * RPT) {
    cg = threadIdx.x % G;
    rg = threadIdx.x / G;
    r0 = rg * RPT;
  }
};

// acc += A · W over the K·C reduction rows, where A(r, tap, c) is the operand
// of tile row r at tap `tap`, channel c (0 outside the sequence) and W is the
// (K·C, 2C) weight in row-major order. Ws holds BK·2C floats, As BK·(BM+4).
template <typename T, typename Operand>
__device__ void conv_tile(float (&acc)[RPT][8], const Layout& L, int K, const Operand& A,
                          const T* __restrict__ W, float* Ws, float* As) {
  const int C = L.C, C2 = 2 * C, AS = L.BM + 4;
  for (int kk0 = 0; kk0 < K * C; kk0 += BK) {
    for (int i = threadIdx.x; i < BK * C2 / 4; i += TPB) {
      const int r = (4 * i) / C2, c = 4 * i - r * C2;
      store4(Ws + 4 * i, load4(W + (size_t)(kk0 + r) * C2 + c));
    }
    const int tap = kk0 / C, c0 = kk0 - tap * C;
    for (int i = threadIdx.x; i < BK * L.BM; i += TPB) {
      const int r = i / BK, j = i - r * BK;
      As[j * AS + r] = A(r, tap, c0 + j);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 w1 = load4(Ws + j * C2 + 4 * L.cg);
      const float4 w2 = load4(Ws + j * C2 + C + 4 * L.cg);
      const float4 a0 = load4(As + j * AS + L.r0);
      const float4 a1 = load4(As + j * AS + L.r0 + 4);
      const float a[RPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        acc[i][0] = fmaf(a[i], w1.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], w1.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], w1.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], w1.w, acc[i][3]);
        acc[i][4] = fmaf(a[i], w2.x, acc[i][4]);
        acc[i][5] = fmaf(a[i], w2.y, acc[i][5]);
        acc[i][6] = fmaf(a[i], w2.z, acc[i][6]);
        acc[i][7] = fmaf(a[i], w2.w, acc[i][7]);
      }
    }
    __syncthreads();
  }
}

// v[k] summed over the G threads of the caller's row group, for all 2·RPT
// values. red holds 2·RPT·R·max(G/32, 1) floats. Called by every thread.
__device__ void row_group_sum(float (&v)[2 * RPT], const Layout& L, float* red) {
  const int lanes = L.G < 32 ? L.G : 32;
#pragma unroll
  for (int k = 0; k < 2 * RPT; ++k)
    for (int off = lanes >> 1; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  if (L.G <= 32) return;
  const int wpg = L.G >> 5, w = L.cg >> 5;
  if ((L.cg & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 2 * RPT; ++k) red[(k * L.R + L.rg) * wpg + w] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2 * RPT; ++k) {
    float s = 0.f;
    for (int i = 0; i < wpg; ++i) s += red[(k * L.R + L.rg) * wpg + i];
    v[k] = s;
  }
  __syncthreads();
}

// acc (the conv without bias) → the block output in acc[i][0..3], given the
// residual res[i][0..3]. bias: 2C f32; ln: (4, C) f32.
__device__ void highway_epilogue(float (&acc)[RPT][8], const float (&res)[RPT][4],
                                 const Layout& L, const float* __restrict__ bias,
                                 const float* __restrict__ ln, float eps, float* red) {
  const int C = L.C, c = 4 * L.cg;
  const float4 b1 = load4(bias + c), b2 = load4(bias + C + c);
  const float bb[8] = {b1.x, b1.y, b1.z, b1.w, b2.x, b2.y, b2.z, b2.w};
  float v[2 * RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    v[2 * i] = v[2 * i + 1] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] += bb[j];
      v[2 * i + j / 4] += acc[i][j];
    }
  }
  row_group_sum(v, L, red);
  float mu[2 * RPT];
#pragma unroll
  for (int k = 0; k < 2 * RPT; ++k) mu[k] = v[k] / C;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    v[2 * i] = v[2 * i + 1] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] -= mu[2 * i + j / 4];
      v[2 * i + j / 4] += acc[i][j] * acc[i][j];
    }
  }
  row_group_sum(v, L, red);
  const float4 s1 = load4(ln + c), o1 = load4(ln + C + c);
  const float4 s2 = load4(ln + 2 * C + c), o2 = load4(ln + 3 * C + c);
  const float sc1[4] = {s1.x, s1.y, s1.z, s1.w}, of1[4] = {o1.x, o1.y, o1.z, o1.w};
  const float sc2[4] = {s2.x, s2.y, s2.z, s2.w}, of2[4] = {o2.x, o2.y, o2.z, o2.w};
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float r1 = rsqrtf(v[2 * i] / C + eps), r2 = rsqrtf(v[2 * i + 1] / C + eps);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float g = sigmoid(acc[i][j] * r1 * sc1[j] + of1[j]);
      const float n2 = acc[i][4 + j] * r2 * sc2[j] + of2[j];
      acc[i][j] = g * n2 + (1.f - g) * res[i][j];
    }
  }
}

// Rows of x (T frames) at frame g, or zeros outside [0, T).
template <typename T>
__device__ __forceinline__ float4 frame4(const T* xb, int g, int T_, int C, int c) {
  return (g >= 0 && g < T_) ? load4(xb + (size_t)g * C + c) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Shared-memory bytes of the conv/epilogue scratch: Ws, As, red.
__host__ __device__ inline size_t tile_smem(int C) {
  const int G = C / 4, R = TPB / G, BM = R * RPT, wpg = G > 32 ? G / 32 : 1;
  return align16(sizeof(float) * BK * 2 * C) + align16(sizeof(float) * BK * (BM + 4)) +
         align16(sizeof(float) * 2 * RPT * R * wpg);
}

// ---------------------------------------------------------------------------
// K4: grid (ceil(T/BM), B). Tile row r is frame t0 + r; its tap k reads frame
// t0 + r − pad_left + k·dil.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(TPB, 2)
hconv_kernel(const T* __restrict__ x, const T* __restrict__ W, const float* __restrict__ bias,
             const float* __restrict__ ln, T* __restrict__ out, int T_, int C, int K, int dil,
             int pad_left, float eps) {
  extern __shared__ float4 smem4[];
  const Layout L(C);
  float* Ws = reinterpret_cast<float*>(smem4);
  float* As = Ws + align16(sizeof(float) * BK * 2 * C) / sizeof(float);
  float* red = As + align16(sizeof(float) * BK * (L.BM + 4)) / sizeof(float);
  const int t0 = blockIdx.x * L.BM;
  const T* xb = x + (size_t)blockIdx.y * T_ * C;
  T* yb = out + (size_t)blockIdx.y * T_ * C;

  float acc[RPT][8];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto operand = [&](int r, int tap, int c) -> float {
    const int g = t0 + r - pad_left + tap * dil;
    return (g >= 0 && g < T_) ? to_f(xb[(size_t)g * C + c]) : 0.f;
  };
  conv_tile(acc, L, K, operand, W, Ws, As);

  const int c = 4 * L.cg;
  float res[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float4 v = frame4(xb, t0 + L.r0 + i, T_, C, c);
    res[i][0] = v.x, res[i][1] = v.y, res[i][2] = v.z, res[i][3] = v.w;
  }
  highway_epilogue(acc, res, L, bias, ln, eps, red);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int g = t0 + L.r0 + i;
    if (g < T_) store4(yb + (size_t)g * C + c, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

// C a power of two in [16, 1024]: C/4 column groups tile the block's 256
// threads, and BK divides C so a reduction chunk never straddles two taps.
bool tile_geometry_ok(int C) { return C >= 16 && C <= 1024 && (C & (C - 1)) == 0; }

// A failed runtime call also sets the last error; clear it so that the next
// launch's cudaGetLastError() does not report this one.
int clear_and_return(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

template <typename T>
int hconv_launch(const void* x, const void* w, const float* bias, const float* ln, void* out,
                 int B, int T_, int C, int K, int dil, int pad_left, float eps, cudaStream_t s) {
  const size_t smem = tile_smem(C);
  cudaError_t e = cudaFuncSetAttribute(hconv_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return clear_and_return(e);
  const int BM = (TPB / (C / 4)) * RPT;
  dim3 grid((T_ + BM - 1) / BM, B);
  hconv_kernel<T><<<grid, TPB, smem, s>>>((const T*)x, (const T*)w, bias, ln, (T*)out, T_, C, K,
                                          dil, pad_left, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K6. dtype 0 f32, 1 bf16. h (rows, 2C), x and out (rows, C); ln (4, C) f32.
int spoofsv_highway_gate_launch(int dtype, const void* h, const void* x, const float* ln,
                                void* out, int rows, int C, float eps, void* stream) {
  if (dtype < 0 || dtype > 1 || C <= 0 || C % 32 || C > 32 * GATE_MAXV || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (rows + GATE_WARPS - 1) / GATE_WARPS;
  if (dtype == 0)
    gate_kernel<float><<<grid, GATE_WARPS * 32, 0, s>>>((const float*)h, (const float*)x, ln,
                                                        (float*)out, rows, C, eps);
  else
    gate_kernel<bf16><<<grid, GATE_WARPS * 32, 0, s>>>((const bf16*)h, (const bf16*)x, ln,
                                                       (bf16*)out, rows, C, eps);
  return (int)cudaGetLastError();
}

// K4. x and out (B, T, C); w (K·C, 2C) in x's type; bias (2C) and ln (4, C) f32.
int spoofsv_hconv_launch(int dtype, const void* x, const void* w, const float* bias,
                         const float* ln, void* out, int B, int T, int C, int K, int dil,
                         int pad_left, float eps, void* stream) {
  if (dtype < 0 || dtype > 1 || !tile_geometry_ok(C) || K < 1 || dil < 1 || B < 0 || T < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? hconv_launch<float>(x, w, bias, ln, out, B, T, C, K, dil, pad_left, eps, s)
                    : hconv_launch<bf16>(x, w, bias, ln, out, B, T, C, K, dil, pad_left, eps, s);
}

const char* spoofsv_highway_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
