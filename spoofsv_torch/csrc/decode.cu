// K1: the whole autoregressive Text2Mel decode in one launch (sm_90a).
//
// Replaces the Pallas TPU kernel spoofsv_tpu/ops/pallas_decode.py::_decode_kernel.
// One block runs the full T-frame rollout for R batch rows: per frame the
// audio-encoder front, 10 encoder highway steps, monotonic attention over K
// (window [pma, pma+2]) and r = A·V, the [r; q] dense, 6 decoder highway
// steps, 3x dense-LN-relu and the 80-bin dense + LN + sigmoid.
//
// What bounds it on the H100: every frame each block streams all decode
// weights (~13 MB in bf16, 16 highway kernels of 768x512 plus the denses)
// from L2, so the per-SM L2 read rate bounds a frame; the products are
// f32-accumulated FMAs on the CUDA cores (~7 MFMA per row per frame).
// What the design does about it: the weights are read once per frame per
// block and used for R rows at a time; the weights (13 MB) stay resident
// in the 50 MB L2 across blocks and frames; the row activations live in
// shared memory; the 16 causal-conv caches are rings in global memory
// addressed at slot t mod 2d, so no cache data moves between frames.
// Tensor-core products (mma.sync / wgmma) are later work.
//
// Layouts (row-major, as spoofsv_torch.ops.decode_kernel.pack_decode_weights):
//   K, V (Bp, N, C) T;  s1, s2 (Bp, C) T
//   hw_w (16, 3C, 2C) T; hw_b (16, 2C) f32; hw_ln (16, 4, C) f32
//   sq_w (5, C, C) T; sq_b (5, C) f32; misc_ln (7, 2, C) f32
//   enc_w1 (fpad, C) T; enc_b1 (C) f32; dec_w1 (2C, C) T; dec_b1 (C) f32
//   tail_w5 (C, fpad) T; tail_b5, ln5_s, ln5_b (fpad) f32
//   rings (256 slots, Bp, C) T, zeroed by the caller
//   outputs: Y (Bp, T, F) T; A (Bp, N, T) T; pma (Bp) int32 (in-loop f32 argmax)

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int N_HW = 16;
constexpr float LN_EPS = 1e-5f;

// decode-path highway layers in execution order: enc.hci1, enc.hci2,
// enc.hc1, enc.hc2, dec.hci, dec.hc1, dec.hc2
__constant__ int c_dil[N_HW] = {1, 3, 9, 27, 1, 3, 9, 27, 3, 3, 1, 3, 9, 27, 1, 1};
__constant__ int c_slot0[N_HW] = {0, 2, 8, 26, 80, 82, 88, 106, 160, 166, 172, 174, 180, 198, 252, 254};
constexpr int RING_SLOTS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// value as the working type T would hold it
template <typename T> __device__ __forceinline__ float round_t(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
struct DecodeArgs {
  const T *K, *V, *s1, *s2;
  const T* hw_w; const float* hw_b; const float* hw_ln;
  const T* sq_w; const float* sq_b; const float* misc_ln;
  const T* enc_w1; const float* enc_b1;
  const T* dec_w1; const float* dec_b1;
  const T* tail_w5; const float* tail_b5; const float* ln5_s; const float* ln5_b;
  T* rings; T* y_out; T* a_out; int* pma_out;
  int Bp, T_frames, N, F, fpad, C, condition;
};

// 16-byte weight loads: VEC consecutive output columns of one W row.
template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int VEC = 4;
  __device__ __forceinline__ static void load(const float* p, float* w) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* w) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      w[2 * i] = f.x;
      w[2 * i + 1] = f.y;
    }
  }
};
// floats of split-K partial sums a block needs: R x THREADS x VEC
template <typename T, int R> constexpr int part_floats() { return R * THREADS * Pack<T>::VEC; }

// out[r, j] = bias[j] + sum_k in[r, k] * W[k, j] for the block's R rows.
// Each thread owns VEC consecutive columns (one 16-byte load per W row) and a
// contiguous slice of k (split-K across the threads left over); the slices'
// partial sums meet in shared memory. nout % VEC == 0, nout / VEC <= THREADS.
template <int R, typename T>
__device__ void dense(const float* in, int ldin, int kdim, const T* __restrict__ W,
                      int ldw, int nout, const float* __restrict__ bias, float* out,
                      int ldout, float* part) {
  constexpr int VEC = Pack<T>::VEC;
  const int ncg = nout / VEC;
  const int ksplit = THREADS / ncg;
  const int cg = threadIdx.x % ncg, ks = threadIdx.x / ncg;
  if (ks < ksplit) {
    float acc[R][VEC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
    const int k0 = ks * kdim / ksplit, k1 = (ks + 1) * kdim / ksplit;
    const T* wp = W + (size_t)k0 * ldw + cg * VEC;
#pragma unroll 8
    for (int k = k0; k < k1; ++k, wp += ldw) {
      float w[VEC];
      Pack<T>::load(wp, w);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = in[r * ldin + k];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(x, w[v], acc[r][v]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) part[(ks * R + r) * nout + cg * VEC + v] = acc[r][v];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * nout; i += THREADS) {
    const int r = i / nout, j = i % nout;
    float s = bias[j];
    for (int q = 0; q < ksplit; ++q) s += part[(q * R + r) * nout + j];
    out[r * ldout + j] = s;
  }
  __syncthreads();
}

// Row-wise LayerNorm (flax fast variance: E[x^2] - mean^2), optional relu.
template <int R>
__device__ void layer_norm(float* x, int ld, int width, const float* __restrict__ scale,
                           const float* __restrict__ bias, bool relu) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += THREADS / 32) {
    float* row = x + r * ld;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < width; c += 32) {
      const float v = row[c];
      s += v;
      s2 += v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mean = s / width;
    const float var = fmaxf(s2 / width - mean * mean, 0.f);
    const float rstd = 1.0f / sqrtf(var + LN_EPS);
    for (int c = lane; c < width; c += 32) {
      float v = (row[c] - mean) * rstd * scale[c] + bias[c];
      row[c] = relu ? fmaxf(v, 0.f) : v;
    }
  }
  __syncthreads();
}

// dst[r, c] = value of src[r, c] rounded to T (the matmul operand type).
template <typename T, int R>
__device__ void stage(float* dst, int lddst, const float* src, int ldsrc, int width) {
  for (int i = threadIdx.x; i < R * width; i += THREADS) {
    const int r = i / width, c = i % width;
    dst[r * lddst + c] = round_t<T>(src[r * ldsrc + c]);
  }
  __syncthreads();
}

// One gated highway step (HighwayConv.step) with circular ring addressing.
template <typename T, int R>
__device__ void highway(const DecodeArgs<T>& a, int li, int t, int b0, float* sx, float* sop,
                        float* sh, float* part) {
  const int C = a.C, d = c_dil[li];
  const int i0 = t % (2 * d);        // slot of x[t-2d], also the write slot of x[t]
  const int i1 = (t + d) % (2 * d);  // slot of x[t-d]
  T* ring0 = a.rings + ((size_t)(c_slot0[li] + i0) * a.Bp + b0) * C;
  const T* ring1 = a.rings + ((size_t)(c_slot0[li] + i1) * a.Bp + b0) * C;
  for (int i = threadIdx.x; i < R * C; i += THREADS) {
    const int r = i / C, c = i % C;
    sop[r * 3 * C + c] = to_f(ring0[r * C + c]);
    sop[r * 3 * C + C + c] = to_f(ring1[r * C + c]);
    sop[r * 3 * C + 2 * C + c] = round_t<T>(sx[r * C + c]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * C; i += THREADS) ring0[i] = from_f<T>(sx[i]);
  dense<R>(sop, 3 * C, 3 * C, a.hw_w + (size_t)li * 3 * C * 2 * C, 2 * C, 2 * C,
        a.hw_b + li * 2 * C, sh, 2 * C, part);
  const float* ln = a.hw_ln + (size_t)li * 4 * C;
  layer_norm<R>(sh, 2 * C, C, ln, ln + C, false);
  layer_norm<R>(sh + C, 2 * C, C, ln + 2 * C, ln + 3 * C, false);
  for (int i = threadIdx.x; i < R * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const float g = sigm(sh[r * 2 * C + c]);
    sx[i] = g * sh[r * 2 * C + C + c] + (1.f - g) * sx[i];
  }
  __syncthreads();
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS) decode_kernel(DecodeArgs<T> a) {
  extern __shared__ float smem[];
  const int C = a.C, fpad = a.fpad, F = a.F, N = a.N;
  float* sx = smem;                    // (R, C)   current activation
  float* sop = sx + R * C;          // (R, 3C)  matmul operand (rounded to T)
  float* sh = sop + R * 3 * C;      // (R, 2C)  matmul output
  float* sy = sh + R * 2 * C;       // (R, fpad) previous mel frame
  float* part = sy + R * fpad;      // split-K partial sums of dense()
  __shared__ int spma[R];
  const int b0 = blockIdx.x * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float scale = 1.0f / sqrtf((float)C);

  for (int i = threadIdx.x; i < R * fpad; i += THREADS) sy[i] = 0.f;
  if (threadIdx.x < R) spma[threadIdx.x] = 0;
  __syncthreads();

  for (int t = 0; t < a.T_frames; ++t) {
    // ---- audio-encoder front (AudioEncoder._front) ----
    stage<T, R>(sop, fpad, sy, fpad, F);
    dense<R>(sop, fpad, F, a.enc_w1, C, C, a.enc_b1, sx, C, part);
    if (a.condition) {
      for (int i = threadIdx.x; i < R * C; i += THREADS) sx[i] += to_f(a.s1[(size_t)b0 * C + i]);
      __syncthreads();
    }
    layer_norm<R>(sx, C, C, a.misc_ln, a.misc_ln + C, true);
    stage<T, R>(sop, C, sx, C, C);
    dense<R>(sop, C, C, a.sq_w, C, C, a.sq_b, sx, C, part);
    layer_norm<R>(sx, C, C, a.misc_ln + 2 * C, a.misc_ln + 3 * C, true);
    stage<T, R>(sop, C, sx, C, C);
    dense<R>(sop, C, C, a.sq_w + (size_t)C * C, C, C, a.sq_b + C, sx, C, part);
    if (a.condition) {
      for (int i = threadIdx.x; i < R * C; i += THREADS) sx[i] += to_f(a.s2[(size_t)b0 * C + i]);
      __syncthreads();
    }
    layer_norm<R>(sx, C, C, a.misc_ln + 4 * C, a.misc_ln + 5 * C, false);

    for (int li = 0; li < 10; ++li) highway<T, R>(a, li, t, b0, sx, sop, sh, part);

    // ---- monotonic attention (MelSyn.decode_step); warp r owns row r ----
    // Scores outside [pma, pma+2] are masked to -2^32 before the softmax, so
    // their probabilities are exactly 0: only the window is evaluated.
    if (warp < R) {
      const int r = warp, b = b0 + r;
      const int pma = spma[r];
      const int hi = min(pma + 2, N - 1);
      const float* q = sx + r * C;
      float sc[3];
      float m = -3.0e38f;
      for (int w = 0; w < 3; ++w) {
        const int n = pma + w;
        sc[w] = -3.0e38f;
        if (n <= hi) {
          const T* kr = a.K + ((size_t)b * N + n) * C;
          float s = 0.f;
          for (int c = lane; c < C; c += 32) s = fmaf(to_f(kr[c]), q[c], s);
          sc[w] = warp_sum(s) * scale;
          m = fmaxf(m, sc[w]);
        }
      }
      float e[3], sum = 0.f;
      for (int w = 0; w < 3; ++w) {
        e[w] = (pma + w <= hi) ? expf(sc[w] - m) : 0.f;
        sum += e[w];
      }
      float p[3], amax = 0.f;
      for (int w = 0; w < 3; ++w) {
        p[w] = e[w] / sum;
        amax = fmaxf(amax, p[w]);
      }
      int arg = pma;   // first index attaining the max
      for (int w = 2; w >= 0; --w)
        if (pma + w <= hi && p[w] >= amax) arg = pma + w;
      for (int n = lane; n < N; n += 32) {
        const int w = n - pma;
        const float v = (w >= 0 && w < 3 && n <= hi) ? p[w] : 0.f;
        a.a_out[((size_t)b * N + n) * a.T_frames + t] = from_f<T>(v);
      }
      // dec1 operand [r; q], each rounded to T
      for (int c = lane; c < C; c += 32) {
        float acc = 0.f;
        for (int w = 0; w < 3; ++w)
          if (pma + w <= hi) acc = fmaf(p[w], to_f(a.V[((size_t)b * N + pma + w) * C + c]), acc);
        sop[r * 2 * C + c] = round_t<T>(acc);
        sop[r * 2 * C + C + c] = round_t<T>(q[c]);
      }
      __syncwarp();
      if (lane == 0) spma[r] = arg;
    }
    __syncthreads();

    // ---- audio decoder ----
    dense<R>(sop, 2 * C, 2 * C, a.dec_w1, C, C, a.dec_b1, sx, C, part);
    layer_norm<R>(sx, C, C, a.misc_ln + 6 * C, a.misc_ln + 7 * C, false);
    for (int li = 10; li < N_HW; ++li) highway<T, R>(a, li, t, b0, sx, sop, sh, part);
    for (int i = 2; i < 5; ++i) {
      stage<T, R>(sop, C, sx, C, C);
      dense<R>(sop, C, C, a.sq_w + (size_t)i * C * C, C, C, a.sq_b + i * C, sx, C, part);
      layer_norm<R>(sx, C, C, a.misc_ln + (2 * i + 4) * C, a.misc_ln + (2 * i + 5) * C, true);
    }
    stage<T, R>(sop, C, sx, C, C);
    dense<R>(sop, C, C, a.tail_w5, fpad, F, a.tail_b5, sh, fpad, part);
    layer_norm<R>(sh, fpad, F, a.ln5_s, a.ln5_b, false);
    for (int i = threadIdx.x; i < R * F; i += THREADS) {
      const int r = i / F, f = i % F;
      const T y = from_f<T>(sigm(sh[r * fpad + f]));
      a.y_out[((size_t)(b0 + r) * a.T_frames + t) * F + f] = y;
      sy[r * fpad + f] = to_f(y);
    }
    __syncthreads();
  }
  if (threadIdx.x < R) a.pma_out[b0 + threadIdx.x] = spma[threadIdx.x];
}

template <typename T, int R>
int launch(const DecodeArgs<T>& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (R * (6 * a.C + a.fpad) + part_floats<T, R>());
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<T, R><<<a.Bp / R, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* const* p, int rows, int Bp, int T_frames, int N, int F, int fpad,
                int C, int condition, cudaStream_t stream) {
  DecodeArgs<T> a;
  a.K = (const T*)p[0]; a.V = (const T*)p[1]; a.s1 = (const T*)p[2]; a.s2 = (const T*)p[3];
  a.hw_w = (const T*)p[4]; a.hw_b = (const float*)p[5]; a.hw_ln = (const float*)p[6];
  a.sq_w = (const T*)p[7]; a.sq_b = (const float*)p[8]; a.misc_ln = (const float*)p[9];
  a.enc_w1 = (const T*)p[10]; a.enc_b1 = (const float*)p[11];
  a.dec_w1 = (const T*)p[12]; a.dec_b1 = (const float*)p[13];
  a.tail_w5 = (const T*)p[14]; a.tail_b5 = (const float*)p[15];
  a.ln5_s = (const float*)p[16]; a.ln5_b = (const float*)p[17];
  a.rings = (T*)p[18]; a.y_out = (T*)p[19]; a.a_out = (T*)p[20]; a.pma_out = (int*)p[21];
  a.Bp = Bp; a.T_frames = T_frames; a.N = N; a.F = F; a.fpad = fpad; a.C = C;
  a.condition = condition;
  switch (rows) {
    case 1: return launch<T, 1>(a, stream);
    case 2: return launch<T, 2>(a, stream);
    case 4: return launch<T, 4>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int spoofsv_decode_ring_slots() { return RING_SLOTS; }

// ptrs: the 22 device pointers in DecodeArgs order. dtype 0 = f32, 1 = bf16.
// rows: batch rows per block (1, 2 or 4); Bp must be a multiple of it.
int spoofsv_decode_launch(int dtype, const void* const* ptrs, int rows, int Bp, int T_frames,
                          int N, int F, int fpad, int C, int condition, void* stream) {
  // dense() needs every output width (2C, C, F) a multiple of 8 and 2C/4 <= THREADS
  if (rows < 1 || Bp % rows != 0 || C % 32 != 0 || C > 512 || F % 8 != 0 || N < 1 ||
      F > fpad)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? launch_rows<__nv_bfloat16>(ptrs, rows, Bp, T_frames, N, F, fpad, C, condition, s)
             : launch_rows<float>(ptrs, rows, Bp, T_frames, N, F, fpad, C, condition, s);
}

const char* spoofsv_decode_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
