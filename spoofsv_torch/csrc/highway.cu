// K6, the highway gate, for sm_90a, in f32 or bf16 storage with f32
// arithmetic. Replaces spoofsv_tpu/ops/pallas_ops.py::_gate_kernel. (K4 and
// K5, whole highway blocks, are csrc/hconv_pair.cu.)
//
// Per row of h (rows, 2C) and x (rows, C):
//   y = s(LN1(h1))·LN2(h2) + (1 − s(LN1(h1)))·x,  s = sigmoid
// with both LayerNorms in f32 and the two-pass variance mean((v − μ)²).
//
// What bounds it: device-memory bytes. h and x are read once and y written
// once, with ~10 operations an element: the audio encoder's 16·325 rows at
// C = 256 in f32 are 21.3 MB, 6.4 µs at 3.35 TB/s.
//
// What this design does about it.
// - 16-byte loads and stores: a row half is C / V vectors of V = 4 f32 or
//   8 bf16; L = min(32, C / V) lanes share a row, neighbouring lanes on
//   neighbouring vectors, and the row sums are shuffles within those lanes.
// - Bytes in flight: a warp issues every load of its rows (h and x) before
//   any arithmetic, and takes two passes' rows at once where one pass would
//   keep less than 2 KB in flight.
// - One launch a call: the four LayerNorm vectors come as four pointers in
//   their own storage type and go to shared memory as f32 once a block. The
//   grid is the card's SMs times the blocks an SM holds; each warp walks its
//   rows with a grid stride.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

typedef __nv_bfloat16 bf16;

// 16 bytes of T ↔ 16 / sizeof(T) floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x, f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// sum over the L lanes of this lane's row (aligned groups of L lanes)
template <int L>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Lane `lane` of a warp takes row grp = lane / L of each of the warp's G =
// 32 / L rows a pass, and vectors j·L + lane % L (j < NV) of each row half;
// C = NV·L·V. A warp takes R passes' rows at once.
// ---------------------------------------------------------------------------
template <typename T, int NV, int L>
__global__ void __launch_bounds__(THREADS)
gate_kernel(const T* __restrict__ h, const T* __restrict__ x, const void* s1, const void* b1,
            const void* s2, const void* b2, int ln_bf16, T* __restrict__ out, int rows,
            float eps) {
  constexpr int V = 16 / sizeof(T), C = NV * L * V, G = 32 / L;
  constexpr int R = NV == 1 ? 2 : 1;  // one pass of NV = 1 keeps 1.5 KB in flight
  extern __shared__ float lns[];      // [4][C]: LN1 scale, LN1 bias, LN2 scale, LN2 bias
  for (int i = threadIdx.x; i < 4 * C; i += THREADS) {
    const int v = i / C, c = i - v * C;
    const void* p = v == 0 ? s1 : v == 1 ? b1 : v == 2 ? s2 : b2;
    lns[i] = ln_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[c])
                     : static_cast<const float*>(p)[c];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, sub = lane % L, grp = lane / L;
  const int warp = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int stride = gridDim.x * (THREADS / 32) * G * R;
  const float inv_c = 1.f / C;
  for (int base = warp * G * R; base < rows; base += stride) {
    float a[R][NV][V], b[R][NV][V], r[R][NV][V];
    // every load of the warp's rows first
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = base + i * G + grp;
      const bool ok = row < rows;
      const T* hr = h + (size_t)row * 2 * C;
      const T* xr = x + (size_t)row * C;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int off = (j * L + sub) * V;
        const uint4 z = make_uint4(0, 0, 0, 0);
        unpack(ok ? *reinterpret_cast<const uint4*>(hr + off) : z, a[i][j]);
        unpack(ok ? *reinterpret_cast<const uint4*>(hr + C + off) : z, b[i][j]);
        unpack(ok ? *reinterpret_cast<const uint4*>(xr + off) : z, r[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e) m1 += a[i][j][e], m2 += b[i][j][e];
      m1 = row_sum<L>(m1) * inv_c, m2 = row_sum<L>(m2) * inv_c;
      float q1 = 0.f, q2 = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          a[i][j][e] -= m1, b[i][j][e] -= m2;
          q1 += a[i][j][e] * a[i][j][e], q2 += b[i][j][e] * b[i][j][e];
        }
      const float r1 = rsqrtf(row_sum<L>(q1) * inv_c + eps);
      const float r2 = rsqrtf(row_sum<L>(q2) * inv_c + eps);
      const int row = base + i * G + grp;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int off = (j * L + sub) * V;
        float y[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int c = off + e;
          const float g = sigmoid(a[i][j][e] * r1 * lns[c] + lns[C + c]);
          const float n2 = b[i][j][e] * r2 * lns[2 * C + c] + lns[3 * C + c];
          y[e] = g * n2 + (1.f - g) * r[i][j][e];
        }
        *reinterpret_cast<uint4*>(out + (size_t)row * C + off) = pack(y);
      }
    }
  }
}

// A failed runtime call also sets the last error; clear it so that the next
// launch's cudaGetLastError() does not report this one.
int clear_and_return(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

template <typename T, int NV, int L>
int gate_launch(const void* h, const void* x, const void* s1, const void* b1, const void* s2,
                const void* b2, int ln_bf16, void* out, int rows, float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T), C = NV * L * V, G = 32 / L, R = NV == 1 ? 2 : 1;
  constexpr size_t smem = 4 * C * sizeof(float);
  auto kernel = gate_kernel<T, NV, L>;
  static int per_sm = 0;  // blocks an SM holds (the same on every H100)
  if (!per_sm) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (e != cudaSuccess) return clear_and_return(e);
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return clear_and_return(e);
  const long long rows_per_block = (long long)(THREADS / 32) * G * R;
  const long long need = (rows + rows_per_block - 1) / rows_per_block;
  const int grid = (int)(need < (long long)sms * per_sm ? need : (long long)sms * per_sm);
  kernel<<<grid, THREADS, smem, s>>>((const T*)h, (const T*)x, s1, b1, s2, b2, ln_bf16, (T*)out,
                                     rows, eps);
  return (int)cudaGetLastError();
}

// The instantiation for C (a power of two in [32, 1024]).
template <typename T>
int gate_dispatch(const void* h, const void* x, const void* s1, const void* b1, const void* s2,
                  const void* b2, int ln_bf16, void* out, int rows, int C, float eps,
                  cudaStream_t s) {
#define SPOOFSV_GATE(NV, L) \
  return gate_launch<T, NV, L>(h, x, s1, b1, s2, b2, ln_bf16, out, rows, eps, s)
  constexpr int V = 16 / sizeof(T);
  if constexpr (V == 8) {
    if (C == 32) SPOOFSV_GATE(1, 4);
  }
  if (C == 8 * V) SPOOFSV_GATE(1, 8);
  if (C == 16 * V) SPOOFSV_GATE(1, 16);
  if (C == 32 * V) SPOOFSV_GATE(1, 32);
  if (C == 64 * V) SPOOFSV_GATE(2, 32);
  if (C == 128 * V) SPOOFSV_GATE(4, 32);
  if constexpr (V == 4) {
    if (C == 1024) SPOOFSV_GATE(8, 32);
  }
#undef SPOOFSV_GATE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K6. dtype 0 f32, 1 bf16: h (rows, 2C), x and out (rows, C); s1, b1, s2, b2
// the LayerNorm vectors (C each: LN1 scale, LN1 bias, LN2 scale, LN2 bias),
// f32 (ln_dtype 0) or bf16 (1). C a power of two in [32, 1024].
int spoofsv_highway_gate_launch(int dtype, const void* h, const void* x, const void* s1,
                                const void* b1, const void* s2, const void* b2, int ln_dtype,
                                void* out, int rows, int C, float eps, void* stream) {
  if (dtype < 0 || dtype > 1 || ln_dtype < 0 || ln_dtype > 1 || C < 32 || C > 1024 ||
      (C & (C - 1)) || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? gate_dispatch<float>(h, x, s1, b1, s2, b2, ln_dtype, out, rows, C, eps, s)
                    : gate_dispatch<bf16>(h, x, s1, b1, s2, b2, ln_dtype, out, rows, C, eps, s);
}

const char* spoofsv_highway_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
