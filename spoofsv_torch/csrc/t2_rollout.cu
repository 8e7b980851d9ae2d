// The Tacotron 2 decoder step between its two LSTM gate products, for sm_90a,
// bf16 weights and memory, f32 arithmetic. Replaces no TPU kernel (the JAX
// package has no Tacotron 2); ops/t2_kernel.py launches both kernels, between
// two cuBLAS products, four launches a step, and captures the 1000 steps of a
// call into one CUDA graph.
//
// t2_att_step_kernel: the attention LSTM cell's pointwise update (gates i, f,
//   g, o; cell state f32) → h; the query q = W_q h; the location term: the
//   K-tap convolution over [w, Σw] (zero padded) through its dense layer;
//   energies e_n = v·tanh(q + location_n + pm_n), −inf past the row's length;
//   the softmax in f32; Σw += w; the context Σ_n w_n memory_n. h and the
//   context go in bf16 into the next products' operand rows.
// t2_dec_step_kernel: the decoder cell's pointwise update → h; [h, context]
//   through the projection and the gate (one matrix of n_mel + 1 rows) → the
//   frame and its stop logit; the next step's prenet (two layers, ReLU,
//   dropout kept at inference with masks hashed from (step, unit, row seed,
//   layer)) → the attention cell's next operand row.
//
// What bounds it: latency, then instruction issue. A step is two products of
// B × 4096 over 2048 / 2816 inputs, then these kernels: a few µs of f32 work
// over weights that the products' 40 MB a step push out of the L2 (W_q
// 256 KB, the projection 287 KB, the prenet 172 KB) and the memory (B·N·768
// bf16, 12 MB at B=160 N=49). A block that loads what a phase needs when the
// phase starts waits on device memory phase after phase; with the bytes staged
// ahead, each phase is bound by its instructions (f32 activations: the
// products run on the CUDA cores).
//
// What this design does about it:
// - A thread-block cluster of C CTAs serves R batch rows (ops/t2_kernel.py's
//   step_plan chooses R, C and the memory's staging from B and N). Each CTA
//   owns a slice of every matrix: of the cells' units (the pointwise update,
//   and the k-slice of W_q and of the projection that those units feed), of
//   the attention width (the location term, the energies, v), of the
//   memory's columns (the context) and of the prenet's units. ops/t2_kernel.py
//   lays the weights out slice by slice (StepWeights), so a CTA's slice of a
//   matrix is one contiguous block.
// - A CTA's bytes come by asynchronous copies into shared memory, each group
//   completing on its own mbarrier, so a phase waits only on its operands:
//   tensor-map copies (TMA) of its rows' gate sums and cell state (one box
//   each), of its memory columns (one box a chunk) and of the decoder's
//   context columns; 1-D bulk copies of the weight slices, the biases and the
//   processed memory's rows; cp.async of [w, Σw] (rows of N floats are no
//   whole 16 bytes). The copies are issued by threads of different warps,
//   the gate sums first, the weights behind them; the processed memory and
//   the memory follow once the gate sums and weights are in (all share the
//   SM's path from memory, and the gate sums are wanted first). Where a row's
//   memory does not fit whole it streams through two chunk buffers.
// - The narrow results cross the cluster through distributed shared memory,
//   completing on the receiver's mbarrier: by one bulk copy per destination
//   CTA, each CTA's partial query (over its units) to the CTA owning those
//   attention units, its partial energies (over its attention units) and its
//   partial projection (over its inputs) to every CTA; by 16-byte st.async
//   stores, its prenet units into every CTA's input row of the second layer.
//   Every receiver sums the partials in rank order, so a launch is
//   deterministic (the graph replays bit-equal to eager steps).
// - The products run from shared memory: a group of lanes takes a tile of 8
//   outputs × a few rows, its lanes split the inputs (16-byte weight loads
//   down a column, rows padded to an odd multiple of 16 bytes: no bank
//   conflicts), the tile's sums meet by halving exchanges of shuffles.
// - The location convolution is folded into its dense layer on the host (U =
//   dense · conv, in float64, stored f32), so a CTA computes its attention
//   units' location term straight from [w, Σw], four positions a thread with
//   the window held in registers, over the taps that reach the row's length.
// - The softmax and the context are a warp's a row: no block barrier between.

#include <cuda.h>   // CUtensorMap (its encoder, cuTensorMapEncodeTiled, looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifdef SPOOFSV_T2_PROBE
// per kernel: clock64 at each phase boundary of block 0 (thread 0), then the
// global timer (ns) at the start and the end of each CTA of the first cluster
__device__ long long g_t2_probe[2][48];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define T2_MARK(kernel, i) \
  if (blockIdx.x == 0 && threadIdx.x == 0) g_t2_probe[kernel][i] = clock64()
#define T2_SPAN(kernel, end) \
  if (blockIdx.x < 8 && threadIdx.x == 0) g_t2_probe[kernel][32 + 2 * blockIdx.x + end] = global_ns()
#else
#define T2_MARK(kernel, i)
#define T2_SPAN(kernel, end)
#endif

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_MAX = 232448;   // bytes of shared memory a block may use (sm_90)
constexpr int C_MAX = 8;           // CTAs a cluster at most (the loops over them unrolled)

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// shared-memory layouts (mirrored by ops/t2_kernel.py's att_smem / dec_smem)
// ---------------------------------------------------------------------------

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ inline int take(int& off, int bytes) {   // 128-byte aligned parts
  const int at = off;
  off += (bytes + 127) & ~127;
  return at;
}
// a row's [w | Σw] channels: positions −pad ... round4(N) + pad + 3, zero outside [0, N)
__host__ __device__ inline int wc_width(int N, int K) { return round4(round4(N) + K - 1); }

struct AttLayout {
  int bars, g, bias, c, wq, u, v, wc, pm, qrecv, sq, esend, erecv, wts, len, ctx, mem, total;
};

// R rows a cluster of C CTAs, the memory in nbuf buffers of `chunk` positions
__host__ __device__ inline AttLayout att_layout(int R, int C, int N, int chunk, int nbuf, int A,
                                                int AT, int M, int K) {
  const int Au = A / C, Aa = AT / C, Mc = M / C, N4 = round4(N);
  AttLayout L;
  int o = 0;
  L.bars = take(o, 8 * 8);
  L.g = take(o, 16 * R * Au);      // R × 4 gates × Au f32; h in place of gate i
  L.bias = take(o, 16 * Au);
  L.c = take(o, 4 * R * Au);
  L.wq = take(o, 2 * Au * (AT + 8));   // W_q^T's rows of this CTA's units, padded
  L.u = take(o, 8 * K * Aa);           // 2K taps × Aa, the folded location layer
  L.v = take(o, 4 * Aa);
  L.wc = take(o, 8 * R * wc_width(N, K));
  L.pm = take(o, 2 * R * Aa * N);      // [r][a][n] bf16
  L.qrecv = take(o, 4 * C * R * Aa);   // [source][r][a] (st.async from every CTA)
  L.sq = take(o, 4 * R * Aa);          // the query, summed
  L.esend = take(o, 4 * R * N4);
  // [source][r][n]; in the gate sums' place where it fits (they are spent
  // before any CTA sends its energies: it waits for this CTA's query first)
  L.erecv = C * N4 <= 4 * Au ? L.g : take(o, 4 * C * R * N4);
  L.wts = take(o, 4 * R * N4);
  L.len = take(o, 4 * R);
  L.ctx = take(o, 4 * R * Mc);
  L.mem = take(o, 2 * nbuf * R * chunk * Mc);   // [buffer][r][n][column] bf16
  L.total = o;
  return L;
}

struct DecLayout {
  int bars, g, bias, c, ctx, x, wp, bp, psend, precv, frame, w1, w2, ysend, x2, seed, total;
};

__host__ __device__ inline DecLayout dec_layout(int R, int C, int D, int M, int P, int NM) {
  const int Du = D / C, Mc = M / C, Pu = P / C, OS = round8(NM + 1), KP = Du + Mc;
  DecLayout L;
  int o = 0;
  L.bars = take(o, 8 * 8);
  L.g = take(o, 16 * R * Du);
  L.bias = take(o, 16 * Du);
  L.c = take(o, 4 * R * Du);
  L.ctx = take(o, 2 * R * Mc);
  L.x = take(o, 4 * R * KP);            // [r][h units | context columns] f32
  L.wp = take(o, 2 * KP * OS);          // the projection's rows of those inputs, transposed
  L.bp = take(o, 4 * OS);
  L.psend = take(o, 4 * R * OS);
  L.precv = take(o, 4 * C * R * OS);    // [source][r][o]
  L.frame = take(o, 4 * R * OS);
  L.w1 = take(o, 2 * NM * (Pu + 8));    // the prenet's units of this CTA, transposed, padded
  L.w2 = take(o, 2 * P * (Pu + 8));
  L.ysend = take(o, 4 * R * Pu);
  L.x2 = take(o, 4 * R * P);            // the first layer's units, every CTA's (st.async)
  L.seed = take(o, 4 * R);
  L.total = o;
  return L;
}

// ---------------------------------------------------------------------------
// arithmetic
// ---------------------------------------------------------------------------

// (by value: the caller's dereference is one 16-byte load)
__device__ __forceinline__ void unpack8(const uint4 u, float (&f)[8]) {
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

// An LSTM unit's update, four units: gate sums x (i, f, g, o) plus bias bb;
// the cell state c in place; h out.
__device__ __forceinline__ void lstm4(const float4 (&x)[4], const float4 (&bb)[4], float (&cc)[4],
                                      float (&h)[4]) {
  const float gi[4] = {x[0].x + bb[0].x, x[0].y + bb[0].y, x[0].z + bb[0].z, x[0].w + bb[0].w};
  const float gf[4] = {x[1].x + bb[1].x, x[1].y + bb[1].y, x[1].z + bb[1].z, x[1].w + bb[1].w};
  const float gg[4] = {x[2].x + bb[2].x, x[2].y + bb[2].y, x[2].z + bb[2].z, x[2].w + bb[2].w};
  const float go[4] = {x[3].x + bb[3].x, x[3].y + bb[3].y, x[3].z + bb[3].z, x[3].w + bb[3].w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cc[k] = sigmoid(gf[k]) * cc[k] + sigmoid(gi[k]) * tanhf(gg[k]);
    h[k] = sigmoid(go[k]) * tanhf(cc[k]);
  }
}

// Sums v[0..V) over the LPG lanes of a lane group by halving exchanges: after
// it, v[i] of the group's lane l holds the sum of entry l·(V/LPG) + i.
template <int V, int H, int S>
__device__ __forceinline__ void halve(float (&v)[V], int lane) {
  if constexpr (H >= 1) {
    const bool up = (lane & H) != 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float send = up ? v[i] : v[i + S];
      const float keep = up ? v[i + S] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
    halve<V, H / 2, S / 2>(v, lane);
  }
}
template <int V, int LPG>
__device__ __forceinline__ void group_reduce(float (&v)[V], int lane) {
  halve<V, LPG / 2, V / 2>(v, lane);
}

// Products from shared memory: for r < R and o < 8·NG, the sum over k < K of
// W[k·ldw + o] · x[r·ldx + k] (W bf16, ldw·2 bytes an odd multiple of 16, so
// 16-byte loads down a column of lanes meet no bank conflict; x f32). A group
// of LPG lanes takes a tile of 8 outputs × RG rows, its lanes splitting k;
// the tile's sums meet by halving exchanges, then each lane calls
// out(r, o, sum) for its 8·RG/LPG of them (rows from R on skipped).
template <int RG, int LPG, typename Out>
__device__ __forceinline__ void mv_tiles(const bf16* W, int ldw, int K, int NG, const float* x,
                                         int ldx, int R, Out out) {
  constexpr int V = 8 * RG, GPW = 32 / LPG, SF = V / LPG;
  static_assert(V >= LPG && 32 % LPG == 0, "a tile's sums cover its lanes");
  const int lane = threadIdx.x & 31, gl = lane % LPG;
  const int units = NG * ((R + RG - 1) / RG);
  for (int base = (threadIdx.x >> 5) * GPW; base < units; base += WARPS * GPW) {
    const int unit = base + lane / LPG;
    const bool on = unit < units;
    const int g = on ? unit % NG : 0, r0 = on ? (unit / NG) * RG : 0;
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.f;
    if (on) {
      // the tile's rows (past R: row R-1 again, its sums dropped below)
      const float* xr[RG];
#pragma unroll
      for (int r = 0; r < RG; ++r) xr[r] = x + min(r0 + r, R - 1) * ldx;
      const bf16* wg = W + 8 * g;
      for (int k = gl; k < K; k += LPG) {
        float w8[8];
        unpack8(*reinterpret_cast<const uint4*>(wg + (size_t)k * ldw), w8);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const float xv = xr[r][k];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[r * 8 + j] += w8[j] * xv;
        }
      }
    }
    group_reduce<V, LPG>(v, lane);
    if (on) {
#pragma unroll
      for (int i = 0; i < SF; ++i) {
        const int idx = gl * SF + i, r = r0 + idx / 8;
        if (r < R) out(r, 8 * g + idx % 8, v[i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// barriers, bulk and tensor copies, the cluster
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// this phase's one arrival, expecting `bytes` of copies to complete on it
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// until the phase of `bar` with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile("{\n.reg .pred p;\nWAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               "@!p bra WAIT;\n}\n" ::"r"(bar),
               "r"(parity)
               : "memory");
}
// 1-D bulk copy global → this CTA's shared memory, completing `bytes` on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// 1-D bulk copy of this CTA's shared memory into a cluster CTA's (dst and bar
// from mapa), completing on that CTA's barrier
__device__ __forceinline__ void bulk_s2c(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n" ::"r"(dst),
               "r"(smem_addr(src)), "r"(bytes), "r"(bar)
               : "memory");
}
// a box of a 2-D / 3-D tensor map (the map in kernel parameter space) at the
// given coordinates (innermost first) into this CTA's shared memory, completing
// the box's bytes on `bar`; past the tensor's edge the box holds zeros
__device__ __forceinline__ void tma2d(void* dst, const CUtensorMap* map, int x, int y,
                                      uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
               "l"(map), "r"(x), "r"(y), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}
__device__ __forceinline__ void tma3d(void* dst, const CUtensorMap* map, int x, int y, int z,
                                      uint32_t bar) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
               "l"(map), "r"(x), "r"(y), "r"(z), "r"(bar)
               : "memory");
}
// 4 bytes, or 4 zero bytes where !valid
__device__ __forceinline__ void cp4z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// this thread's arrival on `bar` (made for THREADS of them) once its
// cp.async copies so far have landed
__device__ __forceinline__ void cp_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// asynchronous 16- and 4-byte stores into a cluster CTA's shared memory (addr
// and bar from mapa), completing their bytes on that CTA's barrier with
// release semantics at cluster scope
__device__ __forceinline__ void st_async_v4(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
               "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z),
               "f"(v.w), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async_f32(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "f"(v), "r"(bar)
               : "memory");
}
// mbar_wait, acquiring at cluster scope what other CTAs' copies and stores
// into this CTA released
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile("{\n.reg .pred p;\nWAIT:\n"
               "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
               "@!p bra WAIT;\n}\n" ::"r"(bar),
               "r"(parity)
               : "memory");
}
// the block waits for what other CTAs sent it: one thread acquires it at
// cluster scope, the block barrier orders every thread's reads after that
__device__ __forceinline__ void block_wait_cluster(uint32_t bar, uint32_t parity) {
  if (threadIdx.x == 0) mbar_wait_cluster(bar, parity);
  __syncthreads();
}

__device__ __forceinline__ uint32_t remote(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
// orders this thread's plain shared-memory accesses before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A split cluster barrier, every thread of the block at the same point: the
// warp reconverges first (.aligned: the warp arrives as one). Relaxed: what
// it orders is the barriers' initialisation (fenced by fence.mbarrier_init)
// and copies whose completion the arriving thread has already observed on
// its own barriers.
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// tid 0: the kernel's n barriers, barrier i made for counts[i] arrivals
__device__ __forceinline__ void make_barriers(uint32_t bars, const int* counts, int n) {
  for (int i = 0; i < n; ++i) mbar_init(bars + 8 * i, counts[i]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// `src` (bytes) of this CTA into each cluster CTA's `dst` + this CTA's place,
// completing on its `bar`: threads d < C send to CTA d, after every thread's
// writes of `src` (the caller fenced them with fence_proxy_async)
__device__ __forceinline__ void send_all(const void* src, const void* dst, uint32_t bytes,
                                         uint32_t bar, int C) {
  if ((int)threadIdx.x < C)
    bulk_s2c(remote(smem_addr(dst), threadIdx.x), src, bytes, remote(bar, threadIdx.x));
}

// ---------------------------------------------------------------------------
// t2_att_step_kernel
// ---------------------------------------------------------------------------

struct AttArgs {
  CUtensorMap gmap;      // (B, 4, A) f32 the attention cell's gate products, boxes (R, 4, A/C)
  CUtensorMap cmap;      // (B, A) f32 its cell state, boxes (R, A/C)
  CUtensorMap mmap;      // (B, N, M) bf16 the memory, boxes (R, chunk, M/C)
  const float* bias;     // (4A) its summed biases
  float* c;              // (B, A) its cell state
  bf16* abuf;            // (B, P + M + A) [prenet | context | attention h]
  bf16* dbuf;            // (B, A + D + M) [attention h | decoder h | context]
  const bf16* wq;        // (C, A/C, AT + 8) W_q^T by CTA, rows padded
  const float* u;        // (C, 2K, AT/C) the folded location layer by CTA
  const float* v;        // (AT)
  const bf16* pm;        // (B, AT, N) the processed memory
  const int* lengths;    // (B)
  float* w;              // (B, N) the attention weights
  float* cum;            // (B, N) their running sum
  float* att_out;        // (B, N, T)
  int B, N, T, t, A, P, M, D, AT, K, R, C, chunk;
};

// barriers of t2_att_step_kernel: [w, Σw] and the lengths take every
// thread's cp.async arrival, the others one arrival expecting copied bytes
enum { AB_WC, AB_IN, AB_W, AB_PM, AB_MEM0, AB_MEM1, AB_Q, AB_E, AB_N };

__global__ void __launch_bounds__(THREADS, 1)
t2_att_step_kernel(const __grid_constant__ AttArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int C = a.C, R = a.R, N = a.N, K = a.K, AT = a.AT;
  const int Au = a.A / C, Aa = AT / C, Mc = a.M / C, N4 = round4(N), WCW = wc_width(N, K);
  const int nchunks = (N + a.chunk - 1) / a.chunk, nbuf = nchunks > 1 ? 2 : 1;
  const AttLayout L = att_layout(R, C, N, a.chunk, nbuf, a.A, AT, a.M, K);
  const int rank = blockIdx.x % C, r0 = (blockIdx.x / C) * R, nv = min(R, a.B - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int LA = a.P + a.M + a.A, LD = a.A + a.D + a.M, pad = (K - 1) / 2;
  float* sg = reinterpret_cast<float*>(smem + L.g);
  const float* sbias = reinterpret_cast<const float*>(smem + L.bias);
  const float* sc = reinterpret_cast<const float*>(smem + L.c);
  const bf16* swq = reinterpret_cast<const bf16*>(smem + L.wq);
  const float* su = reinterpret_cast<const float*>(smem + L.u);
  const float* sv = reinterpret_cast<const float*>(smem + L.v);
  float* swc = reinterpret_cast<float*>(smem + L.wc);
  bf16* spm = reinterpret_cast<bf16*>(smem + L.pm);
  const float* sqrecv = reinterpret_cast<const float*>(smem + L.qrecv);
  float* sq = reinterpret_cast<float*>(smem + L.sq);
  float* sesend = reinterpret_cast<float*>(smem + L.esend);
  const float* serecv = reinterpret_cast<const float*>(smem + L.erecv);
  float* swts = reinterpret_cast<float*>(smem + L.wts);
  int* slen = reinterpret_cast<int*>(smem + L.len);
  float* sctx = reinterpret_cast<float*>(smem + L.ctx);
  bf16* smem_m = reinterpret_cast<bf16*>(smem + L.mem);
  const uint32_t bars = smem_addr(smem + L.bars);

  T2_MARK(0, 0);
  T2_SPAN(0, 0);
  // every byte this CTA reads from device memory, in flight at once, each
  // group of copies issued by a thread of its own warp (which arrives on its
  // barrier expecting the bytes): the gate sums, cell state and biases of its
  // units; the weight slices; its memory columns; its attention units'
  // processed memory; and by every thread [w, Σw] zero padded and the lengths
  if (tid == 0) {
    const int counts[AB_N] = {THREADS, 3, 1, 1, 1, 1, 1, 1};
    make_barriers(bars, counts, AB_N);
    mbar_expect_tx(bars + 8 * AB_Q, C * R * Aa * 4);
    mbar_expect_tx(bars + 8 * AB_E, C * R * N4 * 4);
  } else if (tid == 32) {
    prefetch_map(&a.gmap);
  } else if (tid == 64) {
    prefetch_map(&a.cmap);
  } else if (tid == 128) {
    prefetch_map(&a.mmap);
  }
  __syncthreads();
  cluster_arrive();   // this CTA's barriers are made (waited for before the first send)
  T2_MARK(0, 1);
  if (tid == 32) {   // the gate sums first, then the weights
    mbar_expect_tx(bars + 8 * AB_IN, 16 * R * Au);
    tma3d(sg, &a.gmap, rank * Au, 0, r0, bars + 8 * AB_IN);
    mbar_expect_tx(bars + 8 * AB_W, 2 * Au * (AT + 8) + 8 * K * Aa + 4 * Aa);
    bulk_g2s(smem + L.wq, a.wq + (size_t)rank * Au * (AT + 8), Au * (AT + 8) * 2, bars + 8 * AB_W);
    bulk_g2s(smem + L.u, a.u + (size_t)rank * 2 * K * Aa, 8 * K * Aa, bars + 8 * AB_W);
    bulk_g2s(smem + L.v, a.v + rank * Aa, 4 * Aa, bars + 8 * AB_W);
  } else if (tid == 64) {
    mbar_expect_tx(bars + 8 * AB_IN, 4 * R * Au);
    tma2d(smem + L.c, &a.cmap, rank * Au, r0, bars + 8 * AB_IN);
  } else if (tid == 96) {
    mbar_expect_tx(bars + 8 * AB_IN, 16 * Au);
    for (int q = 0; q < 4; ++q)
      bulk_g2s(smem + L.bias + q * Au * 4, a.bias + q * a.A + rank * Au, Au * 4,
               bars + 8 * AB_IN);
  }
  for (int i = tid; i < R * Mc; i += THREADS) sctx[i] = 0.f;
  for (int rc = warp; rc < 2 * R; rc += WARPS) {   // a warp a row's channel
    const int r = rc >> 1;
    const float* src = (rc & 1 ? a.cum : a.w) + (size_t)(r0 + min(r, nv - 1)) * N - pad;
    for (int i = lane; i < WCW; i += 32) {
      const bool valid = r < nv && i >= pad && i - pad < N;
      cp4z(swc + rc * WCW + i, valid ? src + i : a.w, valid);
    }
  }
  for (int r = tid; r < R; r += THREADS)
    cp4z(slen + r, a.lengths + r0 + min(r, nv - 1), r < nv);
  cp_arrive(bars + 8 * AB_WC);
  T2_MARK(0, 2);

  // the cell's update for this CTA's units; h in place of gate i (zero past B)
  mbar_wait(bars + 8 * AB_IN, 0);
  T2_MARK(0, 3);

  {
    const int A4 = Au / 4;
    for (int i = tid; i < R * A4; i += THREADS) {
      const int r = i / A4, j = (i - r * A4) * 4, b = r0 + r;
      float* gr = sg + r * 4 * Au;
      if (r >= nv) {
        *reinterpret_cast<float4*>(gr + j) = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      float4 x[4], bb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q] = *reinterpret_cast<const float4*>(gr + q * Au + j);
        bb[q] = *reinterpret_cast<const float4*>(sbias + q * Au + j);
      }
      const float4 cv = *reinterpret_cast<const float4*>(sc + r * Au + j);
      float cc[4] = {cv.x, cv.y, cv.z, cv.w}, h[4];
      lstm4(x, bb, cc, h);
      *reinterpret_cast<float4*>(a.c + (size_t)b * a.A + rank * Au + j) =
          make_float4(cc[0], cc[1], cc[2], cc[3]);
      *reinterpret_cast<float4*>(gr + j) = make_float4(h[0], h[1], h[2], h[3]);
      const uint2 hb = pack4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint2*>(a.abuf + (size_t)b * LA + a.P + a.M + rank * Au + j) = hb;
      *reinterpret_cast<uint2*>(a.dbuf + (size_t)b * LD + rank * Au + j) = hb;
    }
  }
  __syncthreads();
  T2_MARK(0, 4);

  // the query's partial sums over this CTA's units, each to the CTA owning
  // those attention units
  mbar_wait(bars + 8 * AB_W, 0);
  T2_MARK(0, 5);
  // once the gate sums and weights are in, the rest streams in behind them
  // (the copies share the SM's path from memory): the processed memory, the
  // memory columns
  if (tid == 128) {
    mbar_expect_tx(bars + 8 * AB_PM, nv * Aa * N * 2);
    for (int r = 0; r < nv; ++r)
      bulk_g2s(spm + (size_t)r * Aa * N, a.pm + ((size_t)(r0 + r) * AT + rank * Aa) * N,
               Aa * N * 2, bars + 8 * AB_PM);
    for (int j = 0; j < nbuf; ++j) {
      mbar_expect_tx(bars + 8 * (AB_MEM0 + j), R * a.chunk * Mc * 2);
      tma3d(smem_m + (size_t)j * R * a.chunk * Mc, &a.mmap, rank * Mc, j * a.chunk, r0,
            bars + 8 * (AB_MEM0 + j));
    }
  }
  cluster_wait();   // every CTA's barriers are made
  mv_tiles<4, 8>(swq, AT + 8, Au, AT / 8, sg, 4 * Au, R, [&](int r, int o, float s) {
    const int d = o / Aa;
    st_async_f32(remote(smem_addr(sqrecv + (rank * R + r) * Aa + o - d * Aa), d), s,
                 remote(bars + 8 * AB_Q, d));
  });
  T2_MARK(0, 6);
  T2_MARK(0, 7);

  // the location term of this CTA's attention units over the rows' positions
  // below their lengths: a thread per channel of [w, Σw], four positions and
  // eight units (the window in registers); the channels' sums meet between
  // neighbouring lanes, each lane takes two positions' energies, the a-groups
  // meet across the lanes above
  mbar_wait(bars + 8 * AB_WC, 0);
  {
    int groups = 0;   // the rows' groups of four positions below their lengths
    for (int r = 0; r < nv; ++r) groups += (slen[r] + 3) / 4;
    const int AG = Aa / 8, per = 2 * AG, items = groups * per;
    for (int it0 = 0; it0 < items; it0 += THREADS) {
      const int it = it0 + tid;
      const bool on = it < items;
      const int sub = it % per, ch = sub & 1, ag = sub >> 1;
      int r = 0, gi = on ? it / per : 0;
      while (r + 1 < nv && gi >= (slen[r] + 3) / 4) gi -= (slen[r++] + 3) / 4;
      const int n0 = 4 * gi;
      float acc[4][8];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;
      if (on) {
        // the taps that reach the row's positions (past its length w and Σw
        // are zero, as the masked softmax and the reset leave them)
        const int k_lo = max(0, pad - n0 - 3), k_hi = min(K, pad + slen[r] - n0);
        const float* xp = swc + (r * 2 + ch) * WCW + n0;
        const float* up = su + ch * K * Aa + ag * 8;
        float x0 = xp[k_lo], x1 = xp[k_lo + 1], x2 = xp[k_lo + 2];
#pragma unroll 4
        for (int k = k_lo; k < k_hi; ++k) {
          const float x3 = xp[k + 3];
          const float4 ua = *reinterpret_cast<const float4*>(up + k * Aa);
          const float4 ub = *reinterpret_cast<const float4*>(up + k * Aa + 4);
          const float u8[8] = {ua.x, ua.y, ua.z, ua.w, ub.x, ub.y, ub.z, ub.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[0][j] += u8[j] * x0;
            acc[1][j] += u8[j] * x1;
            acc[2][j] += u8[j] * x2;
            acc[3][j] += u8[j] * x3;
          }
          x0 = x1, x1 = x2, x2 = x3;
        }
      }
      float lt[2][8];   // the location term of this lane's two positions
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float both = acc[p][j] + __shfl_xor_sync(0xffffffffu, acc[p][j], 1);
          if (p / 2 == 0) {
            if (ch == 0) lt[p % 2][j] = both;
          } else if (ch == 1) {
            lt[p % 2][j] = both;
          }
        }
      if (it0 == 0) {   // the query: its partials summed in rank order, once
        if (tid == 0) T2_MARK(0, 8);
        block_wait_cluster(bars + 8 * AB_Q, 0);
        for (int i = tid; i < R * Aa; i += THREADS) {
          const int qr = i / Aa, qa = i - qr * Aa;
          float q = 0.f;
#pragma unroll
          for (int s = 0; s < C_MAX; ++s)
            if (s < C) q += sqrecv[(s * R + qr) * Aa + qa];
          sq[i] = q;
        }
        mbar_wait(bars + 8 * AB_PM, 0);
        __syncthreads();
        if (tid == 0) T2_MARK(0, 9);
      }
      float e2[2] = {0.f, 0.f};
      if (on) {
        float q8[8];
        {
          const float4 qa = *reinterpret_cast<const float4*>(sq + r * Aa + ag * 8);
          const float4 qb = *reinterpret_cast<const float4*>(sq + r * Aa + ag * 8 + 4);
          q8[0] = qa.x, q8[1] = qa.y, q8[2] = qa.z, q8[3] = qa.w;
          q8[4] = qb.x, q8[5] = qb.y, q8[6] = qb.z, q8[7] = qb.w;
        }
        const bf16* pmr = spm + ((size_t)r * Aa + ag * 8) * N;
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const int n = n0 + 2 * ch + pp;
          if (n < N) {
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              s += sv[ag * 8 + j] * tanhf(q8[j] + lt[pp][j] + __bfloat162float(pmr[j * N + n]));
            e2[pp] = s;
          }
        }
      }
      for (int h = 2; h < per; h <<= 1)
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) e2[pp] += __shfl_xor_sync(0xffffffffu, e2[pp], h);
      if (on && ag == 0)
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const int n = n0 + 2 * ch + pp;
          if (n < N) sesend[r * N4 + n] = e2[pp];
        }
    }
  }
  fence_proxy_async();
  __syncthreads();
  send_all(sesend, serecv + rank * R * N4, R * N4 * 4, bars + 8 * AB_E, C);
  T2_MARK(0, 10);

  // The softmax over the row's length, then the row's context over this CTA's
  // memory columns, a warp a row in every CTA of the cluster (the CTA of rank
  // r % C stores the row's weights): the context's lanes take 8 columns each
  // and a share of the positions, chunk by chunk. A warp needs no other
  // warp's results, so only a streamed memory's next chunk waits for the block.
  block_wait_cluster(bars + 8 * AB_E, 0);
  T2_MARK(0, 11);
  cluster_arrive();   // every byte sent to this CTA has arrived
  for (int r = warp; r < nv; r += WARPS) {
    const int b = r0 + r, len = slen[r];
    float* wr = swts + r * N4;
    float m = -INFINITY;
    for (int n = lane; n < len; n += 32) {
      float e = 0.f;
#pragma unroll
      for (int s = 0; s < C_MAX; ++s)
        if (s < C) e += serecv[(s * R + r) * N4 + n];
      wr[n] = e;
      m = fmaxf(m, e);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int n = lane; n < len; n += 32) {
      const float e = expf(wr[n] - m);
      wr[n] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    const bool store = r % C == rank;
    for (int n = lane; n < N; n += 32) {
      const float wn = n < len ? wr[n] * inv : 0.f;
      wr[n] = wn;
      if (store) {
        a.w[(size_t)b * N + n] = wn;
        a.cum[(size_t)b * N + n] = swc[(r * 2 + 1) * WCW + pad + n] + wn;
        a.att_out[((size_t)b * N + n) * a.T + a.t] = wn;
      }
    }
  }
  __syncwarp();
  T2_MARK(0, 12);
  {
    // lanes: S to a group of 8 columns (the largest power of two with CG·S ≤ 32)
    const int CG = Mc / 8;
    int S = 1;
    while (CG * S * 2 <= 32) S *= 2;
    const int s = lane % S, lanes = 32 / S;
    for (int j = 0; j < nchunks; ++j) {
      const int buf = j % nbuf, nlo = j * a.chunk;
      mbar_wait(bars + 8 * (AB_MEM0 + buf), (j / nbuf) & 1);
      if (j == 0) T2_MARK(0, 15);
      for (int r = warp; r < nv; r += WARPS) {
        const int cnt = min(max(slen[r] - nlo, 0), a.chunk);
        const uint4* mr =
            reinterpret_cast<const uint4*>(smem_m + (size_t)(buf * R + r) * a.chunk * Mc);
        const float* wr = swts + r * N4 + nlo;
        for (int cg0 = 0; cg0 < CG; cg0 += lanes) {
          const int cg = cg0 + lane / S;
          float acc[8] = {};
          if (cg < CG)
            for (int n = s; n < cnt; n += S) {
              float m8[8];
              unpack8(mr[n * CG + cg], m8);
              const float wn = wr[n];
#pragma unroll
              for (int k = 0; k < 8; ++k) acc[k] += wn * m8[k];
            }
          for (int h = 1; h < S; h <<= 1)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], h);
          if (cg < CG && s == 0)
#pragma unroll
            for (int k = 0; k < 8; ++k) sctx[r * Mc + cg * 8 + k] += acc[k];
        }
      }
      if (j + nbuf < nchunks) {   // the buffer's next chunk, once every warp is done with it
        fence_proxy_async();
        __syncthreads();
        if (tid == 128) {
          mbar_expect_tx(bars + 8 * (AB_MEM0 + buf), R * a.chunk * Mc * 2);
          tma3d(smem_m + (size_t)buf * R * a.chunk * Mc, &a.mmap, rank * Mc, (j + nbuf) * a.chunk,
                r0, bars + 8 * (AB_MEM0 + buf));
        }
      }
    }
    __syncwarp();
    T2_MARK(0, 16);
    for (int r = warp; r < nv; r += WARPS)
      for (int cg = lane; cg < CG; cg += 32) {
        float v8[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v8[k] = sctx[r * Mc + cg * 8 + k];
        const uint4 o = pack8(v8);
        const size_t b = r0 + r;
        *reinterpret_cast<uint4*>(a.abuf + b * LA + a.P + rank * Mc + cg * 8) = o;
        *reinterpret_cast<uint4*>(a.dbuf + b * LD + a.A + a.D + rank * Mc + cg * 8) = o;
      }
  }
  T2_MARK(0, 13);
  cluster_wait();   // no CTA leaves while a copy from it may still be in flight
  T2_MARK(0, 14);
  T2_SPAN(0, 1);
}

// ---------------------------------------------------------------------------
// t2_dec_step_kernel
// ---------------------------------------------------------------------------

struct DecArgs {
  CUtensorMap gmap;      // (B, 4, D) f32 the decoder cell's gate products, boxes (R, 4, D/C)
  CUtensorMap cmap;      // (B, D) f32 its cell state, boxes (R, D/C)
  CUtensorMap xmap;      // (B, A + D + M) bf16 dbuf, boxes (R, M/C) of the context
  const float* bias;     // (4D)
  float* c;              // (B, D)
  bf16* dbuf;            // (B, A + D + M)
  bf16* abuf;            // (B, P + M + A)
  const bf16* wp;        // (C, D/C + M/C, OS) the projection and gate, transposed, by CTA
  const float* bp;       // (OS) their biases, zero padded
  const bf16* w1;        // (C, NM, P/C + 8) the prenet's first layer, transposed, by CTA
  const bf16* w2;        // (C, P, P/C + 8) its second
  const int* seeds;      // (B)
  float* mel;            // (B, T, NM)
  float* gate;           // (B, T)
  int B, T, t, A, P, M, D, NM, R, C;
  uint32_t thresh;
  float scale;
};

// barriers of t2_dec_step_kernel: the first takes tid 0's arrival expecting
// copied bytes and every thread's cp.async arrival (the seeds), the others
// one arrival expecting copied bytes
enum { DB_IN, DB_W, DB_P, DB_Y, DB_N };

__global__ void __launch_bounds__(THREADS, 1)
t2_dec_step_kernel(const __grid_constant__ DecArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int C = a.C, R = a.R, NM = a.NM;
  const int Du = a.D / C, Mc = a.M / C, Pu = a.P / C, OS = round8(NM + 1), KP = Du + Mc;
  const DecLayout L = dec_layout(R, C, a.D, a.M, a.P, NM);
  const int rank = blockIdx.x % C, r0 = (blockIdx.x / C) * R, nv = min(R, a.B - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int LA = a.P + a.M + a.A, LD = a.A + a.D + a.M;
  float* sg = reinterpret_cast<float*>(smem + L.g);
  const float* sbias = reinterpret_cast<const float*>(smem + L.bias);
  const float* sc = reinterpret_cast<const float*>(smem + L.c);
  const bf16* sctx = reinterpret_cast<const bf16*>(smem + L.ctx);
  float* sx = reinterpret_cast<float*>(smem + L.x);
  const bf16* swp = reinterpret_cast<const bf16*>(smem + L.wp);
  const float* sbp = reinterpret_cast<const float*>(smem + L.bp);
  float* spsend = reinterpret_cast<float*>(smem + L.psend);
  const float* sprecv = reinterpret_cast<const float*>(smem + L.precv);
  float* sframe = reinterpret_cast<float*>(smem + L.frame);
  const bf16* sw1 = reinterpret_cast<const bf16*>(smem + L.w1);
  const bf16* sw2 = reinterpret_cast<const bf16*>(smem + L.w2);
  float* sysend = reinterpret_cast<float*>(smem + L.ysend);
  float* sx2 = reinterpret_cast<float*>(smem + L.x2);
  int* sseed = reinterpret_cast<int*>(smem + L.seed);
  const uint32_t bars = smem_addr(smem + L.bars);

  T2_MARK(1, 0);
  T2_SPAN(1, 0);
  // every byte this CTA reads from device memory, in flight at once, each
  // group of copies issued by a thread of its own warp (arriving on its
  // barrier expecting the bytes): the rows' gate sums, cell state and context
  // columns of its units, the biases; the weight slices; and by threads r < R
  // the seeds
  if (tid == 0) {
    const int counts[DB_N] = {THREADS + 4, 1, 1, 1};
    make_barriers(bars, counts, DB_N);
    mbar_expect_tx(bars + 8 * DB_P, C * R * OS * 4);
    mbar_expect_tx(bars + 8 * DB_Y, C * R * Pu * 4);
  } else if (tid == 32) {
    prefetch_map(&a.gmap);
  } else if (tid == 64) {
    prefetch_map(&a.cmap);
  } else if (tid == 96) {
    prefetch_map(&a.xmap);
  }
  __syncthreads();
  cluster_arrive();   // this CTA's barriers are made (waited for before the first send)
  T2_MARK(1, 1);
  if (tid == 32) {   // the gate sums first, then the weights
    mbar_expect_tx(bars + 8 * DB_IN, 16 * R * Du);
    tma3d(sg, &a.gmap, rank * Du, 0, r0, bars + 8 * DB_IN);
    mbar_expect_tx(bars + 8 * DB_W,
                   2 * KP * OS + 4 * OS + 2 * NM * (Pu + 8) + 2 * a.P * (Pu + 8));
    bulk_g2s(smem + L.wp, a.wp + (size_t)rank * KP * OS, KP * OS * 2, bars + 8 * DB_W);
    bulk_g2s(smem + L.bp, a.bp, OS * 4, bars + 8 * DB_W);
    bulk_g2s(smem + L.w1, a.w1 + (size_t)rank * NM * (Pu + 8), NM * (Pu + 8) * 2, bars + 8 * DB_W);
    bulk_g2s(smem + L.w2, a.w2 + (size_t)rank * a.P * (Pu + 8), a.P * (Pu + 8) * 2,
             bars + 8 * DB_W);
  } else if (tid == 64) {
    mbar_expect_tx(bars + 8 * DB_IN, 4 * R * Du);
    tma2d(smem + L.c, &a.cmap, rank * Du, r0, bars + 8 * DB_IN);
  } else if (tid == 96) {
    mbar_expect_tx(bars + 8 * DB_IN, 2 * R * Mc);
    tma2d(smem + L.ctx, &a.xmap, a.A + a.D + rank * Mc, r0, bars + 8 * DB_IN);
  } else if (tid == 128) {
    mbar_expect_tx(bars + 8 * DB_IN, 16 * Du);
    for (int q = 0; q < 4; ++q)
      bulk_g2s(smem + L.bias + q * Du * 4, a.bias + q * a.D + rank * Du, Du * 4,
               bars + 8 * DB_IN);
  }
  for (int r = tid; r < R; r += THREADS) cp4z(sseed + r, a.seeds + r0 + min(r, nv - 1), r < nv);
  cp_arrive(bars + 8 * DB_IN);
  T2_MARK(1, 2);

  // the cell's update for this CTA's units → x's first Du columns; the context
  // columns after them (zero past B)
  mbar_wait(bars + 8 * DB_IN, 0);
  T2_MARK(1, 3);
  {
    const int D4 = Du / 4;
    for (int i = tid; i < R * D4; i += THREADS) {
      const int r = i / D4, j = (i - r * D4) * 4, b = r0 + r;
      float* xr = sx + r * KP;
      if (r >= nv) {
        *reinterpret_cast<float4*>(xr + j) = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      const float* gr = sg + r * 4 * Du;
      float4 x[4], bb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q] = *reinterpret_cast<const float4*>(gr + q * Du + j);
        bb[q] = *reinterpret_cast<const float4*>(sbias + q * Du + j);
      }
      const float4 cv = *reinterpret_cast<const float4*>(sc + r * Du + j);
      float cc[4] = {cv.x, cv.y, cv.z, cv.w}, h[4];
      lstm4(x, bb, cc, h);
      *reinterpret_cast<float4*>(a.c + (size_t)b * a.D + rank * Du + j) =
          make_float4(cc[0], cc[1], cc[2], cc[3]);
      *reinterpret_cast<float4*>(xr + j) = make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint2*>(a.dbuf + (size_t)b * LD + a.A + rank * Du + j) =
          pack4(h[0], h[1], h[2], h[3]);
    }
    for (int i = tid; i < R * Mc; i += THREADS) {
      const int r = i / Mc, m = i - r * Mc;
      sx[r * KP + Du + m] = r < nv ? __bfloat162float(sctx[r * Mc + m]) : 0.f;
    }
  }
  __syncthreads();
  T2_MARK(1, 4);

  // the projection and gate's partial sums over this CTA's inputs, to every CTA
  mbar_wait(bars + 8 * DB_W, 0);
  T2_MARK(1, 5);
  mv_tiles<4, 8>(swp, OS, KP, OS / 8, sx, KP, R,
                 [&](int r, int o, float s) { spsend[r * OS + o] = s; });
  T2_MARK(1, 6);
  fence_proxy_async();
  __syncthreads();
  cluster_wait();   // every CTA's barriers are made
  send_all(spsend, sprecv + rank * R * OS, R * OS * 4, bars + 8 * DB_P, C);
  T2_MARK(1, 7);

  // the frame and its stop logit, summed in rank order in every CTA; the CTA
  // of rank r % C stores the row's
  block_wait_cluster(bars + 8 * DB_P, 0);
  T2_MARK(1, 8);
  for (int r = warp; r < R; r += WARPS)
    for (int o = lane; o < OS; o += 32) {
      float f = 0.f;
#pragma unroll
      for (int s = 0; s < C_MAX; ++s)
        if (s < C) f += sprecv[(s * R + r) * OS + o];
      f += sbp[o];
      sframe[r * OS + o] = f;
      if (r < nv && r % C == rank && o <= NM) {
        const int b = r0 + r;
        if (o < NM)
          a.mel[((size_t)b * a.T + a.t) * NM + o] = f;
        else
          a.gate[(size_t)b * a.T + a.t] = f;
      }
    }
  __syncthreads();
  T2_MARK(1, 9);

  // the next step's prenet, this CTA's units: ReLU, then the inference
  // dropout's hashed mask; the first layer's units to every CTA
  mv_tiles<4, 32>(sw1, Pu + 8, NM, Pu / 8, sframe, OS, R, [&](int r, int o, float s) {
    const bool keep = r < nv && (mask_hash(a.t + 1, rank * Pu + o, (uint32_t)sseed[r], 0) &
                                 0xFFFFFFu) >= a.thresh;
    sysend[r * Pu + o] = keep ? fmaxf(s, 0.f) * a.scale : 0.f;
  });
  __syncthreads();
  {   // into every CTA's x2 at this CTA's columns, 16 bytes a store
    const int per = R * Pu / 4;
    for (int i = tid; i < C * per; i += THREADS) {
      const int d = i / per, rq = i - d * per, r = rq / (Pu / 4), q = rq - r * (Pu / 4);
      st_async_v4(remote(smem_addr(sx2 + r * a.P + rank * Pu + 4 * q), d),
                  *reinterpret_cast<const float4*>(sysend + r * Pu + 4 * q),
                  remote(bars + 8 * DB_Y, d));
    }
  }
  T2_MARK(1, 10);

  block_wait_cluster(bars + 8 * DB_Y, 0);
  T2_MARK(1, 11);
  cluster_arrive();   // every byte sent to this CTA has arrived
  T2_MARK(1, 12);
  mv_tiles<4, 32>(sw2, Pu + 8, a.P, Pu / 8, sx2, a.P, R, [&](int r, int o, float s) {
    if (r >= nv) return;
    const int u = rank * Pu + o;
    const bool keep = (mask_hash(a.t + 1, u, (uint32_t)sseed[r], 1) & 0xFFFFFFu) >= a.thresh;
    a.abuf[(size_t)(r0 + r) * LA + u] = __float2bfloat16(keep ? fmaxf(s, 0.f) * a.scale : 0.f);
  });
  T2_MARK(1, 13);
  cluster_wait();   // no CTA leaves while a copy from it may still be in flight
  T2_MARK(1, 14);
  T2_SPAN(1, 1);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool att_set = false, dec_set = false;

template <typename Kern>
cudaError_t prepare(Kern kern, bool& set) {
  if (set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e == cudaSuccess) set = true;
  return e;
}

// a launch of `blocks` blocks in clusters of C
void fill_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int C, int blocks,
                 size_t smem, cudaStream_t s) {
  cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

bool cluster_ok(int C) { return C == 1 || C == 2 || C == 4 || C == 8; }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tensor map over `base` (rank dims, innermost first; the byte strides of
// dims 1..; the box), zeros past its edges; false where the encoder is
// missing or refuses the shape (box dims at most 256, the innermost a
// multiple of 16 bytes)
bool tensor_map(CUtensorMap* m, CUtensorMapDataType type, cuuint32_t rank, const void* base,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      (void)cudaGetLastError();
      return false;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(m, type, rank, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the (B, 4, H) gate sums and (B, H) cell state of a cell of H units, boxes of
// R rows × H/C units
bool cell_maps(CUtensorMap* gmap, CUtensorMap* cmap, const void* g, const void* c, int B, int H,
               int R, int C) {
  const cuuint64_t gd[3] = {(cuuint64_t)H, 4, (cuuint64_t)B};
  const cuuint64_t gs[2] = {(cuuint64_t)H * 4, (cuuint64_t)H * 16};
  const cuuint32_t gb[3] = {(cuuint32_t)(H / C), 4, (cuuint32_t)R};
  const cuuint64_t cd[2] = {(cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t cs[1] = {(cuuint64_t)H * 4};
  const cuuint32_t cb[2] = {(cuuint32_t)(H / C), (cuuint32_t)R};
  return tensor_map(gmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, g, gd, gs, gb) &&
         tensor_map(cmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, c, cd, cs, cb);
}

}  // namespace

extern "C" {

// The plan's shared memory, as the kernels lay it out (ops/t2_kernel.py checks its own)
int spoofsv_t2_att_smem(int R, int C, int N, int chunk, int A, int AT, int M, int K) {
  const int nbuf = (N + chunk - 1) / chunk > 1 ? 2 : 1;
  return att_layout(R, C, N, chunk, nbuf, A, AT, M, K).total;
}

int spoofsv_t2_dec_smem(int R, int C, int D, int M, int P, int NM) {
  return dec_layout(R, C, D, M, P, NM).total;
}

// Clusters of C one-CTA-an-SM blocks of a kernel (0 attention, 1 decoder)
// that the card holds at once; a negative CUDA error on failure
int spoofsv_t2_resident_clusters(int kernel, int C) {
  cudaError_t e = kernel == 0 ? prepare(t2_att_step_kernel, att_set)
                              : prepare(t2_dec_step_kernel, dec_set);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fill_config(cfg, attr, C, C * 64, SMEM_MAX, 0);
  int n = 0;
  e = kernel == 0 ? cudaOccupancyMaxActiveClusters(&n, t2_att_step_kernel, &cfg)
                  : cudaOccupancyMaxActiveClusters(&n, t2_dec_step_kernel, &cfg);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();
    return -(int)e;
  }
  return n;
}

int spoofsv_t2_att_step(void* g, void* bias, void* c, void* abuf, void* dbuf, void* wq, void* u,
                        void* v, void* pm, void* mem, void* lengths, void* w, void* cum,
                        void* att_out, int B, int N, int T, int t, int A, int P, int M, int D,
                        int AT, int K, int R, int C, int chunk, int smem, void* stream) {
  if (!cluster_ok(C) || R < 1 || R > 256 || B < 1 || N < 1 || chunk < 1 || chunk > N ||
      chunk > 256 || A % (4 * C) || A / C > 256 || M % (8 * C) || M / C > 256 || AT % (8 * C) ||
      K < 1 || K % 2 == 0)
    return (int)cudaErrorInvalidValue;
  if (smem != spoofsv_t2_att_smem(R, C, N, chunk, A, AT, M, K) || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = prepare(t2_att_step_kernel, att_set);
  if (e != cudaSuccess) return (int)e;
  AttArgs a{{}, {}, {}, (const float*)bias, (float*)c, (bf16*)abuf, (bf16*)dbuf,
            (const bf16*)wq, (const float*)u, (const float*)v, (const bf16*)pm,
            (const int*)lengths, (float*)w, (float*)cum, (float*)att_out,
            B, N, T, t, A, P, M, D, AT, K, R, C, chunk};
  const cuuint64_t md[3] = {(cuuint64_t)M, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t ms[2] = {(cuuint64_t)M * 2, (cuuint64_t)N * M * 2};
  const cuuint32_t mb[3] = {(cuuint32_t)(M / C), (cuuint32_t)chunk, (cuuint32_t)R};
  if (!cell_maps(&a.gmap, &a.cmap, g, c, B, A, R, C) ||
      !tensor_map(&a.mmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, mem, md, ms, mb))
    return (int)cudaErrorNotSupported;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fill_config(cfg, attr, C, C * ((B + R - 1) / R), smem, (cudaStream_t)stream);
  cudaLaunchKernelEx(&cfg, t2_att_step_kernel, a);
  return (int)cudaGetLastError();
}

int spoofsv_t2_dec_step(void* g, void* bias, void* c, void* dbuf, void* abuf, void* wp, void* bp,
                        void* w1, void* w2, void* seeds, void* mel, void* gate, int B, int T,
                        int t, int A, int P, int M, int D, int NM, int thresh, int R, int C,
                        int smem, float scale, void* stream) {
  if (!cluster_ok(C) || R < 1 || R > 256 || B < 1 || D % (4 * C) || D / C > 256 ||
      M % (8 * C) || M / C > 256 || P % (8 * C) || NM < 1)
    return (int)cudaErrorInvalidValue;
  if (smem != spoofsv_t2_dec_smem(R, C, D, M, P, NM) || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = prepare(t2_dec_step_kernel, dec_set);
  if (e != cudaSuccess) return (int)e;
  DecArgs a{{}, {}, {}, (const float*)bias, (float*)c, (bf16*)dbuf, (bf16*)abuf,
            (const bf16*)wp, (const float*)bp, (const bf16*)w1, (const bf16*)w2,
            (const int*)seeds, (float*)mel, (float*)gate, B, T, t, A, P, M, D, NM, R, C,
            (uint32_t)thresh, scale};
  const int LD = A + D + M;
  const cuuint64_t xd[2] = {(cuuint64_t)LD, (cuuint64_t)B};
  const cuuint64_t xs[1] = {(cuuint64_t)LD * 2};
  const cuuint32_t xb[2] = {(cuuint32_t)(M / C), (cuuint32_t)R};
  if (!cell_maps(&a.gmap, &a.cmap, g, c, B, D, R, C) ||
      !tensor_map(&a.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dbuf, xd, xs, xb))
    return (int)cudaErrorNotSupported;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fill_config(cfg, attr, C, C * ((B + R - 1) / R), smem, (cudaStream_t)stream);
  cudaLaunchKernelEx(&cfg, t2_dec_step_kernel, a);
  return (int)cudaGetLastError();
}

const char* spoofsv_t2_rollout_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

#ifdef SPOOFSV_T2_PROBE
// the phase clocks and spans of the last launches (2 × 48 int64) into host memory
int spoofsv_t2_probe_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_t2_probe, sizeof(g_t2_probe));
}
#endif

}  // extern "C"
