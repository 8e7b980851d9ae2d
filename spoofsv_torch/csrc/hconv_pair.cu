// K4 and K5: one highway block (K4) or two consecutive ones (K5) in one
// launch, for sm_90a, in f32 or bf16 storage: one kernel template on the
// number of layers. Replaces spoofsv_tpu/ops/pallas_conv.py::_hconv_kernel
// (LAYERS = 1) and ::_hconv_pair_kernel (LAYERS = 2).
//
// Per frame t of x (B, T, C), each block computes
//   [h1, h2] = conv(x)[t] + bias            (K taps at dilation d, 2C wide)
//   y[t]     = s(LN1(h1))·LN2(h2) + (1 − s(LN1(h1)))·x[t],  s = sigmoid
// with both LayerNorms in f32 and the two-pass variance mean((v − μ)²); the
// pair is block B applied to block A's output y1, which is rounded through
// the storage type and zeroed outside [0, T) (conv B's zero padding).
//
// What bounds it. The conv is a (rows, K·C) × (K·C, 2C) product: 131 GFLOP
// for SSRN hc3→hc4 at B=16, T=1300, C=512, far above what the CUDA cores
// give (the first port ran it as f32 FMAs). The LayerNorm needs whole 2C-wide
// rows, and 64 rows of f32 h at C=512 are 256 KB, the whole register file of
// an SM. The weight (6.3 MB per layer in f32 at C=512, K=3) streams from L2
// once per tile, so the tile must be tall; and layer B reads d_b·(K−1) rows
// of y1 beyond its own, which layer A must recompute per tile. With the design
// below, hc3→hc4 streams 5.5 GB of tiles from L2 (f32: 40 KB per CTA per
// chunk) and runs 3xTF32's 425 GFLOP on the tensor cores; on an H100 both
// are near their limits (about 4 TB/s and 65 % of the TF32 peak).
//
// What this design does about it.
// - Tensor cores: wgmma m64nN from two warpgroups (64 rows each), N = 2·CH:
//   all of the CTA's columns in one instruction a k-step (in n64 blocks the
//   f32 kernels took 13-15 % longer), the weight from shared memory. bf16
//   storage: bf16 products (exact in f32) with f32 accumulation, the operand
//   from shared memory too. f32 storage: 3xTF32, each operand
//   a = a_hi + a_lo, both TF32,
//   h ≈ a_lo·w_hi + a_hi·w_lo + a_hi·w_hi in f32, which holds f32 accuracy
//   (one TF32 pass keeps ~3 digits). The weight comes split into hi/lo from
//   the wrapper (wgmma reads it from shared memory as it lies); the
//   activation is split in registers and feeds wgmma from there.
// - A cluster of n = C/CH CTAs (CH = min(C, 128)) spans one 2C-wide row:
//   CTA r owns channels [r·CH, (r+1)·CH) of h1 and the same of h2, i.e.
//   2·CH output columns of the weight, held as a (128 rows × 2·CH) f32
//   accumulator in registers (128 floats a thread at CH = 128). The
//   LayerNorm row sums (mean, then the two-pass variance) go to every CTA of
//   the cluster through distributed shared memory, one cluster barrier each.
// - Tall tiles: layer A runs over 128 rows of y1 and layer B over
//   rows_out = 128 − d_b·(K−1) output frames (its row count rounded up to a
//   warpgroup's 64), so the weight fetched from L2 serves 128 frames, and
//   layer A's recompute is the halo alone: 1.016× the useful rows for
//   hc3→hc4.
// - Operands by TMA: one thread asks for each reduction chunk (16 f32 / 32
//   bf16 of K·C, 64 bytes a row) of the 128 operand rows and of the CTA's
//   weight rows, into a 5-stage (f32) or 8-stage (bf16) ring with an
//   mbarrier per stage; the copies land in the 64-byte swizzle that wgmma
//   reads, and rows outside the sequence (or past the y1 tile) come back as
//   zeros: the conv's zero padding. The consumers never compute an address
//   or issue a copy, and keep one chunk of products in flight while the next
//   is set up. (Issued by every thread with cp.async, the same feed took
//   twice as long.)
// - The epilogue's operands (bias, LayerNorm parameters, residual rows) are
//   copied into the idle ring while the row sums cross the cluster, so no
//   thread waits on a global load there.
// - y1 goes to an L2-resident scratch tile (B, tiles, 128, C) in the storage
//   type: each CTA writes its channels, a cluster barrier publishes them, and
//   layer B's operand chunks are fetched from it by the same TMA ring. (A
//   CTA's shared memory holds 128 rows of its own channels only; layer B
//   needs all C channels of y1, and shared memory offers no asynchronous pull
//   from another CTA.)

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // two warpgroups, 64 rows each
constexpr int ROWS = 128;         // y1 rows of a tile (layer A's rows)
constexpr int A_BYTES = ROWS * 64;  // operand rows of a chunk: 64 bytes each
constexpr int MAX_CLUSTER = 8;

typedef __nv_bfloat16 bf16;

// f32: 16 reduction rows per chunk, 3xTF32 (weight hi and lo);
// bf16: 32 reduction rows per chunk, one bf16 product.
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int BK = 16, STAGES = 5, WMATS = 2;
};
template <>
struct Cfg<bf16> {
  static constexpr int BK = 32, STAGES = 8, WMATS = 1;
};

// Dynamic shared memory of one CTA: slack to align the ring to 1024 bytes,
// the operand ring (per stage the 128 operand rows, then the weight's 2·ch
// rows, 64 bytes each, the weight hi and lo for f32; the epilogue reuses
// it), the cluster's row-sum exchange (mean and variance) and the stages'
// mbarriers.
template <typename T>
__host__ __device__ constexpr size_t stage_bytes(int ch) {
  return (size_t)A_BYTES + (size_t)Cfg<T>::WMATS * 2 * ch * 64;
}
template <typename T>
__host__ __device__ constexpr size_t tile_smem(int ch, int n) {
  return 1024 + Cfg<T>::STAGES * stage_bytes<T>(ch) + 4 * 2 * (size_t)n * ROWS * 2 +
         8 * Cfg<T>::STAGES;
}

// Plain loads: cuda_bf16.hpp's __ldcg is an asm statement without a memory
// clobber, which the compiler may hoist above the cluster barrier that
// publishes y1 (it did, and layer B read y1 before layer A had written it).
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global → shared, zero-filled when !valid (src must still be a
// mapped address).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// order this thread's generic-proxy accesses (plain and cp.async loads and
// stores, shared and global) before later async-proxy ones (TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
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

// TMA: the box of `map` at the given coordinates (innermost first) into
// shared memory at `dst`, completing transaction bytes on `bar`.
__device__ __forceinline__ void tma2(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0,
                                     int c1) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma3(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0,
                                     int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}
__device__ __forceinline__ void tma4(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0,
                                     int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
               "r"(c3)
               : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// (a, b) into the shared memory of cluster CTA `rank` at the address that
// `local` has in this CTA.
__device__ __forceinline__ void st_cluster2(uint32_t local, int rank, float a, float b) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(remote), "f"(a), "f"(b)
               : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// wgmma's shared-memory matrix descriptor, K-major with the 64-byte swizzle
// that TMA writes: rows of 64 bytes, 8-row groups 512 bytes apart (stride
// byte offset); the start address steps 32 bytes per k-step within a row.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

// Byte offset of `off` (within a tile of 64-byte rows, 512-byte aligned)
// under that swizzle: its 16-byte chunk index XOR address bits 7-8.
__device__ __forceinline__ uint32_t sw64(uint32_t off) { return off ^ (((off >> 7) & 3) << 4); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma operand lists: the n accumulator registers "+f"(d[0..n)) and their
// "{%0, ..., %(n−1)}"
#define SPOOFSV_D8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define SPOOFSV_D32(i) SPOOFSV_D8(i), SPOOFSV_D8(i + 8), SPOOFSV_D8(i + 16), SPOOFSV_D8(i + 24)

#define SPOOFSV_R32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19," \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define SPOOFSV_R64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19," \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37," \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55," \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

#define SPOOFSV_R128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19," \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37," \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55," \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73," \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91," \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107," \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122," \
  "%123, %124, %125, %126, %127}"

// d (64 rows × N columns of the warpgroup, f32: N / 2 floats a thread, n8
// block J's 4 at 4J) += a · b in one wgmma, N = 2·CH (64, 128 or 256). tf32:
// a the thread's 4 words of the warpgroup's (64, 8) TF32 operand (the m16n8k8
// A layout per warp), b the (N columns, 8) weight slice behind `desc`. bf16:
// the operand too from shared memory (no split).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc);
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SPOOFSV_R32
               ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : SPOOFSV_D32(0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SPOOFSV_R32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : SPOOFSV_D32(0)
               : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " SPOOFSV_R64
               ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
               : SPOOFSV_D32(0), SPOOFSV_D32(32)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SPOOFSV_R64
               ", %64, %65, p, 1, 1, 0, 0;\n}\n"
               : SPOOFSV_D32(0), SPOOFSV_D32(32)
               : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<256>(float (&d)[128], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 " SPOOFSV_R128
               ", {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
               : SPOOFSV_D32(0), SPOOFSV_D32(32), SPOOFSV_D32(64), SPOOFSV_D32(96)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SPOOFSV_R128
               ", %128, %129, p, 1, 1, 0, 0;\n}\n"
               : SPOOFSV_D32(0), SPOOFSV_D32(32), SPOOFSV_D32(64), SPOOFSV_D32(96)
               : "l"(desc_a), "l"(desc_b), "r"(1));
}

// ---------------------------------------------------------------------------
// Grid (n, tiles, B), cluster (n, 1, 1): CTA `rank` = blockIdx.x of tile
// blockIdx.y of utterance blockIdx.z. y1 row j ∈ [0, 128) is frame
// t0 − pb_left + j, t0 = tile·rows_out; layer A's tap k for it reads x at
// that frame − pa_left + k·dil_a; layer B's output row r ∈ [0, rows_out),
// frame t0 + r, tap k reads y1 row r + k·dil_b. With LAYERS = 1, layer A's
// rows are the output (pb_left = 0, rows_out = 128) and the layer-B
// arguments are unused.
//
// Weights: (n, 2·CH, K·C) per layer, CTA r's slice row j < CH the h1 column
// r·CH + j, row CH + j the h2 column C + r·CH + j, reduction index k·C + i
// contiguous (f32: hi and lo TF32 parts). bias (2C) and ln (4, C) f32.
//
// Warpgroup wg computes rows 64·wg + [0, 64) over all 2·CH = 64·NT columns
// in one wgmma of width 2·CH per k-step (and TF32 pass); warp wq of it holds
// rows 16·wq + g and 16·wq + g + 8 (lane (g, t) = (lane / 4, lane % 4)) and
// columns 8·J + 2t, 8·J + 2t + 1 of every n8 block J: acc[4·J + 2·h + e] is
// row g + 8h, column 8J + 2t + e. h1 is n8 blocks [0, 4·NT), h2 the next
// 4·NT, so the gate pairs h1 and h2 in registers.
// ---------------------------------------------------------------------------
template <typename T, int NT, int LAYERS>
__global__ void __launch_bounds__(THREADS, 1)
hconv_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_y1,
             const __grid_constant__ CUtensorMap tm_wa_hi,
             const __grid_constant__ CUtensorMap tm_wa_lo,
             const __grid_constant__ CUtensorMap tm_wb_hi,
             const __grid_constant__ CUtensorMap tm_wb_lo, const T* __restrict__ x,
             const float* __restrict__ bias_a, const float* __restrict__ ln_a,
             const float* __restrict__ bias_b, const float* __restrict__ ln_b,
             T* __restrict__ y1, T* __restrict__ out, int T_, int C, int K, int dil_a,
             int dil_b, int pa_left, int pb_left, int rows_out, int rows_b, float eps) {
  constexpr int CH = 32 * NT, NC = 2 * CH, HB = 4 * NT;  // HB: n8 blocks of h1
  constexpr int BK = Cfg<T>::BK, STAGES = Cfg<T>::STAGES, WMATS = Cfg<T>::WMATS;
  constexpr bool SPLIT = WMATS == 2;
  constexpr int STAGE = (int)stage_bytes<T>(CH), WBYTES = NC * 64;
  constexpr int SEG = 16 / sizeof(T);  // elements per 16-byte copy
  static_assert(6 * CH * 4 + ROWS * (CH + 8) * sizeof(T) <= STAGES * stage_bytes<T>(CH),
                "the epilogue's operands fit the ring");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring 1024-byte aligned (the swizzle's pattern follows address bits)
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* xch = reinterpret_cast<float*>(smem + STAGES * STAGE);  // [2][n][ROWS][2]
  const uint32_t ring_s = smem_addr(smem);
  const uint32_t bars_s = smem_addr(xch + 2 * gridDim.x * ROWS * 2);  // [STAGES] mbarriers

  const int n = gridDim.x, rank = blockIdx.x, tile = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int chunks = K * C / BK, per_tap = C / BK;
  const int t0 = tile * rows_out;
  const T* xb = x + (size_t)b * T_ * C;
  T* y1t = LAYERS == 2 ? y1 + ((size_t)b * gridDim.y + tile) * ROWS * C : nullptr;
  const int rl0 = 64 * wg + 16 * wq + g;  // this thread's rows: rl0 and rl0 + 8

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars_s + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA of the cluster runs before any remote store; barriers ready

#pragma unroll 1
  for (int layer = 0; layer < LAYERS; ++layer) {
    // layer B's second warpgroup idles when its rows hold no output frame
    const bool active = layer == 0 || 64 * wg < rows_b;
    const int g0 = layer * chunks;  // chunks of earlier layers: stage and phase run on

    // thread 0: chunk q (tap k, channels c0..c0 + BK) into its stage. Operand
    // row r is x frame t0 − pb_left − pa_left + k·dil_a + r (layer A) or y1
    // row k·dil_b + r of this tile (layer B); the weight's rows are this
    // CTA's 2·CH columns.
    auto issue = [&](int q) {
      const int k = q / per_tap, c0 = (q - k * per_tap) * BK, gq = g0 + q;
      const uint32_t s = ring_s + (gq % STAGES) * STAGE, bar = bars_s + 8 * (gq % STAGES);
      mbar_expect_tx(bar, STAGE);
      if (layer == 0) {
        tma3(s, tm_x, bar, c0, t0 - pb_left - pa_left + k * dil_a, b);
        tma2(s + A_BYTES, tm_wa_hi, bar, q * BK, rank * NC);
        if constexpr (SPLIT) tma2(s + A_BYTES + WBYTES, tm_wa_lo, bar, q * BK, rank * NC);
      } else {
        tma4(s, tm_y1, bar, c0, k * dil_b, tile, b);
        tma2(s + A_BYTES, tm_wb_hi, bar, q * BK, rank * NC);
        if constexpr (SPLIT) tma2(s + A_BYTES + WBYTES, tm_wb_lo, bar, q * BK, rank * NC);
      }
    };

    float acc[NC / 2];
#pragma unroll
    for (int e = 0; e < NC / 2; ++e) acc[e] = 0.f;

    // ---- the conv: chunks of the K·C reduction through the TMA ring.
    // Chunk q's products stay in flight while chunk q + 1 is set up, so a
    // stage is refilled two chunks after its use (STAGES − 2 chunks ahead),
    // and the f32 operand fragments alternate between two register sets.
    if (threadIdx.x == 0)
      for (int q = 0; q < STAGES - 2 && q < chunks; ++q) issue(q);
    auto conv_chunk = [&](int q, uint32_t (&ah)[2][4], uint32_t (&al)[2][4]) {
      wgmma_wait<1>();
      // f32 reads chunk q − 2's operand rows with plain loads; the copy that
      // refills their stage is an async-proxy write
      if constexpr (SPLIT) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // every warpgroup is done with chunk q − 2
      if (threadIdx.x == 0 && q + STAGES - 2 < chunks) issue(q + STAGES - 2);
      if (!active) return;
      const int gq = g0 + q;
      mbar_wait(bars_s + 8 * (gq % STAGES), (gq / STAGES) & 1);  // chunk q landed
      const uint32_t a_s = ring_s + (gq % STAGES) * STAGE, w_s = a_s + A_BYTES;
      if constexpr (SPLIT) {
        // the warp's operand words of the two k-steps (the m16n8k8 A layout:
        // rows g, g + 8 × words t, t + 4), split into TF32 hi and lo
        const unsigned char* a_p = smem + (gq % STAGES) * STAGE;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rl0 + 8 * (e & 1), w = 8 * ks + 4 * (e >> 1) + t;
            const float f = *reinterpret_cast<const float*>(a_p + sw64(r * 64 + 4 * w));
            ah[ks][e] = to_tf32(f);
            al[ks][e] = to_tf32(f - __uint_as_float(ah[ks][e]));
          }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        // all 2·CH weight rows (64 bytes each) at once; the warpgroup's
        // operand rows 64·wg.. (4096 bytes on); k-step ks 32 bytes into each row
        const uint32_t w = w_s + ks * 32;
        if constexpr (SPLIT) {
          wgmma_tf32<NC>(acc, al[ks], wgmma_desc(w));
          wgmma_tf32<NC>(acc, ah[ks], wgmma_desc(w + WBYTES));
          wgmma_tf32<NC>(acc, ah[ks], wgmma_desc(w));
        } else {
          wgmma_bf16<NC>(acc, wgmma_desc(a_s + wg * 4096 + ks * 32), wgmma_desc(w));
        }
      }
      wgmma_commit();
    };
    uint32_t ah0[2][4], al0[2][4], ah1[2][4], al1[2][4];  // f32 only
    int q = 0;
    for (; q + 1 < chunks; q += 2) {
      conv_chunk(q, ah0, al0);
      conv_chunk(q + 1, ah1, al1);
    }
    if (q < chunks) conv_chunk(q, ah0, al0);
    wgmma_wait<0>();

    // ---- epilogue: bias, the two LayerNorms over whole rows, gate, residual.
    // Its operands come through the idle ring, copied while the row sums
    // cross the cluster: prm ([6][CH] f32: b1, b2, s1, o1, s2, o2 of this
    // CTA's channels) and the residual rows (res, [128][CH + 8] of T: x at
    // y1 row r's frame for layer A, y1 row r + pb_left for layer B).
    const float* bias = layer == 0 ? bias_a : bias_b;
    const float* ln = layer == 0 ? ln_a : ln_b;
    float* prm = reinterpret_cast<float*>(smem);
    T* res = reinterpret_cast<T*>(smem + 6 * CH * 4);
    constexpr int RSTRIDE = CH + 8;                 // elements: rows stagger across banks
    constexpr int RSEG = CH * (int)sizeof(T) / 16;  // 16-byte segments of a residual row
    __syncthreads();  // every warpgroup is done with the ring
    for (int i = threadIdx.x; i < 6 * CH / 4; i += THREADS) {
      const int v = i / (CH / 4), c4 = (i % (CH / 4)) * 4;
      cp16(smem_addr(prm + v * CH + c4), (v < 2 ? bias + v * C : ln + (v - 2) * C) + rank * CH + c4,
           true);
    }
    cp_commit();
    for (int i = threadIdx.x; i < ROWS * RSEG; i += THREADS) {
      const int r = i / RSEG, sg = i % RSEG;
      const int f = layer == 0 ? t0 - pb_left + r : r + pb_left;
      const bool ok = layer == 0 ? f >= 0 && f < T_ : f < ROWS;
      const T* g = (layer == 0 ? xb : y1t) + (size_t)f * C + rank * CH + sg * SEG;
      cp16(smem_addr(res + r * RSTRIDE) + 16 * sg, ok ? g : xb, ok);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // prm landed

    const int cl0 = 2 * t;  // + 8·J: this lane's channel pair (of the CTA's CH) in n8 block J
    auto h1 = [&](int J, int h, int e) -> float& { return acc[4 * J + 2 * h + e]; };
    auto h2 = [&](int J, int h, int e) -> float& { return acc[4 * (J + HB) + 2 * h + e]; };
    auto prm2 = [&](int v, int cl) { return *reinterpret_cast<const float2*>(prm + v * CH + cl); };

    // row sums over the whole 2C row, for mean (pass 0) or variance (pass 1):
    // lanes of a quad, then the cluster's CTAs
    float st[2][2];  // [row g / g + 8][h1 / h2]
    auto row_sums = [&](int pass) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          st[h][u] += __shfl_xor_sync(0xffffffffu, st[h][u], 1);
          st[h][u] += __shfl_xor_sync(0xffffffffu, st[h][u], 2);
        }
        if (t == 0) {
          const uint32_t dst = smem_addr(xch + ((size_t)(pass * n + rank) * ROWS + rl0 + 8 * h) * 2);
          for (int q = 0; q < n; ++q) st_cluster2(dst, q, st[h][0], st[h][1]);
        }
      }
      cluster_sync();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = 0.f, v1 = 0.f;
        for (int q = 0; q < n; ++q) {
          const float2 v = *reinterpret_cast<const float2*>(
              xch + ((size_t)(pass * n + q) * ROWS + rl0 + 8 * h) * 2);
          v0 += v.x, v1 += v.y;
        }
        st[h][0] = v0, st[h][1] = v1;
      }
    };

#pragma unroll
    for (int h = 0; h < 2; ++h) st[h][0] = st[h][1] = 0.f;
#pragma unroll
    for (int J = 0; J < HB; ++J) {
      const float2 b1 = prm2(0, cl0 + 8 * J), b2 = prm2(1, cl0 + 8 * J);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        h1(J, h, 0) += b1.x;
        h1(J, h, 1) += b1.y;
        h2(J, h, 0) += b2.x;
        h2(J, h, 1) += b2.y;
        st[h][0] += h1(J, h, 0) + h1(J, h, 1);
        st[h][1] += h2(J, h, 0) + h2(J, h, 1);
      }
    }
    row_sums(0);
    const float inv_c = 1.f / C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mu1 = st[h][0] * inv_c, mu2 = st[h][1] * inv_c;
      st[h][0] = st[h][1] = 0.f;
#pragma unroll
      for (int J = 0; J < HB; ++J)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v1 = h1(J, h, e) -= mu1;
          const float v2 = h2(J, h, e) -= mu2;
          st[h][0] += v1 * v1;
          st[h][1] += v2 * v2;
        }
    }
    row_sums(1);
    cp_wait<0>();
    __syncthreads();  // the residual rows landed

    float r1[2], r2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      r1[h] = rsqrtf(st[h][0] * inv_c + eps);
      r2[h] = rsqrtf(st[h][1] * inv_c + eps);
    }
#pragma unroll
    for (int J = 0; J < HB; ++J) {
      const int cl = cl0 + 8 * J, c = rank * CH + cl;
      const float2 s1 = prm2(2, cl), o1 = prm2(3, cl), s2 = prm2(4, cl), o2 = prm2(5, cl);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rl0 + 8 * h;
        const float ga = sigmoid(h1(J, h, 0) * r1[h] * s1.x + o1.x);
        const float gb = sigmoid(h1(J, h, 1) * r1[h] * s1.y + o1.y);
        const float na = h2(J, h, 0) * r2[h] * s2.x + o2.x;
        const float nb = h2(J, h, 1) * r2[h] * s2.y + o2.y;
        const float2 x2 = load2(res + r * RSTRIDE + cl);
        if (layer + 1 < LAYERS) {
          // y1 row r, frame t0 − pb_left + r; zeros outside the sequence
          const int f = t0 - pb_left + r;
          const bool in = f >= 0 && f < T_;
          store2(y1t + (size_t)r * C + c, in ? ga * na + (1.f - ga) * x2.x : 0.f,
                 in ? gb * nb + (1.f - gb) * x2.y : 0.f);
        } else if (r < rows_out && t0 + r < T_) {
          store2(out + ((size_t)b * T_ + t0 + r) * C + c, ga * na + (1.f - ga) * x2.x,
                 gb * nb + (1.f - gb) * x2.y);
        }
      }
    }
    // y1 complete across the cluster (layer B's operand, read by TMA: the
    // proxy fence orders the plain stores before it, as it orders this
    // layer's plain use of the ring before the next layer's copies). After
    // the last layer no barrier is needed: every store into another CTA's
    // shared memory came before row_sums(1)'s cluster barrier.
    if (layer + 1 < LAYERS) {
      __threadfence();
      fence_proxy_async();
      cluster_sync();
    }
  }
}

// A failed runtime call also sets the last error; clear it so that the next
// launch's cudaGetLastError() does not report this one.
int clear_and_return(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime API
// (the library links no libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
    else cudaGetLastError();
  }
  return fn;
}

// A tensor map of `rank` dims (innermost first; strides in bytes of dims 1..)
// with the 64-byte swizzle, zeros outside the tensor; 0 or a CUDA error.
template <typename T>
int encode(CUtensorMap* m, int rank, const void* base, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(m, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
         rank, const_cast<void*>(base), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int NT, int LAYERS>
int hconv_launch(const void* x, const void* wa_hi, const void* wa_lo, const float* bias_a,
                 const float* ln_a, const void* wb_hi, const void* wb_lo, const float* bias_b,
                 const float* ln_b, void* y1, void* out, int B, int T_, int C, int K, int dil_a,
                 int dil_b, int pa_left, int pb_left, int rows_out, int tiles, float eps,
                 cudaStream_t s) {
  constexpr int CH = 32 * NT;
  constexpr cuuint32_t BK = Cfg<T>::BK;
  const int n = C / CH;
  // one layer: the tile's 128 rows are output frames; two: layer B's rows and
  // their halo must fit the 128 rows of y1. The tiles must cover the sequence
  // (the scratch holds `tiles` tiles per utterance).
  const bool rows_ok = LAYERS == 1 ? rows_out == ROWS && pb_left == 0
                                   : rows_out >= 1 && rows_out + dil_b * (K - 1) <= ROWS;
  if (n > MAX_CLUSTER || !rows_ok || (long long)tiles * rows_out < T_ ||
      (long long)(tiles - 1) * rows_out >= T_)
    return (int)cudaErrorInvalidValue;
  const int rows_b = rows_out > 64 ? ROWS : 64;
  // TMA boxes: BK channels × 128 rows of x (C, T, B) and of the y1 scratch
  // (C, 128, tiles, B); BK × 2·CH of each weight (K·C, n·2·CH). One layer
  // has no scratch and no layer-B weight: their maps repeat x's and A's.
  const cuuint64_t es = sizeof(T), uC = C, uT = T_, uK = K;
  const cuuint64_t dx[3] = {uC, uT, (cuuint64_t)B}, sx[2] = {uC * es, uT * uC * es};
  const cuuint64_t dy[4] = {uC, ROWS, (cuuint64_t)tiles, (cuuint64_t)B},
                   sy[3] = {uC * es, ROWS * uC * es, tiles * ROWS * uC * es};
  const cuuint64_t dw[2] = {uK * uC, (cuuint64_t)n * 2 * CH}, sw[1] = {uK * uC * es};
  const cuuint32_t bx[3] = {BK, ROWS, 1}, by[4] = {BK, ROWS, 1, 1}, bw[2] = {BK, 2 * CH};
  CUtensorMap mx, my, mw[4];
  const void* ws[4] = {wa_hi, wa_lo, wb_hi, wb_lo};
  int err = encode<T>(&mx, 3, x, dx, sx, bx);
  for (int i = 0; i < 2 * LAYERS && !err; ++i) err = encode<T>(&mw[i], 2, ws[i], dw, sw, bw);
  if constexpr (LAYERS == 2) {
    if (!err) err = encode<T>(&my, 4, y1, dy, sy, by);
  } else {
    my = mx, mw[2] = mw[0], mw[3] = mw[1];
  }
  if (err) return err;
  const size_t smem = tile_smem<T>(CH, n);
  auto kernel = hconv_kernel<T, NT, LAYERS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return clear_and_return(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, tiles, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, mx, my, mw[0], mw[1], mw[2], mw[3], (const T*)x, bias_a,
                         ln_a, bias_b, ln_b, (T*)y1, (T*)out, T_, C, K, dil_a, dil_b, pa_left,
                         pb_left, rows_out, rows_b, eps);
  if (e != cudaSuccess) return clear_and_return(e);
  return (int)cudaGetLastError();
}

// The instantiation for dtype (0 f32, 1 bf16) and C (a power of two in
// [32, 1024]: 32 or 64 channels a CTA below 128, else 128).
template <int LAYERS>
int dispatch(int dtype, const void* x, const void* wa_hi, const void* wa_lo, const float* bias_a,
             const float* ln_a, const void* wb_hi, const void* wb_lo, const float* bias_b,
             const float* ln_b, void* y1, void* out, int B, int T_, int C, int K, int dil_a,
             int dil_b, int pa_left, int pb_left, int rows_out, int tiles, float eps,
             void* stream) {
  if (dtype < 0 || dtype > 1 || C < 32 || C > 1024 || (C & (C - 1)) || K < 1 || dil_a < 1 ||
      dil_b < 1 || B < 0 || T_ < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T_ == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define SPOOFSV_HCONV(T, NT_)                                                                  \
  return hconv_launch<T, NT_, LAYERS>(x, wa_hi, wa_lo, bias_a, ln_a, wb_hi, wb_lo, bias_b, ln_b, \
                                      y1, out, B, T_, C, K, dil_a, dil_b, pa_left, pb_left,      \
                                      rows_out, tiles, eps, s)
  if (dtype == 0) {
    if (C == 32) SPOOFSV_HCONV(float, 1);
    if (C == 64) SPOOFSV_HCONV(float, 2);
    SPOOFSV_HCONV(float, 4);
  }
  if (C == 32) SPOOFSV_HCONV(bf16, 1);
  if (C == 64) SPOOFSV_HCONV(bf16, 2);
  SPOOFSV_HCONV(bf16, 4);
#undef SPOOFSV_HCONV
}

}  // namespace

extern "C" {

// K4. x and out (B, T, C); w_hi, w_lo (n, 2·CH, K·C) in x's type (w_lo
// unused for bf16); bias (2C) and ln (4, C) f32; tiles = ceil(T / 128).
// C a power of two in [32, 1024].
int spoofsv_hconv_launch(int dtype, const void* x, const void* w_hi, const void* w_lo,
                         const float* bias, const float* ln, void* out, int B, int T, int C,
                         int K, int dil, int pad_left, int tiles, float eps, void* stream) {
  return dispatch<1>(dtype, x, w_hi, w_lo, bias, ln, w_hi, w_lo, bias, ln, nullptr, out, B, T, C,
                     K, dil, 1, pad_left, 0, ROWS, tiles, eps, stream);
}

// K5. x and out (B, T, C); w*_hi, w*_lo (n, 2·CH, K·C) in x's type (w*_lo
// unused for bf16); bias (2C) and ln (4, C) f32; y1 the scratch
// (B, tiles, 128, C) in x's type. C a power of two in [32, 1024].
int spoofsv_hconv_pair_launch(int dtype, const void* x, const void* wa_hi, const void* wa_lo,
                              const float* bias_a, const float* ln_a, const void* wb_hi,
                              const void* wb_lo, const float* bias_b, const float* ln_b, void* y1,
                              void* out, int B, int T, int C, int K, int dil_a, int dil_b,
                              int pa_left, int pb_left, int rows_out, int tiles, float eps,
                              void* stream) {
  return dispatch<2>(dtype, x, wa_hi, wa_lo, bias_a, ln_a, wb_hi, wb_lo, bias_b, ln_b, y1, out, B,
                     T, C, K, dil_a, dil_b, pa_left, pb_left, rows_out, tiles, eps, stream);
}

// Dynamic shared memory of one K4 or K5 CTA, in bytes: both run the same
// tile and ring (the wrapper's tile plan states the same).
int spoofsv_hconv_smem(int dtype, int C) {
  const int ch = C < 128 ? C : 128;
  return (int)(dtype == 0 ? tile_smem<float>(ch, C / ch) : tile_smem<bf16>(ch, C / ch));
}

const char* spoofsv_hconv_pair_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
