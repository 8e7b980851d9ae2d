// K1: the whole autoregressive Text2Mel decode in one launch, for sm_90a,
// in bf16 or f32 (one template on the operand type E). Replaces
// spoofsv_tpu/ops/pallas_decode.py::_decode_kernel (:144, pallas_call at
// :329).
//
// Per frame t: the audio-encoder front (enc_w1 + s1, LN, relu; sq_w[0], LN,
// relu; sq_w[1] + s2, LN), 10 encoder highway steps with ring caches at slot
// t mod 2d, monotonic attention over K in the window [pma, pma+2] and
// r = A·V, dec_w1 on [r | q], LN, 6 decoder highway steps, 3× dense-LN-relu,
// the 80-bin tail, LN5 and sigmoid. Matmul operands in E, f32 accumulation,
// f32 LayerNorm with the fast variance E[x²] − mean², the in-loop f32 pma.
// The arithmetic is spoofsv_torch.ops.decode_kernel.decode_plain's; the
// decomposition below is decode_cluster_emulate's (tf32x3=True for f32).
//
// What bounds it. A frame is ~27 dependent layers; each needs all of its
// weights (13.6 MB a frame in bf16, 27.2 in f32) and a LayerNorm over whole
// 2C-wide rows. The first port ran one block per batch row on CUDA-core
// FMAs, each block streaming all weights from L2 every frame: 64 blocks ×
// 27.2 MB a frame at B=64 in f32, the card's L2 stream limit. The work
// itself is 282 GFLOP at B=64 (0.29 ms of bf16 tensor-core time, 1.71 ms as
// 3xTF32), but 325 frames × ~27 layers are in series, so what a design can
// reach is set by each layer's synchronisation latency.
//
// What this design does about it.
// - A cluster of n CTAs (16, 8, 4 or 2) serves a tile of 16 to 64 batch
//   rows; decode_cluster_plan chooses them by a rule timed on the card.
//   CTA `rank` owns CH = C/n channels of every C-wide activation: the same
//   columns of h1 and h2 in a highway step, C/n columns of the other
//   products, fpad/n columns of the tail. So a cluster reads each layer's
//   weights once a frame for all its rows, and each CTA only its 1/n share.
// - Products on the tensor cores with mma.sync. bf16: m16n8k16 (bf16 →
//   f32), A fragments by ldmatrix. f32: 3xTF32 on m16n8k8, hi·hi + hi·lo +
//   lo·hi with hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x − hi), each
//   operand split in registers as its fragment is loaded (the weights stay
//   f32 in the stream, 27.2 MB a frame that stays resident in the 50 MB L2;
//   a host-side hi/lo stream would be twice that and come from DRAM). The
//   tf32 A layout is not ldmatrix's: within 16 columns of a k row the k
//   order is permuted alike in A and in the packed weights, so a lane loads
//   four A operands (two k8 steps) with one 16-byte shared load from rows at
//   a stride of 16 mod 32 words (conflict-free), and the three passes go
//   pass by pass over the steps, so no product waits on the one before it.
//   The operand rows (E, [x(t−2d) |
//   x(t−d) | x] for a highway step) are in shared memory; the weights arrive
//   in B-fragment order (the host packs each CTA's column slice of every
//   layer, in execution order, into one stream), so a lane loads a 32-deep k
//   row of an n8 block with one 16-byte load (bf16) or two (f32).
// - The weight stream runs ahead: a producer warp (one lane) feeds a ring of
//   mbarrier stages (16 KB each, 8 where shared memory allows) with 1-D
//   cp.async.bulk copies of whole 32-deep k rows, taking each stage back
//   when every consumer warp has arrived on its "empty" barrier (each warp
//   fences its plain reads of the stage against the copy's async proxy
//   first). It never
//   waits on activations, so the next layers' weights arrive while this
//   layer's LayerNorm exchange runs, and it wraps from frame t's tail to
//   frame t+1's first layer.
// - Each layer's bias and LayerNorm vectors for the CTA's columns sit in a
//   shared-memory table, loaded once. The shapes of the plans that
//   decode_cluster_plan chooses at C = 256 are template parameters (pick());
//   other shapes are read at run time. The product is
//   compiled once for each kind of layer (enc_w1, sq_w, highway, dec_w1,
//   tail), so with the shapes fixed a chunk's k rows unroll and the index
//   math folds.
// - LayerNorm across the cluster: each CTA sends its per-row partial (Σh,
//   Σh²) into every CTA's shared memory with st.async, which completes on
//   the receiver's mbarrier (release/acquire at cluster scope); every CTA
//   sums the n partials in rank order, so all hold the same statistics. The
//   new x is all-gathered the same way (16-byte pieces) into every CTA's
//   operand rows (E). Two exchanges a layer, no cluster barrier: a CTA
//   waits only for the bytes it needs.
// - Attention: each CTA's partial q·K dot products over its channels go out
//   with the all-gather of the last encoder step; every CTA sums them in
//   rank order and computes the softmax, pma and r = A·V for its tile's
//   rows (3 dot products of C a row, no extra exchange). Rank 0 writes A and
//   pma.
// - The 16 causal-conv caches are rings in global memory (slot t mod 2d).
//   Each CTA writes its own channels of x(t) with plain
//   stores once the layer's partials have arrived (every CTA has read its
//   taps by then) and reads the full-width taps of later frames with
//   cp.async.cg (L2, not the incoherent L1), issued while the previous
//   layer's partials travel. The exchanges' barriers order the two.
//
// Built with -DSPOOFSV_K1_PROBE (spoofsv_torch/ops/k1_probe.py, a developer
// tool; never on the product path), the library also holds instantiations
// that fill a per-phase clock profile, more compiled plans for the plan
// sweep, and a query of how many clusters of a plan the card holds at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // the consumer warps: products, LayerNorm, exchanges
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK = THREADS + 32;  // and one producer warp feeding the weight ring
constexpr int N_HW = 16;
constexpr int N_LAYERS = 24;
constexpr int RING_SLOTS = 256;
constexpr float LN_EPS = 1e-5f;
// phases of the probe build's profile (k1_probe.PHASES): waiting for
// weight chunks, the rest of the products, row partials and their stores,
// waiting for the partials, LayerNorm and the slice's stores, score
// partials, waiting for the slices and taps, attention and r, the products'
// epilogue and CTA barrier, a product's set-up, issuing the next highway's
// tap copies
constexpr int kPhases = 11;
constexpr int CHUNK = 16384;  // bytes of weight stream a ring stage holds

typedef __nv_bfloat16 bf16;

// decode-path highway layers in execution order: enc.hci1, enc.hci2,
// enc.hc1, enc.hc2, dec.hci, dec.hc1, dec.hc2; each ring's first slot
__constant__ int c_dil[N_HW] = {1, 3, 9, 27, 1, 3, 9, 27, 3, 3, 1, 3, 9, 27, 1, 1};
__constant__ int c_slot0[N_HW] = {0, 2, 8, 26, 80, 82, 88, 106, 160, 166, 172, 174, 180, 198, 252, 254};

// E: the operand type (bf16 or float) of K, V, s1, s2, the weight stream,
// the rings and the outputs
template <typename E>
struct Args {
  const E *K, *V, *s1, *s2;
  const E* stream;  // (n, cta_elems): each CTA's weight stream
  const float *hw_b, *hw_ln, *sq_b, *misc_ln, *enc_b1, *dec_b1, *tail_b5, *ln5_s, *ln5_b;
  E* rings;
  E* y_out;
  E* a_out;
  int* pma_out;
  long long* prof;  // probe build: kPhases clock sums of CTA (0, 0)'s warp 0
  int Bp, T, N, F, fpad, C, condition, n, rows, stages;
  long long cta_elems;
};

// Layer l of a frame: reduction depth K and n8 column blocks of this CTA.
// 0 enc_w1, 1-2 sq_w[0..1], 3-12 highways 0-9, 13 dec_w1, 14-19 highways
// 10-15, 20-22 sq_w[2..4], 23 the tail.
__host__ __device__ inline void layer_shape(int l, int C, int fpad, int n, int& K, int& ncol) {
  const int nb = C / n / 8;
  if (l == 0) K = fpad, ncol = nb;
  else if (l == 13) K = 2 * C, ncol = nb;
  else if (l == 23) K = C, ncol = fpad / n / 8;
  else if ((l >= 3 && l <= 12) || (l >= 14 && l <= 19)) K = 3 * C, ncol = 2 * nb;
  else K = C, ncol = nb;
}
// k rows of 32 per stream chunk; a k row of an n8 block is 256·esize bytes
__host__ __device__ inline int rows_per_chunk(int chunk, int ncol, int esize) {
  const int r = chunk / (ncol * 256 * esize);
  return r > 0 ? r : 1;
}
// (k splits S, n8 blocks per warp nbw) of a product of depth K: WARPS /
// (rows / 16) warps share an m tile. bf16: over columns first, then over k.
// f32: over k first, up to the k rows a chunk holds and the layer's own
// (never fewer splits than the columns leave), so that fewer warps split
// the same A fragment into TF32.
__host__ __device__ inline void warp_split(int rows, int ncol, int K, int esize, int& S,
                                           int& nbw) {
  const int wpm = WARPS / (rows / 16);
  S = ncol < wpm ? wpm / ncol : 1;
  if (esize == 4) {
    const int rpc = rows_per_chunk(CHUNK, ncol, esize);
    int most = wpm < rpc ? wpm : rpc;
    while (most > K / 32) most >>= 1;  // powers of two: K/32 may be 3·2^k
    S = most > S ? most : S;
  }
  nbw = ncol * S / wpm;
}

// Elements between consecutive operand rows of width w: bf16 rows padded
// by 16 bytes, so that ldmatrix's eight rows fall in different banks; f32
// rows at a stride of 16 mod 32 words, so that the 16-byte A loads of lanes
// (g, t) and (g + 1, t) fall in different halves of the banks.
__host__ __device__ inline int row_stride(int w, int esize) {
  return esize == 2 ? w + 8 : w + ((16 - w) & 31);
}

// Dynamic shared memory of one CTA with operands of esize bytes; the plan in
// ops/decode_kernel.py states the same (ClusterPlan.smem_bytes).
__host__ __device__ inline size_t cluster_smem(int C, int fpad, int n, int rows, int chunk,
                                               int stages, int esize) {
  const int ldt = row_stride(2 * C, esize), sx = row_stride(C / n, esize);
  const int sy = row_stride(fpad / n, esize), ss = sx > sy ? sx : sy;
  size_t hbuf = 0;
  for (int l = 0; l < N_LAYERS; ++l) {
    int K, ncol, S, nbw;
    layer_shape(l, C, fpad, n, K, ncol);
    warp_split(rows, ncol, K, esize, S, nbw);
    const size_t h = (size_t)S * rows * ncol * 8;
    hbuf = h > hbuf ? h : hbuf;
  }
  size_t prm = 0;  // per layer its bias and LayerNorm vectors: 3 floats a column
  for (int l = 0; l < N_LAYERS; ++l) {
    int K, ncol;
    layer_shape(l, C, fpad, n, K, ncol);
    prm += 3 * ncol * 8;
  }
  return 128 + (size_t)stages * chunk + (size_t)rows * (ldt + (size_t)n * ss) * esize +
         (size_t)rows * (C / n) * 4 + hbuf * 4 + prm * 4 + 2 * (size_t)n * rows * 16 +
         (size_t)rows * 16 + (size_t)rows * 8 + 2 * N_HW * 4 + (size_t)(2 * stages + 2) * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// bf16 outputs: the fast exponential and division; f32 outputs: the
// accurate ones (eager torch's)
template <typename E>
__device__ __forceinline__ float sigmoid(float v) {
  if constexpr (sizeof(E) == 2) return __fdividef(1.f, 1.f + __expf(-v));
  else return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
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
// 1-D bulk copy global → this CTA's shared memory, completing `bytes` on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// mbar_wait, acquiring at cluster scope what st.async's completions released
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile("{\n.reg .pred p;\nWAIT:\n"
               "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
               "@!p bra WAIT;\n}\n" ::"r"(bar),
               "r"(parity)
               : "memory");
}
// 16 bytes global → shared through L2 (.cg: not L1, which other SMs' stores
// do not update)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// not .aligned: loops whose trip count differs by lane may leave a warp
// diverged here
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}
// the consumer warps' CTA barrier (the producer warp does not take part)
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// orders this thread's plain (generic-proxy) shared-memory accesses before
// later async-proxy ones, such as the next cp.async.bulk into the same stage
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t remote(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
// Asynchronous stores into a cluster CTA's shared memory (addresses from
// mapa), each completing its bytes on that CTA's barrier `bar` with release
// semantics at cluster scope: the receiver, having expected the bytes, waits
// on its barrier and needs no further fence.
__device__ __forceinline__ void st_async_v4f(uint32_t addr, float a, float b, float c, float d,
                                             uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
               "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr), "f"(a), "f"(b), "f"(c), "f"(d),
               "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async_f32(uint32_t addr, float a, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "f"(a), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async_v4b(uint32_t addr, uint4 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
               "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z),
               "r"(v.w), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 (f32 operands): D += A·B on m16n8k8, A and B as TF32 (not
// volatile: independent products may be scheduled across each other)
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x → (hi, lo), both TF32: hi rounded to nearest, ties away from zero, lo
// the remainder rounded likewise (decode_kernel.tf32_split on the host)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
// two consecutive operands of type E (4- or 8-byte aligned) as f32, and back
__device__ __forceinline__ float2 load2(const bf16* p) {
  return unpack_bf2(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf2(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store1(bf16* p, float a) { *p = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

// What a layer's product becomes: a LayerNorm over C columns (relu or not),
// a highway step (two LayerNorms, gate, residual), or the tail (LN5 over F,
// sigmoid).
enum Kind { DENSE = 0, HIGHWAY = 1, TAIL = 2 };
// What a layer's product reads and how wide it is: enc_w1 (on y), sq_w (on
// x), a highway step (on [x(t−2d) | x(t−d) | x]), dec_w1 (on [r | q]), the
// tail. A template argument of the product, as PK<kind>.
enum ProductKind { P_ENC = 0, P_SQ = 1, P_HW = 2, P_DEC = 3, P_TAIL = 4 };
template <int V>
struct PK {
  static constexpr int value = V;
};
__device__ __forceinline__ int layer_kind(int l) {
  return l == 23 ? TAIL : ((l >= 3 && l <= 12) || (l >= 14 && l <= 19)) ? HIGHWAY : DENSE;
}
__device__ __forceinline__ bool layer_relu(int l) { return l <= 1 || (l >= 20 && l <= 22); }
__device__ __forceinline__ int layer_hw(int l) { return l <= 12 ? l - 3 : l - 4; }
// Where layer l's vectors start in the parameter table: 3 floats a column of
// every earlier layer (the dense layers 0-2, 13, 20-22 have nb blocks of 8
// columns, the highway steps 2·nb; the tail, layer 23, comes last).
__device__ __forceinline__ int prm_offset(int l, int nb) {
  const int dense = (l < 3 ? l : 3) + (l > 13 ? 1 : 0) + (l > 20 ? l - 20 : 0);
  return 24 * nb * (2 * l - dense);
}

// Layer l's bias and LayerNorm vectors in global memory: bias (its full
// width), ln[v] the v-th LayerNorm vector (scale, bias[, scale 2, bias 2]).
template <typename E>
__device__ void layer_vectors(const Args<E>& a, int l, const float*& bias,
                              const float* (&ln)[4]) {
  const int C = a.C;
  const float* ml = a.misc_ln;
  const float* lnb = nullptr;  // LayerNorm block of (scale, bias[, scale, bias]) of C each
  if (layer_kind(l) == HIGHWAY) {
    const int j = layer_hw(l);
    bias = a.hw_b + (size_t)j * 2 * C, lnb = a.hw_ln + (size_t)j * 4 * C;
  } else if (l == 23) {
    bias = a.tail_b5, ln[0] = a.ln5_s, ln[1] = a.ln5_b, ln[2] = ln[3] = nullptr;
    return;
  } else if (l == 0) {
    bias = a.enc_b1, lnb = ml;
  } else if (l == 13) {
    bias = a.dec_b1, lnb = ml + 6 * C;
  } else {
    const int i = l <= 2 ? l - 1 : l - 18;  // sq_w index
    bias = a.sq_b + (size_t)i * C, lnb = ml + (size_t)2 * (l <= 2 ? l : i + 2) * C;
  }
  for (int v = 0; v < 4; ++v) ln[v] = lnb + (size_t)v * C;
}

// E: the operand type. CT, FPT, NT, RT: C, fpad, the cluster size and the
// rows per tile, fixed at compile time for the default plans so that their
// divisions fold into shifts and constants (0: read from the arguments;
// pick() chooses). PROF: the probe build's instantiation that fills a.prof
// (the others carry no profile code).
template <typename E, int CT, int FPT, int NT, int RT, bool PROF>
__global__ void __launch_bounds__(BLOCK, 1) decode_cluster_kernel(Args<E> a) {
  constexpr bool F32 = sizeof(E) == 4;
  constexpr int PIECE = 16 / sizeof(E);  // elements of 16 bytes
  // accumulator sets of a product: bf16 the two 16-deep halves of a 32-deep
  // k row; f32 its four k8 steps where the shapes are fixed (more
  // independent mma chains), else two (the run-time shapes' registers)
  constexpr int NACC = F32 && CT ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const int C = CT ? CT : a.C, fpad = FPT ? FPT : a.fpad, n = NT ? NT : a.n;
  const int rows = RT ? RT : a.rows, CH = C / n, FT = fpad / n;
  // row strides of the taps buffer and of one CTA's slice of x and of y
  const int ldt = row_stride(2 * C, sizeof(E)), SX = row_stride(CH, sizeof(E));
  const int SY = row_stride(FT, sizeof(E)), SS = SX > SY ? SX : SY;
  // ring stages are a power of two: stage = count & smask, phase = count >> sshift
  const unsigned smask = a.stages - 1, sshift = __ffs(a.stages) - 1;
  const int rank = blockIdx.x, tile = blockIdx.y, b0 = tile * rows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int TPR = THREADS / rows;  // threads per row in the row-statistics pass

  // ---- shared memory (cluster_smem) ----
  // The products' operands: taps [rows][ldt] (x(t−2d) | x(t−d) of a highway
  // step, or r in columns [C, 2C)); xbuf, the gathered x as [n][rows][SX] or
  // the gathered y as [n][rows][SY], CTA q's slice at q (every CTA stores a
  // slice at the same offset, and this CTA writes its own in place). y
  // and x share it: every CTA has finished the tail's product, the last
  // reader of x, before any y slice is written, and the first encoder
  // product, the only reader of y, before any x slice.
  unsigned char* ring = smem;
  E* taps = reinterpret_cast<E*>(ring + (size_t)a.stages * CHUNK);
  E* xbuf = taps + rows * ldt;
  float* xown = reinterpret_cast<float*>(xbuf + n * rows * SS);  // [rows][CH]
  float* hbuf = xown + rows * CH;
  size_t hfl = 0;
  for (int l = 0; l < N_LAYERS; ++l) {
    int K, ncol, S, nbw;
    layer_shape(l, C, fpad, n, K, ncol);
    warp_split(rows, ncol, K, sizeof(E), S, nbw);
    const size_t h = (size_t)S * rows * ncol * 8;
    hfl = h > hfl ? h : hfl;
  }
  const int NB = CH / 8, prm_n = prm_offset(N_LAYERS - 1, NB) + 3 * FT;
  // prm: per layer its columns' bias, then its LayerNorm vectors over this
  // CTA's channels (v-th vector at ncols + v·width)
  float* prm = hbuf + hfl;
  // CTA q's partials at q (this CTA writes its own in place)
  float* xch = prm + prm_n;                // [n][rows][4] LayerNorm partials
  float* sxch = xch + n * rows * 4;        // [n][rows][4] attention-score partials
  float* patt = sxch + n * rows * 4;       // [rows][4] window probabilities
  int* spma = reinterpret_cast<int*>(patt + rows * 4);  // [rows]
  int* wbase = spma + rows;                             // [rows] window start of this frame
  // [N_HW][2] this frame's ring slots: x(t−2d) (also where x(t) goes), x(t−d)
  int* slots = wbase + rows;
  // mbarriers: the ring's stages full, the partials' and the slices'
  // arrival, the ring's stages empty
  const uint32_t bars = smem_addr(slots + 2 * N_HW);
  const uint32_t bar_part = bars + 8 * a.stages, bar_x = bar_part + 8, empties = bar_x + 8;
  const uint32_t ring_s = smem_addr(ring), taps_s = smem_addr(taps);
  const uint32_t xbuf_s = smem_addr(xbuf);
  const unsigned char* my_stream =
      reinterpret_cast<const unsigned char*>(a.stream) + (size_t)rank * a.cta_elems * sizeof(E);

  if (tid < THREADS) {
    for (int i = tid; i < rows * (ldt + n * SS) * (int)sizeof(E) / 4; i += THREADS)
      reinterpret_cast<uint32_t*>(taps)[i] = 0u;   // taps and x (frame 0's y is 0)
    for (int i = tid; i < rows * CH; i += THREADS) xown[i] = 0.f;
    if (tid < rows) spma[tid] = 0;
    for (int l = 0; l < N_LAYERS; ++l) {
      const float* bias;
      const float* ln[4];
      layer_vectors(a, l, bias, ln);
      const int kind = layer_kind(l), w = kind == TAIL ? FT : CH;
      const int ncols = kind == HIGHWAY ? 2 * CH : w;
      const int base = kind == TAIL ? rank * FT : rank * CH, nvec = kind == HIGHWAY ? 4 : 2;
      float* p = prm + prm_offset(l, NB);
      for (int i = tid; i < ncols; i += THREADS)
        p[i] = bias[(i >= w ? C : 0) + base + i % w];
      for (int i = tid; i < nvec * w; i += THREADS) p[ncols + i] = ln[i / w][base + i % w];
    }
  }
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(bars + 8 * s, 1);              // the producer's expect_tx
      mbar_init(empties + 8 * s, WARPS);       // each consumer warp done with it
    }
    mbar_init(bar_part, 1);  // this CTA's expect_tx; the bytes from st.async
    mbar_init(bar_x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA runs before any remote store reaches it; barriers and prm ready

  if (warp == WARPS) {
    // ---- the producer warp: lane 0 walks this CTA's weight stream chunk by
    // chunk, layer by layer, frame by frame, into the ring's stages as the
    // consumers free them. It never waits on activations, so the stream runs
    // a ring ahead of the products, across layers and frames.
    if (lane == 0) {
      long long off = 0;  // bytes into this CTA's stream
      unsigned gi = 0;    // chunks issued
      for (int t = 0; t < a.T; ++t, off = 0)
        for (int l = 0; l < N_LAYERS; ++l) {
          int K, ncol;
          layer_shape(l, C, fpad, n, K, ncol);
          const int KP = K / 32, rpc = rows_per_chunk(CHUNK, ncol, sizeof(E));
          for (int kp = 0; kp < KP; kp += rpc, ++gi) {
            const uint32_t bytes = (uint32_t)min(rpc, KP - kp) * ncol * 256 * sizeof(E);
            const int s = gi & smask;
            if (gi >= (unsigned)a.stages) mbar_wait(empties + 8 * s, ((gi >> sshift) - 1) & 1);
            mbar_expect_tx(bars + 8 * s, bytes);
            bulk_copy(ring_s + s * CHUNK, my_stream + off, bytes, bars + 8 * s);
            off += bytes;
          }
        }
    }
    __syncwarp();
    cluster_sync();  // the consumers' final one
    return;
  }

  unsigned gc = 0;  // chunks consumed (the same count in every consumer thread)
  // the profile is warp 0's (its lanes take the same branches: no divergence)
  const bool profiling = PROF && warp == 0 && rank == 0 && tile == 0;
  // lane p of the profiled warp sums phase p (one register a lane; a run's
  // sum of one phase fits 32 bits)
  unsigned prof_sum = 0, t_mark = clock();
  auto mark = [&](int phase) {  // time since the last mark to `phase`
    if (profiling) {
      const unsigned now = clock();
      prof_sum += lane == phase ? now - t_mark : 0u;
      t_mark = now;
    }
  };

  // ---- the product of layer l, of product kind P: its operand rows (K
  // columns: the taps or r from `taps`, then x from xbuf; y from xbuf for
  // enc_w1) times this CTA's weight slice, plus bias (and speaker
  // projection), into hbuf [S][rows][ncol·8] (f32; split 0 carries the
  // bias). P fixes the shape at compile time, so with the plan's shapes
  // fixed too the k rows of a chunk unroll and the index math folds.
  auto product = [&](auto kind_tag, int l) {
    constexpr int P = decltype(kind_tag)::value;
    constexpr int BB = 256 * sizeof(E);  // bytes of a 32-deep k row of an n8 block
    const int K = P == P_HW ? 3 * C : P == P_DEC ? 2 * C : P == P_ENC ? fpad : C;
    const int ncol = P == P_HW ? 2 * NB : P == P_TAIL ? FT / 8 : NB;
    const int wpm = WARPS / (rows / 16);  // warps an m tile has (powers of two)
    int S, nbw;
    warp_split(rows, ncol, K, sizeof(E), S, nbw);
    const int KP = K / 32, rpc = CHUNK / (ncol * BB), nch = (KP + rpc - 1) / rpc;
    // the m tile's warps: S k splits of cw warps, warp nb0 of a split taking
    // n8 blocks nb0 + cw·i, i < nbw
    const int mt = warp / wpm, wi = warp % wpm, cw = wpm / S;
    const int split = wi / cw, nb0 = wi % cw;
    float acc[NACC][4][4];  // NACC sets, each its share of a k row's depth
#pragma unroll
    for (int u = 0; u < NACC; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][i][e] = 0.f;
    // The operand columns: the taps (or r) first, then x (or y) slices W
    // columns wide
    const int tcols = P == P_HW ? 2 * C : P == P_DEC ? C : 0;
    const int W = P == P_ENC ? FT : CH, SW = P == P_ENC ? SY : SX;
    // bf16: this lane's ldmatrix row address for the k-step at k0: row
    // mt·16 + lane % 16, column k0 + 8·(lane / 16)
    const int ar = mt * 16 + (lane & 15), c8 = 8 * (lane >> 4);
    const uint32_t t_row = taps_s + (uint32_t)((ar * ldt + (P == P_DEC ? C : 0) + c8) * 2);
    auto a_addr = [&](int k0) -> uint32_t {
      if (k0 < tcols) return t_row + k0 * 2;
      const int c = k0 - tcols + c8;
      return xbuf_s + (uint32_t)((((c / W) * rows + ar) * SW + c % W) * 2);
    };
    // f32: this lane's four operands (row mt·16 + g + 8·h, columns k0 + 4·t4
    // to k0 + 4·t4 + 3) of the 16 columns at k0; they lie in one x slice (W
    // is a multiple of 8)
    const int ag = mt * 16 + g;
    auto a_elem = [&](int k0, int h) -> const E* {
      if (k0 < tcols) return taps + (ag + 8 * h) * ldt + (P == P_DEC ? C : 0) + k0 + 4 * t4;
      const int c = k0 - tcols + 4 * t4;
      return xbuf + ((c / W) * rows + ag + 8 * h) * SW + c % W;
    };
    for (int c = 0; c < nch; ++c, ++gc) {
      const int st = gc & smask;
      mark(c == 0 ? 9 : 1);
      mbar_wait(bars + 8 * st, (gc >> sshift) & 1);
      mark(0);
      __syncwarp();  // ldmatrix and mma.sync need the warp converged
      const unsigned char* w = ring + (size_t)st * CHUNK;
      // k rows of this chunk, and of this warp: kp0 + split + S·i, i < nkw
      const int kp0 = c * rpc;
      const int nk = KP <= rpc ? KP : KP % rpc == 0 ? rpc : min(rpc, KP - kp0);
      const int nkw = nk % S == 0 ? nk / S : (nk - split + S - 1) / S;
      const int k_first = kp0 + split;
      // this warp's i-th n8 block of k row kp in the chunk: lane's 16 bytes
      // of its q-th half (f32: two halves)
      auto wfrag = [&](int kp, int i, int q) {
        return *reinterpret_cast<const uint4*>(w + ((kp - kp0) * ncol + nb0 + cw * i) * BB +
                                               q * 512 + lane * 16);
      };
      if constexpr (!F32) {
        // a 32-deep k row's operands: two ldmatrix A fragments (k halves) and
        // the weight fragments of this warp's n8 blocks
        auto load = [&](int kp, uint32_t(&f0)[4], uint32_t(&f1)[4], uint4(&b)[4]) {
          ldmatrix_x4(f0, a_addr(32 * kp));
          ldmatrix_x4(f1, a_addr(32 * kp + 16));
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i < nbw) b[i] = wfrag(kp, i, 0);
        };
        // the k halves into the two accumulator sets: no mma waits on the other
        auto mmas = [&](const uint32_t(&f0)[4], const uint32_t(&f1)[4], const uint4(&b)[4]) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i < nbw) {
              mma16816(acc[0][i], f0, b[i].x, b[i].y);
              mma16816(acc[1][i], f1, b[i].z, b[i].w);
            }
        };
        // two buffers: the next k row's operands load while this one's mmas run
        uint32_t fa0[4], fa1[4], fb0[4], fb1[4];
        uint4 ba[4], bb[4];
        if (nkw > 0) load(k_first, fa0, fa1, ba);
#pragma unroll
        for (int p = 0; p < nkw / 2; ++p) {
          load(k_first + (2 * p + 1) * S, fb0, fb1, bb);
          mmas(fa0, fa1, ba);
          if (2 * p + 2 < nkw) load(k_first + (2 * p + 2) * S, fa0, fa1, ba);
          mmas(fb0, fb1, bb);
        }
        if (nkw & 1) mmas(fa0, fa1, ba);
      } else {
        // 3xTF32 on m16n8k8, by 16 columns of a k row (two k8 steps). Their
        // k order is permuted alike in A and in the packed weights: lane (g,
        // t) holds columns 4t..4t+3 of rows g and g + 8 (one 16-byte load
        // each) and the weights of the same four k rows, which are its k
        // rows t, t + 4 of the first step (columns 4t, 4t + 1) and of the
        // second (4t + 2, 4t + 3). Each operand is split into TF32 hi and lo
        // as it is loaded, and the three passes go pass by pass over both
        // steps and every n8 block: consecutive products never share an
        // accumulator.
#pragma unroll
        for (int p = 0; p < nkw; ++p) {
          const int kp = k_first + p * S;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float4 x0 = *reinterpret_cast<const float4*>(a_elem(32 * kp + 16 * q, 0));
            const float4 x1 = *reinterpret_cast<const float4*>(a_elem(32 * kp + 16 * q, 1));
            uint32_t ah[2][4], al[2][4];  // [step][a0..a3]
            tf32_split(x0.x, ah[0][0], al[0][0]), tf32_split(x1.x, ah[0][1], al[0][1]);
            tf32_split(x0.y, ah[0][2], al[0][2]), tf32_split(x1.y, ah[0][3], al[0][3]);
            tf32_split(x0.z, ah[1][0], al[1][0]), tf32_split(x1.z, ah[1][1], al[1][1]);
            tf32_split(x0.w, ah[1][2], al[1][2]), tf32_split(x1.w, ah[1][3], al[1][3]);
            uint32_t bh[4][4], bl[4][4];  // [n8 block][b0, b1 of step 0, of step 1]
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (i < nbw) {
                const uint4 b = wfrag(kp, i, q);
                tf32_split(__uint_as_float(b.x), bh[i][0], bl[i][0]);
                tf32_split(__uint_as_float(b.y), bh[i][1], bl[i][1]);
                tf32_split(__uint_as_float(b.z), bh[i][2], bl[i][2]);
                tf32_split(__uint_as_float(b.w), bh[i][3], bl[i][3]);
              }
#pragma unroll
            for (int pass = 0; pass < 3; ++pass)
#pragma unroll
              for (int s = 0; s < 2; ++s)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  if (i < nbw) {
                    float(&d)[4] = acc[(2 * q + s) % NACC][i];
                    const uint32_t(&a)[4] = pass == 0 ? al[s] : ah[s];
                    const uint32_t(&bb)[4] = pass == 1 ? bl[i] : bh[i];
                    mma1688(d, a, bb[2 * s], bb[2 * s + 1]);
                  }
          }
        }
      }
      // the next copy into the stage is an async-proxy write: each lane
      // fences its plain reads of the stage before the warp releases it
      // (csrc/gl_tc.cu, without this fence, read stages being overwritten)
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(empties + 8 * st);  // this warp is done with the stage
    }
    mark(1);
    const int ncols = ncol * 8;
    const float* bias = prm + prm_offset(l, NB);
    const E* add = !a.condition ? nullptr : P == P_ENC ? a.s1 : l == 2 ? a.s2 : nullptr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < nbw) {
        const int col = (nb0 + cw * i) * 8 + 2 * t4;
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8) {
          const int r = mt * 16 + g + 8 * h8;
          float v0 = acc[0][i][2 * h8], v1 = acc[0][i][2 * h8 + 1];
#pragma unroll
          for (int u = 1; u < NACC; ++u) v0 += acc[u][i][2 * h8], v1 += acc[u][i][2 * h8 + 1];
          if (split == 0) {
            v0 += bias[col], v1 += bias[col + 1];
            if (add) {
              const float2 s2 = load2(add + (size_t)(b0 + r) * C + rank * CH + col);
              v0 += s2.x, v1 += s2.y;
            }
          }
          *reinterpret_cast<float2*>(hbuf + ((size_t)split * rows + r) * ncols + col) =
              make_float2(v0, v1);
        }
      }
    }
    csync();
    mark(8);
  };

  // ---- the taps of highway j for frame t into `taps`, 16-byte pieces
  auto fetch_taps = [&](int j, int t) {
    const int seg = C / PIECE;  // 16-byte pieces of a C-wide row
    for (int i = tid; i < rows * 2 * seg; i += THREADS) {
      const int r = i / (2 * seg), k = i % (2 * seg), half = k / seg, s = k % seg;
      const int slot = slots[2 * j + half];
      cp16(taps_s + (uint32_t)((r * ldt + half * C + PIECE * s) * sizeof(E)),
           a.rings + ((size_t)slot * a.Bp + b0 + r) * C + PIECE * s);
    }
  };

  // ---- per-row partial (Σh, Σh²) of this CTA's columns (h1 and h2 apart)
  // into this CTA's place in every CTA's xch, completing on its bar_part;
  // the TPR lanes of a row share the stores
  auto row_partials = [&](int l) {
    int K, ncol, S, nbw;
    layer_shape(l, C, fpad, n, K, ncol);
    warp_split(rows, ncol, K, sizeof(E), S, nbw);
    const int kind = layer_kind(l), ncols = ncol * 8, r = tid / TPR, sub = tid % TPR;
    float s1 = 0.f, q1 = 0.f, s2 = 0.f, q2 = 0.f;
    for (int c = sub; c < ncols; c += TPR) {
      float v = hbuf[(size_t)r * ncols + c];
      for (int s = 1; s < S; ++s) v += hbuf[((size_t)s * rows + r) * ncols + c];
      if (S > 1) hbuf[(size_t)r * ncols + c] = v;
      if (kind == TAIL && rank * FT + c >= a.F) continue;
      if (kind == HIGHWAY && c >= CH) s2 += v, q2 += v * v;
      else s1 += v, q1 += v * v;
    }
    for (int o = TPR / 2; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      q1 += __shfl_xor_sync(0xffffffffu, q1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      q2 += __shfl_xor_sync(0xffffffffu, q2, o);
    }
    const uint32_t dst = smem_addr(xch + ((size_t)rank * rows + r) * 4);
    for (int q = sub; q < n; q += TPR)
      st_async_v4f(remote(dst, q), s1, q1, s2, q2, remote(bar_part, q));
  };


  // ---- LayerNorm (statistics from the cluster's partials, summed in rank
  // order, so every CTA holds the same), gate / relu / sigmoid over this
  // CTA's channels, 2 a thread: the new x (or y) slice into this CTA's place
  // in xbuf and into the same place in every other CTA's, completing on its
  // bar_x (the lanes of 16 bytes of channels, 4 in bf16 and 2 in f32, gather
  // them for one st.async)
  auto finish = [&](int l, int t) {
    const int kind = layer_kind(l), w = kind == TAIL ? FT : CH;
    const int ncols = kind == HIGHWAY ? 2 * w : w, sw = kind == TAIL ? SY : SX;
    const int width = kind == TAIL ? a.F : C;
    // pairs of channels a row, a power of two ≥ 4: rows·pairs is a multiple
    // of 32, so whole warps take part in the shuffles
    const int lp = __ffs(w) - 2, pairs = 1 << lp;
    E* mine = xbuf + (size_t)rank * rows * sw;
    const uint32_t mine_s = smem_addr(mine);
    const float* p = prm + prm_offset(l, NB) + ncols;  // LayerNorm vector v at p + v·w
    const bool relu = layer_relu(l);
    for (int i = tid; i < rows << lp; i += THREADS) {
      const int r = i >> lp, c = 2 * (i & (pairs - 1)), b = b0 + r;
      float s1 = 0.f, q1 = 0.f, s2 = 0.f, q2 = 0.f;
      for (int q = 0; q < n; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(xch + ((size_t)q * rows + r) * 4);
        s1 += v.x, q1 += v.y, s2 += v.z, q2 += v.w;
      }
      const float m1 = s1 / width, m2 = s2 / width;
      const float r1 = rsqrtf(fmaxf(q1 / width - m1 * m1, 0.f) + LN_EPS);
      const float r2 = rsqrtf(fmaxf(q2 / width - m2 * m2, 0.f) + LN_EPS);
      const float* h = hbuf + (size_t)r * ncols + c;
      const float* pv = p + c;
      float v[2];
      if (kind == TAIL) {
        const int col = rank * FT + c;
        for (int k = 0; k < 2; ++k)
          v[k] = col + k < a.F ? sigmoid<E>((h[k] - m1) * r1 * pv[k] + pv[w + k]) : 0.f;
        E* yo = a.y_out + ((size_t)b * a.T + t) * a.F + col;
        if (col + 1 < a.F) store2(yo, v[0], v[1]);
        else if (col < a.F) store1(yo, v[0]);
      } else {
        float* xo = xown + r * CH + c;
        if (kind == HIGHWAY) {
          // x(t) into its ring slot (every CTA has fetched this layer's taps)
          store2(a.rings + ((size_t)slots[2 * layer_hw(l)] * a.Bp + b) * C + rank * CH + c, xo[0],
                 xo[1]);
          for (int k = 0; k < 2; ++k) {
            const float gt = sigmoid<E>((h[k] - m1) * r1 * pv[k] + pv[w + k]);
            const float nv = (h[CH + k] - m2) * r2 * pv[2 * w + k] + pv[3 * w + k];
            v[k] = gt * nv + (1.f - gt) * xo[k];
          }
        } else {
          for (int k = 0; k < 2; ++k) {
            const float x = (h[k] - m1) * r1 * pv[k] + pv[w + k];
            v[k] = relu ? fmaxf(x, 0.f) : x;
          }
        }
        xo[0] = v[0], xo[1] = v[1];
      }
      uint4 piece;
      bool lead;
      if constexpr (!F32) {
        const uint32_t u = pack_bf2(v[0], v[1]);
        const uint32_t u1 = __shfl_down_sync(0xffffffffu, u, 1);
        const uint32_t u2 = __shfl_down_sync(0xffffffffu, u, 2);
        const uint32_t u3 = __shfl_down_sync(0xffffffffu, u, 3);
        piece = make_uint4(u, u1, u2, u3), lead = (lane & 3) == 0;
      } else {
        const uint32_t u0 = __float_as_uint(v[0]), u1 = __float_as_uint(v[1]);
        const uint32_t n0 = __shfl_down_sync(0xffffffffu, u0, 1);
        const uint32_t n1 = __shfl_down_sync(0xffffffffu, u1, 1);
        piece = make_uint4(u0, u1, n0, n1), lead = (lane & 1) == 0;
      }
      if (lead) {
        *reinterpret_cast<uint4*>(mine + r * sw + c) = piece;
        const uint32_t dst = mine_s + (uint32_t)((r * sw + c) * sizeof(E));
        for (int q = 0; q < n; ++q)
          if (q != rank) st_async_v4b(remote(dst, q), piece, remote(bar_x, q));
      }
    }
  };

  // One whole layer: the product, then two exchanges, each st.async stores
  // from every CTA to every CTA that complete on the receiver's mbarrier,
  // which expects their bytes (no cluster barrier, no fence: a CTA waits only
  // for the data it needs). The next highway's taps are fetched meanwhile. Why a buffer is
  // free when the next stores into it land: CTA q stores layer l+1's partials
  // after its product l+1, which needed this CTA's slice of layer l, sent
  // after this CTA had read layer l's partials; q stores its slice of layer
  // l+1 after reading layer l+1's partials, which this CTA sent after its
  // product l+1 had read xbuf. The same order makes each barrier's phases
  // follow one another.
  unsigned ph = 0;  // exchanges done: the barriers' phase parity
  auto layer = [&](int l, int t) {
    const int kind = layer_kind(l);
    const int next_hw = l == 2 ? 0 : l == 13 ? 10 : (kind == HIGHWAY && l != 12 && l != 19)
                                                        ? layer_hw(l) + 1 : -1;
    if (kind == HIGHWAY) product(PK<P_HW>{}, l);
    else if (l == 0) product(PK<P_ENC>{}, l);
    else if (l == 13) product(PK<P_DEC>{}, l);
    else if (l == 23) product(PK<P_TAIL>{}, l);
    else product(PK<P_SQ>{}, l);
    row_partials(l);
    if (tid == 0) mbar_expect_tx(bar_part, n * rows * 16);
    mark(2);
    if (next_hw >= 0) fetch_taps(next_hw, t);  // while the partials travel
    mark(10);
    mbar_wait_cluster(bar_part, ph & 1);
    mark(3);
    finish(l, t);
    mark(4);
    if (l == 12) {
      csync();  // every thread's xown
      // partial q·K over this CTA's channels for the window [pma, pma + 2]
      const float scale = rsqrtf((float)C);
      for (int i = tid; i < rows * 3; i += THREADS) {
        const int r = i / 3, w = i % 3, pos = spma[r] + w;
        float s = 0.f;
        if (pos < a.N) {
          const E* kr = a.K + ((size_t)(b0 + r) * a.N + pos) * C + rank * CH;
          for (int c = 0; c < CH; c += 2) {
            const float2 k2 = load2(kr + c);
            s = fmaf(k2.x, xown[r * CH + c], s);
            s = fmaf(k2.y, xown[r * CH + c + 1], s);
          }
        }
        const uint32_t dst = smem_addr(sxch + ((size_t)rank * rows + r) * 4 + w);
        for (int q = 0; q < n; ++q) st_async_f32(remote(dst, q), s * scale, remote(bar_x, q));
      }
      mark(5);
    }
    if (tid == 0)   // the other CTAs' slices (and every CTA's score partials)
      mbar_expect_tx(bar_x, (n - 1) * rows * (kind == TAIL ? FT : CH) * (int)sizeof(E) +
                                (l == 12 ? n * rows * 12 : 0));
    cp_wait_all();  // this thread's tap copies have landed
    mbar_wait_cluster(bar_x, ph & 1);
    ++ph;
    csync();  // every thread's tap copies too
    mark(6);
  };

  // ---- monotonic attention over the window [pma, pma + 2] (the same in
  // every CTA, from the summed score partials), r = A·V into the taps' r columns
  auto attention = [&](int t) {
    if (tid < rows) {
      const int r = tid, b = b0 + r, pma = spma[r];
      float sc[3], m = -3.0e38f;
      for (int w = 0; w < 3; ++w) {
        float s = 0.f;
        for (int q = 0; q < n; ++q) s += sxch[((size_t)q * rows + r) * 4 + w];
        sc[w] = s;
        if (pma + w < a.N) m = fmaxf(m, s);
      }
      float ex[3], sum = 0.f;
      for (int w = 0; w < 3; ++w) {
        ex[w] = pma + w < a.N ? expf(sc[w] - m) : 0.f;
        sum += ex[w];
      }
      float amax = 0.f;
      for (int w = 0; w < 3; ++w) {
        patt[r * 4 + w] = ex[w] / sum;
        amax = fmaxf(amax, patt[r * 4 + w]);
      }
      int arg = pma;  // first index attaining the max
      for (int w = 2; w >= 0; --w)
        if (pma + w < a.N && patt[r * 4 + w] >= amax) arg = pma + w;
      if (rank == 0)
        for (int w = 0; w < 3; ++w)
          if (pma + w < a.N) store1(a.a_out + ((size_t)b * a.N + pma + w) * a.T + t, patt[r * 4 + w]);
      wbase[r] = pma;
      spma[r] = arg;
    }
    csync();
    for (int i = tid; i < rows * (C / 2); i += THREADS) {
      const int r = i / (C / 2), c = 2 * (i % (C / 2)), b = b0 + r, pma = wbase[r];
      float r0 = 0.f, r1 = 0.f;
      for (int w = 0; w < 3; ++w)
        if (pma + w < a.N) {
          const float2 v = load2(a.V + ((size_t)b * a.N + pma + w) * C + c);
          r0 = fmaf(patt[r * 4 + w], v.x, r0);
          r1 = fmaf(patt[r * 4 + w], v.y, r1);
        }
      store2(taps + (size_t)r * ldt + C + c, r0, r1);
    }
    csync();
    mark(7);
  };

  // Per frame: the audio-encoder front (layers 0-2) and the 10 encoder
  // highway steps (3-12), the attention, then the audio decoder: dec_w1 on
  // [r | q] (13), 6 highway steps, 3 dense, the tail. (Two loops: one loop
  // over all 24 layers measured slower on the card.)
  for (int t = 0; t < a.T; ++t) {
    if (tid < N_HW) {  // read from layer 2 on, after the first product's CTA barrier
      const int d = c_dil[tid];
      slots[2 * tid] = c_slot0[tid] + t % (2 * d);
      slots[2 * tid + 1] = c_slot0[tid] + (t + d) % (2 * d);
    }
    for (int l = 0; l <= 12; ++l) layer(l, t);
    attention(t);
    for (int l = 13; l < N_LAYERS; ++l) layer(l, t);
  }
  if (rank == 0 && tid < rows) a.pma_out[b0 + tid] = spma[tid];
  if (profiling && lane < kPhases) a.prof[lane] = prof_sum;
  cluster_sync();  // no CTA leaves while another may still store into it
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// what decode_kernel.ClusterPlan.refusal() checks
bool plan_ok(int C, int fpad, int n, int rows, int chunk, int stages, int esize) {
  if (esize != 2 && esize != 4) return false;
  if (!pow2(n) || n > 16 || (rows != 16 && rows != 32 && rows != 64)) return false;
  if (C < 32 || C % 32 || C % n || (C / n) % 8 || !pow2(C / n / 8)) return false;
  if (fpad < 128 || fpad % 128 || fpad % n || (fpad / n) % 8 || !pow2(fpad / n / 8)) return false;
  if (stages < 2 || !pow2(stages) || chunk != CHUNK) return false;
  for (int l = 0; l < N_LAYERS; ++l) {
    int K, ncol, S, nbw;
    layer_shape(l, C, fpad, n, K, ncol);
    warp_split(rows, ncol, K, esize, S, nbw);
    if (nbw > 4 || ncol * 256 * esize > chunk) return false;
  }
  return cluster_smem(C, fpad, n, rows, chunk, stages, esize) <= 232448;
}

int clear_and_return(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

template <typename E>
using KernelFn = void (*)(Args<E>);

// The instantiation for a plan: at C = 256, fpad = 128 the plans that
// decode_cluster_plan chooses with their shapes fixed (bf16: clusters of
// 16, 8, 4, 2 with 16 rows; f32: 16, 8, 4, its chunk holding no highway k
// row at 2), any other with them read at run time.
template <typename E, bool PROF>
KernelFn<E> pick(int C, int fpad, int n, int rows) {
#define SPOOFSV_K(N_, R_)                                  \
  if (C == 256 && fpad == 128 && n == N_ && rows == R_) \
  return decode_cluster_kernel<E, 256, 128, N_, R_, PROF>
  SPOOFSV_K(16, 16);
  SPOOFSV_K(8, 16);
  SPOOFSV_K(4, 16);
  if constexpr (sizeof(E) == 2) {
    SPOOFSV_K(2, 16);
  }
#ifdef SPOOFSV_K1_PROBE
  // the other candidates of the probe's plan sweep (bf16 clusters of 16 with
  // 32 or 64 rows spill with their shapes fixed: 168 registers is the most
  // a thread of 9 warps gets)
  if constexpr (sizeof(E) == 2) {
    SPOOFSV_K(8, 32);
    SPOOFSV_K(4, 32);
    SPOOFSV_K(8, 64);
  } else {
    SPOOFSV_K(16, 32);
    SPOOFSV_K(8, 32);
    SPOOFSV_K(4, 32);
  }
#endif
#undef SPOOFSV_K
  return decode_cluster_kernel<E, 0, 0, 0, 0, PROF>;
}
template <typename E>
KernelFn<E> pick(int C, int fpad, int n, int rows, bool prof) {
#ifdef SPOOFSV_K1_PROBE
  if (prof) return pick<E, true>(C, fpad, n, rows);
#endif
  return pick<E, false>(C, fpad, n, rows);
}

template <typename E>
int configure(KernelFn<E> fn, int n, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && n > 8)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e == cudaSuccess ? 0 : clear_and_return(e);
}

void fill_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int n, int tiles, size_t smem,
                 cudaStream_t s) {
  cfg = {};
  cfg.gridDim = dim3(n, tiles, 1);
  cfg.blockDim = dim3(BLOCK);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// ptrs: see spoofsv_decode_cluster_launch; prof null (the product build) or
// kPhases int64
template <typename E>
int launch(const void* const* p, long long* prof, int n, int rows, int tiles, int T, int N, int F,
           int fpad, int C, int condition, int chunk, int stages, void* stream) {
  if (!plan_ok(C, fpad, n, rows, chunk, stages, sizeof(E)) || tiles < 1 || N < 1 || F < 2 ||
      F % 2 || F > fpad || T < 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  Args<E> a;
  a.K = (const E*)p[0]; a.V = (const E*)p[1]; a.s1 = (const E*)p[2]; a.s2 = (const E*)p[3];
  a.stream = (const E*)p[4];
  a.hw_b = (const float*)p[5]; a.hw_ln = (const float*)p[6]; a.sq_b = (const float*)p[7];
  a.misc_ln = (const float*)p[8]; a.enc_b1 = (const float*)p[9]; a.dec_b1 = (const float*)p[10];
  a.tail_b5 = (const float*)p[11]; a.ln5_s = (const float*)p[12]; a.ln5_b = (const float*)p[13];
  a.rings = (E*)p[14]; a.y_out = (E*)p[15]; a.a_out = (E*)p[16]; a.pma_out = (int*)p[17];
  a.prof = prof;
  a.Bp = tiles * rows; a.T = T; a.N = N; a.F = F; a.fpad = fpad; a.C = C;
  a.condition = condition; a.n = n; a.rows = rows; a.stages = stages;
  a.cta_elems = 0;
  for (int l = 0; l < N_LAYERS; ++l) {
    int K, ncol;
    layer_shape(l, C, fpad, n, K, ncol);
    a.cta_elems += (long long)K * ncol * 8;
  }
  const size_t smem = cluster_smem(C, fpad, n, rows, chunk, stages, sizeof(E));
  const KernelFn<E> fn = pick<E>(C, fpad, n, rows, prof != nullptr);
  int err = configure(fn, n, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fill_config(cfg, attr, n, tiles, smem, (cudaStream_t)stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) return clear_and_return(e);
  return (int)cudaGetLastError();
}

// dtype: 0 f32, 1 bf16 (spoofsv_torch.ops._build.DTYPE_CODES)
int launch_dtype(int dtype, const void* const* p, long long* prof, int n, int rows, int tiles,
                 int T, int N, int F, int fpad, int C, int condition, int chunk, int stages,
                 void* stream) {
  if (dtype == 0)
    return launch<float>(p, prof, n, rows, tiles, T, N, F, fpad, C, condition, chunk, stages,
                         stream);
  if (dtype == 1)
    return launch<bf16>(p, prof, n, rows, tiles, T, N, F, fpad, C, condition, chunk, stages,
                        stream);
  return (int)cudaErrorInvalidValue;
}

#ifdef SPOOFSV_K1_PROBE
template <typename E>
int max_active(int C, int fpad, int n, int rows, int chunk, int stages) {
  if (!plan_ok(C, fpad, n, rows, chunk, stages, sizeof(E))) return -(int)cudaErrorInvalidValue;
  const size_t smem = cluster_smem(C, fpad, n, rows, chunk, stages, sizeof(E));
  const KernelFn<E> fn = pick<E>(C, fpad, n, rows, false);
  int err = configure(fn, n, smem);
  if (err) return -err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fill_config(cfg, attr, n, 1, smem, 0);
  int count = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&count, fn, &cfg);
  if (e != cudaSuccess) return -clear_and_return(e);
  return count;
}
#endif

}  // namespace

extern "C" {

// dtype 0 (f32) or 1 (bf16) for E. ptrs: K, V, s1, s2 (Bp, N|-, C) E; the
// weight stream (n, cta_elems) E; hw_b, hw_ln, sq_b, misc_ln, enc_b1,
// dec_b1, tail_b5, ln5_s, ln5_b f32; rings (256, Bp, C) E zeroed; Y (Bp, T,
// F) E; A (Bp, N, T) E zeroed (the kernel writes the window); pma (Bp)
// int32. Bp = tiles·rows.
int spoofsv_decode_cluster_launch(int dtype, const void* const* p, int n, int rows, int tiles,
                                  int T, int N, int F, int fpad, int C, int condition, int chunk,
                                  int stages, void* stream) {
  return launch_dtype(dtype, p, nullptr, n, rows, tiles, T, N, F, fpad, C, condition, chunk,
                      stages, stream);
}

// Dynamic shared memory of one CTA, in bytes (the plan states the same), or
// -1 for an unknown dtype.
int spoofsv_decode_cluster_smem(int dtype, int C, int fpad, int n, int rows, int chunk,
                                int stages) {
  if (dtype != 0 && dtype != 1) return -1;
  return (int)cluster_smem(C, fpad, n, rows, chunk, stages, dtype == 0 ? 4 : 2);
}

const char* spoofsv_decode_cluster_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#ifdef SPOOFSV_K1_PROBE
// As spoofsv_decode_cluster_launch, filling prof (kPhases int64): the clock
// of each phase in CTA (0, 0)'s warp 0, summed over the run.
int spoofsv_decode_cluster_probe_launch(int dtype, const void* const* p, void* prof, int n,
                                        int rows, int tiles, int T, int N, int F, int fpad, int C,
                                        int condition, int chunk, int stages, void* stream) {
  if (!prof) return (int)cudaErrorInvalidValue;
  return launch_dtype(dtype, p, (long long*)prof, n, rows, tiles, T, N, F, fpad, C, condition,
                      chunk, stages, stream);
}

// Clusters of this plan that the card can hold at once (0 if none), or a
// negative CUDA error.
int spoofsv_decode_cluster_max_active(int dtype, int C, int fpad, int n, int rows, int chunk,
                                      int stages) {
  if (dtype == 0) return max_active<float>(C, fpad, n, rows, chunk, stages);
  if (dtype == 1) return max_active<bf16>(C, fpad, n, rows, chunk, stages);
  return -(int)cudaErrorInvalidValue;
}
#endif

}  // extern "C"
