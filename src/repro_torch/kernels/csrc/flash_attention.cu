// Hand-written Hopper (sm_90a) flash-attention forward kernels.
//
// They replace the Pallas kernel of the JAX package's
// src/repro/kernels/flash_attention.py (flash_attention_pallas, the
// pallas_call at :105, body _kernel at :37) and are the CUDA path of
// repro_torch.kernels.ops.flash_attention.  Plain C entry point fa_forward,
// built with nvcc into a shared library and loaded with ctypes
// (repro_torch/kernels/flash_attention.py).  It launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() (or the error of
// the shared-memory attribute call, or cudaErrorInvalidValue when a tensor
// map cannot be encoded).
//
// What both kernels compute, in the order of the TPU kernel (causal,
// sliding-window and bidirectional layers, with or without a softcap):
// q * Dh^-0.5 in float32, s = q k^T, the softcap cap * tanh(s / cap) (a
// division, as in the reference), the causal and window masks to -1e30
// (a finite value, as in the reference), the online max / sum /
// accumulator in float32, and acc / max(l, 1e-30) cast to the output
// type.  q is (B, H, S, Dh); k, v are (B, KV, S, Dh); query head h reads
// KV head h / (H / KV) in place, which equals the TPU wrapper's jnp.repeat
// of k and v without materialising it.
// Any S: each kernel masks its own ragged edge.  Key tiles that lie wholly
// above the diagonal or wholly outside the window are skipped.  Skipping
// such a tile changes nothing: with the finite -1e30, a row's contribution
// from a wholly masked tile is wiped by corr = exp(-1e30 - m) = 0 once a
// visible tile arrives, and adds exp(-1e30 - m) = 0 after one.  No atomics:
// two calls give the same bits.
//
// What bounds them on this card: at the serving shape (B=4, H=8, S=1024,
// Dh=256, causal) the work is 4 * Dh * B * H * S(S+1)/2 = 17.2 GFLOP
// against about 50 MB moved, so the bound is the operations (17 us at the
// bf16 tensor-core rate, 15 us for the bytes).  The path is chosen by the
// input type:
//
// * bfloat16: flash_fwd_wgmma_kernel, on the tensor cores.  One block of
//   three warpgroups per (128-query tile, head, batch).  Warpgroup 0 is the
//   producer: one thread loads the Q tile once and then K and V tiles of 64
//   keys with TMA (cp.async.bulk.tensor) into a ring of STAGES shared-memory
//   stages, a full and an empty mbarrier for each K and each V; its
//   registers go to the consumers (setmaxnreg 24 / 240).  Warpgroups 1 and
//   2 each own 64 query rows and take turns at the tensor cores (named
//   barriers 1 and 2): in its turn a warpgroup issues O += P V of its last
//   tile and S = Q K^T of the next, then runs that tile's softmax while
//   the other's products run, so the tensor cores need not wait for a
//   softmax.  S = Q K^T with wgmma m64n64k16 (both operands in shared
//   memory, K-major), the scale, softcap, masks and online softmax on the
//   float32 accumulator in registers, then O += P V with wgmma m64nNk16
//   taking P from registers (rounded to bf16: the one rounding the
//   reference does not make, within the bf16 output's 2^-8) and V from
//   shared memory as it lies, MN-major, through the descriptor's transpose
//   bit.  A tile of Dh columns is Dh / COLS boxes of COLS columns, COLS
//   the widest of 64, 32 and 16 that divides Dh, each box swizzled over
//   its row (128, 64 or 32 bytes) as the wgmma descriptors name it: one
//   box of 32 or 16 columns at Dh = 32 and 16, boxes of 64 at 64, 128,
//   192 and 256.  Dh = 80 (hubert_xlarge: 1280 over 16 heads) is five
//   boxes of 16 columns with the 32-byte swizzle of the Dh = 16 path, not
//   a box of 64 beside a box of 16: 160 bytes a row are no whole number
//   of 128-byte boxes, and one box width keeps one loader, one descriptor
//   rule and the n16 P V product the Dh = 16 path already runs (a tile's
//   P V is 20 m64n16k16 products instead of 4 n64 + 4 n16; attention is
//   a small share of hubert's layer, so the simpler layout goes first).
//   Tile<DH> refuses at compile time a Dh that its boxes do not cover
//   (DH % COLS), so no head dim can lose columns.  q, k and v are not
//   padded to a wider head.  K and V are described to TMA as 3-D
//   tensors (Dh, S, B * KV) and Q as (Dh, S, B * H), so rows past S are
//   out of bounds and arrive as zeros: a tile never reads the next head,
//   whose values may be anything (0 * inf in P V would be NaN).  The scale
//   multiplies s in float32 after the product (the same value as scaling q
//   in exact arithmetic).  The softmax runs as straight passes over a
//   thread's 32 scores with no branch inside them, so that the compiler
//   interleaves them: the divisions (s / cap, acc / l) are the correctly
//   rounded quotient from a correctly rounded reciprocal and one FMA
//   correction (Markstein) instead of the branching division routine, tanh
//   is 1 - 2 / (e^2y + 1) on the special-function unit (within about 2e-7
//   of tanhf), and exp is ex2.approx (2 ulp).  The output is stored from
//   registers, rows past S left alone.  Blocks start with the longest
//   causal query tiles.  Every branch around a wgmma is warp-uniform to
//   ptxas (the role comes from __shfl_sync, the mbarrier spin stays inside
//   its asm): a divergent path makes ptxas serialize the products.
//   Registers (ptxas -v, -Xptxas in registry.NVCC_FLAGS): the launch
//   allocates 168 a thread, no spills; the consumers hold the 64 x Dh
//   accumulator (Dh / 2 floats a thread, 128 at Dh = 256) beside the
//   64 x 64 scores and their bf16 copy.
// * float32: flash_fwd_kernel, float32 FMA (wgmma has no float32 product,
//   and TF32 would miss the float32 tolerance).  One block of 256 threads
//   per (64-query tile, head, batch), a loop over 64-key tiles inside the
//   block (the TPU's sequential nk grid axis), K/V tiles staged in shared
//   memory as float32 with rows padded to an odd stride (no bank conflicts
//   on the row-strided reads), a 4 x 4 register micro-tile of s per thread
//   and a 4 x (Dh/16) register tile of the accumulator per thread (0.3-0.5
//   shared loads per FMA), explicit fmaf (the library is built with
//   --fmad=false).  Shared memory at Dh = 256 is 213,760 bytes (Q and K
//   64 x 257 floats, V 64 x 256, P 64 x 65), so one block runs per SM; it is
//   bound by the float32 FMA rate; expf and tanhf without fast math.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached through
                   // cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// float32: the FMA kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 16 x 16, 4 x 4 micro-tiles
constexpr float NEG_INF = -1e30f;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (DH + 1) + size_t(BK) * (DH + 1) + size_t(BK) * DH +
          size_t(BQ) * (BK + 1));
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i (i < 4):
// score columns tx + 16 j (j < 4) of each key tile and accumulator columns
// tx + 16 c (c < Dh / 16).  The 16 threads of a row group are 16
// consecutive lanes of one warp, so row max and row sum are 4 xor shuffles.
template <int DH>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int H, int KV, int S, int causal, int window,
                     int has_softcap, float softcap, float scale) {
  static_assert(DH % 16 == 0, "a thread's columns are tx + 16 c");
  constexpr int QS = DH + 1;  // padded row stride of Q and K (floats)
  constexpr int PS = BK + 1;  // padded row stride of P
  constexpr int CPT = DH / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + BQ * QS;
  float* sv = sk + BK * QS;
  float* sp = sv + BK * DH;

  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + (size_t(b) * H + h) * S * DH;
  const float* kb = k + (size_t(b) * KV + g) * S * DH;
  const float* vb = v + (size_t(b) * KV + g) * S * DH;
  float* ob = out + (size_t(b) * H + h) * S * DH;

  for (int e = tid; e < BQ * DH; e += NT) {
    const int r = e / DH, d = e % DH, qp = q0 + r;
    sq[r * QS + d] = qp < S ? qb[size_t(qp) * DH + d] * scale : 0.f;
  }

  float acc[4][CPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // key tiles that can hold a visible key for some row of this tile
  const int q_last = min(q0 + BQ, S) - 1;
  const int nk = (S + BK - 1) / BK;
  const int j_end = causal ? q_last / BK + 1 : nk;
  int j_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // first key row q0 may see
    j_begin = lo > 0 ? lo / BK : 0;
  }

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // Q stored; the last tile's readers are done
    for (int e = tid; e < BK * DH; e += NT) {
      const int r = e / DH, d = e % DH, kp = k0 + r;
      const bool in = kp < S;
      sk[r * QS + d] = in ? kb[size_t(kp) * DH + d] : 0.f;
      sv[r * DH + d] = in ? vb[size_t(kp) * DH + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sq[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = sk[(tx + 16 * jj) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kp = k0 + tx + 16 * jj;
        float x = s[i][jj];
        if (has_softcap) x = softcap * tanhf(x / softcap);
        bool vis = kp < S;
        if (causal) vis = vis && qp >= kp;
        if (window > 0) vis = vis && (qp - kp) < window;
        s[i][jj] = vis ? x : NEG_INF;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        // a key past S is no key at all (the reference has none)
        const float p = k0 + c < S ? expf(s[i][jj] - m_new) : 0.f;
        sp[r * PS + c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float vv = sv[c * DH + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      ob[size_t(qp) * DH + tx + 16 * c] = acc[i][c] / l_safe;
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int S, int causal, int window, int has_softcap,
           float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DH><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, KV, S,
      causal, window, has_softcap, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: the wgmma + TMA kernel
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128;  // query rows per block: 64 per consumer warpgroup
constexpr int BK = 64;   // keys per K/V tile
constexpr int NT = 384;  // a producer and two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;

// The shared-memory layout of one head dim.  A row tile of Dh columns is
// NCB boxes of COLS columns (the widest of 64, 32 and 16 that divides Dh),
// each box ROWB bytes a row, swizzled over ROWB bytes (the 128-, 64- or
// 32-byte pattern of TMA and of the wgmma descriptor's LAYOUT).  Q (BQ
// rows), then STAGES stages of K and V (BK rows each), then the mbarriers;
// every box starts on a 1024-byte line.
template <int DH>
struct Tile {
  static constexpr int COLS = DH % 64 == 0 ? 64 : DH % 32 == 0 ? 32 : 16;
  static_assert(DH % COLS == 0, "the boxes must cover every column");
  static constexpr int NCB = DH / COLS;
  static constexpr int ROWB = 2 * COLS;
  static constexpr int LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr int STAGES = DH >= 256 ? 2 : DH >= 192 ? 3 : 4;
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;  // one K or one V tile
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  // 1024 bytes of slack to align the base
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (4 * STAGES + 1);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One arrival from each warp (lane 0), chosen inside the asm: the warp
// passed wgmma.wait_group together, so no lane still reads the tile.
__device__ __forceinline__ void mbar_arrive_warp(uint32_t bar) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 lane;\n"
      "mov.u32 lane, %%laneid;\n"
      "setp.eq.u32 p, lane, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// The spin stays inside the asm: a loop in C would be a divergent path to
// ptxas, which then serializes every wgmma after it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 3-D tensor map at (column, row, head) into shared memory;
// completion is counted in bytes on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers in place around the asynchronous products: no read of a
// result moves above the wait, no write of an operand below the fence.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x on the special-function unit; denormal results flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x / d from r, the correctly rounded 1 / d, and one FMA correction
// (Markstein): the correctly rounded quotient, without the branch of the
// division routine, which would keep the compiler from interleaving the
// 32 scores of a thread
__device__ __forceinline__ float div_rn(float x, float d, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, d, x), r, q);
}

// 1 / x on the special-function unit (x >= 2 here: no denormal fix-up)
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) = sign(y) (1 - 2 / (e^(2 |y|) + 1)), branch-free, within about
// 2e-7 of tanh; e^(2 |y|) = inf gives 1
__device__ __forceinline__ float tanh_f32(float y) {
  const float e = ex2(2.f * LOG2E * fabsf(y));
  return copysignf(fmaf(-2.f, rcp_approx(e + 1.f), 1.f), y);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of m64nNk16 (and the A fragment built from it): thread t
// of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 + 8 i (i < 2) and
// columns 8 n + 2 (t % 4) + j (j < 2) in register 4 n + 2 i + j.
// D (64 x 64, float32) = A * B (+ D when acc != 0), A and B bf16 in
// shared memory, both K-major.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 64, float32) += A * B, A bf16 in registers (the
// accumulator layout of mma_ss_n64, rounded), B bf16 in shared memory,
// MN-major (transposed).
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, float32) += A * B, A bf16 in registers (the
// accumulator layout of mma_ss_n64, rounded), B bf16 in shared memory,
// MN-major (transposed).
__device__ __forceinline__ void mma_rs(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 16, float32) += A * B, A bf16 in registers (the
// accumulator layout of mma_ss_n64, rounded), B bf16 in shared memory,
// MN-major (transposed).
__device__ __forceinline__ void mma_rs(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__global__ void __launch_bounds__(NT, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    int H, int KV, int S, int causal, int window, int has_softcap,
    float softcap, float scale) {
  using T = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t s_kv = s_q + T::Q_BYTES;  // stage st: K, then V
  const uint32_t bars = s_q + T::BAR_OFF;
  auto full_k = [&](int st) { return bars + 8 * st; };
  auto full_v = [&](int st) { return bars + 8 * (T::STAGES + st); };
  auto empty_k = [&](int st) { return bars + 8 * (2 * T::STAGES + st); };
  auto empty_v = [&](int st) { return bars + 8 * (3 * T::STAGES + st); };
  const uint32_t q_bar = bars + 32 * T::STAGES;

  // blocks start in grid order, x fastest: every head's last query tile
  // first, so the longest causal tiles start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (static_cast<int>(gridDim.z - 1 - blockIdx.z)) * BQ;
  const int g = h / (H / KV);
  // key tiles that can hold a visible key for some row of this block
  const int q_last = min(q0 + BQ, S) - 1;
  const int j_end = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  int j_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // first key row q0 may see
    j_begin = lo > 0 ? lo / BK : 0;
  }
  const int n_tiles = j_end - j_begin;

  if (threadIdx.x == 0) {
    for (int st = 0; st < T::STAGES; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), 2 * 4);  // every consumer warp
      mbar_init(empty_v(st), 2 * 4);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role, broadcast from lane 0 so that ptxas sees a
  // warp-uniform value and the products in each branch as converged
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 0) {
    // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, T::Q_BYTES);
      for (int c = 0; c < T::NCB; ++c)
        tma_load(s_q + c * BQ * T::ROWB, &tq, q_bar, c * T::COLS, q0,
                 b * H + h);
      // K and V have barriers of their own: K of tile i goes in once both
      // consumers are done with the K of tile i - STAGES (their turn
      // i - STAGES), a turn before its V is free
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % T::STAGES;
        const uint32_t done = ((i / T::STAGES) & 1) ^ 1;  // round 0: at once
        const int k0 = (j_begin + i) * BK;
        const uint32_t sk = s_kv + st * 2 * T::KV_BYTES;
        const uint32_t sv = sk + T::KV_BYTES;
        mbar_wait(empty_k(st), done);
        mbar_expect_tx(full_k(st), T::KV_BYTES);
        for (int c = 0; c < T::NCB; ++c)
          tma_load(sk + c * BK * T::ROWB, &tk, full_k(st), c * T::COLS, k0,
                   b * KV + g);
        mbar_wait(empty_v(st), done);
        mbar_expect_tx(full_v(st), T::KV_BYTES);
        for (int c = 0; c < T::NCB; ++c)
          tma_load(sv + c * BK * T::ROWB, &tv, full_v(st), c * T::COLS, k0,
                   b * KV + g);
      }
    }
  } else {
    // a consumer: 64 query rows
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    constexpr int NA = T::COLS / 2;  // accumulator floats a box of columns
    constexpr int SBO = 8 * T::ROWB;  // bytes from 8 rows to the next 8
    const int t = threadIdx.x - 128 * wgi;
    const int wq0 = q0 + 64 * (wgi - 1);  // first row of this warpgroup
    const int wq_last = min(wq0 + 63, S - 1);
    const int row0 = wq0 + 16 * (t / 32) + (t % 32) / 4;  // and row0 + 8
    const int col0 = 2 * (t % 4);
    const uint32_t qa = s_q + 64 * (wgi - 1) * T::ROWB;
    const float rcap = has_softcap ? 1.f / softcap : 0.f;

    float o[T::NCB][NA];
#pragma unroll
    for (int c = 0; c < T::NCB; ++c)
#pragma unroll
      for (int e = 0; e < NA; ++e) o[c][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    // The two consumers take turns at the tensor cores (named barriers 1
    // and 2): in its turn (i) a warpgroup issues P V of tile i - 1 and
    // Q K^T of tile i, then runs tile i's softmax while the other's
    // products run.  Warpgroup 1 takes the first turn.
    if (wgi == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    uint32_t p[16];  // P of tile i - 1 as bf16 pairs: the A operand
#pragma unroll
    for (int e = 0; e < 16; ++e) p[e] = 0u;
    bool pv = false;  // whether tile i - 1 ran, so that P V is due
    mbar_wait(q_bar, 0);
    for (int i = 0; i <= n_tiles; ++i) {
      const bool tile = i < n_tiles;
      const int st = i % T::STAGES, pst = (i + T::STAGES - 1) % T::STAGES;
      const int k0 = (j_begin + i) * BK;
      // a tile that no row of this warpgroup may see is not computed (the
      // warpgroup still waits for it and releases it)
      const bool run = tile && wq0 < S && !(causal && k0 > wq_last) &&
                       !(window > 0 && k0 + BK - 1 < wq0 - window + 1);
      if (tile) mbar_wait(full_k(st), (i / T::STAGES) & 1);
      if (i > 0) mbar_wait(full_v(pst), ((i - 1) / T::STAGES) & 1);
      float s[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
      hold(s);
      hold(p);
#pragma unroll
      for (int c = 0; c < T::NCB; ++c) hold(o[c]);
      asm volatile("bar.sync %0, 256;\n" ::"r"(wgi) : "memory");
      wgmma_fence();
      if (pv) {
        const uint32_t sv = s_kv + pst * 2 * T::KV_BYTES + T::KV_BYTES;
#pragma unroll
        for (int kt = 0; kt < BK / 16; ++kt) {
          const uint32_t a[4] = {p[4 * kt], p[4 * kt + 1], p[4 * kt + 2],
                                 p[4 * kt + 3]};
#pragma unroll
          for (int c = 0; c < T::NCB; ++c)
            mma_rs(o[c], a,
                   desc(sv + c * BK * T::ROWB + 16 * kt * T::ROWB, SBO, SBO,
                        T::LAYOUT));
        }
      }
      if (run) {
        const uint32_t sk = s_kv + st * 2 * T::KV_BYTES;
#pragma unroll
        for (int c = 0; c < T::NCB; ++c)
#pragma unroll
          for (int kk = 0; kk < T::COLS / 16; ++kk)
            mma_ss_n64(
                s,
                desc(qa + c * BQ * T::ROWB + 32 * kk, 16, SBO, T::LAYOUT),
                desc(sk + c * BK * T::ROWB + 32 * kk, 16, SBO, T::LAYOUT),
                c | kk);
      }
      wgmma_commit();
      asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - wgi) : "memory");
      wgmma_wait_all();
      hold(s);
#pragma unroll
      for (int c = 0; c < T::NCB; ++c) hold(o[c]);
      if (tile) mbar_arrive_warp(empty_k(st));
      if (i > 0) mbar_arrive_warp(empty_v(pst));
      pv = run;
      if (!run) continue;

      // masks are needed only on a tile that crosses the diagonal, the
      // window's edge or S
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > wq0) ||
                        (window > 0 && k0 < wq_last - window + 1);
      // straight passes over the 32 scores, the uniform branches outside
      // them, so the compiler can interleave the scores
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] *= scale;
      if (has_softcap) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] = softcap * tanh_f32(div_rn(s[e], softcap, rcap));
      }
      if (edge) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          // e = 4 n + 2 i2 + j: row row0 + 8 i2, key k0 + 8 n + col0 + j
          const int kp = k0 + 8 * (e / 4) + col0 + e % 2;
          const int qp = row0 + 8 * ((e / 2) % 2);
          bool vis = kp < S;
          if (causal) vis = vis && qp >= kp;
          if (window > 0) vis = vis && (qp - kp) < window;
          s[e] = vis ? s[e] : NEG_INF;
        }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int e = 0; e < 32; ++e)
        mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], s[e]);
      float corr[2];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
        mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
        const float m_new = fmaxf(m[i2], mx[i2]);
        corr[i2] = ex2((m[i2] - m_new) * LOG2E);
        m[i2] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] = ex2((s[e] - m[(e / 2) % 2]) * LOG2E);
        sum[(e / 2) % 2] += s[e];
      }
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) l[i2] = l[i2] * corr[i2] + sum[i2];
#pragma unroll
      for (int c = 0; c < T::NCB; ++c)
#pragma unroll
        for (int e = 0; e < NA; ++e) o[c][e] *= corr[(e / 2) % 2];
#pragma unroll
      for (int e = 0; e < 16; ++e) p[e] = pack_bf16(s[2 * e], s[2 * e + 1]);
    }
    // take up the other consumer's last pass of the turn
    if (wgi == 1) asm volatile("bar.sync 1, 256;\n" ::: "memory");

#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      float lt = l[i2];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float l_safe = fmaxf(lt, 1e-30f), r_l = 1.f / l_safe;
      const int qp = row0 + 8 * i2;
      if (qp >= S) continue;
      __nv_bfloat16* orow = out + ((size_t(b) * H + h) * S + qp) * DH;
#pragma unroll
      for (int c = 0; c < T::NCB; ++c)
#pragma unroll
        for (int n = 0; n < T::COLS / 8; ++n) {
          const int e = 4 * n + 2 * i2;
          *reinterpret_cast<__nv_bfloat162*>(orow + c * T::COLS + 8 * n +
                                             col0) =
              __floats2bfloat162_rn(div_rn(o[c][e], l_safe, r_l),
                                    div_rn(o[c][e + 1], l_safe, r_l));
        }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded
EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (Dh, S, n) bf16 tensor, boxes of (cols, rows, 1), swizzled over the
// box's row of row_bytes; rows past S read as zeros.
bool encode(CUtensorMap* map, const void* base, int dh, int s, int n,
            int cols, int rows, int row_bytes) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return false;
  const cuuint64_t dims[3] = {cuuint64_t(dh), cuuint64_t(s), cuuint64_t(n)};
  const cuuint64_t strides[2] = {cuuint64_t(dh) * 2,
                                 cuuint64_t(dh) * 2 * cuuint64_t(s)};
  const cuuint32_t box[3] = {cuuint32_t(cols), cuuint32_t(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int S, int causal, int window, int has_softcap,
           float softcap, float scale, cudaStream_t stream) {
  using T = Tile<DH>;
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, DH, S, B * H, T::COLS, BQ, T::ROWB) ||
      !encode(&mk, k, DH, S, B * KV, T::COLS, BK, T::ROWB) ||
      !encode(&mv, v, DH, S, B * KV, T::COLS, BK, T::ROWB))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_fwd_wgmma_kernel<DH><<<grid, NT, T::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), H, KV, S, causal, window,
      has_softcap, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// f(std::integral_constant<int, Dh>) for each head dim the kernels take
template <typename F>
int by_head_dim(int Dh, F&& f) {
  switch (Dh) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the wgmma kernel); q,
// k, v and out alike.
int fa_forward(const void* q, const void* k, const void* v, void* out, int B,
               int H, int KV, int S, int Dh, int dtype, int causal,
               int window, int has_softcap, float softcap, float scale,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_head_dim(Dh, [&](auto d) {
      return launch<decltype(d)::value>(q, k, v, out, B, H, KV, S, causal,
                                        window, has_softcap, softcap, scale,
                                        st);
    });
  if (dtype == 1)
    return by_head_dim(Dh, [&](auto d) {
      return wg::launch<decltype(d)::value>(q, k, v, out, B, H, KV, S,
                                            causal, window, has_softcap,
                                            softcap, scale, st);
    });
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
