// Hand-written Hopper (sm_90a) kernel for the RWKV6 recurrence.
//
// It replaces the Pallas kernel of the JAX package's
// src/repro/kernels/rwkv6_scan.py (rwkv6_pallas, the pallas_call at :67,
// body _kernel at :30) and is the CUDA path of
// repro_torch.kernels.ops.rwkv6.  Plain C entry point, built with nvcc into
// a shared library and loaded with ctypes (repro_torch/kernels/rwkv6_scan.py).
// It launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError().
//
// What it computes, per (b, h) and in time order, all in float32:
//   out_t[d]  = sum_k r_t[k] * (S[k][d] + u[k] * k_t[k] * v_t[d])
//   S[k][d]  <- w_t[k] * S[k][d] + k_t[k] * v_t[d]
// The u term factors out of the sum over k:
//   out_t[d]  = sum_k r_t[k] * S[k][d] + v_t[d] * a_t,
//   a_t       = sum_k r_t[k] * u[k] * k_t[k]   (one scalar a step),
// so a key of a column costs one multiply and two FMAs.
// r, k, v, w are (B, H, T, Dh) in float32 or bfloat16 (upcast on load), u is
// (H, Dh) float32, the state (B, H, Dh, Dh) float32 maps key dim k to value
// dim d; out is written in the input type (round to nearest even), the final
// state in float32.  Any T: unlike the TPU wrapper, which walks
// T / 128 * 128 steps, nothing past a multiple of a tile is dropped.
//
// Layout: r, k, v and w share one set of strides (sb, sh, st) in elements
// with the head dim contiguous, and out has its own (ob, oh, ot).  The model
// hands over (B, T, H, Dh) buffers viewed as (B, H, T, Dh), so the kernel
// reads them where they lie and writes out in the same layout: no transpose
// copies before or after it.
//
// What bounds it on this card: at the serving shape (B=4, H=32, T=1024,
// Dh=64, bf16) the work is 5 Dh^2 + 5 Dh float32 operations per (b, h, t)
// (an FMA counted as two): 2.726 G operations, 0.04069 ms at the 67 TFLOP/s
// non-tensor rate, against 88 MB moved (26 us at 3.35 TB/s), so the
// operations set the bound.  Three instructions a state cell a step (a
// multiply, two FMAs) put the floor of issue at about 1.2x that bound.  The
// recurrence is a chain of T dependent steps per (b, h), but the value
// columns d are independent of each other: out_t[d] and column S[:, d] need
// only r_t, k_t, w_t, u, a_t and v_t[d].
//
// What held the first design back: one block of Dh threads per (b, h), so 128
// blocks of two warps at the serving shape (two warps on 128 SMs, 4 SMs
// idle), nothing to hide the latency of shared-memory loads and barriers;
// the loads of a tile staged between two barriers with no step running; a_t
// from a chain of dependent shuffles a step; and every state cell's r, k, w
// read from shared memory one float per FMA triple.
//
// What this design does about it:
// * Fill the card.  A step warp is Dh / 4 key lanes by 128 / Dh column
//   lanes: a lane keeps S[k][d] for 4 keys k and CP columns d in registers
//   for the whole sequence, and the lanes of a column sum their parts with
//   shuffles.  A block has NW step warps (NW * 128 / Dh * CP columns of one
//   (b, h)), so a (b, h) spans Dh / CB blocks.  At Dh = 64 (CP = 4, NW = 4)
//   that is 256 blocks of 4 step warps, 2 blocks an SM on all 132 SMs, 16
//   state cells a lane; each block reads r, k and w again (from L2, mostly).
// * Few shared-memory reads a cell.  A step's r, k, w are one float4 each
//   per lane (its 4 keys) and v one float per column, so each value read
//   feeds CP or 4 cells.  Slot j of a lane holds column c + (j ^ m), m from
//   the lane's key index: each round of the sum over key lanes then keeps
//   its low slots and takes the partner's high ones, the same columns there,
//   with no selects; the sums of U = 4 steps go together, so a round has
//   U times the shuffles in flight and a step costs about four.  The sums
//   go to shared memory; v_t[d] a_t is added when out is written.  The
//   order of every sum is fixed, so the result does not depend on the
//   layout.
// * Overlap the loads.  The block has as many load warps as step warps
//   (so each SM sub-partition runs one of each a block).  They read tile
//   n + 1 (TT steps of r, k, w and the block's columns of v) from global
//   memory while the step warps run tile n, convert it to float32 once per
//   element into the other of two shared-memory buffers, compute its TT
//   values of a_t in one pass (four keys a thread, a shuffle sum over the
//   row's threads, the rows together), and write out the rows of a tile
//   once its steps are done.  Named barriers (full, free) hand each
//   buffer over; a third, among the load warps alone, keeps a load warp
//   from filling a buffer with the next tile while another still writes
//   out its last one.  Rows past the end of a ragged last tile become steps that
//   change nothing (r = 0, k = 0, w = 1), so the steps are unrolled over
//   whole tiles.
// * Explicit fmaf (the library is built with --fmad=false).
// Out of scope: a chunked tensor-core form (per-channel decay products
// overflow float32), thread-block clusters with TMA multicast of r, k, w.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace {

// Launch shape per head dim: CP value columns a lane, NW step warps a
// block (and as many load warps), TT steps a tile.
constexpr int log2i(int x) { return x > 1 ? 1 + log2i(x / 2) : 0; }

template <int DH>
struct Shape;
template <>
struct Shape<16> { static constexpr int CP = 2, NW = 1, TT = 16; };
template <>
struct Shape<32> { static constexpr int CP = 8, NW = 1, TT = 16; };
template <>
struct Shape<64> { static constexpr int CP = 4, NW = 4, TT = 32; };

template <int DH>
struct Config {
  static constexpr int CP = Shape<DH>::CP, NW = Shape<DH>::NW,
                       TT = Shape<DH>::TT;
  static constexpr int U = 4;              // steps whose sums go together
  static constexpr int KL = DH / 4;        // key lanes of a step warp
  static constexpr int CL = 32 / KL;       // column lanes of a step warp
  static constexpr int SPAN = KL / CP;     // key lanes left holding a column
  static constexpr int LOG_CP = log2i(CP), LOG_SPAN = log2i(SPAN);
  // rounds that then split the group's steps, and the rounds after them
  static constexpr int SPLIT = LOG_SPAN < log2i(U) ? LOG_SPAN : log2i(U);
  static constexpr int KEEP = U >> SPLIT;  // sums a lane writes a group
  static constexpr int CB = NW * CL * CP;  // value columns a block
  static constexpr int G = DH / CB;        // blocks a (b, h)
  static constexpr int NS = 32 * NW;       // step threads: NW warps
  static constexpr int NL = 32 * NW;       // load threads: as many warps
  static constexpr int NT = NS + NL;       // threads a block
  // the load warps take four elements a thread: LR threads a row of r, k
  // or w, RI rows a load; LV threads a row of v, VI rows a load
  static constexpr int LR = DH / 4, RI = NL / LR;
  static constexpr int LV = CB / 4, VI = NL / LV;
  static_assert(KL <= 32 && 32 % KL == 0, "key lanes within a warp");
  static_assert(CP >= 1 && CP <= KL && KL % CP == 0 && (CP & (CP - 1)) == 0,
                "the sum over key lanes leaves one column a lane");
  static_assert(DH % CB == 0 && CB % 8 == 0, "whole 16-byte rows of out");
  static_assert(TT % U == 0 && TT % RI == 0 && 32 % LV == 0 && TT % VI == 0,
                "whole groups, whole loads");
};

// The block's shared memory, two buffers of a tile each: r, k, w (all
// keys) and v (the block's columns) as float32, a_t, and the sums
// sum_k r_t[k] S[k][d] the step warps leave for out.
template <int DH>
struct Smem {
  using C = Config<DH>;
  float rkw[2][3 * C::TT * DH];
  float v[2][C::TT * C::CB];
  float a[2][C::TT];
  float sum[2][C::TT * C::CB];
};

// Two floats as two bf16 (round to nearest even) in one word, a first.
__device__ __forceinline__ unsigned bf16x2(float a, float b) {
  return __bfloat16_as_ushort(__float2bfloat16(a)) |
         unsigned(__bfloat16_as_ushort(__float2bfloat16(b))) << 16;
}

// Four consecutive floats of shared memory.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four consecutive elements of global memory as float32: one 16- or 8-byte
// load where they are aligned (`vec`), else four.
__device__ __forceinline__ float4 ldg4(const float* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p, bool vec) {
  if (vec) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(raw.x << 16),
                       __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16),
                       __uint_as_float(raw.y & 0xffff0000u));
  }
  return make_float4(__bfloat162float(p[0]), __bfloat162float(p[1]),
                     __bfloat162float(p[2]), __bfloat162float(p[3]));
}

// Named barriers between the step warps and the load warps: buffer b is
// full (FULL + b) or free again (FREE + b); every thread of the block takes
// part, one side arriving, the other waiting.  LOADS is among the load
// threads alone.  The ids are immediates, so that ptxas counts only the
// barriers used.
constexpr int FULL = 1, FREE = 3, LOADS = 5;
template <int ID>
__device__ __forceinline__ void bar_wait(int b, int n) {
  if (b)
    asm volatile("bar.sync %0, %1;\n" ::"n"(ID + 1), "r"(n) : "memory");
  else
    asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "r"(n) : "memory");
}
template <int ID>
__device__ __forceinline__ void bar_arrive(int b, int n) {
  if (b)
    asm volatile("bar.arrive %0, %1;\n" ::"n"(ID + 1), "r"(n) : "memory");
  else
    asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "r"(n) : "memory");
}
template <int N>
__device__ __forceinline__ void bar_loads() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(LOADS), "n"(N) : "memory");
}

// Key kk of one step: its term of out_d, then the update of S[kk][d].
__device__ __forceinline__ void key_step(float& s, float& acc, float rk,
                                         float kk, float wk, float vd) {
  acc = fmaf(rk, s, acc);
  s = fmaf(wk, s, kk * vd);
}

// The load warps' share of a tile of n steps from row0 into buffer b: r,
// k, w and the block's columns of v from global memory, converted to
// float32 once, and a_t = sum_k r_t[k] u[k] k_t[k] (four keys a thread, a
// shuffle sum over the row's threads, all of a thread's rows at once).
// Rows past n (a ragged last tile) become steps that change nothing:
// r = 0, k = 0, w = 1, v = 0.  `lt` is the thread's index among the load
// threads.  Where the load threads have just written out the buffer's last
// tile (`after_out`), each read rows of v and a_t that another now
// overwrites, so they meet at LOADS between the global loads and the
// first store: the loads' latency hides the wait.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(Smem<DH>& sm, int b, int lt,
                                          const T* r, const T* k, const T* w,
                                          const T* v, long long row0,
                                          long long st, int n, float4 u4,
                                          bool vec, bool after_out) {
  using C = Config<DH>;
  constexpr int TT = C::TT, NR = TT / C::RI, NV = TT / C::VI;
  const int key = 4 * (lt % C::LR), col = 4 * (lt % C::LV);
  float4 rq[NR], kq[NR], wq[NR], vq[NV];
#pragma unroll
  for (int it = 0; it < NR; ++it) {
    const int row = it * C::RI + lt / C::LR;
    const long long at = row0 + min(row, n - 1) * st + key;
    rq[it] = ldg4(r + at, vec);
    kq[it] = ldg4(k + at, vec);
    wq[it] = ldg4(w + at, vec);
  }
#pragma unroll
  for (int it = 0; it < NV; ++it) {
    const int row = it * C::VI + lt / C::LV;
    vq[it] = ldg4(v + row0 + min(row, n - 1) * st + col, vec);
  }
  if (after_out) bar_loads<C::NL>();
  float part[NR];
#pragma unroll
  for (int it = 0; it < NR; ++it) {
    const int row = it * C::RI + lt / C::LR;
    if (row >= n) {
      rq[it] = kq[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      wq[it] = make_float4(1.f, 1.f, 1.f, 1.f);
    }
    float* dst = sm.rkw[b] + row * DH + key;
    *reinterpret_cast<float4*>(dst) = rq[it];
    *reinterpret_cast<float4*>(dst + TT * DH) = kq[it];
    *reinterpret_cast<float4*>(dst + 2 * TT * DH) = wq[it];
    part[it] = (rq[it].x * u4.x * kq[it].x + rq[it].y * u4.y * kq[it].y) +
               (rq[it].z * u4.z * kq[it].z + rq[it].w * u4.w * kq[it].w);
  }
#pragma unroll
  for (int off = C::LR / 2; off > 0; off /= 2)
#pragma unroll
    for (int it = 0; it < NR; ++it)
      part[it] += __shfl_xor_sync(0xffffffffu, part[it], off);
  if (lt % C::LR == 0) {
#pragma unroll
    for (int it = 0; it < NR; ++it)
      sm.a[b][it * C::RI + lt / C::LR] = part[it];
  }
#pragma unroll
  for (int it = 0; it < NV; ++it) {
    const int row = it * C::VI + lt / C::LV;
    *reinterpret_cast<float4*>(sm.v[b] + row * C::CB + col) =
        row < n ? vq[it] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The load warps write out the n rows of buffer b's tile from row0:
// out_t[d] = sum_k r_t[k] S[k][d] + v_t[d] a_t, 16 bytes a store.
template <typename T, int DH>
__device__ __forceinline__ void write_out(const Smem<DH>& sm, int b,
                                          int lt, T* out, long long row0,
                                          long long ot, int n) {
  using C = Config<DH>;
  constexpr int E = 16 / sizeof(T), RC = C::CB / E;
  for (int j = lt; j < n * RC; j += C::NL) {
    const int i = j / RC, x = j % RC * E;
    const float a = sm.a[b][i];
    float o[E];
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 s4 = lds4(sm.sum[b] + i * C::CB + x + e),
                   v4 = lds4(sm.v[b] + i * C::CB + x + e);
      o[e] = fmaf(v4.x, a, s4.x);
      o[e + 1] = fmaf(v4.y, a, s4.y);
      o[e + 2] = fmaf(v4.z, a, s4.z);
      o[e + 3] = fmaf(v4.w, a, s4.w);
    }
    T* dst = out + row0 + i * ot + x;
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(bf16x2(o[0], o[1]), bf16x2(o[2], o[3]),
                     bf16x2(o[4], o[5]), bf16x2(o[6], o[7]));
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(Config<DH>::NT, 2)
    rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 T* __restrict__ out, float* __restrict__ s_out, int H,
                 int n_t, long long sb, long long sh, long long st,
                 long long ob, long long oh, long long ot, int vec) {
  using C = Config<DH>;
  constexpr int TT = C::TT, CP = C::CP, KL = C::KL, CB = C::CB, U = C::U;
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem);
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (n_t + TT - 1) / TT;

  if (threadIdx.x >= C::NS) {
    // the load warps: tile n + 1 while the steps of tile n run, and the
    // out rows of each tile once its steps are done
    const int lt = threadIdx.x - C::NS, key = 4 * (lt % C::LR);
    const long long in0 = b * sb + h * sh;
    const long long out0 = b * ob + h * oh + g * CB;
    const float4 u4 = make_float4(u[h * DH + key], u[h * DH + key + 1],
                                  u[h * DH + key + 2], u[h * DH + key + 3]);
    for (int tile = 0; tile < n_tiles + 2; ++tile) {
      const int buf = tile & 1;
      if (tile >= 2) {
        bar_wait<FREE>(buf, C::NT);
        const int t0 = (tile - 2) * TT;
        write_out<T, DH>(sm, buf, lt, out, out0 + t0 * ot, ot,
                         min(TT, n_t - t0));
      }
      if (tile < n_tiles) {
        const int t0 = tile * TT;
        load_tile<T, DH>(sm, buf, lt, r, k, w, v + g * CB, in0 + t0 * st, st,
                         min(TT, n_t - t0), u4, vec, tile >= 2);
        bar_arrive<FULL>(buf, C::NT);
      }
    }
    return;
  }

  const int tid = threadIdx.x, lane = tid % 32;
  // keys 4 kl .. 4 kl + 3 and columns c .. c + CP - 1 of the block; slot j
  // holds column c + (j ^ m), so that each round of the sum over key lanes
  // below keeps its low slots, and column c + m is left in slot 0
  const int kl = lane % KL, m = kl / C::SPAN;
  const int c = (tid / 32 * C::CL + lane / KL) * CP;
  // the first of the group's steps whose sums this lane is left with
  int u0 = 0;
#pragma unroll
  for (int rd = 1; rd <= C::SPLIT; ++rd)
    if (kl & (C::SPAN >> rd)) u0 += U >> rd;
  const bool writer = (kl & ((C::SPAN >> C::SPLIT) - 1)) == 0;
  const long long state0 =
      (static_cast<long long>(b) * H + h) * DH * DH + 4 * kl * DH + g * CB + c;

  float s[4][CP];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < CP; ++j) s[kk][j] = s0[state0 + kk * DH + (j ^ m)];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    bar_wait<FULL>(buf, C::NT);
    const float* rkw = sm.rkw[buf] + 4 * kl;
    const float* vl = sm.v[buf] + c;
    float* sum = sm.sum[buf] + u0 * CB + c + m;

    // the tile's steps, U at a time; each step's r, k, w and v are read
    // while the step before runs
    float4 rq = lds4(rkw), kq = lds4(rkw + TT * DH),
           wq = lds4(rkw + 2 * TT * DH);
    float vq[CP];
#pragma unroll
    for (int j = 0; j < CP; ++j) vq[j] = vl[j ^ m];
#pragma unroll
    for (int i0 = 0; i0 < TT; i0 += U) {
      float acc[U][CP];
#pragma unroll
      for (int uu = 0; uu < U; ++uu) {
        const int i = i0 + uu;
        const float4 rc = rq, kc = kq, wc = wq;
        float vc[CP];
#pragma unroll
        for (int j = 0; j < CP; ++j) vc[j] = vq[j];
        if (i + 1 < TT) {
          rq = lds4(rkw + (i + 1) * DH);
          kq = lds4(rkw + (TT + i + 1) * DH);
          wq = lds4(rkw + (2 * TT + i + 1) * DH);
#pragma unroll
          for (int j = 0; j < CP; ++j) vq[j] = vl[(i + 1) * CB + (j ^ m)];
        }
#pragma unroll
        for (int j = 0; j < CP; ++j) {
          acc[uu][j] = 0.f;
          key_step(s[0][j], acc[uu][j], rc.x, kc.x, wc.x, vc[j]);
          key_step(s[1][j], acc[uu][j], rc.y, kc.y, wc.y, vc[j]);
          key_step(s[2][j], acc[uu][j], rc.z, kc.z, wc.z, vc[j]);
          key_step(s[3][j], acc[uu][j], rc.w, kc.w, wc.w, vc[j]);
        }
      }
      // the sum over the KL key lanes: each round halves the column slots
      // (keeping the low half, taking the partner's high half: the same
      // columns there), then halves the group's steps, then the lanes
      // left holding the same sums add up
#pragma unroll
      for (int rd = 1; rd <= C::LOG_CP; ++rd)
#pragma unroll
        for (int uu = 0; uu < U; ++uu)
#pragma unroll
          for (int j = 0; j < CP >> rd; ++j)
            acc[uu][j] += __shfl_xor_sync(
                0xffffffffu, acc[uu][j + (CP >> rd)], KL >> rd);
#pragma unroll
      for (int rd = 1; rd <= C::SPLIT; ++rd) {
        const bool hi = kl & (C::SPAN >> rd);
#pragma unroll
        for (int q = 0; q < U >> rd; ++q) {
          const float keep = hi ? acc[q + (U >> rd)][0] : acc[q][0];
          const float send = hi ? acc[q][0] : acc[q + (U >> rd)][0];
          acc[q][0] = keep + __shfl_xor_sync(0xffffffffu, send,
                                             C::SPAN >> rd);
        }
      }
#pragma unroll
      for (int rd = C::SPLIT + 1; rd <= C::LOG_SPAN; ++rd)
        acc[0][0] += __shfl_xor_sync(0xffffffffu, acc[0][0], C::SPAN >> rd);
      if (writer) {
#pragma unroll
        for (int q = 0; q < C::KEEP; ++q) sum[(i0 + q) * CB] = acc[q][0];
      }
    }
    bar_arrive<FREE>(buf, C::NT);
  }

#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < CP; ++j) s_out[state0 + kk * DH + (j ^ m)] = s[kk][j];
}

template <typename T, int DH>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* s_out, int B,
           int H, int n_t, long long sb, long long sh, long long st,
           long long ob, long long oh, long long ot, cudaStream_t stream) {
  using C = Config<DH>;
  constexpr int bytes = sizeof(Smem<DH>);
  // the cap on dynamic shared memory, raised once a device (the attribute
  // belongs to the current device's context; a device past the 64th raises
  // it every launch)
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(rwkv6_kernel<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  // a store writes 16 bytes of out, so its rows must be 16-byte aligned
  // (the wrapper's empty_like makes them so); a load takes four elements of
  // r, k, v or w at once where their rows are aligned to them (`vec`), and
  // one at a time where not
  constexpr long long es = sizeof(T), a4 = 4 * es;
  if (reinterpret_cast<uintptr_t>(out) % 16 || (ob * es) % 16 ||
      (oh * es) % 16 || (ot * es) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w)) %
       a4) == 0 &&
      (sb * es) % a4 == 0 && (sh * es) % a4 == 0 && (st * es) % a4 == 0;
  const dim3 grid(C::G, H, B);
  rwkv6_kernel<T, DH><<<grid, C::NT, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(s_out), H, n_t, sb, sh, st,
      ob, oh, ot, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int shape_of(int B, int H, int* shape) {
  using C = Config<DH>;
  shape[0] = C::G * H * B;
  shape[1] = C::NT;
  shape[2] = static_cast<int>(sizeof(Smem<DH>));
  shape[3] = C::CP;
  shape[4] = C::CB;
  shape[5] = C::TT;
  return 0;
}

template <typename T>
int dispatch(int Dh, const void* r, const void* k, const void* v,
             const void* w, const void* u, const void* s0, void* out,
             void* s_out, int B, int H, int n_t, long long sb, long long sh,
             long long st, long long ob, long long oh, long long ot,
             cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, out, s_out, B, H, n_t, sb, sh,
                           st, ob, oh, ot, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, out, s_out, B, H, n_t, sb, sh,
                           st, ob, oh, ot, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, out, s_out, B, H, n_t, sb, sh,
                           st, ob, oh, ot, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and out alike).
int rwkv6_forward(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, void* out, void* s_out,
                  int B, int H, int n_t, int Dh, int dtype, long long sb,
                  long long sh, long long st, long long ob, long long oh,
                  long long ot, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(Dh, r, k, v, w, u, s0, out, s_out, B, H, n_t, sb,
                           sh, st, ob, oh, ot, cs);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(Dh, r, k, v, w, u, s0, out, s_out, B, H,
                                   n_t, sb, sh, st, ob, oh, ot, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch rwkv6_forward makes for these sizes (either I/O type), into
// shape[0..5]: blocks, threads a block (step and load warps), dynamic
// shared bytes a block, value columns a lane, value columns a block, steps
// a tile.  Launches nothing.
int rwkv6_launch_shape(int B, int H, int Dh, int* shape) {
  switch (Dh) {
    case 16:
      return shape_of<16>(B, H, shape);
    case 32:
      return shape_of<32>(B, H, shape);
    case 64:
      return shape_of<64>(B, H, shape);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
