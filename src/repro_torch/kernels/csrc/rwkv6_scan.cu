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
// (an FMA counted as two): 2.73 G operations, 41 us at the 67 TFLOP/s
// non-tensor rate, against 88 MB moved (26 us at 3.35 TB/s), so the
// operations set the bound.  But the recurrence is a chain of T dependent
// steps per (b, h), and B * H = 128 blocks of Dh = 64 threads leave each SM
// two warps: the kernel is latency- and issue-bound, well above its bound.
// What the design does about it: one block per (b, h) and one thread per
// value column d, so the sum of r_t[k] * S[k][d] over k needs no reduction
// across threads; the thread's column S[:, d] stays in Dh registers for the
// whole sequence (the TPU kernel's VMEM scratch); r, k, v, w for a tile of
// TT steps are staged in shared memory as float32 between two block
// barriers and read back as broadcast float4 loads (four keys per load),
// and the tile's a_t are reduced while it is staged (a warp shuffle, then
// the warps' partial sums in shared memory); the sum over k runs in four
// independent accumulators to shorten its dependency chain; explicit fmaf
// (the library is built with --fmad=false).  Splitting k across a warp,
// several heads per block and a chunked tensor-core form are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TT = 32;  // time steps staged per tile

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as a torch cast
}

// Key kk of one step: its term of out_d, then the update of S[kk][d].
__device__ __forceinline__ void key_step(float& s, float& acc, float rk,
                                         float kk, float wk, float vd) {
  acc = fmaf(rk, s, acc);
  s = fmaf(wk, s, kk * vd);
}

// Sum of x over the lanes of a warp of n <= 32 threads.
template <int N>
__device__ __forceinline__ float warp_sum(float x) {
  constexpr unsigned mask = N >= 32 ? 0xffffffffu : (1u << N) - 1u;
#pragma unroll
  for (int off = (N >= 32 ? 16 : N / 2); off > 0; off /= 2)
    x += __shfl_xor_sync(mask, x, off, N >= 32 ? 32 : N);
  return x;
}

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
    rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 T* __restrict__ out, float* __restrict__ s_out, int H,
                 int n_t, long long sb, long long sh, long long st,
                 long long ob, long long oh, long long ot) {
  constexpr int NW = (DH + 31) / 32;  // warps a block
  __shared__ __align__(16) float sr[TT][DH];
  __shared__ __align__(16) float sk[TT][DH];
  __shared__ __align__(16) float sv[TT][DH];
  __shared__ __align__(16) float sw[TT][DH];
  __shared__ float sa[NW][TT];  // each warp's part of a_t

  const int d = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t in0 = size_t(b) * sb + size_t(h) * sh + d;
  const size_t out0 = size_t(b) * ob + size_t(h) * oh + d;
  const size_t state0 = (size_t(b) * H + h) * DH * DH + d;
  const float ud = u[size_t(h) * DH + d];

  float s[DH];
#pragma unroll
  for (int kk = 0; kk < DH; ++kk) s[kk] = s0[state0 + size_t(kk) * DH];

  for (int t0 = 0; t0 < n_t; t0 += TT) {
    const int n = min(TT, n_t - t0);
    __syncthreads();  // the last tile's readers are done
    for (int i = 0; i < n; ++i) {
      const size_t off = in0 + size_t(t0 + i) * st;
      const float ri = load_f32(r + off), ki = load_f32(k + off);
      sr[i][d] = ri;
      sk[i][d] = ki;
      sv[i][d] = load_f32(v + off);
      sw[i][d] = load_f32(w + off);
      const float part = warp_sum<(DH < 32 ? DH : 32)>(ri * ud * ki);
      if ((d & 31) == 0) sa[d >> 5][i] = part;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float vd = sv[i][d];
      float a = sa[0][i];
#pragma unroll
      for (int j = 1; j < NW; ++j) a += sa[j][i];
      const float4* r4 = reinterpret_cast<const float4*>(sr[i]);
      const float4* k4 = reinterpret_cast<const float4*>(sk[i]);
      const float4* w4 = reinterpret_cast<const float4*>(sw[i]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < DH / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q];
        key_step(s[4 * q + 0], acc[0], rq.x, kq.x, wq.x, vd);
        key_step(s[4 * q + 1], acc[1], rq.y, kq.y, wq.y, vd);
        key_step(s[4 * q + 2], acc[2], rq.z, kq.z, wq.z, vd);
        key_step(s[4 * q + 3], acc[3], rq.w, kq.w, wq.w, vd);
      }
      store_f32(out + out0 + size_t(t0 + i) * ot,
                fmaf(vd, a, (acc[0] + acc[1]) + (acc[2] + acc[3])));
    }
  }

#pragma unroll
  for (int kk = 0; kk < DH; ++kk) s_out[state0 + size_t(kk) * DH] = s[kk];
}

template <typename T, int DH>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* s_out, int B,
           int H, int n_t, long long sb, long long sh, long long st,
           long long ob, long long oh, long long ot, cudaStream_t stream) {
  const dim3 grid(H, B);
  rwkv6_kernel<T, DH><<<grid, DH, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(s_out), H, n_t, sb, sh, st,
      ob, oh, ot);
  return static_cast<int>(cudaGetLastError());
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

}  // extern "C"
