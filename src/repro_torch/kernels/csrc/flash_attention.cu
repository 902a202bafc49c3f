// Hand-written Hopper (sm_90a) flash-attention forward kernel.
//
// It replaces the Pallas kernel of the JAX package's
// src/repro/kernels/flash_attention.py (flash_attention_pallas, the
// pallas_call at :105, body _kernel at :37) and is the CUDA path of
// repro_torch.kernels.ops.flash_attention.  Plain C entry point, built with
// nvcc into a shared library and loaded with ctypes
// (repro_torch/kernels/flash_attention.py).  It launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() (or the error of
// the shared-memory attribute call).
//
// What it computes, in the order of the TPU kernel: q * Dh^-0.5 in float32,
// s = q k^T, the softcap cap * tanh(s / cap), the causal and window masks to
// -1e30 (a finite value, as in the reference), the online max / sum /
// accumulator in float32, and acc / max(l, 1e-30) cast to the output type.
// q is (B, H, S, Dh); k, v are (B, KV, S, Dh); query head h reads KV head
// h / (H / KV), which equals the TPU wrapper's jnp.repeat of k and v without
// materialising it.  Any S: the kernel masks its own ragged edge.
//
// What bounds it on this card: at the serving shape (B=4, H=8, S=1024,
// Dh=256, causal) the work is 4 * Dh * B * H * S(S+1)/2 = 17.2 GFLOP
// against about 50 MB moved, so the bound is the operations (17 us at the
// bf16 tensor-core rate, 15 us for the bytes).  This first kernel does not
// reach the tensor cores: it is a plain float32 FMA kernel, right before
// fast (wgmma / TMA are later work).  What the design does about the
// operations: one block of 256 threads per (64-query tile, head, batch),
// a loop over 64-key tiles inside the block (the TPU's sequential nk grid
// axis), K/V tiles staged in shared memory as float32 with rows padded to an
// odd stride (no bank conflicts on the row-strided reads), a 4 x 4
// register micro-tile of s per thread and a 4 x (Dh/16) register tile of the
// accumulator per thread (0.3-0.5 shared loads per FMA), explicit fmaf (the
// library is built with --fmad=false), and no work on key tiles that lie
// wholly above the diagonal or wholly outside the window.  Skipping such a
// tile changes nothing: with the finite -1e30, a row's contribution from a
// wholly masked tile is wiped by corr = exp(-1e30 - m) = 0 once a visible
// tile arrives, and adds exp(-1e30 - m) = 0 after one.
//
// Shared memory at Dh = 256 is 213,760 bytes (Q and K 64 x 257 floats, V
// 64 x 256, P 64 x 65): above 48 KB it is only dynamic, after
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize), so one block runs per
// SM.  expf / tanhf without fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 16 x 16, 4 x 4 micro-tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as a torch cast
}

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
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int H,
                     int KV, int S, int causal, int window, int has_softcap,
                     float softcap, float scale) {
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
  const T* qb = q + (size_t(b) * H + h) * S * DH;
  const T* kb = k + (size_t(b) * KV + g) * S * DH;
  const T* vb = v + (size_t(b) * KV + g) * S * DH;
  T* ob = out + (size_t(b) * H + h) * S * DH;

  for (int e = tid; e < BQ * DH; e += NT) {
    const int r = e / DH, d = e % DH, qp = q0 + r;
    sq[r * QS + d] = qp < S ? load_f32(qb + size_t(qp) * DH + d) * scale
                            : 0.f;
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
      sk[r * QS + d] = in ? load_f32(kb + size_t(kp) * DH + d) : 0.f;
      sv[r * DH + d] = in ? load_f32(vb + size_t(kp) * DH + d) : 0.f;
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
      store_f32(ob + size_t(qp) * DH + tx + 16 * c, acc[i][c] / l_safe);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int S, int causal, int window, int has_softcap,
           float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KV, S, causal,
      window, has_softcap, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int Dh, const void* q, const void* k, const void* v, void* out,
             int B, int H, int KV, int S, int causal, int window,
             int has_softcap, float softcap, float scale,
             cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, H, KV, S, causal, window,
                           has_softcap, softcap, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, B, H, KV, S, causal, window,
                           has_softcap, softcap, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, H, KV, S, causal, window,
                           has_softcap, softcap, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, H, KV, S, causal, window,
                            has_softcap, softcap, scale, stream);
    case 192:
      return launch<T, 192>(q, k, v, out, B, H, KV, S, causal, window,
                            has_softcap, softcap, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, H, KV, S, causal, window,
                            has_softcap, softcap, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).
int fa_forward(const void* q, const void* k, const void* v, void* out, int B,
               int H, int KV, int S, int Dh, int dtype, int causal,
               int window, int has_softcap, float softcap, float scale,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(Dh, q, k, v, out, B, H, KV, S, causal, window,
                           has_softcap, softcap, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(Dh, q, k, v, out, B, H, KV, S, causal,
                                   window, has_softcap, softcap, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
