// Hand-written Hopper (sm_90a) kernel for the MoE dispatch: token rows
// scattered into per-expert capacity buffers.
//
// It replaces the Pallas kernel of the JAX package's
// src/repro/kernels/moe_dispatch.py (moe_dispatch_pallas at :57, the
// pallas_call at :65, body _kernel at :34) and is the CUDA path of
// repro_torch.kernels.ops.moe_dispatch.  Plain C entry point, built with nvcc
// into a shared library and loaded with ctypes
// (repro_torch/kernels/moe_dispatch.py).  It launches on the stream it is
// given, allocates nothing (the wrapper hands over the output and a scratch
// row map), and returns the first CUDA error, else cudaGetLastError().
//
// What it computes: x is (T, D) rows of row_bytes bytes each (any type: the
// kernel only moves bytes); expert and pos are (T, k) int32 with -1 for a
// dropped slot.  Output row expert * C + pos of the (E * C, D) buffer holds
// x[t] for every kept slot (t, kk); every other row is zero.  A slot whose
// expert or pos is negative, or whose flat row lies past E * C, is dropped,
// as the reference's scatter drops it.  Any T: the TPU wrapper dispatches
// only the first T / 256 * 256 tokens; here every token is dispatched.
// Slots that share a row (routing never makes them) leave the row of the
// highest token, which is what the TPU kernel's in-order last write leaves;
// the plain twin sums them instead.
//
// What bounds it on this card: bytes.  At the moonshot prefill shape (T =
// 4096, D = 2048, k = 6, E = 64, C = 480, bf16) it must read x once (16.8 MB)
// and the two tables (0.2 MB) and write the buffer once (125.8 MB): 42.6 us at
// 3.35 TB/s; there is no arithmetic.
// What the design does about it: the TPU kernel's grid (expert, token block)
// has every expert scan every token and zero its buffer first.  Here the loop
// is inverted and every output byte is written exactly once:
//   1. the wrapper's row map (E * C int32) is set to -1 (cudaMemsetAsync);
//   2. one thread per slot (t, kk) writes t into the row map at its flat row
//      (atomicMax: the highest token wins a shared row, deterministically);
//   3. one warp per output row reads its map entry and either copies x[t] or
//      writes zeros, in the widest vector (16 bytes when the row size and both
//      base addresses allow it) with neighbouring lanes on neighbouring
//      addresses.
// The map costs 2 x 123 KB at the prefill shape; a row of x is read once per
// kept slot, but x (16.8 MB) stays in the 50 MB L2 across its k readers.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;  // output rows per block of the copy

__global__ void map_rows(const int* __restrict__ expert,
                         const int* __restrict__ pos, int* __restrict__ row_of,
                         long long n_slots, int k, int capacity,
                         long long n_rows) {
  long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n_slots) return;
  int e = expert[i];
  int p = pos[i];
  if (e < 0 || p < 0) return;
  long long row = static_cast<long long>(e) * capacity + p;
  if (row >= n_rows) return;
  atomicMax(row_of + row, static_cast<int>(i / k));
}

template <typename Vec>
__global__ void copy_rows(const Vec* __restrict__ x,
                          const int* __restrict__ row_of,
                          Vec* __restrict__ out, long long n_rows,
                          long long vecs_per_row) {
  long long row =
      blockIdx.x * static_cast<long long>(WARPS) + threadIdx.x / 32;
  if (row >= n_rows) return;
  int lane = threadIdx.x % 32;
  int t = row_of[row];
  Vec* dst = out + row * vecs_per_row;
  if (t < 0) {
    const Vec zero{};
#pragma unroll 4
    for (long long j = lane; j < vecs_per_row; j += 32) dst[j] = zero;
    return;
  }
  const Vec* src = x + t * vecs_per_row;
#pragma unroll 4
  for (long long j = lane; j < vecs_per_row; j += 32) dst[j] = src[j];
}

template <typename Vec>
int launch_copy(const void* x, const int* row_of, void* out, long long n_rows,
                long long row_bytes, cudaStream_t stream) {
  long long blocks = (n_rows + WARPS - 1) / WARPS;
  copy_rows<Vec><<<static_cast<unsigned>(blocks), WARPS * 32, 0, stream>>>(
      static_cast<const Vec*>(x), row_of, static_cast<Vec*>(out), n_rows,
      row_bytes / static_cast<long long>(sizeof(Vec)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (n_slots / k) rows of row_bytes; expert, pos: n_slots int32; out:
// n_rows = E * capacity rows of row_bytes; row_of: n_rows int32 scratch.
// vec_bytes (16, 8, 4, 2 or 1) divides row_bytes and both base addresses.
int moe_dispatch(const void* x, const void* expert, const void* pos,
                 void* out, void* row_of, long long n_slots, int k,
                 int capacity, long long n_rows, long long row_bytes,
                 int vec_bytes, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  int* map = static_cast<int*>(row_of);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(map, 0xFF, n_rows * sizeof(int), cs);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_slots > 0) {
    long long blocks = (n_slots + 255) / 256;
    map_rows<<<static_cast<unsigned>(blocks), 256, 0, cs>>>(
        static_cast<const int*>(expert), static_cast<const int*>(pos), map,
        n_slots, k, capacity, n_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (vec_bytes) {
    case 16: return launch_copy<uint4>(x, map, out, n_rows, row_bytes, cs);
    case 8: return launch_copy<uint2>(x, map, out, n_rows, row_bytes, cs);
    case 4: return launch_copy<uint32_t>(x, map, out, n_rows, row_bytes, cs);
    case 2: return launch_copy<uint16_t>(x, map, out, n_rows, row_bytes, cs);
    case 1: return launch_copy<uint8_t>(x, map, out, n_rows, row_bytes, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
