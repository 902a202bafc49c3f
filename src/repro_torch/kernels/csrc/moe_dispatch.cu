// Hand-written Hopper (sm_90a) kernel for the MoE dispatch: token rows
// scattered into per-expert capacity buffers.
//
// It replaces the Pallas kernel of the JAX package's
// src/repro/kernels/moe_dispatch.py (moe_dispatch_pallas at :57, the
// pallas_call at :65, body _kernel at :34) and is the CUDA path of
// repro_torch.kernels.ops.moe_dispatch.  Plain C entry point, built with nvcc
// into a shared library and loaded with ctypes
// (repro_torch/kernels/moe_dispatch.py).  It makes one cooperative launch on
// the stream it is given, allocates nothing (the wrapper hands over the
// output and its row map), and returns the launch's CUDA error, else
// cudaGetLastError().
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
// 3.35 TB/s; there is no arithmetic.  Zeroing a buffer of that size alone
// takes 39.0 us on an H100 (NVIDIA H100 80GB HBM3, 700.00 W), 3.2 TB/s.  At
// a tp = 16 rank's 4 experts the bytes are 4.1 us, and the host's work for
// a call (14-28 us) sets its time.
// The first design put three operations a call on the stream (a
// memset of the row map, a kernel of one thread a slot, a copy kernel of
// one warp a row), staged every byte of the copy in registers, and read a
// row of x once per kept slot: 64.6 us of device time at the prefill shape.
// This design:
//   1. one cooperative launch a call and nothing else on the stream: a
//      persistent grid, sized by the occupancy API, in two phases with one
//      grid barrier between them.  Phase 1: one thread a slot (t, kk), grid
//      stride, a 64-bit atomicMax of (generation << 32) | t into the row map
//      at the slot's flat row (the highest token wins a shared row,
//      deterministically).  The wrapper keeps one map a device and stream
//      and passes one generation more each call, so an entry counts only
//      when its generation is this call's and the map needs no reset;
//   2. phase 2, where rows and both base addresses are multiples of 16
//      bytes (the bulk path), runs token-major, so a row of x is read once:
//      a warp takes a contiguous range of tokens, a lane a slot; a slot is
//      kept where its row's entry is its own token.  One lane loads a
//      token's row chunk (up to CHUNK bytes) into a ring of NBUF shared
//      buffers by Hopper's bulk asynchronous copy (cp.async.bulk, counted
//      in bytes on the buffer's mbarrier), NBUF - 1 chunks ahead, and
//      stores it to each kept slot's row by bulk copies out of shared
//      memory (one bulk group), so no byte passes through registers.  Then
//      the warp's contiguous range of rows that no slot of this call names
//      is stored from one zeroed shared chunk.  A deeper ring issues more
//      of a warp's loads before its first stores (NBUF 2 / 4 / 6: 66.7 /
//      56.7 / 54.8 us at the prefill shape, step_bench
//      --dispatch-variants);
//   3. every other row (a row of 13 bf16 values, an offset view) keeps a
//      warp's widest vector copy (8, 4, 2 or 1 bytes, neighbouring lanes on
//      neighbouring addresses), one warp a row;
//   4. the host path is one ctypes call and one launch; the wrapper
//      allocates only the output.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// the launch shape (step_bench --dispatch-variants edits this line):
// threads a block and row-chunk buffers a warp
struct Shape { static constexpr int THREADS = 256, NBUF = 6; };
constexpr int THREADS = Shape::THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int NBUF = Shape::NBUF;
static_assert(NBUF >= 2 && THREADS % 32 == 0, "a ring of two or more");
constexpr int CHUNK = 4096;             // bytes a buffer (a bf16 row of 2048)
constexpr int MAX_DEVICES = 64;
// shared memory of the bulk path: the mbarriers, the zero chunk, the rings
constexpr int BAR_BYTES = WARPS * NBUF * 8;
constexpr int ZERO_OFF = 128 * ((BAR_BYTES + 127) / 128);
constexpr int RING_OFF = ZERO_OFF + CHUNK;
constexpr int BULK_SMEM = RING_OFF + WARPS * NBUF * CHUNK;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long GEN_BITS = ~0xffffffffull;

struct Params {
  const char* x;
  const int* expert;
  const int* pos;
  char* out;
  // n_rows entries, (generation << 32) | token: an entry counts only when
  // its generation is this call's
  unsigned long long* row_of;
  unsigned long long tag;  // this call's generation << 32
  long long n_slots;
  long long n_rows;
  long long row_bytes;
  int k;
  int capacity;
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

// One thread waits: the spin is a plain branch inside the asm.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from global src into shared dst, counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// bytes (a multiple of 16) from shared src out to global dst, in the
// thread's open bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          __cvta_generic_to_global(dst)),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of this thread's store groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// the bit position of the n-th (from 0) set bit of m
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  for (; n > 0; --n) m &= m - 1;
  return __ffs(m) - 1;
}

// Slot i's flat row, -1 where the slot is dropped.
__device__ __forceinline__ long long slot_row(const Params& p, long long i) {
  const int e = p.expert[i];
  const int q = p.pos[i];
  if (e < 0 || q < 0) return -1;
  const long long row = static_cast<long long>(e) * p.capacity + q;
  return row < p.n_rows ? row : -1;
}

// Phase 1: the highest token of every kept slot's flat row, into the map,
// tagged with this call's generation (older entries are smaller).
__device__ __forceinline__ void map_slots(const Params& p) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < p.n_slots; i += stride) {
    const long long row = slot_row(p, i);
    if (row >= 0)
      atomicMax(p.row_of + row,
                p.tag | static_cast<unsigned long long>(i / p.k));
  }
}

// The bulk path: rows and both base addresses are multiples of 16 bytes.
__global__ void __launch_bounds__(THREADS, 1)
    moe_dispatch_bulk(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t bars = smem_u32(smem) + 8 * NBUF * warp;
  const uint32_t zero = smem_u32(smem + ZERO_OFF);
  const uint32_t ring = smem_u32(smem + RING_OFF) + NBUF * CHUNK * warp;

  // the zero chunk (written by threads, read by the bulk stores: the proxy
  // fence orders the two) and this warp's mbarriers
  for (int i = threadIdx.x; i < CHUNK / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem + ZERO_OFF)[i] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lane == 0) {
    for (int b = 0; b < NBUF; ++b) mbar_init(bars + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  map_slots(p);
  cg::this_grid().sync();

  const long long n_warps = static_cast<long long>(gridDim.x) * WARPS;
  const long long w = static_cast<long long>(blockIdx.x) * WARPS + warp;
  const int n_chunks = static_cast<int>((p.row_bytes + CHUNK - 1) / CHUNK);
  auto chunk_bytes = [&](int c) {
    const long long left = p.row_bytes - static_cast<long long>(c) * CHUNK;
    return static_cast<uint32_t>(left < CHUNK ? left : CHUNK);
  };

  // Phase 2 (a): this warp's contiguous range of tokens, token-major, so a
  // row of x is read once: 32 slots at a time (a lane a slot), a slot kept
  // where its row's map entry is its own token this call.  A unit is a
  // chunk of one token's row (read into buffer u % NBUF), stored to each of
  // its kept slots' rows (one bulk group), NBUF - 1 units loaded ahead.
  const long long n_tokens = p.k > 0 ? p.n_slots / p.k : 0;
  const long long s_lo = n_tokens * w / n_warps * p.k;
  const long long s_hi = n_tokens * (w + 1) / n_warps * p.k;
  uint32_t phase = 0;  // lane 0: the parity bit of each buffer's mbarrier
  for (long long s0 = s_lo; s0 < s_hi; s0 += 32) {
    const long long s = s0 + lane;
    int t = -1;
    long long row = -1;
    unsigned same = 0;  // the lanes of this lane's token
    if (s < s_hi) {
      t = static_cast<int>(s / p.k);
      row = slot_row(p, s);
      if (row >= 0 &&
          __ldcg(p.row_of + row) != (p.tag | static_cast<unsigned>(t)))
        row = -1;
      const long long first = static_cast<long long>(t) * p.k - s0;
      const int a = first < 0 ? 0 : static_cast<int>(first);
      const long long end = first + p.k;
      const int b = end > 32 ? 32 : static_cast<int>(end);
      same = (b == 32 ? FULL : (1u << b) - 1) & ~((1u << a) - 1);
    }
    const unsigned kept = __ballot_sync(FULL, row >= 0);
    // a token's first kept lane heads it
    const unsigned below = (1u << lane) - 1;
    const unsigned heads =
        __ballot_sync(FULL, row >= 0 && (kept & same & below) == 0);
    const int n_units = __popc(heads) * n_chunks;
    // the last batch's stores have read every buffer
    if (lane == 0) bulk_wait_read<0>();
    auto load = [&](int u) {  // every lane calls it (a shuffle)
      const int tu = __shfl_sync(FULL, t, nth_bit(heads, u / n_chunks));
      if (lane != 0) return;
      const int c = u % n_chunks;
      const uint32_t b = u % NBUF;
      mbar_expect_tx(bars + 8 * b, chunk_bytes(c));
      bulk_load(ring + b * CHUNK,
                p.x + tu * p.row_bytes + static_cast<long long>(c) * CHUNK,
                chunk_bytes(c), bars + 8 * b);
    };
    for (int u = 0; u < NBUF - 1 && u < n_units; ++u) load(u);
    for (int u = 0; u < n_units; ++u) {
      const int h = nth_bit(heads, u / n_chunks);
      const int c = u % n_chunks;
      const uint32_t b = u % NBUF;
      if (lane == 0) {
        mbar_wait(bars + 8 * b, (phase >> b) & 1u);
        phase ^= 1u << b;
      }
      const unsigned mine = kept & __shfl_sync(FULL, same, h);
      for (unsigned m = mine; m; m &= m - 1) {
        const long long r = __shfl_sync(FULL, row, __ffs(m) - 1);
        if (lane == 0)
          bulk_store(p.out + r * p.row_bytes +
                         static_cast<long long>(c) * CHUNK,
                     ring + b * CHUNK, chunk_bytes(c));
      }
      if (lane == 0) bulk_commit();
      if (u + NBUF - 1 < n_units) {
        // group u - 1 has read buffer (u - 1) % NBUF, the next load's
        if (lane == 0) bulk_wait_read<1>();
        load(u + NBUF - 1);
      }
    }
  }

  // Phase 2 (b): this warp's contiguous range of rows, 32 at a time (a
  // lane a map entry); a row that no slot of this call names is stored
  // from the zero chunk
  const long long r_lo = p.n_rows * w / n_warps;
  const long long r_hi = p.n_rows * (w + 1) / n_warps;
  for (long long r0 = r_lo; r0 < r_hi; r0 += 32) {
    const long long r = r0 + lane;
    unsigned empty = __ballot_sync(
        FULL, r < r_hi && (__ldcg(p.row_of + r) & GEN_BITS) != p.tag);
    if (lane == 0) {
      for (; empty; empty &= empty - 1) {
        char* dst = p.out + (r0 + __ffs(empty) - 1) * p.row_bytes;
        for (int c = 0; c < n_chunks; ++c)
          bulk_store(dst + static_cast<long long>(c) * CHUNK, zero,
                     chunk_bytes(c));
        bulk_commit();
      }
    }
  }
  // the shared buffers live until every store has read them
  if (lane == 0) bulk_wait_read<0>();
}

// The vector path: one warp a row (grid stride), Vec-wide copies.
template <typename Vec>
__global__ void __launch_bounds__(THREADS) moe_dispatch_vec(const Params p) {
  map_slots(p);
  cg::this_grid().sync();
  const int lane = threadIdx.x % 32;
  const long long n_warps = static_cast<long long>(gridDim.x) * WARPS;
  const long long vecs = p.row_bytes / static_cast<long long>(sizeof(Vec));
  const Vec* x = reinterpret_cast<const Vec*>(p.x);
  Vec* out = reinterpret_cast<Vec*>(p.out);
  for (long long row = static_cast<long long>(blockIdx.x) * WARPS +
                       threadIdx.x / 32;
       row < p.n_rows; row += n_warps) {
    unsigned long long v = 0;
    if (lane == 0) v = __ldcg(p.row_of + row);
    v = __shfl_sync(FULL, v, 0);
    Vec* dst = out + row * vecs;
    if ((v & GEN_BITS) != p.tag) {
      const Vec zero{};
#pragma unroll 4
      for (long long j = lane; j < vecs; j += 32) dst[j] = zero;
      continue;
    }
    const Vec* src = x + static_cast<long long>(v & 0xffffffffull) * vecs;
#pragma unroll 4
    for (long long j = lane; j < vecs; j += 32) dst[j] = src[j];
  }
}

// The blocks a launch of `kernel` may hold on device `dev` at once (the
// occupancy API times the SMs), found once a device and kernel into
// cache[dev].
template <typename Kernel>
cudaError_t coresident(Kernel kernel, int smem, int dev, int* cache) {
  if (cache[dev] > 0) return cudaSuccess;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm * sms < 1)
    err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) cache[dev] = per_sm * sms;
  return err;
}

template <typename Kernel>
int launch(Kernel kernel, int smem, int* cache, Params& p,
           cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  err = coresident(kernel, smem, dev, cache);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long most = cache[dev];
  // enough blocks for a slot a thread and a row a warp, at most `most`
  long long need = (p.n_slots + THREADS - 1) / THREADS;
  const long long for_rows = (p.n_rows + WARPS - 1) / WARPS;
  if (for_rows > need) need = for_rows;
  const long long blocks = need < 1 ? 1 : (need < most ? need : most);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(static_cast<unsigned>(blocks)),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int bulk_blocks[MAX_DEVICES];
int vec_blocks[4][MAX_DEVICES];

}  // namespace

extern "C" {

// x: (n_slots / k) rows of row_bytes; expert, pos: n_slots int32; out:
// n_rows = E * capacity rows of row_bytes; row_of: n_rows 64-bit entries
// whose generations are all below `generation` (1 to 2^32 - 1, one more
// each call on the map).  unit 0: the bulk path (row_bytes and both base
// addresses multiples of 16); 8, 4, 2 or 1: the vector path in that many
// bytes, which divide row_bytes and both base addresses.  A stream that is
// being captured into a CUDA graph is refused.
int moe_dispatch(const void* x, const void* expert, const void* pos,
                 void* out, void* row_of, long long n_slots, int k,
                 int capacity, long long n_rows, long long row_bytes,
                 int unit, unsigned long long generation, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  Params p{static_cast<const char*>(x),
           static_cast<const int*>(expert),
           static_cast<const int*>(pos),
           static_cast<char*>(out),
           static_cast<unsigned long long*>(row_of),
           generation << 32,
           n_slots,
           n_rows,
           row_bytes,
           k,
           capacity};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  // a CUDA graph would replay one generation of the row map
  cudaStreamCaptureStatus capturing = cudaStreamCaptureStatusNone;
  cudaError_t err = cudaStreamIsCapturing(cs, &capturing);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (capturing != cudaStreamCaptureStatusNone)
    return static_cast<int>(cudaErrorStreamCaptureUnsupported);
  switch (unit) {
    case 0: return launch(moe_dispatch_bulk, BULK_SMEM, bulk_blocks, p, cs);
    case 8:
      return launch(moe_dispatch_vec<uint2>, 0, vec_blocks[0], p, cs);
    case 4:
      return launch(moe_dispatch_vec<uint32_t>, 0, vec_blocks[1], p, cs);
    case 2:
      return launch(moe_dispatch_vec<uint16_t>, 0, vec_blocks[2], p, cs);
    case 1:
      return launch(moe_dispatch_vec<uint8_t>, 0, vec_blocks[3], p, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
