// Decoupled gather, hand-written for Hopper (sm_90a): out[i] =
// fn(table[idx[i]]), with the template's access / FIFO / execute split
// written out inside the kernel.
//
// Replaces the Pallas TPU kernel `decoupled_gather`
// (src/repro/kernels/decoupled_gather.py:71, body from `_make_kernel`).
// There the grid walks the N output rows in order; at step i the kernel
// starts the DMA of row idx[i+1] into the free slot of a two-slot VMEM
// ring (one DMA semaphore per slot), then waits on slot i's semaphore and
// computes row i while row i+1 is in flight; the indices are scalar-
// prefetched.  Here:
//
//  * each warp walks its own contiguous run of output rows (4 to 32 rows,
//    so a 4096-row gather keeps ~1024 warps in flight) with its own
//    two-slot ring in shared memory;
//  * index fetch: the warp loads its run's indices once, one per lane (the
//    scalar prefetch), wraps negative ones as Python indexing does and
//    clamps the rest into [0, R) so no copy leaves the table;
//  * access stage: row i+1's copy into slot (i+1)%2 is issued with
//    cp.async, 16-byte chunks spread over the lanes, before row i's compute
//    waits on its own slot (cp.async.wait_group 1: one group per row, so
//    the wait is the slot's semaphore);
//  * execute stage: each lane computes the chunks it copied itself, so no
//    lane waits on another, and writes the output row once.
//
// `fn` is a named set, because a kernel cannot run a Python callable:
// 0 is the reference's default, tanh(2*row) computed in fp32 and rounded
// once to the table's type; 1 is the plain gather.  Types: f32, bf16.
//
// What bounds it on the card: bytes.  It reads N rows and the indices and
// writes N rows: at 4096 rows of 576 bf16, 9.45 MB, 2.8 us at 3.35 TB/s.
// Each warp has at most two rows in flight, so the run is latency-bound
// unless enough warps run at once; the warp count is what the design
// spends on that.
//
// Every entry point takes device pointers and a stream, launches on that
// stream without synchronising, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;          // warps per block, one ring each
constexpr int kTargetWarps = 1024;
constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch rounds
}

template <int CHUNK>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (CHUNK == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(gmem));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// CHUNK bytes of row values, viewed as a word of the chunk's size
template <int CHUNK>
struct Word;
template <>
struct Word<16> { using type = uint4; };
template <>
struct Word<4> { using type = unsigned; };

template <typename T, int CHUNK, int FN>
__device__ __forceinline__ void execute(const unsigned char* src,
                                        unsigned char* dst) {
  using W = typename Word<CHUNK>::type;
  W word = *reinterpret_cast<const W*>(src);
  if constexpr (FN == 0) {
    T* v = reinterpret_cast<T*>(&word);
#pragma unroll
    for (int e = 0; e < CHUNK / static_cast<int>(sizeof(T)); ++e) {
      v[e] = from_float<T>(tanhf(2.0f * to_float(v[e])));
    }
  }
  *reinterpret_cast<W*>(dst) = word;
}

template <typename T, int CHUNK, int FN>
__global__ void __launch_bounds__(kWarps * 32)
gather_kernel(const int* __restrict__ idx, const T* __restrict__ table,
              T* __restrict__ out, int N, int R, int D, int run) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = (blockIdx.x * kWarps + warp) * run;
  if (first >= N) return;
  const int count = min(run, N - first);
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int nchunks = row_bytes / CHUNK;
  unsigned char* slots = ring + static_cast<size_t>(warp) * 2 * row_bytes;

  // index fetch: lane j holds the row index of output row first + j
  int r = lane < count ? idx[first + lane] : 0;
  r = r < 0 ? r + R : r;
  r = min(max(r, 0), R - 1);

  auto issue = [&](int i, int slot) {  // access stage: row i into a slot
    const int row = __shfl_sync(kFull, r, i);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        table + static_cast<size_t>(row) * D);
    unsigned char* dst = slots + slot * row_bytes;
    for (int c = lane; c < nchunks; c += 32) {
      cp_async<CHUNK>(dst + c * CHUNK, src + c * CHUNK);
    }
  };

  issue(0, 0);
  cp_async_commit();
  for (int i = 0; i < count; ++i) {
    if (i + 1 < count) issue(i + 1, (i + 1) & 1);  // runs ahead
    cp_async_commit();    // one group per row (empty after the last)
    cp_async_wait_one();  // FIFO pop: this lane's chunks of row i landed
    const unsigned char* src = slots + (i & 1) * row_bytes;
    unsigned char* dst = reinterpret_cast<unsigned char*>(
        out + static_cast<size_t>(first + i) * D);
    for (int c = lane; c < nchunks; c += 32) {
      execute<T, CHUNK, FN>(src + c * CHUNK, dst + c * CHUNK);
    }
  }
}

template <typename T, int CHUNK, int FN>
int launch_chunk(const int* idx, const T* table, T* out, int N, int R, int D,
                 cudaStream_t s) {
  const int run = min(32, max(4, (N + kTargetWarps - 1) / kTargetWarps));
  const int warps = (N + run - 1) / run;
  const int blocks = (warps + kWarps - 1) / kWarps;
  const size_t smem = static_cast<size_t>(kWarps) * 2 * D * sizeof(T);
  if (smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_kernel<T, CHUNK, FN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gather_kernel<T, CHUNK, FN><<<blocks, kWarps * 32, smem, s>>>(
      idx, table, out, N, R, D, run);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int FN>
int launch_fn(const int* idx, const T* table, T* out, int N, int R, int D,
              cudaStream_t s) {
  const size_t row_bytes = static_cast<size_t>(D) * sizeof(T);
  const auto aligned = [&](size_t a) {
    return row_bytes % a == 0 && reinterpret_cast<uintptr_t>(table) % a == 0
           && reinterpret_cast<uintptr_t>(out) % a == 0;
  };
  if (aligned(16)) return launch_chunk<T, 16, FN>(idx, table, out, N, R, D, s);
  if (aligned(4)) return launch_chunk<T, 4, FN>(idx, table, out, N, R, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* idx, const void* table, void* out, int N, int R,
           int D, int fn, void* stream) {
  if (N <= 0 || D <= 0) return 0;
  if (R <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* ip = static_cast<const int*>(idx);
  const T* tp = static_cast<const T*>(table);
  T* op = static_cast<T*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fn) {
    case 0: return launch_fn<T, 0>(ip, tp, op, N, R, D, s);
    case 1: return launch_fn<T, 1>(ip, tp, op, N, R, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// idx (N,) int32, table (R, D), out (N, D) of the table's type; fn 0 is
// tanh(2*row), 1 the plain gather.  Rows must be a multiple of 4 bytes and
// at most kMaxSmem / (2 * kWarps) bytes; otherwise cudaErrorInvalidValue.
#define GATHER_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* idx, const void* table, void* out, int N, \
                      int R, int D, int fn, void* stream) {                 \
    return launch<T>(idx, table, out, N, R, D, fn, stream);                 \
  }

GATHER_ENTRY(decoupled_gather_f32, float)
GATHER_ENTRY(decoupled_gather_bf16, __nv_bfloat16)
