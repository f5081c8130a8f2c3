// Exact inclusive running maximum (max-scan) over int64 or int32, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `pallas_running_max`
// (src/repro/core/engine.py).  There the grid walks 1024-element blocks
// in order on one core, scans each block associatively and folds in a
// one-cell SMEM carry of all earlier blocks.  Blocks on the card run in
// parallel and in no order, so the carry becomes two extra passes:
//
//  (a) tile_max:       one block per 1024-element tile writes its maximum;
//  (b) tile_carry:     one block scans the tile maxima into an exclusive
//                      carry per tile (the max of every earlier tile);
//  (c) tile_scan:      one block per tile scans it (4 values per thread in
//                      registers, then a warp-shuffle scan and a scan of
//                      the warp totals in shared memory) and folds in the
//                      tile's carry.
//
// max is exact on integers, so the result is bit-identical to
// np.maximum.accumulate for any n >= 1 and any values, including those
// above 2^31.  Bound on the card: memory — n values read and n written
// (16 MiB for 2^20 int64, ~5 us at 3.35 TB/s); this simple design reads
// the input twice (passes a and c).  A single-pass decoupled look-back
// scan is a later optimisation.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // 1024 values per tile
constexpr int kCarryThreads = 1024;

template <typename T> struct Lowest;
template <> struct Lowest<long long> {
  static __device__ __forceinline__ long long value() { return LLONG_MIN; }
};
template <> struct Lowest<int> {
  static __device__ __forceinline__ int value() { return INT_MIN; }
};

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

// Inclusive max-scan across the block; every thread gets its prefix.
// `warp_tot` holds one value per warp.  Ends with a barrier, so the
// caller may reuse `warp_tot` right away.
template <typename T, int NT>
__device__ T block_scan(T v, T* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const T o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = tmax(v, o);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = lane < NT / 32 ? warp_tot[lane] : Lowest<T>::value();
    for (int off = 1; off < 32; off <<= 1) {
      const T o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w = tmax(w, o);
    }
    if (lane < NT / 32) warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = tmax(v, warp_tot[warp - 1]);
  __syncthreads();
  return v;
}

template <typename T>
__global__ void tile_max(const T* __restrict__ x, T* __restrict__ tmaxes,
                         long long n) {
  __shared__ T warp_tot[kThreads / 32];
  const long long base = (long long)blockIdx.x * kTile
                         + (long long)threadIdx.x * kItems;
  T m = Lowest<T>::value();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (base + k < n) m = tmax(m, x[base + k]);
  }
  m = block_scan<T, kThreads>(m, warp_tot);
  if (threadIdx.x == kThreads - 1) tmaxes[blockIdx.x] = m;
}

template <typename T>
__global__ void tile_carry(const T* __restrict__ tmaxes,
                           T* __restrict__ carry, int ntiles) {
  __shared__ T warp_tot[kCarryThreads / 32];
  __shared__ T incl[kCarryThreads];
  T running = Lowest<T>::value();
  for (int lo = 0; lo < ntiles; lo += kCarryThreads) {
    const int i = lo + threadIdx.x;
    const T v = i < ntiles ? tmaxes[i] : Lowest<T>::value();
    const T inc = block_scan<T, kCarryThreads>(v, warp_tot);
    incl[threadIdx.x] = inc;
    __syncthreads();
    if (i < ntiles) {
      carry[i] = threadIdx.x == 0 ? running
                                  : tmax(running, incl[threadIdx.x - 1]);
    }
    running = tmax(running, incl[kCarryThreads - 1]);
    __syncthreads();
  }
}

template <typename T>
__global__ void tile_scan(const T* __restrict__ x, T* __restrict__ out,
                          const T* __restrict__ carry, long long n) {
  __shared__ T warp_tot[kThreads / 32];
  __shared__ T incl[kThreads];
  const long long base = (long long)blockIdx.x * kTile
                         + (long long)threadIdx.x * kItems;
  T v[kItems];
  T run = Lowest<T>::value();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = base + k < n ? x[base + k] : Lowest<T>::value();
    run = tmax(run, v[k]);
    v[k] = run;
  }
  // scan the per-thread totals; thread t's prefix is thread t-1's value
  incl[threadIdx.x] = block_scan<T, kThreads>(run, warp_tot);
  __syncthreads();
  const T excl = threadIdx.x > 0 ? incl[threadIdx.x - 1]
                                 : Lowest<T>::value();
  const T prefix = tmax(carry[blockIdx.x], excl);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (base + k < n) out[base + k] = tmax(v[k], prefix);
  }
}

template <typename T>
int launch(const void* x, void* out, void* scratch, long long n,
           void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long ntiles = (n + kTile - 1) / kTile;
  T* tmaxes = (T*)scratch;
  T* carry = tmaxes + ntiles;
  tile_max<T><<<(unsigned)ntiles, kThreads, 0, s>>>((const T*)x, tmaxes, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_carry<T><<<1, kCarryThreads, 0, s>>>(tmaxes, carry, (int)ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_scan<T><<<(unsigned)ntiles, kThreads, 0, s>>>((const T*)x, (T*)out,
                                                      carry, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (n,) on the device; scratch: 2 * ceil(n / 1024) values of the
// same type (tile maxima, then tile carries).
extern "C" int running_max_i64(const void* x, void* out, void* scratch,
                               long long n, void* stream) {
  return launch<long long>(x, out, scratch, n, stream);
}

extern "C" int running_max_i32(const void* x, void* out, void* scratch,
                               long long n, void* stream) {
  return launch<int>(x, out, scratch, n, stream);
}
