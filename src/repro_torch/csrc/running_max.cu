// Exact inclusive running maximum (max-scan) over int64 or int32, for
// Hopper (sm_90a): one launch, one read of the input, one write of the
// output.  Also the host round trip that feeds it from pinned memory.
//
// Replaces the Pallas TPU kernel `pallas_running_max`
// (src/repro/core/engine.py).  There the grid walks 1024-element blocks
// in order on one core, scans each block associatively and folds in a
// one-cell SMEM carry of all earlier blocks.  Blocks on the card run in
// parallel and in no order, so the one-cell carry becomes a single-pass
// decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back"):
//
//  * tile ids come from a global atomic ticket, so a tile only ever waits
//    on tiles that took their ticket earlier and are already running;
//  * each CTA loads its tile once, 16 bytes a thread per load (8 loads a
//    thread: 8192 int32 or 4096 int64 values a tile), warp-striped so a
//    warp's loads are contiguous, all loads in flight before any scan; it
//    scans the tile in registers, across lanes by warp shuffles and
//    across warps in shared memory;
//  * it publishes its tile maximum (flag AGG), then warp 0 looks back over
//    its predecessors' status words, 128 at a time (4 a lane), until it
//    meets an inclusive prefix (flag PREFIX); it folds what it saw into
//    the tile's exclusive prefix and publishes its own inclusive prefix;
//  * each value is written once, folded with that prefix.
//
// Status words: for int32 the flag and the value share one 64-bit word,
// stored and loaded whole (st/ld.relaxed.gpu), so no fence is needed.  For
// int64 the value is stored first and the flag with st.release.gpu; a
// reader loads the flags relaxed and, once its window is published, takes
// one fence.acq_rel.gpu before it loads the values.  A reader that sees
// AGG may read a value already raised to the PREFIX: max is idempotent and
// the prefix only covers tiles the reader folds in anyway, so that is
// exact too.
//
// `carry` (optional, a device cell) is folded in front of the first tile:
// the round trip below scans an array in chunks, each chunk carrying in
// the previous chunk's last output.
//
// The state (the ticket, a count of CTAs past their look-back, one status
// word per tile) starts zeroed and the kernel leaves it zeroed: the last
// CTA to count itself clears the flags and both counters, after every CTA
// has read the flags it needs.  So no memset precedes a call, and a
// CUDA-graph replay of calls on one stream stays correct.  Calls that
// share a state must not run concurrently (the wrapper keeps one state per
// stream).
//
// max is exact on integers, so the result is bit-identical to
// np.maximum.accumulate for any n >= 1 and any values, including those
// above 2^31.  Bound on the card: memory — n values read and n written
// (8 MiB for 2^20 int32, 2.5 us at 3.35 TB/s).  At that size the kernel is
// bound by latency instead: the launch, the ticket, the loads, one
// look-back round and the stores follow one another.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 8;  // 16-byte loads a thread
constexpr int kLook = 4;  // status words a lane reads per look-back round

constexpr unsigned kAgg = 1;     // the tile's own maximum
constexpr unsigned kPrefix = 2;  // the max of every value up to the tile's
                                 // end (and the carry)

// values per tile: kThreads * kVecs 16-byte vectors
template <typename T>
__host__ __device__ constexpr long long tile_values() {
  return static_cast<long long>(kThreads) * kVecs * (16 / sizeof(T));
}

struct Status {
  unsigned long long flag;  // int32: flag << 32 | value
  long long value;          // int64 only
};

// state: counters[0] the ticket, counters[1] the CTAs past their
// look-back; then one Status per tile, 16-byte aligned
struct State {
  unsigned counters[4];
  Status tiles[1];
};

template <typename T> struct Lowest;
template <> struct Lowest<long long> {
  static __device__ __forceinline__ long long value() { return LLONG_MIN; }
};
template <> struct Lowest<int> {
  static __device__ __forceinline__ int value() { return INT_MIN; }
};

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

template <typename T>
__device__ __forceinline__ T warp_incl_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = tmax(v, o);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = tmax(v, static_cast<T>(__shfl_xor_sync(kFull, v, off)));
  return v;
}

__device__ __forceinline__ void st_relaxed(void* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ void st_release(void* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(const void* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

template <typename T>
__device__ __forceinline__ void publish(Status* s, T value, unsigned flag) {
  if constexpr (sizeof(T) == 4) {
    st_relaxed(&s->flag, static_cast<unsigned long long>(flag) << 32 |
                             static_cast<unsigned>(value));
  } else {
    st_relaxed(&s->value, static_cast<unsigned long long>(value));
    st_release(&s->flag, flag);
  }
}

// The exclusive prefix of `tile` (> 0): the max of every earlier tile's
// values and `head` (the carry).  Run by one whole warp.
template <typename T>
__device__ T look_back(const Status* tiles, int tile, T head) {
  const int lane = threadIdx.x & 31;
  T excl = Lowest<T>::value();
  for (int j = tile - 1;; j -= 32 * kLook) {
    unsigned f[kLook];
    T v[kLook];
    bool ready = false;
    while (!ready) {  // spin until every word of the window is published
      ready = true;
#pragma unroll
      for (int k = 0; k < kLook; ++k) {
        const int t = j - (lane + 32 * k);
        if (t < 0) {  // before the first tile: the carry, as a prefix
          f[k] = kPrefix;
          v[k] = head;
        } else {
          const unsigned long long w = ld_relaxed(&tiles[t].flag);
          f[k] = sizeof(T) == 4 ? static_cast<unsigned>(w >> 32)
                                : static_cast<unsigned>(w);
          v[k] = static_cast<T>(static_cast<unsigned>(w));  // int32 only
        }
        ready = ready && f[k] != 0;
      }
      ready = __all_sync(kFull, ready);
    }
    if constexpr (sizeof(T) == 8) {  // the values, after the flags
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < kLook; ++k) {
        const int t = j - (lane + 32 * k);
        if (t >= 0) v[k] = static_cast<T>(ld_relaxed(&tiles[t].value));
      }
    }
    // the nearest prefix in the window, as a distance from j
    int nearest = INT_MAX;
#pragma unroll
    for (int k = kLook - 1; k >= 0; --k) {
      const unsigned b = __ballot_sync(kFull, f[k] == kPrefix);
      if (b) nearest = 32 * k + __ffs(b) - 1;
    }
    T m = Lowest<T>::value();
#pragma unroll
    for (int k = 0; k < kLook; ++k)
      if (lane + 32 * k <= nearest) m = tmax(m, v[k]);
    excl = tmax(excl, warp_max(m));
    if (nearest != INT_MAX) return excl;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ x, T* __restrict__ out,
            const T* __restrict__ carry, State* __restrict__ state,
            long long n, int ntiles) {
  constexpr int W = 16 / sizeof(T);  // values a 16-byte vector holds
  __shared__ T warp_tot[kWarps];
  __shared__ T tile_excl;
  __shared__ int tile_id;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) tile_id = atomicAdd(&state->counters[0], 1u);
  __syncthreads();
  const int tile = tile_id;
  // warp-striped: round r of warp w covers 32 consecutive vectors
  const long long base = tile * tile_values<T>()
                         + static_cast<long long>(warp) * 32 * kVecs * W;

  T v[kVecs][W];
#pragma unroll
  for (int r = 0; r < kVecs; ++r) {
    const long long i0 = base + static_cast<long long>(r * 32 + lane) * W;
    if (VEC && i0 + W <= n) {
      const uint4 word = *reinterpret_cast<const uint4*>(x + i0);
      const T* w = reinterpret_cast<const T*>(&word);
#pragma unroll
      for (int e = 0; e < W; ++e) v[r][e] = w[e];
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e)
        v[r][e] = i0 + e < n ? x[i0 + e] : Lowest<T>::value();
    }
  }
  T run = Lowest<T>::value();  // the max of this warp's earlier rounds
#pragma unroll
  for (int r = 0; r < kVecs; ++r) {
#pragma unroll
    for (int e = 1; e < W; ++e) v[r][e] = tmax(v[r][e], v[r][e - 1]);
    const T inc = warp_incl_scan(v[r][W - 1]);
    T exc = __shfl_up_sync(kFull, inc, 1);
    exc = tmax(lane == 0 ? Lowest<T>::value() : exc, run);
#pragma unroll
    for (int e = 0; e < W; ++e) v[r][e] = tmax(v[r][e], exc);
    run = tmax(run, static_cast<T>(__shfl_sync(kFull, inc, 31)));
  }
  if (lane == 0) warp_tot[warp] = run;
  __syncthreads();
  T before = Lowest<T>::value(), agg = Lowest<T>::value();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before = tmax(before, warp_tot[w]);
    agg = tmax(agg, warp_tot[w]);
  }

  unsigned counted = 0;  // warp 0, lane 0: the CTAs past look-back before
  if (warp == 0) {
    const T head = carry != nullptr ? *carry : Lowest<T>::value();
    Status* tiles = state->tiles;
    T excl = head;
    if (tile > 0) {
      if (lane == 0) publish<T>(tiles + tile, agg, kAgg);
      excl = look_back<T>(tiles, tile, head);
    }
    if (lane == 0) {
      publish<T>(tiles + tile, tmax(excl, agg), kPrefix);
      tile_excl = excl;
      // release: this CTA's publishes come first; acquire: for the clear
      asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                   : "=r"(counted)
                   : "l"(&state->counters[1])
                   : "memory");
    }
  }
  __syncthreads();
  const T prefix = tmax(tile_excl, before);
#pragma unroll
  for (int r = 0; r < kVecs; ++r) {
    const long long i0 = base + static_cast<long long>(r * 32 + lane) * W;
#pragma unroll
    for (int e = 0; e < W; ++e) v[r][e] = tmax(v[r][e], prefix);
    if (VEC && i0 + W <= n) {
      uint4 word;
      T* w = reinterpret_cast<T*>(&word);
#pragma unroll
      for (int e = 0; e < W; ++e) w[e] = v[r][e];
      *reinterpret_cast<uint4*>(out + i0) = word;
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (i0 + e < n) out[i0 + e] = v[r][e];
    }
  }

  // the last CTA past its look-back leaves the state zeroed
  if (warp == 0 && __shfl_sync(kFull, counted, 0) ==
                       static_cast<unsigned>(ntiles - 1)) {
    for (int t = lane; t < ntiles; t += 32) state->tiles[t].flag = 0;
    if (lane == 0) {
      state->counters[0] = 0;
      state->counters[1] = 0;
    }
  }
}

template <typename T>
cudaError_t launch(const T* x, T* out, const T* carry, void* state,
                   long long state_tiles, long long n, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  const long long ntiles = (n + tile_values<T>() - 1) / tile_values<T>();
  if (ntiles > state_tiles || ntiles > INT_MAX ||
      reinterpret_cast<uintptr_t>(state) % 16 != 0)
    return cudaErrorInvalidValue;
  State* sp = static_cast<State*>(state);
  const unsigned grid = static_cast<unsigned>(ntiles);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    scan_kernel<T, true><<<grid, kThreads, 0, s>>>(x, out, carry, sp, n,
                                                    static_cast<int>(ntiles));
  } else {
    scan_kernel<T, false><<<grid, kThreads, 0, s>>>(x, out, carry, sp, n,
                                                     static_cast<int>(ntiles));
  }
  return cudaGetLastError();
}

// The host round trip of n values in chunks of `chunk`: chunk k goes up on
// `up`, is scanned on `scan` once its upload is in (events[2k]), carrying
// in the last output of chunk k-1, and comes down on `down` once its scan
// is done (events[2k+1]); `done` is recorded on `down` after the last
// download.  The caller fills pinned_in first and reads pinned_out after
// `done`.  Chunk k+1's upload, chunk k's scan and chunk k-1's download run
// at once.  Counts the launches made in *launches.
template <typename T>
cudaError_t round_trip(const T* pinned_in, T* dev_in, T* dev_out,
                       T* pinned_out, void* state, long long state_tiles,
                       long long n, long long chunk, cudaStream_t up,
                       cudaStream_t scan, cudaStream_t down,
                       cudaEvent_t* events, cudaEvent_t done,
                       int* launches) {
  *launches = 0;
  if (n <= 0 || chunk <= 0) return cudaErrorInvalidValue;
  for (long long lo = 0, k = 0; lo < n; lo += chunk, ++k) {
    const long long m = n - lo < chunk ? n - lo : chunk;
    const size_t bytes = static_cast<size_t>(m) * sizeof(T);
    cudaError_t e;
    if ((e = cudaMemcpyAsync(dev_in + lo, pinned_in + lo, bytes,
                             cudaMemcpyHostToDevice, up)) != cudaSuccess ||
        (e = cudaEventRecord(events[2 * k], up)) != cudaSuccess ||
        (e = cudaStreamWaitEvent(scan, events[2 * k], 0)) != cudaSuccess ||
        (e = launch<T>(dev_in + lo, dev_out + lo,
                       lo > 0 ? dev_out + lo - 1 : nullptr, state,
                       state_tiles, m, scan)) != cudaSuccess)
      return e;
    ++*launches;
    if ((e = cudaEventRecord(events[2 * k + 1], scan)) != cudaSuccess ||
        (e = cudaStreamWaitEvent(down, events[2 * k + 1], 0)) !=
            cudaSuccess ||
        (e = cudaMemcpyAsync(pinned_out + lo, dev_out + lo, bytes,
                             cudaMemcpyDeviceToHost, down)) != cudaSuccess)
      return e;
  }
  return cudaEventRecord(done, down);
}

}  // namespace

// x, out: (n,) on the device; carry: one value of the same type folded in
// front of x, or null; state: 16 + 16 * state_tiles zeroed bytes, 16-byte
// aligned, which the kernel leaves zeroed (state_tiles >= ceil(n / 8192)
// for int32, ceil(n / 4096) for int64).
#define SCAN_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* x, void* out, const void* carry,          \
                      void* state, long long state_tiles, long long n,       \
                      void* stream) {                                        \
    return static_cast<int>(launch<T>(                                       \
        static_cast<const T*>(x), static_cast<T*>(out),                      \
        static_cast<const T*>(carry), state, state_tiles, n,                 \
        static_cast<cudaStream_t>(stream)));                                 \
  }

SCAN_ENTRY(running_max_i64, long long)
SCAN_ENTRY(running_max_i32, int)

// pinned_in, pinned_out: n values of pinned host memory; dev_in, dev_out:
// n values on the device; events: 2 * ceil(n / chunk) events and `done`,
// all without timing; the scans' state as above, for `scan`'s stream.
#define TRIP_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* pinned_in, void* dev_in, void* dev_out,    \
                      void* pinned_out, void* state, long long state_tiles,   \
                      long long n, long long chunk, void* up, void* scan,     \
                      void* down, void* const* events, void* done,            \
                      int* launches) {                                        \
    return static_cast<int>(round_trip<T>(                                   \
        static_cast<const T*>(pinned_in), static_cast<T*>(dev_in),            \
        static_cast<T*>(dev_out), static_cast<T*>(pinned_out), state,         \
        state_tiles, n, chunk, static_cast<cudaStream_t>(up),                 \
        static_cast<cudaStream_t>(scan), static_cast<cudaStream_t>(down),     \
        reinterpret_cast<cudaEvent_t*>(const_cast<void**>(events)),           \
        static_cast<cudaEvent_t>(done), launches));                           \
  }

TRIP_ENTRY(running_max_round_trip_i64, long long)
TRIP_ENTRY(running_max_round_trip_i32, int)
