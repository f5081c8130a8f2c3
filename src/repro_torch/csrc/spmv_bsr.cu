// Block-sparse-row SpMV for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel `spmv_bsr` (src/repro/kernels/spmv.py,
// body `_spmv_kernel`).  There, scalar-prefetched block-column ids drive
// the DMA of each x tile along a sequential (row, slot) grid, with an
// fp32 VMEM accumulator: the paper's index fetch -> gather -> FMA
// pipeline, its FIFO the double-buffered VMEM slot.
//
// Bound on the card: memory.  Every stored block is read once —
// nbr*nnz*bm*bk*4 bytes (64 MiB at Table-I size, ~20 us at 3.35 TB/s) —
// for 2 flops per value (33.5 MFLOP).  Reaching the HBM rate takes tens
// of KB in flight on every SM, which scalar loads walking one slot after
// another do not give.  On an H100 a ring of 1-D bulk copies streams 64
// MiB at ~2.8 TB/s in 16-32 KB copies and ~2.55 TB/s in 4 KB ones
// (scripts/bulk_copy_bandwidth.py), hence stages of several blocks.
//
// Two designs; the wrapper (kernels/spmv.py, `spmv_route`) picks one
// before the launch.
//
// The bulk-copy ring (bk a multiple of 4, 16-byte-aligned values and x,
// two stages fit in shared memory): the template on the card.
//  * The grid is persistent, two blocks per SM, each walking block rows
//    blockIdx.x + k*gridDim.x.
//  * One producer warp is the access stage: it reads the row's column ids
//    from device memory 32 at a time (any nnz), skips -1 slots outright
//    and clamps ids past the last block column to it, as the reference's
//    indexing does.  Its lane 0 packs the valid slots of a row into stages of
//    up to ~16 KB of value blocks (4 blocks at Table-I size) and fills
//    each by 1-D bulk copies (cp.async.bulk) — one copy for a run of
//    consecutive slots, whose blocks are contiguous, and one for a run of
//    consecutive block columns' x tiles — into a ring of ~64 KB in shared
//    memory, the bounded FIFO, each stage completed on its "full"
//    mbarrier.  Two blocks keep ~128 KB in flight per SM, and the ring
//    runs on across block rows: the next row's loads overlap this row's
//    reduction and store.
//  * Eight consumer warps are the execute stage: warp w owns the tile's
//    rows w, w+8, ... (any bm), reads 16 bytes a lane of each value row
//    and x tile of the stage from shared memory, adds into its lane's
//    fp32 sum of the row in shared memory, and releases the stage on its
//    "empty" mbarrier.  The stage that ends a block row (the producer
//    holds a full stage back until it knows) makes them fold each row's
//    lane sums with shuffles and write y; a row with no valid slot gets
//    a stage without blocks, and writes zeros.
//
// Scalar loads (every other shape): one block per block row, up to 32
// warps; warp w owns rows w, w+32, ... and walks the row's slots,
// reading each slot's id from device memory, skipping -1 and clamping
// ids past the last block column as the ring does, its lanes
// striding over bk with 4-byte loads; a shuffle reduction, then lane 0
// writes y.
//
// Neither design limits bm or nnz.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kConsumers = 8;                      // consumer warps
constexpr int kRingThreads = 32 * (kConsumers + 1);
constexpr int kBlocksPerSm = 2;
constexpr int kStageTarget = 16 * 1024;  // value bytes a stage aims at
constexpr int kMaxSlots = 32;            // slots a stage may carry
constexpr int kRingBytes = 64 * 1024;    // ring of one block
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 227 * 1024;     // a block's limit

// flags of a ring stage
constexpr int kLast = 1;  // the last stage of its block row
constexpr int kStop = 2;  // no block row left

struct RingLayout {
  int slots, tile, stage, stages, ring, bytes;  // ring: offset of stage 0
};

__host__ __device__ inline RingLayout ring_layout(int bm, int bk) {
  RingLayout l;
  l.tile = 4 * bm * bk;  // one value block
  l.slots = kStageTarget / l.tile;
  l.slots = l.slots < 1 ? 1 : (l.slots > kMaxSlots ? kMaxSlots : l.slots);
  l.stage = l.slots * (l.tile + 4 * bk);  // the blocks, then their x tiles
  l.stages = kRingBytes / l.stage;
  l.stages = l.stages < 2 ? 2 : (l.stages > kMaxStages ? kMaxStages
                                                       : l.stages);
  // full[], empty[] (8 B each), meta[] (int4), 32 lane sums a row
  l.ring = (32 * l.stages + 128 * bm + 127) / 128 * 128;
  l.bytes = l.ring + l.stages * l.stage;
  return l;
}

// Bulk-copy `bytes` into the stage of `bar`, raising the bytes its phase
// waits for (the stage's arrival comes when the producer closes it).
__device__ __forceinline__ void stage_copy(uint32_t dst, const void* src,
                                           uint32_t bytes, uint32_t bar) {
  mbar_expect_tx(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The producer's lane 0: fills stages of up to L.slots slots of one block
// row, merging consecutive slots into one bulk copy of their value blocks
// and consecutive block columns into one copy of their x tiles.
struct Producer {
  const float* values;
  const float* x;
  uint64_t* full;
  uint64_t* empty;
  int4* meta;
  unsigned char* ring;
  RingLayout L;
  int nnz, bk;
  int stage = 0, cnt = -1;  // the open stage and its slots (-1: none open)
  uint32_t phase = 0;
  int vslot = 0, vpos = 0, vn = 0;  // pending run of value blocks
  int xcol = 0, xpos = 0, xn = 0;   // pending run of x tiles

  __device__ __forceinline__ uint32_t bar() const {
    return smem_u32(&full[stage]);
  }
  __device__ __forceinline__ unsigned char* buf() const {
    return ring + stage * L.stage;
  }
  __device__ __forceinline__ void open() {
    mbar_wait(smem_u32(&empty[stage]), phase ^ 1u);  // first pass: at once
    cnt = 0;
  }
  __device__ __forceinline__ void flush_values(int row) {
    if (vn > 0)
      stage_copy(smem_u32(buf() + vpos * L.tile),
                values + (static_cast<size_t>(row) * nnz + vslot) *
                             (L.tile / 4),
                vn * L.tile, bar());
    vn = 0;
  }
  __device__ __forceinline__ void flush_x() {
    if (xn > 0)
      stage_copy(smem_u32(buf() + L.slots * L.tile + xpos * 4 * bk),
                x + static_cast<size_t>(xcol) * bk, xn * 4 * bk, bar());
    xn = 0;
  }
  // publish the open stage (cnt slots, maybe none) and move to the next
  __device__ __forceinline__ void close(int row, int flags) {
    flush_values(row);
    flush_x();
    meta[stage] = make_int4(row, flags, cnt, 0);
    mbar_arrive(bar());
    if (++stage == L.stages) {
      stage = 0;
      phase ^= 1u;
    }
    cnt = -1;
  }
  __device__ __forceinline__ void add(int row, int slot, int col) {
    if (cnt == L.slots) close(row, 0);  // full, and not the row's last
    if (cnt < 0) open();
    if (vn > 0 && slot == vslot + vn) {
      ++vn;
    } else {
      flush_values(row);
      vslot = slot, vpos = cnt, vn = 1;
    }
    if (xn > 0 && col == xcol + xn) {
      ++xn;
    } else {
      flush_x();
      xcol = col, xpos = cnt, xn = 1;
    }
    ++cnt;
  }
};

__global__ void __launch_bounds__(kRingThreads)
spmv_ring_kernel(const float* __restrict__ values,
                 const int* __restrict__ col_ids, const float* __restrict__ x,
                 float* __restrict__ y, int nbr, int nnz, int bm, int bk,
                 int nbc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RingLayout L = ring_layout(bm, bk);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + L.stages;
  int4* meta = reinterpret_cast<int4*>(empty + L.stages);  // row, flags, n
  float* sums = reinterpret_cast<float*>(meta + L.stages);  // [bm][32]
  unsigned char* ring = smem + L.ring;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);            // the producer's close
      mbar_init(smem_u32(&empty[s]), kConsumers);  // lane 0 of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < 32 * bm; i += blockDim.x) sums[i] = 0.f;
  __syncthreads();

  if (warp == kConsumers) {
    // -- access stage: the index stream drives the bulk copies ------------
    Producer p{values, x, full, empty, meta, ring, L, nnz, bk};
    for (int br = blockIdx.x; br < nbr; br += gridDim.x) {
      const int* ids = col_ids + static_cast<size_t>(br) * nnz;
      for (int j0 = 0; j0 < nnz; j0 += 32) {
        const int id = j0 + lane < nnz ? ids[j0 + lane] : -1;
        const int c = min(id, nbc - 1);  // past the last column: the last
        unsigned valid = __ballot_sync(kFull, id >= 0);
        while (valid) {
          const int src = __ffs(valid) - 1;
          valid &= valid - 1;
          const int col = __shfl_sync(kFull, c, src);
          if (lane == 0) p.add(br, j0 + src, col);
        }
      }
      if (lane == 0) {
        if (p.cnt < 0) p.open();  // no valid slot: an empty stage, zeros
        p.close(br, kLast);
      }
      __syncwarp();
    }
    if (lane == 0) {
      p.open();
      p.close(-1, kStop);
    }
  } else {
    // -- execute stage: eight warps, one per tile row (looping past 8) ----
    const int bk4 = bk / 4;
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(smem_u32(&full[stage]), phase);
      const int4 m = meta[stage];
      if (m.y & kStop) break;
      const unsigned char* buf = ring + stage * L.stage;
      const float4* xs =
          reinterpret_cast<const float4*>(buf + L.slots * L.tile);
      for (int r = warp; r < bm; r += kConsumers) {
        float acc = 0.f;
        for (int s = 0; s < m.z; ++s) {
          const float4* vr =
              reinterpret_cast<const float4*>(buf + s * L.tile) + r * bk4;
          const float4* xt = xs + s * bk4;
#pragma unroll 1
          for (int k = lane; k < bk4; k += 32) {
            const float4 a = vr[k], b = xt[k];
            acc = fmaf(a.x, b.x, acc);
            acc = fmaf(a.y, b.y, acc);
            acc = fmaf(a.z, b.z, acc);
            acc = fmaf(a.w, b.w, acc);
          }
        }
        sums[32 * r + lane] += acc;  // the lane's own sum of row r
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
      if (m.y & kLast) {
        // the row's lanes folded once per block row
        for (int r = warp; r < bm; r += kConsumers) {
          const float v = warp_sum(sums[32 * r + lane]);
          sums[32 * r + lane] = 0.f;
          if (lane == 0) y[static_cast<size_t>(m.x) * bm + r] = v;
        }
      }
      if (++stage == L.stages) {
        stage = 0;
        phase ^= 1u;
      }
    }
  }
}

__global__ void spmv_scalar_kernel(const float* __restrict__ values,
                                   const int* __restrict__ col_ids,
                                   const float* __restrict__ x,
                                   float* __restrict__ y, int nnz, int bm,
                                   int bk, int nbc) {
  const int br = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const size_t tile = static_cast<size_t>(bm) * bk;
  const int* ids = col_ids + static_cast<size_t>(br) * nnz;
  for (int r = warp; r < bm; r += warps) {
    const float* row_vals = values + static_cast<size_t>(br) * nnz * tile +
                            static_cast<size_t>(r) * bk;
    float acc = 0.f;
    for (int j = 0; j < nnz; ++j) {
      int c = __ldg(ids + j);
      if (c < 0) continue;  // padding slot: contributes nothing
      c = min(c, nbc - 1);
      const float* v = row_vals + j * tile;
      const float* xt = x + static_cast<size_t>(c) * bk;
      for (int k = lane; k < bk; k += 32) acc = fmaf(v[k], xt[k], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) y[static_cast<size_t>(br) * bm + r] = acc;
  }
}

}  // namespace

// values (nbr, nnz, bm, bk) f32, col_ids (nbr, nnz) int32 (-1 = padding;
// ids >= nbc read the last x tile), x (K,) f32 with K = nbc * bk, nbc >= 1,
// y (nbr * bm,) f32; contiguous.

// The bulk-copy ring: bk % 4 == 0, values and x 16-byte aligned, and a
// ring of two stages within a block's shared memory.
extern "C" int spmv_bsr_ring_f32(const void* values, const void* col_ids,
                                 const void* x, void* y, int nbr, int nnz,
                                 int bm, int bk, int nbc, void* stream) {
  if (nbr <= 0 || bm <= 0) return 0;
  const RingLayout L = ring_layout(bm, bk);
  if (bk <= 0 || bk % 4 != 0 || nbc <= 0 || L.bytes > kMaxSmem ||
      reinterpret_cast<uintptr_t>(values) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the opt-in to more than 48 KB of shared memory, once per device
  static unsigned ready = 0;
  if (dev < 32 && !(ready >> dev & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        spmv_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready |= 1u << dev;
  }
  const int grid = nbr < kBlocksPerSm * sms ? nbr : kBlocksPerSm * sms;
  spmv_ring_kernel<<<grid, kRingThreads, L.bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(col_ids),
      static_cast<const float*>(x), static_cast<float*>(y), nbr, nnz, bm,
      bk, nbc);
  return static_cast<int>(cudaGetLastError());
}

// Scalar loads: any bm, bk and alignment.
extern "C" int spmv_bsr_f32(const void* values, const void* col_ids,
                            const void* x, void* y, int nbr, int nnz,
                            int bm, int bk, int nbc, void* stream) {
  if (nbr <= 0 || bm <= 0) return 0;
  if (nbc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = bm < 32 ? bm : 32;
  spmv_scalar_kernel<<<nbr, 32 * warps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(col_ids),
      static_cast<const float*>(x), static_cast<float*>(y), nnz, bm, bk,
      nbc);
  return static_cast<int>(cudaGetLastError());
}
