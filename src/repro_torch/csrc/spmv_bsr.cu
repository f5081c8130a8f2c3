// Block-sparse-row SpMV for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel `spmv_bsr` (src/repro/kernels/spmv.py,
// body `_spmv_kernel`).  There, scalar-prefetched block-column ids drive
// the DMA of each x tile along a sequential (row, slot) grid, with an
// fp32 VMEM accumulator.  Here:
//
//  * one thread block per block row; the grid runs in any order, and
//    nothing is carried between blocks;
//  * the block loads its own row of col_ids into shared memory (in place
//    of scalar prefetch) and skips padding slots (id -1) outright;
//  * warp w owns row w of the (bm, bk) tile: for every valid slot its
//    lanes stride over bk, multiplying values[br, slot, w, :] by the
//    gathered x tile and accumulating in fp32 registers;
//  * a warp-shuffle reduction folds the lanes, and lane 0 writes y once.
//
// Bound on the card: memory.  Every stored block is read once —
// nbr*nnz*bm*bk*4 bytes (64 MiB at Table-I size, ~20 us at 3.35 TB/s) —
// for 2 flops per value (33.5 MFLOP).  The design reads each values row
// as one contiguous 512-byte run per warp (coalesced), and x tiles hit
// in L1/L2.  Overlapping the slot loads (cp.async / TMA ring) is a later
// optimisation.

#include <cuda_runtime.h>

namespace {

__global__ void spmv_bsr_kernel(const float* __restrict__ values,
                                const int* __restrict__ col_ids,
                                const float* __restrict__ x,
                                float* __restrict__ y,
                                int nnz, int bm, int bk) {
  extern __shared__ int s_cols[];
  const int br = blockIdx.x;
  for (int j = threadIdx.x; j < nnz; j += blockDim.x) {
    s_cols[j] = col_ids[(long long)br * nnz + j];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;  // the block has exactly bm warps
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  const long long tile = (long long)bm * bk;
  const float* row_vals = values + (long long)br * nnz * tile
                          + (long long)warp * bk;
  for (int j = 0; j < nnz; ++j) {
    const int c = s_cols[j];
    if (c < 0) continue;  // padding slot: contributes nothing
    const float* v = row_vals + (long long)j * tile;
    const float* xt = x + (long long)c * bk;
    for (int k = lane; k < bk; k += 32) {
      acc = fmaf(v[k], xt[k], acc);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) y[(long long)br * bm + warp] = acc;
}

}  // namespace

// values (nbr, nnz, bm, bk) f32, col_ids (nbr, nnz) int32 (-1 = padding),
// x (K,) f32 with K = n_block_cols * bk, y (nbr * bm,) f32.  bm <= 32.
extern "C" int spmv_bsr_f32(const void* values, const void* col_ids,
                            const void* x, void* y, int nbr, int nnz,
                            int bm, int bk, void* stream) {
  if (nbr <= 0) return 0;
  const dim3 block(32 * bm);
  const size_t smem = sizeof(int) * (size_t)(nnz > 0 ? nnz : 1);
  spmv_bsr_kernel<<<nbr, block, smem, (cudaStream_t)stream>>>(
      (const float*)values, (const int*)col_ids, (const float*)x, (float*)y,
      nnz, bm, bk);
  return (int)cudaGetLastError();
}
