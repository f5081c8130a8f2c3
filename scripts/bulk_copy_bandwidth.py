#!/usr/bin/env python3
"""How fast 1-D bulk copies (``cp.async.bulk``) stream device memory into
shared memory on one NVIDIA Hopper GPU, against plain 16-byte loads.

    python3 scripts/bulk_copy_bandwidth.py

A ring kernel streams 64 MiB through an mbarrier-guarded ring of shared
memory, as the port's SpMV ring does (a producer lane issues one bulk copy
per stage; eight consumer warps read each stage once and release it),
for copy sizes of 4-32 KB, ring sizes of 48 and 96 KB and one, two or four
blocks per SM; a plain kernel reads the same bytes with 16-byte loads.
Each time is the median of 20 replays of a CUDA graph of 10 launches.
Prints one JSON line per configuration and the card's name and power
limit: the ceiling a streaming kernel of the port can aim at on this card.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

NBYTES = 64 << 20

SOURCE = r"""
#include <cuda_runtime.h>
#include "hopper.cuh"

// nbytes in copies of `chunk` bytes through a ring of `stages`; the last
// warp's lane 0 issues, the others read each stage once and release it
__global__ void ring_read(const char* src, long long nbytes, int chunk,
                          int stages, float* out) {
  extern __shared__ __align__(128) unsigned char sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + stages;
  unsigned char* ring = sm + 256;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = blockDim.x / 32 - 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), nc);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long n = nbytes / chunk;
  int st = 0;
  uint32_t ph = 0;
  float acc = 0.f;
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    if (warp == nc) {
      if (lane == 0) {
        mbar_wait(smem_u32(&empty[st]), ph ^ 1u);
        mbar_arrive_expect_tx(smem_u32(&full[st]), chunk);
        bulk_copy(smem_u32(ring + st * chunk), src + i * chunk, chunk,
                  smem_u32(&full[st]));
      }
    } else {
      mbar_wait(smem_u32(&full[st]), ph);
      const float4* p = reinterpret_cast<const float4*>(ring + st * chunk);
      for (int k = threadIdx.x; k < chunk / 16; k += 32 * nc) {
        const float4 v = p[k];
        acc += v.x + v.y + v.z + v.w;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[st]));
    }
    if (++st == stages) {
      st = 0;
      ph ^= 1u;
    }
  }
  if (acc == 123.f) out[0] = acc;  // keeps the reads
}

__global__ void plain_read(const float4* src, long long n4, float* out) {
  float acc = 0.f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const float4 v = __ldg(src + i);
    acc += v.x + v.y + v.z + v.w;
  }
  if (acc == 123.f) out[0] = acc;
}

extern "C" int run_ring(const void* src, long long nbytes, int chunk,
                        int stages, int blocks, void* out, void* stream) {
  cudaFuncSetAttribute(ring_read,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       227 * 1024);
  ring_read<<<blocks, 32 * 9, 256 + stages * chunk, (cudaStream_t)stream>>>(
      (const char*)src, nbytes, chunk, stages, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int run_plain(const void* src, long long nbytes, int blocks,
                         int threads, void* out, void* stream) {
  plain_read<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)src, nbytes / 16, (float*)out);
  return (int)cudaGetLastError();
}
"""


def graph_ms(fn, reps: int = 20, per_graph: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from repro_torch.kernels import _lib
    out_dir = os.path.join(ROOT, "build", "bulk_copy_bandwidth")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = (os.path.join(out_dir, n) for n in ("bw.cu", "libbw.so"))
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC),
                    "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.run_ring.argtypes = [P, L, I, I, I, P, P]
    lib.run_plain.argtypes = [P, L, I, I, P, P]
    dev = torch.device("cuda")
    data = torch.empty(NBYTES, dtype=torch.uint8, device=dev)
    sink = torch.zeros(4, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def stream():  # the current stream, the graph's own while capturing
        return torch.cuda.current_stream().cuda_stream

    def report(kind, ms, **cfg):
        print(json.dumps({"kind": kind, **cfg, "ms": ms,
                          "tb_per_s": NBYTES / ms / 1e9}), flush=True)

    for per_sm in (1, 2, 4):
        for threads in (256, 512):
            report("plain 16-byte loads", graph_ms(lambda: lib.run_plain(
                data.data_ptr(), NBYTES, per_sm * sms, threads,
                sink.data_ptr(), stream())), blocks_per_sm=per_sm,
                threads=threads)
    for chunk in (4096, 8192, 16384, 32768):
        for ring in (48 << 10, 96 << 10):
            stages = max(2, min(16, ring // chunk))
            for per_sm in (1, 2, 4):
                if per_sm * (stages * chunk + 256) > 227 << 10:
                    continue
                report("bulk-copy ring", graph_ms(lambda: lib.run_ring(
                    data.data_ptr(), NBYTES, chunk, stages, per_sm * sms,
                    sink.data_ptr(), stream())), copy_bytes=chunk,
                    stages=stages, blocks_per_sm=per_sm)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
