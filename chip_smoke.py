#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:  ``python3 chip_smoke.py``

Phases, one line (or block) each:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (one ``nvcc`` per ``src/repro_torch/csrc/*.cu``, all at once), then the
   instructions the Hopper designs compile to: ``cuobjdump -sass`` (beside
   ``nvcc``) must find ``HGMMA`` in ``dataflow_matmul``'s library (its
   wgmma route), ``HMMA`` in ``flash_attention``'s (its bf16 prefill) and
   the bulk copy ``UBLKCP`` in ``spmv_bsr``'s, ``flash_attention``'s and
   ``decoupled_gather``'s (the SpMV ring, the decode ring and the gather
   ring); without ``cuobjdump`` it prints "SASS not checked";
2. each CUDA kernel against its plain PyTorch version on the card, at the
   main path's shapes (kernel times are CUDA-graph replays, so the
   host's enqueue time is left out) — ``spmv_bsr`` on the Table-I BSR matrix
   (512, 32, 8, 128), which must take the bulk-copy ring
   (``spmv_route``), within rtol=atol=1e-4 (fp32 sums in another order),
   ``running_max`` bit for bit at 2^20 and odd sizes, int32 and int64,
   values above 2^31, one kernel launch per call — with median CUDA-event
   times of the kernel, the plain version and one PyTorch library call
   (``torch.mv`` on the dense matrix, ``torch.cummax``); then the
   engine's chunked host round trip at 2^20 int32, bit for bit, on the
   host clock, and one round trip under ``torch.profiler`` split into its
   uploads, scans and downloads on the card;
3. the main path: Table-I SpMV (dim 4096, density 0.25) built on the
   card, ``compile(..., loop=True)``, ``report()`` (5 stages), the
   ``sequential`` and ``emulated`` backends over the first row's
   nonzeros against the plain loop, and ``ops.spmv`` on the whole matrix
   against a float64 dense product on the host (rtol=atol=1e-4); every
   ``spmv_bsr`` launch of phases 3-4 on the bulk-copy ring;
3b. the other Table-I bodies at Table-I size on the card — knapsack (W
   3200, N 200), Floyd–Warshall (n 1024), DFS (4000 x 200) — each
   compiled in loop mode to the reference's recorded plan (nodes, stages,
   channels, bytes per token, II, latency, ops per stage) and simulator
   stages (II, latency, memory-in-SCC, trace regions), then run by the
   ``sequential`` and ``emulated`` backends bit for bit the plain loop
   body over a window: knapsack's item row 0 (3,201 steps, also against
   numpy), Floyd–Warshall's first 1,024 steps (k = i = 0, also against
   numpy), DFS's first 1,000 steps; then ``at_set`` and its lowered
   scatter on indices past both ends, eagerly and on both backends: a
   negative index wraps once, one still out of range drops the write;
4. Fig. 5, SpMV, ACP: the dataflow and conventional machines simulated
   over all 4,194,304 iterations with the ``torch`` engine (the solver's
   running max on the card), again with the ``numpy`` engine; the cycles
   must be identical and equal the reference's recorded
   16,517,754 / 318,747,791;
4b. the Fig. 5 grid through the port's harness
   (``repro_torch.workloads.fig5.run_all``, in this process) on the
   ``torch`` engine with the resolution cache off: SpMV, knapsack and DFS
   at all their Table-I iterations, Floyd–Warshall at its first 2^22 of
   2^30 (the whole of it takes over 20 minutes of host time), each on
   ACP, ACP+64KB, HP and HP+64KB through the dataflow and conventional
   machines and the processor baseline; the 36 cycle counts must equal
   the reference's recorded grid (``REF_FIG5``).  Per cell df/base,
   conv/base and df/conv; per kernel the wall, its tasks' walls, the
   engine's phase walls and the ``running_max`` launches (at least one
   per kernel); then each kernel's best dataflow vs best conventional
   gain;
5. the attention kernels against their plain versions on the card, at
   the serving path's shapes in bf16 (rtol=atol=2e-2, the bf16 tolerance
   of tests/test_kernels.py) and once in fp32 (rtol=atol=1e-4) —
   ``flash_attention`` causal on q (8, 9, 512, 64) and k/v (8, 3, 512,
   64), ``decode_attention`` on q (8, 9, 64) against (8, 3, 552, 64)
   caches at length 513 and at ragged lengths, in clusters of
   ``decode_split(8, 3, 552, SMs)`` CTAs — with median CUDA-event times of
   the kernel, the plain version and ``F.scaled_dot_product_attention``
   (GQA, causal or length-masked);
6. the serving path: SmolLM-135M at full width (30 layers, d_model 576,
   random weights from seed 0), 8 requests of 512 tokens, 32 new tokens
   each.  (a) In fp32, ``attn_impl="pallas"`` against ``"full"``: the
   greedy tokens identical and the prefill logits within rtol=atol=1e-3.
   (b) In the published bf16, the kernels' path timed on the host clock
   (prefill s, decode ms/token, tok/s) and held against the bf16
   ``"full"`` path: max |Δ prefill logits| within the larger of
   2e-2·max|logits| and the bf16 plain path's own max |Δ| to the fp32
   logits of (a) (30 bf16 layers amplify a one-ulp difference in one
   attention output to about 2 % of max|logits|); every prefill launch
   of the served batch must take the tensor-core route (``mma.sync``,
   counted by the wrapper in ``_lib.ROUTES``) and every decode launch the
   cluster split of phase 5; the share of greedy tokens that agree is
   printed, and one decode step is traced with ``torch.profiler``: its
   device busy time over the untraced step's host time is the device's
   busy share, and its ``decode_attention`` kernels' time is printed; one
   prefill is traced too, for its device busy time and its attention
   kernels' share of it;
7. the kernel API at SmolLM-135M's full width, on phase 6's bf16 model
   (seed 0) and prompt tokens.  Driven once with the launch counts set
   to 0: ``decoupled_gather`` of the 4,096 tokens' rows of the embedding
   table with the default ``fn`` (tanh(2*row)), ``ops.rmsnorm`` with
   layer 0's norm weight on the (8, 512, 576) embeddings ``table[tokens]``,
   and ``ops.matmul`` of the normed (4096, 576) rows with layer 0's MLP
   input weight (576 x 1536), then of that (4096, 1536) product with the
   output weight (1536 x 576).  Then each kernel against its plain
   version: ``decoupled_gather`` rtol 2**-7 / atol 0 in bf16 (one bf16
   ulp: both sides compute tanh in fp32 and round once) and 1e-6 in fp32,
   with ``fn="identity"`` bit for bit ``table[idx]`` and, on indices past
   both ends of the table, bit for bit its wrapped-and-clamped rows (the
   path's gather must take the bulk-copy ring, ``gather_route``);
   ``rmsnorm`` 2e-2 bf16, 1e-5 fp32; both products rtol 1e-2 / atol 5e-2 in bf16 (one
   rounding of fp32 sums taken in another order) and 2e-5 / 3e-4 in
   fp32 (tests/test_kernels.py's); both bf16 products of the path must
   take the ``wgmma+tma`` route.  ``decoupled_gather_staged``
   on the same indices and table with the ``sequential`` and
   ``emulated`` backends, bit for bit the plain version, its report
   printed (3 stages, 2 channels required); the quickstart kernel
   (``examples/quickstart.py``) through ``dataflow_jit(stream_argnums=
   (1,))`` on the card: its plan equal to the reference's recorded one
   (4 stages, 3 channels, 96 B/token, II 1, latency 15), the
   ``sequential``, ``emulated`` and ``eager`` backends and a 6-microbatch
   ``stream`` equal to the direct calls.  Kernel, plain version and
   library times (``torch.matmul``, ``F.rms_norm``; none computes the
   gather, whose floor ``torch.index_select`` is printed), each product
   also in fp32 (the CUDA-core route) and at every tile width the wgmma
   route chooses among; the matmul's row in the kernels line sums the
   path's two products;
8. one JSON line listing every kernel with its launches on its main path
   (phases 3-4b for the SpMV kernels, run (b) of phase 6 for attention,
   phase 7 for the kernel API), the design those launches took, its error
   against the plain version, its times and its bound; then the
   ``nvidia-smi`` line; then the result line.

Any failed phase exits non-zero before the result line.  Without a CUDA
device, or outside the repository, the script exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM data-sheet peaks: HBM rate, the float32 rate outside the
#: tensor cores, and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12

#: the serving phase: smollm-135m, 8 requests of 512 tokens, 32 new each
SERVE_BATCH, PROMPT_LEN, GEN = 8, 512, 32
MAX_LEN = PROMPT_LEN + GEN + 8

#: one bf16 unit in the last place, relative: the bound on a kernel's bf16
#: result against its plain version when both compute in fp32 and round once
BF16_ULP = 2 ** -7

#: the reference's plan of the quickstart kernel on table f32[1024], idx
#: i32[8], w f32[] (repro.dataflow.compile on the CPU): stages, channels,
#: channel bytes per token, pipeline II, total latency
REF_QUICKSTART_PLAN = (4, 3, 96, 1, 15)

#: the running max's previous design on an NVIDIA H100 80GB HBM3 at
#: 700.00 W (PERF.md §6): three kernel passes at 2^20 int32, and the
#: engine's pageable copies up and down, host clock
PARENT_RMAX_MS, PARENT_H2D_MS, PARENT_D2H_MS = 0.0091, 0.483, 0.461

#: the reference's recorded Fig. 5 SpMV cells on ACP (BENCH_sim.json)
REF_DATAFLOW_CYCLES = 16_517_754
REF_CONVENTIONAL_CYCLES = 318_747_791
FIFO_DEPTH = 256
MAX_OUTSTANDING = 16

#: the reference's plans of the other Table-I bodies
#: (repro.dataflow.compile(..., loop=True, nonaliasing_carries=...), jax
#: 0.9.0, on the CPU; held against the reference by
#: tests/test_torch_fig5.py::test_chip_smoke_plans_are_the_reference):
#: nodes, stages, channels, bytes per token, pipeline II, total latency,
#: ops per stage; then each simulator stage's (II, latency,
#: memory-in-SCC, trace regions)
REF_TABLE1_PLANS = {
    "knapsack": ((35, 6, 11, 36, 1, 41, [4, 5, 6, 5, 7, 8]),
                 [(1, 5, False, ["dp_load"]), (1, 6, False, ["dp_load2"]),
                  (1, 7, False, ["dp_store"]), (1, 6, False, []),
                  (1, 8, False, []), (1, 9, False, [])]),
    "floyd_warshall": ((30, 8, 13, 40, 1, 46, [1, 5, 2, 5, 2, 5, 4, 6]),
                       [(1, 4, False, []), (1, 6, False, ["d_ij"]),
                        (1, 5, False, []), (1, 6, False, ["d_ik"]),
                        (1, 5, False, []), (1, 6, False, ["d_kj"]),
                        (1, 7, False, []), (1, 7, False, ["d_store"])]),
    "dfs": ((30, 1, 0, 0, 38, 38, [30]),
            [(38, 38, True, ["stack", "adj", "visited"])]),
}

#: the reference's Fig. 5 grid (benchmarks/paper_fig5.py, numpy engine,
#: jax 0.9.0, rescache off; FIFO 256, 16 outstanding requests; held
#: against the reference by
#: tests/test_torch_fig5.py::test_chip_smoke_cycles_are_the_reference): per
#: kernel the simulated iterations, then (dataflow, conventional) cycles
#: on ACP, ACP+64KB, HP, HP+64KB, then the processor baseline's cycles.
#: Floyd–Warshall is its first 2^22 of 2^30 iterations.
FIG5_MEMS = ("ACP", "ACP+64KB", "HP", "HP+64KB")
REF_FIG5 = {
    "spmv": (4_194_304, ((16_517_754, 318_747_791), (4_196_075, 34_614_417),
                         (20_902_216, 432_013_335), (4_196_580, 47_824_056)),
             55_472_158),
    "knapsack": (640_000, ((640_807, 32_627_621), (640_798, 649_631),
                           (640_976, 44_160_041), (640_976, 653_274)),
                 6_800_030),
    "floyd_warshall": (1 << 22, ((4_206_778, 318_735_634),
                                 (4_206_548, 16_248_450),
                                 (4_210_939, 432_013_358),
                                 (4_210_845, 21_483_182)), 47_174_400),
    "dfs": (800_000, ((152_820_165, 90_410_178), (66_229_666, 43_236_008),
                      (198_399_790, 112_000_038), (76_817_296, 48_808_791)),
            14_021_984),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAILED: {msg}", flush=True)
        sys.exit(1)


def cuda_ms(fn, reps: int = 20, per_graph: int = 10) -> float:
    """Median device time of one call of ``fn`` in ms: ``per_graph`` calls
    captured in a CUDA graph, the graph replayed ``reps`` times between
    CUDA events.  Replaying leaves the host's enqueue time out, which
    exceeds the device time of a small kernel."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                       # warm-up
            fn()
    torch.cuda.current_stream().wait_stream(side)
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
    del graph
    return statistics.median(times)


def profiled(fn, name: str, kernel: str = "") -> dict:
    """One call of ``fn`` under ``torch.profiler``, in ms: ``busy``, the
    union of the kernel, memcpy and memset spans of its trace (None where
    the trace holds no device span); ``wall``, the host clock, which
    includes the profiler's own cost; ``named``, the summed spans of the
    kernels whose name holds ``kernel``; ``kernels``, ``h2d`` and ``d2h``,
    the summed spans of all kernels and of the copies each way.  The trace
    goes to ``build/<name>_trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    path = os.path.join(ROOT, "build", f"{name}_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "dur" in e
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]

    def total(keep) -> float:
        return sum(e["dur"] for e in events if keep(e)) / 1e3

    out = {"wall": wall, "busy": None,
           "named": total(lambda e: e["cat"] == "kernel" and kernel
                          and kernel in e.get("name", "")),
           "kernels": total(lambda e: e["cat"] == "kernel"),
           "h2d": total(lambda e: "HtoD" in e.get("name", "")),
           "d2h": total(lambda e: "DtoH" in e.get("name", ""))}
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    if events:
        out["busy"] = busy / 1e3
    return out


def host_ms(fn, reps: int = 10) -> float:
    """Median host time of ``fn`` in ms, synchronized with the card."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> None:
    import torch
    require(torch.cuda.is_available(), "no CUDA device")
    import repro_torch
    from repro_torch import interop
    from repro_torch.core import engine
    from repro_torch.core.simulator import acp
    from repro_torch.kernels import _lib, ops, ref
    from repro_torch.kernels.scan import CHUNK, running_max
    from repro_torch.kernels.spmv import RING, csr_to_bsr, spmv_bsr, spmv_route
    from repro_torch.workloads import make_spmv

    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 yardstick
    dev = torch.device("cuda")
    repro_torch.set_device(dev)

    # -- 1. the card and the build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[1] card: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _lib.build_all()
    print(f"[1] kernels built in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(_lib.SIGNATURES)})", flush=True)
    print(f"[1] {check_sass()}", flush=True)

    # -- the Table-I workload on the card ------------------------------------
    t0 = time.perf_counter()
    w = make_spmv(1.0, device=dev)
    csr_ptr, csr_cols, csr_vals, csr_x = (
        w.data[k] for k in ("indptr", "indices", "values", "x"))
    dim = csr_x.size
    bvals, bcols = csr_to_bsr(csr_ptr, csr_cols, csr_vals, (dim, dim),
                              bm=8, bk=128)
    state = interop.spmv_state_to_torch(
        {"bsr_values": bvals, "bsr_col_ids": bcols, "x": csr_x}, dev)
    print(f"[setup] Table-I SpMV: dim {dim}, {len(csr_vals)} nonzeros, BSR "
          f"{tuple(bvals.shape)}, built in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # -- 2. each kernel against its plain version ------------------------------
    vals, cols, x = (state["bsr_values"], state["bsr_col_ids"], state["x"])
    nbr, nnz, bm, bk = vals.shape
    spmv_design = spmv_route(vals, x)
    require(spmv_design == RING, f"the Table-I matrix takes {spmv_design}, "
            f"not the bulk-copy ring")
    y_k = spmv_bsr(vals, cols, x)
    y_p = ref.spmv_bsr_ref(vals, cols, x, nbr * bm)
    torch.cuda.synchronize()
    spmv_err = float((y_k - y_p).abs().max())
    require(torch.allclose(y_k, y_p, rtol=1e-4, atol=1e-4),
            f"spmv_bsr disagrees with its plain version (max err "
            f"{spmv_err})")
    rows = np.repeat(np.arange(dim), np.diff(csr_ptr))
    dense = torch.zeros(dim, dim, device=dev)
    dense[torch.from_numpy(rows).to(dev),
          torch.from_numpy(csr_cols.astype(np.int64)).to(dev)] = \
        torch.from_numpy(csr_vals).to(dev)
    valid = int((bcols >= 0).sum())
    spmv_bytes = (valid * bm * bk * 4 + bcols.size * 4 + x.numel() * 4
                  + nbr * bm * 4)
    spmv_ops = 2 * valid * bm * bk
    spmv_row = {
        "name": "spmv_bsr", "route": "cuda", "design": spmv_design,
        "source": "src/repro_torch/csrc/spmv_bsr.cu",
        "replaces": "src/repro/kernels/spmv.py:56",
        "max_abs_err": spmv_err,
        "ms": cuda_ms(lambda: spmv_bsr(vals, cols, x)),
        "plain_ms": cuda_ms(lambda: ref.spmv_bsr_ref(vals, cols, x,
                                                      nbr * bm)),
        "library_ms": cuda_ms(lambda: torch.mv(dense, x)),
        **_bound(spmv_bytes, spmv_ops),
    }
    del dense
    print(f"[2] spmv_bsr {tuple(vals.shape)}, route {spmv_design!r}: "
          f"max|kernel-plain| "
          f"{spmv_err:.3g} (rtol=atol=1e-4), kernel {spmv_row['ms']:.4f} ms, "
          f"plain {spmv_row['plain_ms']:.4f} ms, torch.mv dense "
          f"{spmv_row['library_ms']:.4f} ms, bound {spmv_row['bound_ms']:.4f}"
          f" ms ({spmv_row['bound_by']})", flush=True)

    rng = np.random.default_rng(0)
    n_main = 1 << 20
    cases = {
        "i32 2^20 trending": (rng.integers(0, 1000, n_main)
                              - np.cumsum(rng.integers(1, 9, n_main))
                              ).astype(np.int32),
        "i32 odd 1000003": rng.integers(-(1 << 30), 1 << 30,
                                        1_000_003).astype(np.int32),
        "i64 2^20+12345 >2^31": rng.integers(-(1 << 40), 1 << 40,
                                             n_main + 12345),
        "i64 n=1": np.array([(1 << 35) + 3], dtype=np.int64),
    }
    rmax_err = 0
    for label, a in cases.items():
        t = torch.from_numpy(a).to(dev)
        before = _lib.counts()["running_max"]
        got_k = running_max(t)
        require(_lib.counts()["running_max"] - before == 1,
                f"running_max {label}: not one kernel launch per call")
        got_p = ref.running_max_ref(t)
        torch.cuda.synchronize()
        rmax_err = max(rmax_err, int((got_k.long() - got_p.long()).abs()
                                     .max()))
        require(torch.equal(got_k, got_p), f"running_max {label}: kernel "
                f"!= plain")
        require(np.array_equal(got_k.cpu().numpy(),
                               np.maximum.accumulate(a)),
                f"running_max {label}: kernel != np.maximum.accumulate")
        print(f"[2] running_max {label}: one launch, bit-identical to the "
              f"plain version and np.maximum.accumulate", flush=True)
    a_main = cases["i32 2^20 trending"]
    t_main = torch.from_numpy(a_main).to(dev)
    rmax_row = {
        "name": "running_max", "route": "cuda", "design": "look-back",
        "source": "src/repro_torch/csrc/running_max.cu",
        "replaces": "src/repro/core/engine.py:477",
        "max_abs_err": float(rmax_err),
        "ms": cuda_ms(lambda: running_max(t_main)),
        "plain_ms": cuda_ms(lambda: ref.running_max_ref(t_main)),
        "library_ms": cuda_ms(lambda: torch.cummax(t_main, 0)),
        **_bound(2 * a_main.nbytes, a_main.size),
    }
    print(f"[2] running_max i32 2^20 (look-back, one launch): kernel "
          f"{rmax_row['ms']:.4f} ms (the previous design's three passes: "
          f"{PARENT_RMAX_MS} ms, PERF.md; scripts/kernel_times.py times two "
          f"trees side by side), plain {rmax_row['plain_ms']:.4f} "
          f"ms, torch.cummax "
          f"{rmax_row['library_ms']:.4f} ms, bound {rmax_row['bound_ms']:.4f}"
          f" ms ({rmax_row['bound_by']})", flush=True)
    buf = a_main.copy()
    with engine.use("torch"):
        engine.running_max(buf)
        require(np.array_equal(buf, np.maximum.accumulate(a_main)),
                "engine round trip != np.maximum.accumulate")
        # in place and idempotent: every call repeats the same work
        trip = host_ms(lambda: engine.running_max(buf))
        p = profiled(lambda: engine.running_max(buf), "round_trip")
    print(f"[2] engine round trip, i32 2^20 in {-(-buf.size // CHUNK)} chunks "
          f"of {CHUNK}: {trip:.3f} ms on the host clock (the previous "
          f"design's pageable copies alone: H2D {PARENT_H2D_MS} + D2H "
          f"{PARENT_D2H_MS} ms, PERF.md); one under torch.profiler: "
          + ("no device spans in the trace (not measured)"
             if p["busy"] is None else f"H2D {p['h2d']:.4f} ms, scan "
             f"{p['kernels']:.4f} ms, D2H {p['d2h']:.4f} ms of device time, "
             f"{p['busy']:.4f} ms busy in all"), flush=True)

    # -- 3. the main path -----------------------------------------------------
    _lib.reset_counts()
    t0 = time.perf_counter()
    c = repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                            loop=True)
    print(f"[3] compiled in {time.perf_counter() - t0:.2f} s on {c.device}")
    print(c.report(), flush=True)
    require(c.num_stages == 5, f"expected 5 stages, got {c.num_stages}")
    require(c.device.type == "cuda", "the program did not compile for CUDA")
    lo, hi = int(csr_ptr[0]), int(csr_ptr[1])
    plain = torch.zeros((), device=dev)
    accs = {b: torch.zeros((), device=dev) for b in ("sequential", "emulated")}
    t0 = time.perf_counter()
    for j in range(lo, hi):
        jt = torch.tensor(j, dtype=torch.int32, device=dev)
        plain = w.loop_body(plain, jt)
        for b in accs:
            accs[b] = c(accs[b], jt, backend=b)
    torch.cuda.synchronize()
    for b, acc in accs.items():
        require(torch.equal(acc, plain), f"{b} backend {float(acc)} != "
                f"plain {float(plain)}")
    require(abs(float(plain) - float(w.expected[0]))
            <= 1e-4 + 1e-4 * abs(float(w.expected[0])),
            f"row 0: {float(plain)} vs CSR product {w.expected[0]}")
    print(f"[3] sequential and emulated over row 0's {hi - lo} nonzeros == "
          f"plain loop ({float(plain):.6f}; CSR row product "
          f"{w.expected[0]:.6f}) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    y = ops.spmv(vals, cols, x)[:dim].cpu().numpy()
    dense64 = np.zeros((dim, dim))
    dense64[rows, csr_cols] = csr_vals
    want = dense64 @ csr_x.astype(np.float64)
    require(np.allclose(y, want, rtol=1e-4, atol=1e-4),
            f"ops.spmv vs float64 dense: max err {np.abs(y - want).max()}")
    print(f"[3] ops.spmv on the whole matrix == float64 dense product "
          f"(max err {np.abs(y - want).max():.3g}, rtol=atol=1e-4)",
          flush=True)

    # -- 3b. the other Table-I bodies on the card ------------------------------
    table1_bodies(dev)

    # -- 4. Fig. 5, SpMV, ACP --------------------------------------------------
    mem = acp()
    mem.max_outstanding = MAX_OUTSTANDING
    traces = list(w.full_traces.values())
    n = w.n_iters_full
    reps, secs = {}, {}
    for eng in ("torch", "numpy"):
        before = _lib.counts()["running_max"]
        engine.reset_walls()
        t0 = time.perf_counter()
        reps[eng] = c.simulate(n_iters=n, traces=traces, mem=mem,
                               fifo_depth=FIFO_DEPTH, engine=eng,
                               use_rescache=False)
        secs[eng] = time.perf_counter() - t0
        walls = ", ".join(f"{k} {v:.2f} s" for k, v in
                          sorted(engine.walls().items()))
        launched = _lib.counts()["running_max"] - before
        print(f"[4] {eng:<5} engine: dataflow {reps[eng].dataflow.cycles} "
              f"cycles, conventional {reps[eng].conventional.cycles} cycles "
              f"over {n} iterations in {secs[eng]:.2f} s (phases: {walls}; "
              f"{launched} running_max launches)", flush=True)
        if eng == "torch":
            require(launched > 0, "the torch engine launched no running_max")
    for part in ("dataflow", "conventional"):
        a = getattr(reps["torch"], part)
        b = getattr(reps["numpy"], part)
        require(a.cycles == b.cycles and a.stage_stall_cycles
                == b.stage_stall_cycles,
                f"{part}: torch and numpy engines disagree")
    df, cv = reps["torch"].dataflow.cycles, reps["torch"].conventional.cycles
    print(f"[4] Fig. 5 SpMV ACP, all {n} iterations: dataflow {df} "
          f"(reference {REF_DATAFLOW_CYCLES}), conventional {cv} (reference "
          f"{REF_CONVENTIONAL_CYCLES}), speedup {cv / df:.2f}x; torch == "
          f"numpy engine", flush=True)
    require((df, cv) == (REF_DATAFLOW_CYCLES, REF_CONVENTIONAL_CYCLES),
            "Fig. 5 cycles differ from the reference's")

    # -- 4b. the Fig. 5 grid, four kernels x four memories --------------------
    fig5_grid()

    spmv_launches = _lib.counts()
    require(_lib.routes()["spmv_bsr"] == {RING: spmv_launches["spmv_bsr"]},
            f"phases 3-4b spmv_bsr launches by design: "
            f"{_lib.routes()['spmv_bsr']}, expected all on {RING}")

    # -- 5. the attention kernels against their plain versions ---------------
    fa_row, da_row = attention_kernels(dev)

    # -- 6. the serving path ----------------------------------------------------
    serve_launches, model = serve_smollm(dev)

    # -- 7. the kernel API ----------------------------------------------------
    api_rows, api_launches = kernel_api(dev, model)
    del model
    torch.cuda.empty_cache()

    # -- 8. the kernels line --------------------------------------------------
    rows = (spmv_row, rmax_row, fa_row, da_row, *api_rows)
    for row, launches in zip(rows, (spmv_launches, spmv_launches,
                                    serve_launches, serve_launches,
                                    *[api_launches] * len(api_rows))):
        row["launches"] = launches[row["name"]]
        require(row["launches"] > 0,
                f"{row['name']} was not launched on its main path")
    keys = ("name", "route", "design", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def attention_kernels(dev) -> tuple[dict, dict]:
    """Phase 5: each attention kernel against its plain version at the
    serving path's shapes; times of kernel, plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (decode_attention,
                                                    decode_design,
                                                    decode_split,
                                                    flash_attention)

    gen = torch.Generator(device=dev).manual_seed(0)
    B, HQ, HKV, S, D = SERVE_BATCH, 9, 3, PROMPT_LEN, 64
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def held(name, got, want, tol):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        require(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                f"{name} disagrees with its plain version (max err {err})")
        return err

    q, k, v = randn(B, HQ, S, D), randn(B, HKV, S, D), randn(B, HKV, S, D)
    errs = {}
    for dtype, tol in ((bf16, 2e-2), (f32, 1e-4)):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        errs[dtype] = held(f"flash_attention {dtype}",
                           flash_attention(qq, kk, vv, causal=True),
                           ref.flash_attention_ref(qq, kk, vv, causal=True),
                           tol)
    causal_ops = 2 * 2 * B * HQ * S * S * D // 2
    fa_row = {
        "name": "flash_attention", "route": "cuda", "design": "mma.sync",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85",
        "max_abs_err": errs[bf16],
        "ms": cuda_ms(lambda: flash_attention(q, k, v, causal=True)),
        "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                            causal=True)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        **_bound(2 * (2 * q.numel() + k.numel() + v.numel()), causal_ops,
                 BF16_TC_OPS_PER_S),
    }
    q32, k32, v32 = q.float(), k.float(), v.float()
    fp32_ms = cuda_ms(lambda: flash_attention(q32, k32, v32, causal=True))
    print(f"[5] flash_attention bf16 q {tuple(q.shape)} k/v "
          f"{tuple(k.shape)} causal: max|kernel-plain| {errs[bf16]:.3g} "
          f"(rtol=atol=2e-2; fp32 {errs[f32]:.3g} at 1e-4), kernel "
          f"{fa_row['ms']:.4f} ms, plain {fa_row['plain_ms']:.4f} ms, SDPA "
          f"{fa_row['library_ms']:.4f} ms, bound {fa_row['bound_ms']:.4f} ms "
          f"({fa_row['bound_by']}); in fp32 (cuda-core fp32) {fp32_ms:.4f} "
          f"ms", flush=True)

    qd = randn(B, HQ, D)
    kc, vc = randn(B, HKV, MAX_LEN, D), randn(B, HKV, MAX_LEN, D)
    first = torch.full((B,), PROMPT_LEN + 1, dtype=torch.int32, device=dev)
    ragged = torch.tensor([1, 17, 256, MAX_LEN, 300, 2, 513, 64],
                          dtype=torch.int32, device=dev)[:B]
    errs = {}
    for dtype, tol in ((bf16, 2e-2), (f32, 1e-4)):
        for label, lengths in (("513", first), ("ragged", ragged)):
            qq, kk, vv = (t.to(dtype) for t in (qd, kc, vc))
            errs[dtype, label] = held(
                f"decode_attention {dtype} lengths {label}",
                decode_attention(qq, kk, vv, lengths),
                ref.decode_attention_ref(qq, kk, vv, lengths), tol)
    mask = (torch.arange(MAX_LEN, device=dev)[None, :]
            < first[:, None])[:, None, None, :]
    valid = int(first.sum())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split = decode_split(B, HKV, MAX_LEN, sms)
    da_row = {
        "name": "decode_attention", "route": "cuda",
        "design": decode_design(split),
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:178",
        "max_abs_err": max(errs[bf16, "513"], errs[bf16, "ragged"]),
        "ms": cuda_ms(lambda: decode_attention(qd, kc, vc, first)),
        "plain_ms": cuda_ms(lambda: ref.decode_attention_ref(qd, kc, vc,
                                                             first)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True)),
        **_bound(2 * (2 * qd.numel() + 2 * valid * HKV * D) + 4 * B,
                 4 * HQ * valid * D, BF16_TC_OPS_PER_S),
    }
    print(f"[5] decode_attention bf16 q {tuple(qd.shape)} caches "
          f"{tuple(kc.shape)}, {da_row['design']!r} ({split} CTAs per "
          f"cluster on {sms} SMs): max|kernel-plain| {errs[bf16, '513']:.3g} at "
          f"length 513, {errs[bf16, 'ragged']:.3g} ragged {ragged.tolist()} "
          f"(rtol=atol=2e-2; fp32 {errs[f32, '513']:.3g} / "
          f"{errs[f32, 'ragged']:.3g} at 1e-4), kernel {da_row['ms']:.4f} "
          f"ms, plain {da_row['plain_ms']:.4f} ms, SDPA "
          f"{da_row['library_ms']:.4f} ms, bound {da_row['bound_ms']:.4f} ms"
          f" ({da_row['bound_by']})", flush=True)
    return fa_row, da_row


def serve_smollm(dev) -> tuple[dict, dict]:
    """Phase 6: serve SmolLM-135M at full width; returns the kernel
    launches of run (b), the bf16 kernels' path, and the bf16 model's
    prompt tokens, embedding table and layer 0's norm and MLP weights."""
    import dataclasses

    import torch
    from repro_torch.configs import load_config
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import (decode_design,
                                                    decode_split)
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import decode_step, init_params, prefill

    cfg = load_config("smollm-135m")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(SERVE_BATCH, PROMPT_LEN)).astype(np.int32)
    reqs = [Request(i, prompts[i], GEN) for i in range(SERVE_BATCH)]
    tokens = torch.from_numpy(prompts).to(dev)

    def run(c, params, impl):
        """Prefill logits, then one served batch with its kernel launches
        counted from 0 and its host-clock wall."""
        c = dataclasses.replace(c, attn_impl=impl)
        with torch.inference_mode():
            logits, _ = prefill(params, tokens, c, MAX_LEN)
        server = BatchedServer(c, params, max_len=MAX_LEN)
        _lib.reset_counts()
        t0 = time.perf_counter()
        res = server.serve(reqs)
        wall = time.perf_counter() - t0
        launches = _lib.counts()
        return (logits.float(), np.array([r.tokens for r in res]), res, wall,
                launches, _lib.routes())

    # (a) fp32: the kernels' path against the plain path
    c32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(torch.Generator(device=dev).manual_seed(0), c32, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    lp, tp, *_ = run(c32, params, "pallas")
    lf, tf, *_ = run(c32, params, "full")
    logits32 = lf
    err = float((lp - lf).abs().max())
    require(bool(torch.isfinite(lp).all()) and lp.shape == (SERVE_BATCH,
                                                            cfg.vocab_size),
            f"fp32 prefill logits: shape {tuple(lp.shape)} or not finite")
    require(torch.allclose(lp, lf, rtol=1e-3, atol=1e-3),
            f"fp32 prefill logits, pallas vs full: max err {err}")
    require(np.array_equal(tp, tf), "fp32 greedy tokens, pallas != full")
    print(f"[6a] smollm-135m fp32 ({n_params} params, {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}), {SERVE_BATCH}x{PROMPT_LEN} "
          f"prompts, {GEN} new tokens: pallas == full greedy tokens; "
          f"prefill logits max|Δ| {err:.3g} (rtol=atol=1e-3)", flush=True)
    del params
    torch.cuda.empty_cache()

    # (b) the published bf16: the kernels' path, timed and counted
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    lf, tf, *_ = run(cfg, params, "full")
    run(cfg, params, "pallas")                      # warm-up
    lp, tp, res, wall, launches, routes = run(cfg, params, "pallas")
    err = float((lp - lf).abs().max())
    scale = float(lf.abs().max())
    # the bf16 plain path's own error: its distance to the fp32 logits of
    # the same weights (the bf16 weights are the fp32 ones rounded)
    noise = float((lf - logits32).abs().max())
    require(bool(torch.isfinite(lp).all()), "bf16 prefill logits not finite")
    require(routes["flash_attention"] == {"mma.sync":
                                          launches["flash_attention"]},
            f"bf16 prefill launches by design: {routes['flash_attention']}, "
            f"expected all {launches['flash_attention']} on mma.sync")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split = decode_design(decode_split(SERVE_BATCH, cfg.num_kv_heads,
                                       MAX_LEN, sms))
    require(routes["decode_attention"] == {split:
                                           launches["decode_attention"]},
            f"decode launches by design: {routes['decode_attention']}, "
            f"expected all {launches['decode_attention']} on {split!r}")
    require(err <= max(2e-2 * scale, noise),
            f"bf16 prefill logits, pallas vs full: max |Δ| {err} > both "
            f"2e-2 * {scale} and the plain path's bf16 error {noise}")
    agree = float((tp == tf).mean())
    decode_ms = res[0].decode_s * 1e3
    n_tok = SERVE_BATCH * GEN
    print(f"[6b] smollm-135m bf16, attn_impl='pallas': prefill "
          f"{res[0].prefill_s:.4f} s, decode {decode_ms:.3f} ms/token step "
          f"({SERVE_BATCH} sequences), {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tok/s (host clock); prefill logits max|Δ| vs "
          f"full {err:.4g} (max|logits| {scale:.4g}; limit the larger of "
          f"2e-2 of it and the plain bf16 path's max|Δ| to fp32, {noise:.4g});"
          f" pallas bf16 max|Δ| to fp32 "
          f"{float((lp - logits32).abs().max()):.4g}; "
          f"greedy tokens agreeing with full {agree:.4f}; launches "
          f"flash_attention {launches['flash_attention']} (by design "
          f"{dict(routes['flash_attention'])}), decode_attention "
          f"{launches['decode_attention']} (by design "
          f"{dict(routes['decode_attention'])})", flush=True)
    cp = dataclasses.replace(cfg, attn_impl="pallas")
    with torch.inference_mode():
        logits, cache = prefill(params, tokens, cp, MAX_LEN)
        step = profiled(lambda: decode_step(
            params, logits.argmax(-1), cache, PROMPT_LEN, cp), "decode_step",
            "decode_kernel")
        pre = profiled(lambda: prefill(params, tokens, cp, MAX_LEN),
                       "prefill", "prefill_mma_kernel")
    busy, wall, dec_attn = step["busy"], step["wall"], step["named"]
    pre_busy, pre_wall, pre_attn = pre["busy"], pre["wall"], pre["named"]
    print(f"[6b] one decode step under torch.profiler: host {wall:.3f} ms "
          f"with the profiler's cost, "
          + ("device busy not measured (no device spans in the trace)"
             if busy is None else f"device busy {busy:.3f} ms = "
             f"{100 * busy / decode_ms:.1f} % of the untraced "
             f"{decode_ms:.3f} ms step, of which the "
             f"{cfg.num_layers} decode_attention kernels {dec_attn:.4f} ms"),
          flush=True)
    print(f"[6b] one prefill under torch.profiler: host {pre_wall:.3f} ms "
          f"with the profiler's cost, "
          + ("device busy not measured (no device spans in the trace)"
             if pre_busy is None else f"device busy {pre_busy:.3f} ms, of "
             f"which flash_attention's kernels {pre_attn:.3f} ms"),
          flush=True)
    layer0 = params["segment_0"][0][0]
    model = {"tokens": tokens, "table": params["embed"]["table"],
             "norm": layer0["norm1"]["scale"],
             "w_in": layer0["mlp"]["w_up"], "w_out": layer0["mlp"]["w_down"]}
    del params, cache
    torch.cuda.empty_cache()
    return launches, model


def kernel_api(dev, model: dict) -> tuple[list[dict], dict]:
    """Phase 7: the kernel API at SmolLM-135M's full width; returns the
    rows of its three kernels and their launches on the driven path."""
    import torch
    import torch.nn.functional as F
    from repro_torch import dataflow_jit
    from repro_torch.kernels import (_lib, decoupled_gather,
                                     decoupled_gather_ref,
                                     decoupled_gather_staged, matmul, ref,
                                     rmsnorm)
    from repro_torch.kernels.dataflow_matmul import (BLOCK_M, BLOCK_NS,
                                                     WGMMA, Route, _launch,
                                                     route)
    from repro_torch.kernels.decoupled_gather import BULK, gather_route

    tokens, table = model["tokens"], model["table"]
    norm_w, w_in, w_out = model["norm"], model["w_in"], model["w_out"]
    idx = tokens.flatten()
    n, d = idx.numel(), table.shape[1]

    # the path, driven once with the counts at 0
    emb = table[tokens]
    _lib.reset_counts()
    gathered = decoupled_gather(idx, table)
    normed = rmsnorm(emb, norm_w)
    x = normed.reshape(n, d)
    up = matmul(x, w_in)
    down = matmul(up, w_out)
    torch.cuda.synchronize()
    launches = _lib.counts()
    require(_lib.routes()["dataflow_matmul"] == {"wgmma+tma": 2},
            f"the path's bf16 products by design: "
            f"{_lib.routes()['dataflow_matmul']}, expected both on wgmma+tma")
    require(_lib.routes()["decoupled_gather"] == {BULK: 1},
            f"the path's gather by design: "
            f"{_lib.routes()['decoupled_gather']}, expected {BULK}")

    def held(name, got, want, rtol, atol):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        require(bool(torch.isfinite(got.float()).all())
                and got.shape == want.shape and got.dtype == want.dtype,
                f"{name}: shape {tuple(got.shape)} / dtype {got.dtype} or "
                f"not finite")
        require(torch.allclose(got.float(), want.float(), rtol=rtol,
                               atol=atol),
                f"{name} disagrees with its plain version (max err {err})")
        return err

    require(torch.equal(decoupled_gather(idx, table, fn="identity"),
                        table[idx]),
            "decoupled_gather fn='identity' != table[idx]")
    rows = table.shape[0]
    wild = torch.tensor([0, rows, rows + 7, -1, -rows, -rows - 1, -3 * rows,
                         5, 1 << 30], dtype=torch.int32, device=dev)
    clamped = torch.where(wild < 0, wild + rows, wild).clamp(0, rows - 1)
    require(torch.equal(decoupled_gather(wild, table, fn="identity"),
                        table[clamped.long()]),
            "decoupled_gather fn='identity' on indices out of range != the "
            "wrapped-and-clamped rows")
    t32 = table.float()
    g_err = held("decoupled_gather bf16", gathered,
                 decoupled_gather_ref(idx, table), BF16_ULP, 0.0)
    g_err32 = held("decoupled_gather fp32", decoupled_gather(idx, t32),
                   decoupled_gather_ref(idx, t32), 1e-6, 1e-6)
    r_err = held("rmsnorm bf16", normed, ref.rmsnorm_ref(emb, norm_w),
                 2e-2, 2e-2)
    r_err32 = held("rmsnorm fp32", rmsnorm(emb.float(), norm_w.float()),
                   ref.rmsnorm_ref(emb.float(), norm_w.float()), 1e-5, 1e-5)
    m_errs = [held(f"matmul bf16 {label}", got, ref.matmul_ref(a, b),
                   1e-2, 5e-2)
              for label, got, a, b in (("in", up, x, w_in),
                                       ("out", down, up, w_out))]
    m_errs32 = [held(f"matmul fp32 {label}", matmul(a.float(), b.float()),
                     ref.matmul_ref(a.float(), b.float()), 2e-5, 3e-4)
                for label, a, b in (("in", x, w_in), ("out", up, w_out))]
    print(f"[7] kernel API path (smollm-135m bf16, {n} tokens): "
          f"decoupled_gather ({gather_route(table)!r}) fn='identity' == "
          f"table[idx], and on {wild.numel()} indices past both ends == the "
          f"wrapped-and-clamped rows; "
          f"max|kernel-plain| decoupled_gather {g_err:.3g} (rtol 2**-7, "
          f"one bf16 ulp; fp32 {g_err32:.3g} at 1e-6), rmsnorm "
          f"{tuple(emb.shape)} {r_err:.3g} (2e-2; fp32 {r_err32:.3g} at "
          f"1e-5), matmul {tuple(x.shape)} x {tuple(w_in.shape)} "
          f"{m_errs[0]:.3g} and {tuple(up.shape)} x {tuple(w_out.shape)} "
          f"{m_errs[1]:.3g} (rtol 1e-2, atol 5e-2; "
          f"fp32 {m_errs32[0]:.3g} / {m_errs32[1]:.3g} at 2e-5 / 3e-4); "
          f"launches {launches['decoupled_gather']} / {launches['rmsnorm']} "
          f"/ {launches['dataflow_matmul']}", flush=True)

    # the compiler-derived gather, and the quickstart kernel, on the card
    want = decoupled_gather_ref(idx, table)
    for backend in ("sequential", "emulated"):
        t0 = time.perf_counter()
        got = decoupled_gather_staged(idx, table, backend=backend)
        torch.cuda.synchronize()
        require(got.device == table.device and torch.equal(got, want),
                f"decoupled_gather_staged {backend} != decoupled_gather_ref")
        print(f"[7] decoupled_gather_staged {backend}: bit-identical to "
              f"decoupled_gather_ref in {time.perf_counter() - t0:.3f} s",
              flush=True)
    prog = decoupled_gather_staged.lower(idx, table)
    print(prog.report(), flush=True)
    require((prog.num_stages, prog.schedule.num_channels) == (3, 2),
            f"staged gather: {prog.num_stages} stages, "
            f"{prog.schedule.num_channels} channels, expected 3 and 2")

    @dataflow_jit(stream_argnums=(1,))
    def quickstart(table, idx, w):
        return torch.tanh(table[idx] * w) + 1.0

    qt = torch.arange(1024, dtype=torch.float32, device=dev)
    qi = torch.tensor([3, 997, 41, 512, 7, 800, 64, 2], dtype=torch.int32,
                      device=dev)
    qw = torch.tensor(1.5, device=dev)
    c = quickstart.lower(qt, qi, qw)
    sch = c.schedule
    plan = (sch.num_stages, sch.num_channels, sch.channel_bytes,
            sch.pipeline_ii, sch.total_latency)
    print(c.report(), flush=True)
    require(c.device == dev, "the quickstart did not compile for "
            "CUDA")
    require(plan == REF_QUICKSTART_PLAN, f"quickstart plan {plan} != the "
            f"reference's {REF_QUICKSTART_PLAN}")
    direct = quickstart.__wrapped__(qt, qi, qw)
    for backend in ("sequential", "emulated", "eager"):
        require(torch.equal(quickstart(qt, qi, qw, backend=backend), direct),
                f"quickstart {backend} backend != the direct call")
    stream = torch.stack([(qi + t) % 1024 for t in range(6)])
    require(torch.equal(c.stream(qt, stream, qw), torch.stack(
        [quickstart.__wrapped__(qt, s, qw) for s in stream])),
        "quickstart stream != the direct calls")
    print(f"[7] quickstart on the card: plan {plan} == the reference's; "
          f"sequential, emulated, eager == direct call; stream of 6 "
          f"microbatches == direct calls", flush=True)

    # times at the path's shapes
    floor = cuda_ms(lambda: torch.index_select(table, 0, idx))
    gather_row = {
        "name": "decoupled_gather", "route": "cuda",
        "design": gather_route(table),
        "source": "src/repro_torch/csrc/decoupled_gather.cu",
        "replaces": "src/repro/kernels/decoupled_gather.py:71",
        "max_abs_err": g_err,
        "ms": cuda_ms(lambda: decoupled_gather(idx, table)),
        "plain_ms": cuda_ms(lambda: decoupled_gather_ref(idx, table)),
        "library_ms": None,
        **_bound(2 * n * d * table.element_size() + 4 * n, 2 * n * d),
    }
    rms_row = {
        "name": "rmsnorm", "route": "cuda", "design": "cuda-core fp32",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:28",
        "max_abs_err": r_err,
        "ms": cuda_ms(lambda: rmsnorm(emb, norm_w)),
        "plain_ms": cuda_ms(lambda: ref.rmsnorm_ref(emb, norm_w)),
        "library_ms": cuda_ms(lambda: F.rms_norm(emb, (d,), norm_w, 1e-6)),
        **_bound(2 * emb.numel() * emb.element_size()
                 + norm_w.numel() * norm_w.element_size(), 4 * emb.numel()),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mm_rows = []
    for a, b in ((x, w_in), (up, w_out)):
        (M, K), N = a.shape, b.shape[1]
        rt = route(a, b, sms=sms)
        a32, b32 = a.float(), b.float()
        mm_rows.append({
            "name": "dataflow_matmul", "route": "cuda",
            "design": rt.design,
            "source": "src/repro_torch/csrc/dataflow_matmul.cu",
            "replaces": "src/repro/kernels/dataflow_matmul.py:51",
            "max_abs_err": max(m_errs),
            "ms": cuda_ms(lambda: matmul(a, b)),
            "plain_ms": cuda_ms(lambda: ref.matmul_ref(a, b)),
            "fp32_ms": cuda_ms(lambda: matmul(a32, b32)),
            "library_ms": cuda_ms(lambda: torch.matmul(a, b)),
            **_bound(2 * (M * K + K * N + M * N), 2 * M * N * K,
                     BF16_TC_OPS_PER_S),
            "shape": f"({M}, {K}) x ({K}, {N}), {rt.design} "
                     f"{BLOCK_M} x {rt.block_n} tiles",
        })
    # every tile width the route chooses among, at the path's shapes
    for a, b in ((x, w_in), (up, w_out)):
        widths = {bn: cuda_ms(lambda: _launch(a, b, torch.bfloat16,
                                              Route(WGMMA, bn)))
                  for bn in BLOCK_NS}
        print(f"[7] dataflow_matmul {tuple(a.shape)} x {tuple(b.shape)} by "
              f"tile width: " + ", ".join(f"{BLOCK_M} x {bn} {t:.4f} ms"
                                          for bn, t in widths.items())
              + f"; the route takes {route(a, b, sms=sms).block_n}",
              flush=True)
    # the path launches the kernel once per product: its row sums both
    mm_row = {**mm_rows[0], "shape": "both products", **{
        k: sum(r[k] for r in mm_rows)
        for k in ("ms", "plain_ms", "library_ms", "bound_ms", "fp32_ms")}}
    for row in (gather_row, rms_row, *mm_rows, mm_row):
        print(f"[7] {row['name']} {row.get('shape', '')}: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
              + ("none" if row["library_ms"] is None
                 else f"{row['library_ms']:.4f} ms")
              + f", bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
              + (f"; the same product in fp32 (cuda-core fp32) "
                 f"{row['fp32_ms']:.4f} ms" if "fp32_ms" in row else ""),
              flush=True)
    print(f"[7] decoupled_gather ({gather_row['design']!r}): kernel "
          f"{gather_row['ms']:.4f} ms, floor torch.index_select of the same "
          f"rows {floor:.4f} ms (no PyTorch call computes tanh(2*table[idx]))"
          f", bound {gather_row['bound_ms']:.4f} ms", flush=True)
    return [gather_row, mm_row, rms_row], launches


def table1_bodies(dev) -> None:
    """Phase 3b: knapsack, Floyd–Warshall and DFS at Table-I size on the
    card — each compiled in loop mode to the reference's plan and
    simulator stages, then run over a window by the ``sequential`` and
    ``emulated`` backends, bit for bit the plain loop body; the stores
    drop an index out of range on the card as the reference's do."""
    import torch
    import repro_torch
    from repro_torch import at_set
    from repro_torch.workloads import ALL_KERNELS

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    zero = i32(0)
    windows = {   # the loop's xs for each step of the window
        "knapsack": lambda w: [((zero, j),) for j in torch.arange(
            w.carry_example.shape[0] - 1, -1, -1, dtype=torch.int32,
            device=dev)],                          # item row 0, j = W .. 0
        "floyd_warshall": lambda w: [((zero, zero, j),) for j in torch.arange(
            1024, dtype=torch.int32, device=dev)],     # k = i = 0
        "dfs": lambda w: [(s,) for s in torch.arange(
            1000, dtype=torch.int32, device=dev)],     # the first steps
    }
    for name, (plan_ref, sim_ref) in REF_TABLE1_PLANS.items():
        t0 = time.perf_counter()
        w = ALL_KERNELS[name](1.0, device=dev)
        c = repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                                loop=True,
                                nonaliasing_carries=w.nonaliasing_carries)
        sch = c.schedule
        plan = (len(c.cdfg.nodes), sch.num_stages, sch.num_channels,
                sch.channel_bytes, sch.pipeline_ii, sch.total_latency,
                [sp.eqn_count for sp in c.program.stages])
        require(c.device.type == "cuda", f"{name}: not compiled for CUDA")
        require(plan == plan_ref, f"{name}: plan {plan} != the reference's "
                f"{plan_ref}")
        sim = [(s.ii, s.latency, s.mem_in_scc,
                [a.region for a in s.accesses])
               for s in c.sim_stages(traces=list(w.full_traces.values()))]
        require(sim == sim_ref, f"{name}: simulator stages {sim} != the "
                f"reference's {sim_ref}")
        t_compile = time.perf_counter() - t0
        carry = w.carry_example
        steps = windows[name](w)
        secs = {}
        runs = {}
        for b in ("plain", "sequential", "emulated"):
            state = carry
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for xs in steps:
                state = w.loop_body(state, *xs) if b == "plain" \
                    else c(state, *xs, backend=b)
            torch.cuda.synchronize()
            secs[b] = time.perf_counter() - t0
            runs[b] = state if isinstance(state, tuple) else (state,)
        for b in ("sequential", "emulated"):
            require(all(torch.equal(x, y) for x, y in
                        zip(runs[b], runs["plain"])),
                    f"{name}: {b} backend != plain loop over the window")
        got = runs["plain"][0].cpu().numpy()
        if name == "knapsack":
            w0, v0 = int(w.data["weights"][0]), int(w.data["values"][0])
            want = np.where(np.arange(got.size) >= w0, v0, 0)
            require(np.array_equal(got, want), "knapsack: row 0 != numpy")
        elif name == "floyd_warshall":
            d = w.data["dist0"].copy()
            d[0] = np.minimum(d[0], d[0, 0] + d[0])
            require(np.array_equal(got, d.reshape(-1)),
                    "Floyd–Warshall: the first k = 0 row != numpy")
        took = ", ".join(f"{b} {v:.2f} s" for b, v in secs.items())
        print(f"[3b] {name}: plan {plan[:6]} and {len(sim)} simulator "
              f"stages == the reference's (built and compiled in "
              f"{t_compile:.2f} s); {len(steps)} steps, sequential and "
              f"emulated == plain loop bit for bit ({took})", flush=True)

    x = np.arange(10, 16, dtype=np.int32)
    xt = torch.from_numpy(x).to(dev)
    store = repro_torch.compile(lambda a, i: at_set(a, i, -7), xt, zero)
    for index in (0, -1, -6, 6, 9, -7, -18):
        want = x.copy()
        k = index + 6 if index < 0 else index
        if 0 <= k < 6:
            want[k] = -7
        for b, got in (("eager", at_set(xt, i32(index), -7)),
                       ("sequential", store(xt, i32(index),
                                            backend="sequential")),
                       ("emulated", store(xt, i32(index),
                                          backend="emulated"))):
            require(np.array_equal(got.cpu().numpy(), want),
                    f"at_set {b} at {index} on the card: "
                    f"{got.cpu().numpy()} != {want}")
    print("[3b] at_set and its lowered scatter on the card: a negative "
          "index wraps once, one still out of range drops the write "
          "(indices 0, -1, -6, 6, 9, -7, -18; eager, sequential, emulated)",
          flush=True)


def fig5_grid() -> None:
    """Phase 4b: the Fig. 5 grid through the port's harness on the
    ``torch`` engine — SpMV, knapsack and DFS at all their Table-I
    iterations, Floyd–Warshall at its first 2^22 — each on all four
    memories, dataflow, conventional and processor, cycles equal to the
    reference's recorded grid."""
    from repro_torch.core import engine, rescache
    from repro_torch.kernels import _lib
    from repro_torch.workloads import fig5
    rescache.configure(enabled=False)
    gains = {}
    with engine.use("torch"):
        for kn, (n_ref, cells_ref, base_ref) in REF_FIG5.items():
            engine.reset_walls()
            before = _lib.counts()["running_max"]
            t0 = time.perf_counter()
            res, task_s, _ = fig5.run_all(full=True, jobs=1, kernels=(kn,),
                                          max_iters=1 << 22)
            wall = time.perf_counter() - t0
            launched = _lib.counts()["running_max"] - before
            r = res[kn]
            got = tuple((r[m]["dataflow_cycles"], r[m]["conventional_cycles"])
                        for m in FIG5_MEMS)
            for m in FIG5_MEMS:
                print(f"[4b] {kn:<15}{m:<9} df/base "
                      f"{r[m]['dataflow_vs_baseline']:8.3f}  conv/base "
                      f"{r[m]['conventional_vs_baseline']:8.3f}  df/conv "
                      f"{r[m]['dataflow_vs_conventional']:8.3f}  (cycles "
                      f"{r[m]['dataflow_cycles']} / "
                      f"{r[m]['conventional_cycles']})", flush=True)
            walls = ", ".join(f"{k} {v:.2f} s" for k, v in
                              sorted(engine.walls().items()))
            tasks = ", ".join(f"{k.split('/')[1]} {v['total']:.2f} s"
                              for k, v in task_s.items())
            print(f"[4b] {kn}: {r['n_iters_simulated']} of "
                  f"{r['n_iters_full']} iterations in {wall:.2f} s ({tasks}; "
                  f"engine phases: {walls}; {launched} running_max "
                  f"launches); processor {r['baseline_cycles']} cycles",
                  flush=True)
            require(launched > 0, f"{kn}: the torch engine launched no "
                    f"running_max")
            require(r["n_iters_simulated"] == n_ref,
                    f"{kn}: {r['n_iters_simulated']} iterations simulated")
            require(got == cells_ref and r["baseline_cycles"] == base_ref,
                    f"{kn}: cycles {got} / {r['baseline_cycles']} differ "
                    f"from the reference's {cells_ref} / {base_ref}")
            gains[kn] = fig5.best_vs_best(r)
    print("[4b] 36 cycle counts == the reference's; best dataflow vs best "
          "conventional: " + ", ".join(
              f"{kn} {g:.2f}x" + (" (first 2^22 iterations)"
                                  if kn == "floyd_warshall" else "")
              for kn, g in gains.items()), flush=True)


def check_sass() -> str:
    """Phase 1: count the Hopper instructions in the SASS of the built
    libraries: each tensor-core route must have compiled to its matrix
    instructions, and each ring to the bulk copy (``UBLKCP``)."""
    from repro_torch.kernels import _lib
    tool = os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return "SASS not checked (no cuobjdump beside nvcc)"
    found = []
    for name, op in (("dataflow_matmul", "HGMMA"),
                     ("flash_attention", "HMMA"),
                     ("flash_attention", "UBLKCP"),
                     ("spmv_bsr", "UBLKCP"),
                     ("decoupled_gather", "UBLKCP")):
        sass = subprocess.run([tool, "-sass", str(_lib._lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        n = sum(op in line for line in sass.splitlines())
        require(n > 0, f"no {op} instruction in {name}'s SASS")
        found.append(f"{n} {op} in {name}")
    return "SASS: " + ", ".join(found)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _bound(nbytes: int, ops: int, ops_per_s: float = FP32_OPS_PER_S) -> dict:
    """Least time on the card: bytes moved at the HBM rate vs operations
    at ``ops_per_s`` (default the float32 non-tensor-core rate),
    whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


if __name__ == "__main__":
    main()
