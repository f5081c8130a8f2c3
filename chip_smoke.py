#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:  ``python3 chip_smoke.py``

Phases, one line (or block) each:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (one ``nvcc`` per ``src/repro_torch/csrc/*.cu``, all at once);
2. each CUDA kernel against its plain PyTorch version on the card, at the
   main path's shapes — ``spmv_bsr`` on the Table-I BSR matrix
   (512, 32, 8, 128) within rtol=atol=1e-4 (fp32 sums in another order),
   ``running_max`` bit for bit at 2^20 and odd sizes, int32 and int64,
   values above 2^31 — with median CUDA-event times of the kernel, the
   plain version and one PyTorch library call (``torch.mv`` on the dense
   matrix, ``torch.cummax``), and the engine's host round trip;
3. the main path: Table-I SpMV (dim 4096, density 0.25) built on the
   card, ``compile(..., loop=True)``, ``report()`` (5 stages), the
   ``sequential`` and ``emulated`` backends over the first row's
   nonzeros against the plain loop, and ``ops.spmv`` on the whole matrix
   against a float64 dense product on the host (rtol=atol=1e-4);
4. Fig. 5, SpMV, ACP: the dataflow and conventional machines simulated
   over all 4,194,304 iterations with the ``torch`` engine (the solver's
   running max on the card), again with the ``numpy`` engine; the cycles
   must be identical and equal the reference's recorded
   16,517,754 / 318,747,791;
5. one JSON line listing every kernel with its launches on the main path
   (phases 3-4), its error against the plain version, its times and its
   bound; then the ``nvidia-smi`` line; then the result line.

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

#: H100 SXM data-sheet peaks: HBM rate and the
#: float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: the reference's recorded Fig. 5 SpMV cells on ACP (BENCH_sim.json)
REF_DATAFLOW_CYCLES = 16_517_754
REF_CONVENTIONAL_CYCLES = 318_747_791
FIFO_DEPTH = 256
MAX_OUTSTANDING = 16


def require(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAILED: {msg}", flush=True)
        sys.exit(1)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    from repro_torch.kernels.scan import running_max
    from repro_torch.kernels.spmv import csr_to_bsr, spmv_bsr
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

    # -- the Table-I workload on the card ------------------------------------
    t0 = time.perf_counter()
    w = make_spmv(1.0, device=dev)
    dim = w.dim
    bvals, bcols = csr_to_bsr(w.indptr, w.indices, w.data, (dim, dim),
                              bm=8, bk=128)
    state = interop.spmv_state_to_torch(
        {"bsr_values": bvals, "bsr_col_ids": bcols, "x": w.x}, dev)
    print(f"[setup] Table-I SpMV: dim {dim}, {len(w.data)} nonzeros, BSR "
          f"{tuple(bvals.shape)}, built in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # -- 2. each kernel against its plain version ------------------------------
    vals, cols, x = (state["bsr_values"], state["bsr_col_ids"], state["x"])
    nbr, nnz, bm, bk = vals.shape
    y_k = spmv_bsr(vals, cols, x)
    y_p = ref.spmv_bsr_ref(vals, cols, x, nbr * bm)
    torch.cuda.synchronize()
    spmv_err = float((y_k - y_p).abs().max())
    require(torch.allclose(y_k, y_p, rtol=1e-4, atol=1e-4),
            f"spmv_bsr disagrees with its plain version (max err "
            f"{spmv_err})")
    rows = np.repeat(np.arange(dim), np.diff(w.indptr))
    dense = torch.zeros(dim, dim, device=dev)
    dense[torch.from_numpy(rows).to(dev),
          torch.from_numpy(w.indices.astype(np.int64)).to(dev)] = \
        torch.from_numpy(w.data).to(dev)
    valid = int((bcols >= 0).sum())
    spmv_bytes = (valid * bm * bk * 4 + bcols.size * 4 + x.numel() * 4
                  + nbr * bm * 4)
    spmv_ops = 2 * valid * bm * bk
    spmv_row = {
        "name": "spmv_bsr", "route": "cuda",
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
    print(f"[2] spmv_bsr {tuple(vals.shape)}: max|kernel-plain| "
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
        got_k, got_p = running_max(t), ref.running_max_ref(t)
        torch.cuda.synchronize()
        rmax_err = max(rmax_err, int((got_k.long() - got_p.long()).abs()
                                     .max()))
        require(torch.equal(got_k, got_p), f"running_max {label}: kernel "
                f"!= plain")
        require(np.array_equal(got_k.cpu().numpy(),
                               np.maximum.accumulate(a)),
                f"running_max {label}: kernel != np.maximum.accumulate")
        print(f"[2] running_max {label}: bit-identical to the plain version "
              f"and np.maximum.accumulate", flush=True)
    a_main = cases["i32 2^20 trending"]
    t_main = torch.from_numpy(a_main).to(dev)
    rmax_row = {
        "name": "running_max", "route": "cuda",
        "source": "src/repro_torch/csrc/running_max.cu",
        "replaces": "src/repro/core/engine.py:477",
        "max_abs_err": float(rmax_err),
        "ms": cuda_ms(lambda: running_max(t_main)),
        "plain_ms": cuda_ms(lambda: ref.running_max_ref(t_main)),
        "library_ms": cuda_ms(lambda: torch.cummax(t_main, 0)),
        **_bound(2 * a_main.nbytes, a_main.size),
    }
    h2d = host_ms(lambda: torch.from_numpy(a_main).to(dev))
    d2h = host_ms(lambda: t_main.cpu())
    with engine.use("torch"):
        trip = host_ms(lambda: engine.running_max(a_main.copy()))
    print(f"[2] running_max i32 2^20: kernel {rmax_row['ms']:.4f} ms, plain "
          f"{rmax_row['plain_ms']:.4f} ms, torch.cummax "
          f"{rmax_row['library_ms']:.4f} ms, bound {rmax_row['bound_ms']:.4f}"
          f" ms ({rmax_row['bound_by']}); engine round trip {trip:.3f} ms "
          f"(H2D {h2d:.3f} ms, D2H {d2h:.3f} ms, host clock)", flush=True)

    # -- 3. the main path -----------------------------------------------------
    _lib.reset_counts()
    t0 = time.perf_counter()
    c = repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                            loop=True)
    print(f"[3] compiled in {time.perf_counter() - t0:.2f} s on {c.device}")
    print(c.report(), flush=True)
    require(c.num_stages == 5, f"expected 5 stages, got {c.num_stages}")
    require(c.device.type == "cuda", "the program did not compile for CUDA")
    lo, hi = int(w.indptr[0]), int(w.indptr[1])
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
    dense64[rows, w.indices] = w.data
    want = dense64 @ w.x.astype(np.float64)
    require(np.allclose(y, want, rtol=1e-4, atol=1e-4),
            f"ops.spmv vs float64 dense: max err {np.abs(y - want).max()}")
    print(f"[3] ops.spmv on the whole matrix == float64 dense product "
          f"(max err {np.abs(y - want).max():.3g}, rtol=atol=1e-4)",
          flush=True)

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

    # -- 5. the kernels line --------------------------------------------------
    launches = _lib.counts()
    for row in (spmv_row, rmax_row):
        row["launches"] = launches[row["name"]]
        require(row["launches"] > 0,
                f"{row['name']} was not launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in (spmv_row, rmax_row)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _bound(nbytes: int, ops: int) -> dict:
    """Least time on the card: bytes moved at the HBM rate vs operations
    at the float32 (non-tensor-core) rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


if __name__ == "__main__":
    main()
