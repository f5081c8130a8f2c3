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
   the reference's recorded grid (``REF_FIG5``).  The processor
   baseline's 4-way L1 and 8-way L2 replay through the engine's torch
   N-way core on the card (``engine.counts()["nway_core"]``, at least
   one call per kernel).  Per cell df/base, conv/base and df/conv; per
   kernel the wall, its tasks' walls (the processor's beside its wall
   before the torch core, ``NUMPY_CORE_PROCESSOR_S``), the engine's phase
   walls, the ``running_max`` launches (at least one per kernel) and
   the N-way core's calls; then each kernel's best dataflow vs best
   conventional gain;
4c. the N-way core on the card: the inputs of SpMV's first 8-way L2
   replay in 4b (one full 2^20-iteration chunk, captured on the way)
   through the torch form on the card and the numpy form on the host,
   hit flags and stacks bit for bit, with both host-clock times and the
   CUDA-event time around the torch call; then SpMV's whole processor
   baseline on the numpy and the torch engine in turn, same cycles, both
   walls;
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
6c. Qwen2.5-14B at full width and depth (48 layers, 40 query heads over
   8 kv heads of dim 128) on phase 6's traffic: (a) in fp32 (59 GB),
   ``"pallas"`` against ``"full"``, greedy tokens identical and prefill
   logits within rtol=atol=1e-3; (b) in bf16, the kernels' path timed and
   held to phase 6b's logits bar against the bf16 ``"full"`` path (the
   fp32 logits of (a) give the plain path's own error), all 48 prefill
   launches on ``mma.sync`` and all 48 × 32 decode launches on the
   cluster split; one decode step traced; (c) ``kv_cache_dtype="int8"``:
   the first decode step's softmax within 0.05 of the bf16 cache's and
   the same greedy tokens (tests/test_perf_features.py's tolerance), then
   served once; (d) phase 5's kernel checks and times at this shape;
6d. DeepSeek-V3 at full width: (a) in fp32, cut to 1 dense + 1 MoE layer
   with no MTP head (56 GB), absorbed and naive MLA decode with the same
   greedy tokens and first-step logits within rtol=atol=2e-3 (the
   reference's ``test_mla_absorbed_matches_naive``); (b) in bf16, its 3
   dense layers, 1 of its 58 MoE layers and the MTP head's parameters
   (26.7 B), served with naive and with absorbed decode; the sigmoid
   top-8-of-256 router with its shared expert, the card's top-8 equal to
   the host's on the prefill's MoE input; ``dropped_frac`` of the prefill
   and of one decode step;
6e. RWKV-6 1.6B at full width and depth: in fp32, prefill of the 512
   tokens then 32 decode steps equal ``forward`` over the 544 tokens
   (rtol=atol=2e-3, the reference's ``test_arch_smoke`` bar); in bf16,
   served and timed;
6f. one Jamba-1.5-Large Mamba layer at full width in fp32 (d_model
   8192, d_inner 16384, d_state 16, dt_rank 512), batch 8:
   ``mamba_apply`` over 512 tokens then 32 ``mamba_decode`` steps equal
   ``mamba_apply`` over 544, and the chunked scan equals the sequential
   one (rtol=atol=1e-3); their host-clock times.  Phases 6c-6f print
   each model's parameter count and its peak allocated memory; whole
   Jamba, Llama-4-Scout and DeepSeek-V3 need more than one card;
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
8. the design-space explorer on the torch engine: knapsack's Table-I
   body and traces explored at 2^17 iterations (12 candidates, rescache
   off) through ``Compiled.explore``; the Pareto front (stages, FIFO
   bits, cycles) must equal the reference's recorded one (``REF_DSE``)
   and the solver's ``running_max`` must launch on the card; the wall
   and the engine's phase walls;
9. sharding and serving on the Fig. 5 SpMV ACP cell (all 4,194,304
   iterations, FIFO 256, torch engine): ``simulate_dataflow_many(...,
   workers=4)`` through the chunk-graph pool must give 16,517,754
   dataflow cycles; then a resolution daemon started through
   ``serve.ensure_daemon`` on a fresh store (``python -m
   repro_torch.launch.serve daemon``, on this process's device and
   engine) must give the same through ``server=``, its stats must show
   the request accepted and resolved cold by the daemon and the job
   completed, and ``shutdown`` must end the daemon's process; both walls,
   the daemon's set-up and a spawned worker's set-up;
11. training on the card (run after 9, before the line of 10):
   (a) one ``make_train_step`` (warmup 0, so the step takes the whole
   LR) of each of the ten reduced configs in fp32 on the card and on the
   CPU from the same params and batch: loss and metrics rtol 1e-4,
   ``grad_norm`` 1e-3, ``mu`` and ``nu`` rtol 1e-3 plus 1e-4 of each
   leaf's largest value (the bars of tests/test_torch_train.py's
   three-step test), the card's params within rtol 1e-6 plus 1e-7 of the
   plain AdamW step from the card's own moments (``apply_updates``'
   test bars), each largest |Δ| printed, and the params' card vs CPU;
   (b) SmolLM-135M whole (30 layers, d_model 576, vocab 49,152, tied)
   through ``train_loop``: bf16 params, fp32 moments, the
   synthetic stream at seed 0, 30 steps of 8 x 1,024 tokens, lr 3e-4, a
   checkpoint every 10 steps into a temporary directory under
   ``build/``; the loss at steps 0, 10, 20 and 29 (the mean of the last
   5 must be below that of the first 5), the median step over steps
   3-29 and tokens/s (host clock), model FLOP/s against the bf16 dense
   peak (6·N·tokens + 12·L·d·S·tokens), the peak allocated GiB; the
   path must launch no hand kernel, and the step-30 checkpoint must
   restore bit for bit; one more step under ``torch.profiler``: the
   device busy share, its launches and its five longest kernels; (c) the
   loop again with a failure injected at step 15 (one failure, one
   restore) and 20 steps resumed to 30 (``schedule_steps=30``): final
   losses within 1e-3 relative of (b)'s, whether bit for bit printed;
   (d) a train step with ``attn_impl="pallas"`` raises the kernels'
   autograd guard, and the same loss under ``torch.no_grad()`` launches
   ``flash_attention`` once a layer and is within 1e-2 of the plain
   path's (bf16, 2 x 256 tokens);
12. the rest of the port's entry points (run after 11, before the line of
   10): (a) the decode-step dataflow report of the served SmolLM-135M
   (phase 6b's bf16 params) and of all ten architectures at full width
   from abstract params (batch 8, ``max_len`` 552), each held line for
   line to the reference's (``REF_REPORTS``, read by :func:`report_key`),
   no kernel launched, and ``dataflow_report([])`` the "unavailable"
   string; (b) fp32 SmolLM-135M served with ``max_len`` 520 and 32 new
   tokens (24 steps past the end) on the kernels' and the plain path,
   identical tokens; token ids V, V + 3, −1, −V − 2 served with no
   device-side assert, logits card vs CPU within 1e-3; the reduced
   Qwen2.5 (int8 cache) and DeepSeek-V3 (MLA, naive and absorbed)
   configs past ``max_len``, card vs CPU; (c) each example's ``main()``
   (quickstart, spmv_dataflow, serve_decode, train_lm), Fig. 2, Table II
   and the ``--smoke`` sweep grid with ``measure_perf`` (the
   worker-scaling probe left out: phase 9 shards already), each held to
   the reference's constants, with its wall and hand-kernel launches;
10. one JSON line listing every kernel with its launches on its main path
   (phases 3-4b for the SpMV kernels, run (b) of phase 6 for attention,
   phase 7 for the kernel API) and on each path of phase 12, the design
   those launches took, its error against the plain version, its times
   and its bound (the attention rows also at Qwen2.5-14B's shape, with
   6c's launches); then the
   ``nvidia-smi`` line; then the result line.

Any failed phase exits non-zero before the result line.  Without a CUDA
device, or outside the repository, the script exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import re
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

#: phase 11: SmolLM-135M trained whole, bf16 params, fp32 moments, the
#: synthetic stream at seed 0: batch x sequence, steps, LR, checkpoint
#: period, the step of the injected failure and of the resume's cut
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 1024, 30, 3e-4
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT, TRAIN_CUT = 10, 15, 20

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


#: phase 8: the reference's design-space exploration of knapsack's
#: Table-I body and traces at 2^17 iterations (repro.dataflow ``explore``,
#: numpy engine, jax 0.9.0, rescache off; 12 candidates, FIFO depth 8,
#: ACP; held against the reference by
#: tests/test_torch_dse.py::test_chip_smoke_dse_front_is_the_reference):
#: its Pareto front as (stages, FIFO bits, cycles), and the candidates it
#: simulated
DSE_ITERS = 1 << 17
REF_DSE = ((1, 0, 393_494), (5, 1_536, 135_572), (7, 2_368, 135_532),
           (35, 6_528, 134_453), (35, 8_128, 134_399))
REF_DSE_EVALUATED = 12

#: phase 12a: the reference's decode-step dataflow reports at full width
#: (``repro.launch.serve.BatchedServer(cfg, jax.eval_shape(init_params),
#: max_len=552).dataflow_report`` of 8 requests, jax 0.9.0, on the CPU;
#: held against the reference by
#: tests/test_torch_report.py::test_chip_smoke_reports_are_the_reference),
#: as :func:`report_key` reads them
REPORT_BATCH, REPORT_MAX_LEN = 8, 552
REF_REPORTS = {
    "jamba-1.5-large-398b": (
        (24, 10, 10, 3407968), (1, 55, "0.53"),
        (("broadcast_in_dim,lt,add,select_n,broadcast_in_dim,gather",
          1, 7, 0, 131072, "MEM|LONG", "['arg0']"),
         ("scan", 1, 8, 131072, 131072, "LONG", ""),
         ("convert_element_type,mul", 1, 5, 131072, 524288, "LONG", ""),
         ("reduce_sum", 1, 2, 262144, 32, "LONG", ""),
         ("broadcast_in_dim,div", 1, 5, 32, 32, "LONG", ""),
         ("add,rsqrt", 1, 5, 32, 32, "LONG", ""),
         ("mul", 1, 4, 262176, 262144, "LONG", ""),
         ("convert_element_type,broadcast_in_dim,mul",
          1, 6, 262144, 262144, "LONG", ""),
         ("convert_element_type,convert_element_type,"
          "convert_element_type,dot_general",
          1, 11, 262144, 2097152, "LONG", ""),
         ("slice,squeeze", 1, 2, 2097152, 0, "", "")),
        ("verify: 0 error(s), 1 warning(s)",
         ("fifo-depth", "warning", "fifo_depth=8",
          "below the full-throughput bound 17: backpressure stretches "
          "the initiation interval past the static pipeline II"))),
    "qwen2.5-14b": (
        (24, 10, 10, 5685344), (1, 55, "0.53"),
        (("broadcast_in_dim,lt,add,select_n,broadcast_in_dim,gather",
          1, 7, 0, 81920, "MEM|LONG", "['arg0']"),
         ("scan", 1, 8, 81920, 81920, "LONG", ""),
         ("convert_element_type,mul", 1, 5, 81920, 327680, "LONG", ""),
         ("reduce_sum", 1, 2, 163840, 32, "LONG", ""),
         ("broadcast_in_dim,div", 1, 5, 32, 32, "LONG", ""),
         ("add,rsqrt", 1, 5, 32, 32, "LONG", ""),
         ("mul", 1, 4, 163872, 163840, "LONG", ""),
         ("convert_element_type,broadcast_in_dim,mul",
          1, 6, 163840, 163840, "LONG", ""),
         ("convert_element_type,convert_element_type,"
          "convert_element_type,dot_general",
          1, 11, 163840, 4866048, "LONG", ""),
         ("slice,squeeze", 1, 2, 4866048, 0, "", "")),
        ("verify: 0 error(s), 1 warning(s)",
         ("fifo-depth", "warning", "fifo_depth=8",
          "below the full-throughput bound 17: backpressure stretches "
          "the initiation interval past the static pipeline II"))),
    "olmo-1b": (
        (22, 8, 9, 1871968), (1, 47, "0.47"),
        (("broadcast_in_dim,lt,add,select_n,broadcast_in_dim,gather",
          1, 7, 0, 32768, "MEM|LONG", "['arg0']"),
         ("scan", 1, 8, 32768, 32768, "LONG", ""),
         ("convert_element_type,reduce_sum", 1, 3, 32768, 65568, "LONG", ""),
         ("broadcast_in_dim,div", 1, 5, 32, 32, "LONG", ""),
         ("jit,sub,add,rsqrt", 1, 7, 65568, 65568, "LONG", ""),
         ("mul", 1, 4, 65568, 65536, "LONG", ""),
         ("convert_element_type,convert_element_type,"
          "convert_element_type,dot_general",
          1, 11, 65536, 1609728, "LONG", ""),
         ("slice,squeeze", 1, 2, 1609728, 0, "", "")),
        ("verify: 0 error(s), 1 warning(s)",
         ("fifo-depth", "warning", "fifo_depth=8",
          "below the full-throughput bound 11: backpressure stretches "
          "the initiation interval past the static pipeline II"))),
    "smollm-135m": (
        (24, 10, 10, 1665120), (1, 55, "0.53"),
        (("broadcast_in_dim,lt,add,select_n,broadcast_in_dim,gather",
          1, 7, 0, 9216, "MEM|LONG", "['arg0']"),
         ("scan", 1, 8, 9216, 9216, "LONG", ""),
         ("convert_element_type,mul", 1, 5, 9216, 36864, "LONG", ""),
         ("reduce_sum", 1, 2, 18432, 32, "LONG", ""),
         ("broadcast_in_dim,div", 1, 5, 32, 32, "LONG", ""),
         ("add,rsqrt", 1, 5, 32, 32, "LONG", ""),
         ("mul", 1, 4, 18464, 18432, "LONG", ""),
         ("convert_element_type,broadcast_in_dim,mul",
          1, 6, 18432, 18432, "LONG", ""),
         ("convert_element_type,convert_element_type,"
          "convert_element_type,dot_general",
          1, 11, 18432, 1572864, "LONG", ""),
         ("slice,squeeze", 1, 2, 1572864, 0, "", "")),
        ("verify: 0 error(s), 1 warning(s)",
         ("fifo-depth", "warning", "fifo_depth=8",
          "below the full-throughput bound 17: backpressure stretches "
          "the initiation interval past the static pipeline II"))),
    "command-r-plus-104b": (
        (28, 9, 10, 10158176), (1, 56, "0.50"),
        (("broadcast_in_dim,lt,add,select_n,broadcast_in_dim,gather",
          1, 7, 0, 196608, "MEM|LONG", "['arg0']"),
         ("scan", 1, 8, 196608, 196608, "LONG", ""),
         ("convert_element_type,reduce_sum", 1, 3, 196608, 393248, "LONG", ""),
         ("broadcast_in_dim,div", 1, 5, 32, 32, "LONG", ""),
         ("jit,sub,add,rsqrt", 1, 7, 393248, 393248, "LONG", ""),
         ("mul", 1, 4, 393248, 393216, "LONG", ""),
         ("convert_element_type,broadcast_in_dim,mul",
          1, 6, 393216, 393216, "LONG", ""),
         ("convert_element_type,broadcast_in_dim,add,"
          "convert_element_type,convert_element_type,convert_element_type…",
          1, 14, 393216, 8192000, "LONG", ""),
         ("slice,squeeze", 1, 2, 8192000, 0, "", "")),
        ("verify: 0 error(s), 1 warning(s)",
         ("fifo-depth", "warning", "fifo_depth=8",
          "below the full-throughput bound 14: backpressure stretches "
          "the initiation interval past the static pipeline II"))),
    "rwkv6-1.6b": (
        (28, 9, 10, 2424928), (1, 56, "0.50"),
        (("broadcast_in_dim,lt,add,select_n,broadcast_in_dim,gather",
          1, 7, 0, 32768, "MEM|LONG", "['arg0']"),
         ("scan", 1, 8, 32768, 32768, "LONG", ""),
         ("convert_element_type,reduce_sum", 1, 3, 32768, 65568, "LONG", ""),
         ("broadcast_in_dim,div", 1, 5, 32, 32, "LONG", ""),
         ("jit,sub,add,rsqrt", 1, 7, 65568, 65568, "LONG", ""),
         ("mul", 1, 4, 65568, 65536, "LONG", ""),
         ("convert_element_type,broadcast_in_dim,mul",
          1, 6, 65536, 65536, "LONG", ""),
         ("convert_element_type,broadcast_in_dim,add,"
          "convert_element_type,convert_element_type,convert_element_type…",
          1, 14, 65536, 2097152, "LONG", ""),
         ("slice,squeeze", 1, 2, 2097152, 0, "", "")),
        ("verify: 0 error(s), 1 warning(s)",
         ("fifo-depth", "warning", "fifo_depth=8",
          "below the full-throughput bound 14: backpressure stretches "
          "the initiation interval past the static pipeline II"))),
    "deepseek-v3-671b": (
        (25, 11, 11, 5398624), (1, 63, "0.56"),
        (("broadcast_in_dim,lt,add,select_n,broadcast_in_dim,gather",
          1, 7, 0, 114688, "MEM|LONG", "['arg0']"),
         ("scan", 1, 8, 114688, 114688, "LONG", ""),
         ("scan", 1, 8, 114688, 114688, "LONG", ""),
         ("convert_element_type,mul", 1, 5, 114688, 458752, "LONG", ""),
         ("reduce_sum", 1, 2, 229376, 32, "LONG", ""),
         ("broadcast_in_dim,div", 1, 5, 32, 32, "LONG", ""),
         ("add,rsqrt", 1, 5, 32, 32, "LONG", ""),
         ("mul", 1, 4, 229408, 229376, "LONG", ""),
         ("convert_element_type,broadcast_in_dim,mul",
          1, 6, 229376, 229376, "LONG", ""),
         ("convert_element_type,convert_element_type,"
          "convert_element_type,dot_general",
          1, 11, 229376, 4136960, "LONG", ""),
         ("slice,squeeze", 1, 2, 4136960, 0, "", "")),
        ("verify: 0 error(s), 1 warning(s)",
         ("fifo-depth", "warning", "fifo_depth=8",
          "below the full-throughput bound 17: backpressure stretches "
          "the initiation interval past the static pipeline II"))),
    "llama4-scout-17b-a16e": (
        (24, 10, 10, 7284832), (1, 55, "0.53"),
        (("broadcast_in_dim,lt,add,select_n,broadcast_in_dim,gather",
          1, 7, 0, 81920, "MEM|LONG", "['arg0']"),
         ("scan", 1, 8, 81920, 81920, "LONG", ""),
         ("convert_element_type,mul", 1, 5, 81920, 327680, "LONG", ""),
         ("reduce_sum", 1, 2, 163840, 32, "LONG", ""),
         ("broadcast_in_dim,div", 1, 5, 32, 32, "LONG", ""),
         ("add,rsqrt", 1, 5, 32, 32, "LONG", ""),
         ("mul", 1, 4, 163872, 163840, "LONG", ""),
         ("convert_element_type,broadcast_in_dim,mul",
          1, 6, 163840, 163840, "LONG", ""),
         ("convert_element_type,convert_element_type,"
          "convert_element_type,dot_general",
          1, 11, 163840, 6465536, "LONG", ""),
         ("slice,squeeze", 1, 2, 6465536, 0, "", "")),
        ("verify: 0 error(s), 1 warning(s)",
         ("fifo-depth", "warning", "fifo_depth=8",
          "below the full-throughput bound 17: backpressure stretches "
          "the initiation interval past the static pipeline II"))),
    "musicgen-large": (
        (28, 9, 10, 393312), (1, 56, "0.50"),
        (("broadcast_in_dim,lt,add,select_n,broadcast_in_dim,gather",
          1, 7, 0, 32768, "MEM|LONG", "['arg0']"),
         ("scan", 1, 8, 32768, 32768, "LONG", ""),
         ("convert_element_type,reduce_sum", 1, 3, 32768, 65568, "LONG", ""),
         ("broadcast_in_dim,div", 1, 5, 32, 32, "LONG", ""),
         ("jit,sub,add,rsqrt", 1, 7, 65568, 65568, "LONG", ""),
         ("mul", 1, 4, 65568, 65536, "LONG", ""),
         ("convert_element_type,broadcast_in_dim,mul",
          1, 6, 65536, 65536, "LONG", ""),
         ("convert_element_type,broadcast_in_dim,add,"
          "convert_element_type,convert_element_type,convert_element_type…",
          1, 14, 65536, 65536, "LONG", ""),
         ("slice,squeeze", 1, 2, 65536, 0, "", "")),
        ("verify: 0 error(s), 1 warning(s)",
         ("fifo-depth", "warning", "fifo_depth=8",
          "below the full-throughput bound 14: backpressure stretches "
          "the initiation interval past the static pipeline II"))),
    "chameleon-34b": (
        (24, 10, 10, 3407968), (1, 55, "0.53"),
        (("broadcast_in_dim,lt,add,select_n,broadcast_in_dim,gather",
          1, 7, 0, 131072, "MEM|LONG", "['arg0']"),
         ("scan", 1, 8, 131072, 131072, "LONG", ""),
         ("convert_element_type,mul", 1, 5, 131072, 524288, "LONG", ""),
         ("reduce_sum", 1, 2, 262144, 32, "LONG", ""),
         ("broadcast_in_dim,div", 1, 5, 32, 32, "LONG", ""),
         ("add,rsqrt", 1, 5, 32, 32, "LONG", ""),
         ("mul", 1, 4, 262176, 262144, "LONG", ""),
         ("convert_element_type,broadcast_in_dim,mul",
          1, 6, 262144, 262144, "LONG", ""),
         ("convert_element_type,convert_element_type,"
          "convert_element_type,dot_general",
          1, 11, 262144, 2097152, "LONG", ""),
         ("slice,squeeze", 1, 2, 2097152, 0, "", "")),
        ("verify: 0 error(s), 1 warning(s)",
         ("fifo-depth", "warning", "fifo_depth=8",
          "below the full-throughput bound 17: backpressure stretches "
          "the initiation interval past the static pipeline II"))),
}


#: phase 12c: the reference's Fig. 2 text (benchmarks/fig2_schedule.py,
#: jax 0.9.0, on the CPU) by its SHA-256, and the conventional engine's
#: cycles it prints; its Table II rows (benchmarks/paper_table2.py:
#: nodes, dataflow and conventional stages, channels, channel bytes per
#: token, duplicated ops, ops per stage, op instances without and with
#: the duplicates); its ``--smoke`` sweep grid (benchmarks/sweep.py's
#: tasks, numpy engine, rescache off) as (kernel, memory, transform,
#: words per cycle, dataflow cycles, conventional cycles).  Held against
#: the reference by tests/test_torch_paper.py.
REF_FIG2_SHA256 = ("9c35b231adf7efb4813b37c183ca48fe"
                   "818278c8fdcf06fc9e65ed604c9eb366")
REF_FIG2_CONVENTIONAL_CYCLES = 734
REF_TABLE2 = {
    "spmv": (17, 5, 1, 6, 24, 0, [4, 5, 5, 2, 1], 17, 17),
    "knapsack": (35, 6, 1, 11, 36, 0, [4, 5, 6, 5, 7, 8], 35, 35),
    "floyd_warshall": (30, 8, 1, 13, 40, 0, [1, 5, 2, 5, 2, 5, 4, 6], 30, 30),
    "dfs": (30, 1, 1, 0, 0, 0, [30], 30, 30),
}
REF_SWEEP_SMOKE = (
    ("knapsack", "ACP", "none", 0.5, 40632, 1025201),
    ("knapsack", "ACP", "none", 1.0, 20735, 1025201),
    ("knapsack", "ACP+64KB", "none", 0.5, 40434, 29631),
    ("knapsack", "ACP+64KB", "none", 1.0, 20489, 29631),
    ("spmv", "ACP", "none", 0.5, 172917, 1525003),
    ("spmv", "ACP", "none", 1.0, 172917, 1525003),
    ("spmv", "ACP", "unroll=2+coalesce", 0.5, 88242, 1525003),
    ("spmv", "ACP", "unroll=2+coalesce", 1.0, 88242, 1525003),
    ("spmv", "ACP+64KB", "none", 0.5, 47700, 179233),
    ("spmv", "ACP+64KB", "none", 1.0, 34072, 179233),
    ("spmv", "ACP+64KB", "unroll=2+coalesce", 0.5, 42929, 179233),
    ("spmv", "ACP+64KB", "unroll=2+coalesce", 1.0, 24941, 179233),
)
#: phase 12c: what the reference's examples print of their simulations
#: (examples/quickstart.py's cycles, conventional and dataflow;
#: examples/spmv_dataflow.py's line; jax 0.9.0, on the CPU)
REF_QUICKSTART_CYCLES = (78135, 26740)
REF_SPMV_EXAMPLE_LINE = ("Zynq model, 20000 nnz: conventional 76.3 cyc/nnz "
                         "vs dataflow 2.2 cyc/nnz → 34.1x")

#: each kernel's processor-baseline task in phase 4b when its caches
#: replayed through the numpy N-way core: NVIDIA H100 80GB HBM3 at
#: 700.00 W, host clock (PERF.md §5)
NUMPY_CORE_PROCESSOR_S = {"spmv": 3.37, "knapsack": 0.16,
                          "floyd_warshall": 2.11, "dfs": 0.70}


_HEADER = re.compile(r"dataflow program: (\d+) ops -> (\d+) stages, (\d+) "
                     r"channels \((\d+)B/token\)")
_PIPELINE = re.compile(r"\s+pipeline II=(\d+)\s+total latency=(\d+)\s+"
                       r"bubble@8mb=(\S+)$")
_STAGE = re.compile(r"\s+stage (\d+): \[(.*)\] ii=(\d+) lat=(\d+) "
                    r"in=(\d+)B out=(\d+)B ?(\S*)(?: regions=(.*))?$")
_FINDING = re.compile(r"\s+\[(\S+)\] (\w+) @ ([^:]+): (.*?)"
                      r"(?:\s+\(hint: .*\))?$")


def report_key(report: str) -> tuple:
    """What Algorithm 1 decided, read from a decode-step dataflow report:
    the header's (ops, stages, channels, bytes per token), the pipeline's
    (II, total latency, bubble at 8 microbatches), each stage's (ops, II,
    latency, in bytes, out bytes, flags, regions) and each verifier
    finding's (rule, severity, where, message) — without the pass times,
    the ``backend=`` / ``device=`` fields and the hint text."""
    lines = report.splitlines()
    m = _HEADER.match(lines[0])
    if m is None:
        return (lines[0],)
    pipeline = stages = ()
    findings = []
    for line in lines[1:]:
        if p := _PIPELINE.match(line):
            pipeline = (int(p[1]), int(p[2]), p[3])
        elif s := _STAGE.match(line):
            stages += ((s[2], int(s[3]), int(s[4]), int(s[5]), int(s[6]),
                        s[7], s[8] or ""),)
        elif f := _FINDING.match(line):
            findings.append(f.groups())
        elif line.lstrip().startswith("verify:"):
            findings.insert(0, line.strip())
    return (tuple(int(g) for g in m.groups()), pipeline, stages,
            tuple(findings))


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
    the summed spans of all kernels and of the copies each way;
    ``launches``, the kernel spans counted; ``top``, the five kernels
    with the longest summed spans, as (name, ms, count).  The trace goes
    to ``build/<name>_trace.json``."""
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
           "d2h": total(lambda e: "DtoH" in e.get("name", "")),
           "launches": sum(e["cat"] == "kernel" for e in events)}
    by_name: dict[str, list] = {}
    for e in events:
        if e["cat"] == "kernel":
            acc = by_name.setdefault(e.get("name", "?"), [0.0, 0])
            acc[0] += e["dur"] / 1e3
            acc[1] += 1
    out["top"] = sorted(((n, ms, k) for n, (ms, k) in by_name.items()),
                        key=lambda t: -t[1])[:5]
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
    l2_chunk = fig5_grid()

    # -- 4c. the N-way core on the card ----------------------------------------
    nway_on_card(l2_chunk)

    spmv_launches = _lib.counts()
    require(_lib.routes()["spmv_bsr"] == {RING: spmv_launches["spmv_bsr"]},
            f"phases 3-4b spmv_bsr launches by design: "
            f"{_lib.routes()['spmv_bsr']}, expected all on {RING}")

    # -- 5. the attention kernels against their plain versions ---------------
    fa_row, da_row = attention_kernels(dev)

    # -- 6. the serving path ----------------------------------------------------
    serve_launches, model = serve_smollm(dev)

    # -- 6c-6f. the rest of the model stack at full width ----------------------
    qwen_rows = serve_qwen(dev)
    serve_deepseek(dev)
    serve_rwkv(dev)
    mamba_layer(dev)

    # -- 7. the kernel API ----------------------------------------------------
    api_rows, api_launches = kernel_api(dev, model)
    served_report = model["report"]
    del model
    torch.cuda.empty_cache()

    # -- 8. the design-space explorer on the torch engine ----------------------
    explore_knapsack(dev)

    # -- 9. sharding and serving the Fig. 5 SpMV ACP cell ----------------------
    shard_and_serve(c, traces, mem, n)

    # -- 11. training on the card ------------------------------------------------
    train_on_card(dev)

    # -- 12. the decode-step report, F6/F7 on the card, the examples, the
    #        paper's Fig. 2 / Table II / sweep ----------------------------------
    t12 = time.perf_counter()
    reports_on_card(served_report)
    phase12 = faults_on_card(dev)
    phase12.update(examples_and_paper(dev))
    print(f"[12] phase 12 in {time.perf_counter() - t12:.2f} s; hand-kernel "
          f"launches by path: {phase12}", flush=True)

    # -- 10. the kernels line ---------------------------------------------------
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
    for row in (fa_row, da_row):
        # the same kernel at Qwen2.5-14B's heads, launches on 6c's batch
        row["qwen2.5-14b"] = {k: qwen_rows[row["name"]][k] for k in keys
                              if k not in ("name", "route", "source",
                                           "replaces")}
    for row in rows:
        # this kernel's launches on each of phase 12's paths
        row["phase12_launches"] = {path: n[row["name"]] for path, n in
                                   phase12.items() if n.get(row["name"])}
    print(json.dumps({"kernels": [{k: row[k] for k in
                                   (*keys, "qwen2.5-14b", "phase12_launches")
                                   if k in row}
                                  for row in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def attention_kernels(dev, HQ: int = 9, HKV: int = 3, D: int = 64,
                      tag: str = "5") -> tuple[dict, dict]:
    """Phase 5 (and 6c at Qwen2.5-14B's heads): each attention kernel
    against its plain version at a serving path's shapes, ``HQ`` query
    heads over ``HKV`` kv heads of dim ``D``; times of kernel, plain
    version and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (decode_attention,
                                                    decode_design,
                                                    decode_split,
                                                    flash_attention)

    gen = torch.Generator(device=dev).manual_seed(0)
    B, S = SERVE_BATCH, PROMPT_LEN
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
    print(f"[{tag}] flash_attention bf16 q {tuple(q.shape)} k/v "
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
    print(f"[{tag}] decode_attention bf16 q {tuple(qd.shape)} caches "
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
    from repro_torch.kernels.flash_attention import (decode_design,
                                                    decode_split)
    from repro_torch.models import decode_step, init_params, prefill

    cfg = load_config("smollm-135m")
    tokens, reqs = _traffic(cfg, dev)

    # (a) fp32: the kernels' path against the plain path
    c32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(torch.Generator(device=dev).manual_seed(0), c32, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    lp, tp, *_ = _served(c32, params, tokens, reqs, "pallas")
    lf, tf, *_ = _served(c32, params, tokens, reqs, "full")
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
    lf, tf, *_ = _served(cfg, params, tokens, reqs, "full")
    _served(cfg, params, tokens, reqs, "pallas")                      # warm-up
    lp, tp, res, wall, launches, routes = _served(cfg, params, tokens, reqs, "pallas")
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
    # phase 12a's report of the served model, on its bf16 params here
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import BatchedServer
    before = _lib.counts()
    t0 = time.perf_counter()
    report = BatchedServer(cp, params, max_len=MAX_LEN).dataflow_report(reqs)
    model["report"] = (report, time.perf_counter() - t0,
                       _lib.counts() == before)
    del params, cache
    torch.cuda.empty_cache()
    return launches, model


def _traffic(cfg, dev) -> tuple:
    """The serving phases' traffic for ``cfg``: ``SERVE_BATCH`` prompts of
    ``PROMPT_LEN`` tokens from seed 0 (on the card) and their requests of
    ``GEN`` new tokens each."""
    import torch
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(SERVE_BATCH, PROMPT_LEN)).astype(np.int32)
    reqs = [Request(i, prompts[i], GEN) for i in range(SERVE_BATCH)]
    return torch.from_numpy(prompts).to(dev), reqs


def _served(cfg, params, tokens, reqs, impl: str | None = None) -> tuple:
    """Prefill logits, then one served batch with its kernel launches
    counted from 0 and its host-clock wall: (fp32 prefill logits, greedy
    tokens, results, wall, launches, launches by design)."""
    import dataclasses

    import torch
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import prefill
    if impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=impl)
    with torch.inference_mode():
        logits, _ = prefill(params, tokens, cfg, MAX_LEN)
    server = BatchedServer(cfg, params, max_len=MAX_LEN)
    _lib.reset_counts()
    t0 = time.perf_counter()
    res = server.serve(reqs)
    wall = time.perf_counter() - t0
    launches = _lib.counts()
    return (logits.float(), np.array([r.tokens for r in res]), res, wall,
            launches, _lib.routes())


def _serving_line(res, wall: float) -> str:
    """Prefill s, decode ms a step and tok/s of one served batch, host
    clock."""
    n_tok = SERVE_BATCH * GEN
    return (f"prefill {res[0].prefill_s:.4f} s, decode "
            f"{res[0].decode_s * 1e3:.3f} ms/step ({SERVE_BATCH} sequences), "
            f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s "
            f"(host clock)")


def _memory(dev) -> str:
    import torch
    return (f"peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
            f"allocated")


def _traced_step(cfg, params, tokens, step_ms: float, name: str) -> str:
    """One decode step after a prefill of ``tokens``, under
    ``torch.profiler``: the card's busy time over the untraced step's
    host time ``step_ms``."""
    import torch
    from repro_torch.models import decode_step, prefill
    with torch.inference_mode():
        logits, cache = prefill(params, tokens, cfg, MAX_LEN)
        step = profiled(lambda: decode_step(params, logits.argmax(-1), cache,
                                            PROMPT_LEN, cfg), name)
    busy = step["busy"]
    return ("one decode step traced: device busy not measured (no device "
            "spans in the trace)" if busy is None else
            f"one decode step traced: device busy {busy:.3f} ms = "
            f"{100 * busy / step_ms:.1f} % of the untraced {step_ms:.3f} ms")


def _free() -> None:
    """Return the dropped models' memory to the card."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def serve_qwen(dev) -> dict:
    """Phase 6c: Qwen2.5-14B at full width and depth (48 layers, 40 query
    heads over 8 kv heads of dim 128); returns the attention kernels'
    rows at its shape, with their launches on its served batch."""
    import dataclasses

    import torch
    import torch.nn.functional as F
    from repro_torch.configs import load_config
    from repro_torch.kernels.flash_attention import (decode_design,
                                                    decode_split)
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import decode_step, init_params, prefill

    cfg = load_config("qwen2.5-14b")
    tokens, reqs = _traffic(cfg, dev)
    gen = torch.Generator(device=dev)
    torch.cuda.reset_peak_memory_stats(dev)

    # (a) fp32 at full depth (59 GB): the kernels' path against the plain
    c32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(gen.manual_seed(0), c32, dev)
    lp, tp, *_ = _served(c32, params, tokens, reqs, "pallas")
    lf, tf, *_ = _served(c32, params, tokens, reqs, "full")
    err = float((lp - lf).abs().max())
    require(bool(torch.isfinite(lp).all()) and lp.shape == (SERVE_BATCH,
                                                            cfg.vocab_size),
            f"6c fp32 prefill logits: shape {tuple(lp.shape)} or not finite")
    require(torch.allclose(lp, lf, rtol=1e-3, atol=1e-3),
            f"6c fp32 prefill logits, pallas vs full: max err {err}")
    require(np.array_equal(tp, tf), "6c fp32 greedy tokens, pallas != full")
    print(f"[6c] qwen2.5-14b fp32, all {cfg.num_layers} layers "
          f"({cfg.param_count()} params, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}): "
          f"pallas == full greedy tokens over {GEN} steps; prefill logits "
          f"max|Δ| {err:.3g} (rtol=atol=1e-3); {_memory(dev)}", flush=True)
    logits32 = lf
    del params
    _free()

    # (b) bf16: the kernels' path timed and counted, against the plain
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(gen.manual_seed(0), cfg, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    lf, tf, *_ = _served(cfg, params, tokens, reqs, "full")
    _served(cfg, params, tokens, reqs, "pallas")          # warm-up
    lp, tp, res, wall, launches, routes = _served(cfg, params, tokens, reqs,
                                                  "pallas")
    err = float((lp - lf).abs().max())
    scale = float(lf.abs().max())
    noise = float((lf - logits32).abs().max())
    require(bool(torch.isfinite(lp).all()), "6c bf16 logits not finite")
    require(err <= max(2e-2 * scale, noise),
            f"6c bf16 prefill logits, pallas vs full: max |Δ| {err} > both "
            f"2e-2 * {scale} and the plain path's bf16 error {noise}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split = decode_design(decode_split(SERVE_BATCH, cfg.num_kv_heads,
                                       MAX_LEN, sms))
    n_fa, n_da = launches["flash_attention"], launches["decode_attention"]
    require(n_fa == cfg.num_layers and routes["flash_attention"]
            == {"mma.sync": n_fa},
            f"6c prefill launches {n_fa} by design "
            f"{routes['flash_attention']}, expected {cfg.num_layers} on "
            f"mma.sync")
    require(n_da == cfg.num_layers * GEN and routes["decode_attention"]
            == {split: n_da},
            f"6c decode launches {n_da} by design "
            f"{routes['decode_attention']}, expected "
            f"{cfg.num_layers * GEN} on {split!r}")
    print(f"[6c] qwen2.5-14b bf16 ({n_params} params), attn_impl='pallas': "
          f"{_serving_line(res, wall)}; {_memory(dev)}; prefill logits "
          f"max|Δ| vs full {err:.4g} (max|logits| {scale:.4g}; limit the "
          f"larger of 2e-2 of it and the plain bf16 path's max|Δ| to fp32, "
          f"{noise:.4g}); greedy tokens agreeing with full "
          f"{float((tp == tf).mean()):.4f}; launches flash_attention {n_fa} "
          f"(mma.sync), decode_attention {n_da} ({split!r})", flush=True)
    cp = dataclasses.replace(cfg, attn_impl="pallas")
    with torch.inference_mode():
        logits, cache = prefill(params, tokens, cp, MAX_LEN)
        first = logits.argmax(-1)
        step = profiled(lambda: decode_step(params, first, cache, PROMPT_LEN,
                                            cp), "qwen_decode_step",
                        "decode_kernel")
        del cache
        # (c) the int8 cache against the bf16 cache, at the reference's
        # tolerance: softmax within 0.05, the same greedy token
        c8 = dataclasses.replace(cp, kv_cache_dtype="int8")
        _, cache = prefill(params, tokens, cp, MAX_LEN)
        base, _ = decode_step(params, first, cache, PROMPT_LEN, cp)
        del cache
        _, cache = prefill(params, tokens, c8, MAX_LEN)
        require(cache["segment_0"][0][0]["mixer"]["k"].dtype == torch.int8,
                "6c: the int8 cache is not int8")
        quant, _ = decode_step(params, first, cache, PROMPT_LEN, c8)
        del cache
    dp = float((F.softmax(base.float(), -1)
                - F.softmax(quant.float(), -1)).abs().max())
    require(dp < 0.05 and torch.equal(base.argmax(-1), quant.argmax(-1)),
            f"6c int8 cache: softmax max|Δ| {dp} (< 0.05) or greedy tokens "
            f"differ from the bf16 cache's")
    t0 = time.perf_counter()
    res8 = BatchedServer(c8, params, max_len=MAX_LEN).serve(reqs)
    wall8 = time.perf_counter() - t0
    tq = np.array([r.tokens for r in res8])
    busy = step["busy"]
    decode_ms = res[0].decode_s * 1e3
    print(f"[6c] int8 KV cache: first decode step's softmax max|Δ| to the "
          f"bf16 cache's {dp:.4g} (< 0.05), same greedy tokens; served: "
          f"{_serving_line(res8, wall8)}, greedy tokens agreeing with the "
          f"bf16 cache's {float((tq == tp).mean()):.4f}", flush=True)
    print(f"[6c] one bf16 decode step under torch.profiler: host "
          f"{step['wall']:.3f} ms with the profiler's cost, "
          + ("device busy not measured (no device spans in the trace)"
             if busy is None else f"device busy {busy:.3f} ms = "
             f"{100 * busy / decode_ms:.1f} % of the untraced {decode_ms:.3f}"
             f" ms step, of which the {cfg.num_layers} decode_attention "
             f"kernels {step['named']:.4f} ms"), flush=True)
    del params
    _free()
    fa_row, da_row = attention_kernels(dev, cfg.num_heads, cfg.num_kv_heads,
                                       cfg.head_dim, "6c")
    fa_row["launches"], da_row["launches"] = n_fa, n_da
    return {"flash_attention": fa_row, "decode_attention": da_row}


def serve_deepseek(dev) -> None:
    """Phase 6d: DeepSeek-V3 at full width, depth cut to its 3 dense
    layers and 1 of its 58 MoE layers, with the MTP head's parameters."""
    import dataclasses

    import torch
    from repro_torch.configs import LayerSpec, Segment, load_config
    from repro_torch.interop import _tree_map
    from repro_torch.models import decode_step, init_params, moe, prefill

    full = load_config("deepseek-v3-671b")
    dense, sparse = LayerSpec("mla", "dense"), LayerSpec("mla", "moe")
    tokens, reqs = _traffic(full, dev)
    gen = torch.Generator(device=dev)

    # (a) fp32, cut to 1 dense + 1 MoE layer and no MTP head (13.9 B
    # params, 56 GB): naive and absorbed MLA decode
    torch.cuda.reset_peak_memory_stats(dev)
    c32 = dataclasses.replace(
        full, dtype="float32", num_layers=2, mtp_depth=0,
        segments=(Segment((dense,), 1), Segment((sparse,), 1)))
    params = init_params(gen.manual_seed(0), c32, dev)
    absorbed = dataclasses.replace(c32, mla_absorbed=True)
    with torch.inference_mode():
        logits, cache = prefill(params, tokens, c32, MAX_LEN)
        first = logits.argmax(-1)
        naive_l, _ = decode_step(params, first,
                                 _tree_map(torch.clone, cache), PROMPT_LEN,
                                 c32)
        abs_l, _ = decode_step(params, first, cache, PROMPT_LEN, absorbed)
        del cache
    err = float((abs_l - naive_l).abs().max())
    require(torch.allclose(abs_l, naive_l, rtol=2e-3, atol=2e-3),
            f"6d fp32 absorbed vs naive MLA decode logits: max err {err}")
    _, tn, res_n, wall_n, *_ = _served(c32, params, tokens, reqs)
    _, ta, res_a, wall_a, *_ = _served(absorbed, params, tokens, reqs)
    require(np.array_equal(tn, ta), "6d fp32 greedy tokens, absorbed != "
            "naive MLA decode")
    print(f"[6d] deepseek-v3-671b fp32 cut to 1 dense + 1 MoE layer, no MTP "
          f"head ({c32.param_count()} params): absorbed == naive MLA decode "
          f"greedy tokens over {GEN} steps, first step's logits max|Δ| "
          f"{err:.3g} (rtol=atol=2e-3); {_memory(dev)}", flush=True)
    del params
    _free()

    # (b) bf16, 3 dense + 1 MoE layer + the MTP head: served and timed
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = dataclasses.replace(
        full, num_layers=4,
        segments=(Segment((dense,), 3), Segment((sparse,), 1)))
    params = init_params(gen.manual_seed(0), cfg, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    require("mtp" in params, "6d: no MTP head")
    dropped, inputs = [], []
    apply = moe.moe_apply

    def recorded(p, x, c):
        y, aux = apply(p, x, c)
        dropped.append(float(aux["dropped_frac"]))
        inputs.append(x)
        return y, aux

    moe.moe_apply = recorded
    try:
        with torch.inference_mode():
            logits, cache = prefill(params, tokens, cfg, MAX_LEN)
            decode_step(params, logits.argmax(-1), cache, PROMPT_LEN, cfg)
            del cache
    finally:
        moe.moe_apply = apply
    require(len(dropped) == 2, f"6d: {len(dropped)} MoE calls recorded")
    # the router on the card: sigmoid scores, top-8 of 256 lower index
    # first among ties, as on the host
    m = cfg.moe
    layer = params["segment_1"][0][0]["mlp"]
    xt = inputs[0].reshape(-1, cfg.d_model)
    scores = torch.sigmoid(xt.float() @ layer["router"])
    _, ids = moe._top_k(scores, m.top_k)
    _, ids_host = moe._top_k(scores.cpu(), m.top_k)
    require(torch.equal(ids.cpu(), ids_host),
            "6d: the card's top-8 routing differs from the host's")
    require(m.router_fn == "sigmoid" and m.num_shared == 1
            and "shared" in layer, "6d: not the sigmoid router with a "
            "shared expert")
    del inputs, scores, ids, ids_host
    _served(cfg, params, tokens, reqs)                     # warm-up
    _, tn, res_n, wall_n, *_ = _served(cfg, params, tokens, reqs)
    _, ta, res_a, wall_a, *_ = _served(
        dataclasses.replace(cfg, mla_absorbed=True), params, tokens, reqs)
    traced = _traced_step(cfg, params, tokens, res_n[0].decode_s * 1e3,
                          "deepseek_decode_step")
    print(f"[6d] deepseek-v3-671b bf16, full width, 3 dense + 1 of 58 MoE "
          f"layers + the MTP head's parameters ({n_params} params; sigmoid "
          f"top-{m.top_k} of {m.num_experts} experts + {m.num_shared} shared, "
          f"the card's routing == the host's): naive MLA decode "
          f"{_serving_line(res_n, wall_n)}; absorbed "
          f"{_serving_line(res_a, wall_a)}; greedy tokens agreeing "
          f"{float((tn == ta).mean()):.4f};"
          f" dropped_frac prefill {dropped[0]:.4f}, one decode step "
          f"{dropped[1]:.4f}; {_memory(dev)}; naive MLA's {traced}",
          flush=True)
    del params
    _free()


def serve_rwkv(dev) -> None:
    """Phase 6e: RWKV-6 1.6B at full width and depth."""
    import dataclasses

    import torch
    from repro_torch.configs import load_config
    from repro_torch.models import decode_step, forward, init_params, prefill

    cfg = load_config("rwkv6-1.6b")
    tokens, reqs = _traffic(cfg, dev)
    gen = torch.Generator(device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    # fp32, all 24 layers: prefill then decode == forward on the extended
    # sequence (the reference's 2e-3)
    c32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(gen.manual_seed(0), c32, dev)
    more = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(SERVE_BATCH, GEN)).astype(np.int32)).to(dev)
    seq = torch.cat([tokens, more], 1)
    with torch.inference_mode():
        want, _ = forward(params, seq, c32)
        got, cache = prefill(params, tokens, c32, MAX_LEN)
        worst = float((got - want[:, PROMPT_LEN - 1]).abs().max())
        ok = torch.allclose(got, want[:, PROMPT_LEN - 1], rtol=2e-3,
                            atol=2e-3)
        for i in range(GEN):
            got, cache = decode_step(params, more[:, i], cache,
                                     PROMPT_LEN + i, c32)
            w = want[:, PROMPT_LEN + i]
            worst = max(worst, float((got - w).abs().max()))
            ok = ok and torch.allclose(got, w, rtol=2e-3, atol=2e-3)
        del cache, want
    require(ok, f"6e fp32 prefill + decode vs forward: max err {worst}")
    print(f"[6e] rwkv6-1.6b fp32, all {cfg.num_layers} layers: prefill "
          f"{PROMPT_LEN} + {GEN} decode steps == forward over "
          f"{PROMPT_LEN + GEN} tokens (max|Δ| {worst:.3g}, rtol=atol=2e-3); "
          f"{_memory(dev)}", flush=True)
    del params
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(gen.manual_seed(0), cfg, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    _served(cfg, params, tokens, reqs)                     # warm-up
    logits, toks, res, wall, *_ = _served(cfg, params, tokens, reqs)
    require(bool(torch.isfinite(logits).all()), "6e bf16 logits not finite")
    traced = _traced_step(cfg, params, tokens, res[0].decode_s * 1e3,
                          "rwkv_decode_step")
    print(f"[6e] rwkv6-1.6b bf16 ({n_params} params): "
          f"{_serving_line(res, wall)}; {_memory(dev)}; {traced}",
          flush=True)
    del params
    _free()


def mamba_layer(dev) -> None:
    """Phase 6f: one Jamba-1.5-Large Mamba layer at full width, fp32."""
    import dataclasses

    import torch
    from repro_torch.configs import load_config
    from repro_torch.models import ssm

    cfg = dataclasses.replace(load_config("jamba-1.5-large-398b"),
                              dtype="float32")
    s = cfg.ssm
    seq = dataclasses.replace(cfg, ssm=dataclasses.replace(
        s, scan_impl="sequential"))
    chunked = dataclasses.replace(cfg, ssm=dataclasses.replace(
        s, scan_impl="chunked"))
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = ssm.mamba_init(gen, cfg, dev)
    n_params = sum(t.numel() for t in p.values())
    n = PROMPT_LEN + GEN
    x = torch.randn((SERVE_BATCH, n, cfg.d_model), generator=gen,
                    device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        whole = ssm.mamba_apply(p, x, seq)
        torch.cuda.synchronize()
        t_seq = time.perf_counter() - t0
        t0 = time.perf_counter()
        whole_c = ssm.mamba_apply(p, x, chunked)
        torch.cuda.synchronize()
        t_chunk = time.perf_counter() - t0
        head, cache = ssm.mamba_apply(p, x[:, :PROMPT_LEN], seq,
                                      return_cache=True)
        worst = float((head - whole[:, :PROMPT_LEN]).abs().max())
        ok = torch.allclose(head, whole[:, :PROMPT_LEN], rtol=1e-3, atol=1e-3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(GEN):
            y, cache = ssm.mamba_decode(p, x[:, PROMPT_LEN + i:PROMPT_LEN
                                             + i + 1], cache, seq)
            w = whole[:, PROMPT_LEN + i:PROMPT_LEN + i + 1]
            worst = max(worst, float((y - w).abs().max()))
            ok = ok and torch.allclose(y, w, rtol=1e-3, atol=1e-3)
        t_dec = (time.perf_counter() - t0) / GEN
    err_c = float((whole_c - whole).abs().max())
    require(ok, f"6f mamba_apply {PROMPT_LEN} + {GEN} mamba_decode != "
            f"mamba_apply {n}: max err {worst}")
    require(torch.allclose(whole_c, whole, rtol=1e-3, atol=1e-3),
            f"6f chunked scan != sequential: max err {err_c}")
    print(f"[6f] jamba-1.5-large-398b Mamba layer, fp32, full width "
          f"(d_model {cfg.d_model}, d_inner {s.d_inner}, d_state "
          f"{s.d_state}, dt_rank {s.dt_rank}; {n_params} params), batch "
          f"{SERVE_BATCH}: mamba_apply over {PROMPT_LEN} then {GEN} "
          f"mamba_decode steps == mamba_apply over {n} (max|Δ| {worst:.3g}), "
          f"chunked scan == sequential (max|Δ| {err_c:.3g}; rtol=atol=1e-3);"
          f" mamba_apply over {n}: sequential {t_seq:.3f} s, chunked "
          f"{t_chunk:.3f} s; decode {t_dec * 1e3:.3f} ms/step (host clock, "
          f"one layer); {_memory(dev)}", flush=True)
    del p, x, whole, whole_c, head, cache
    _free()


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


def fig5_grid() -> tuple:
    """Phase 4b: the Fig. 5 grid through the port's harness on the
    ``torch`` engine — SpMV, knapsack and DFS at all their Table-I
    iterations, Floyd–Warshall at its first 2^22 — each on all four
    memories, dataflow, conventional and processor, cycles equal to the
    reference's recorded grid.  Returns the inputs of SpMV's first 8-way
    (L2) N-way replay, copied on the way for phase 4c."""
    from repro_torch.core import engine, rescache
    rescache.configure(enabled=False)
    gains = {}
    captured: list = []
    nway_core = engine.nway_core

    def capture(T, seg_grp, seg_first, carried, max_run):
        if not captured and carried.shape[1] == 8:
            captured.append((T.copy(), seg_grp.copy(), seg_first.copy(),
                             carried.copy(), max_run))
        return nway_core(T, seg_grp, seg_first, carried, max_run)

    engine.nway_core = capture
    try:
        with engine.use("torch"):
            for kn, ref in REF_FIG5.items():
                gains[kn] = _fig5_kernel(kn, ref)
    finally:
        engine.nway_core = nway_core
    print("[4b] 36 cycle counts == the reference's; best dataflow vs best "
          "conventional: " + ", ".join(
              f"{kn} {g:.2f}x" + (" (first 2^22 iterations)"
                                  if kn == "floyd_warshall" else "")
              for kn, g in gains.items()), flush=True)
    require(len(captured) == 1, "SpMV's processor baseline made no 8-way "
            "replay")
    return captured[0]


def _fig5_kernel(kn: str, ref: tuple) -> float:
    """One kernel of phase 4b; returns its best-vs-best gain."""
    from repro_torch.core import engine
    from repro_torch.kernels import _lib
    from repro_torch.workloads import fig5
    n_ref, cells_ref, base_ref = ref
    engine.reset_walls()
    engine.reset_counts()
    before = _lib.counts()["running_max"]
    t0 = time.perf_counter()
    # workers=1: each task resolves in this process (the sharded
    # executor is phase 9's)
    res, task_s, _ = fig5.run_all(full=True, jobs=1, kernels=(kn,),
                                  max_iters=1 << 22, workers=1)
    wall = time.perf_counter() - t0
    launched = _lib.counts()["running_max"] - before
    nway = engine.counts()["nway_core"]
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
    print(f"[4b] {kn}: {r['n_iters_simulated']} of {r['n_iters_full']} "
          f"iterations in {wall:.2f} s ({tasks}; the processor's on the "
          f"numpy N-way core: {NUMPY_CORE_PROCESSOR_S[kn]} s, PERF.md; engine "
          f"phases: {walls}; {launched} running_max launches, {nway} "
          f"torch N-way core calls); processor {r['baseline_cycles']} "
          f"cycles", flush=True)
    require(launched > 0, f"{kn}: the torch engine launched no running_max")
    require(nway > 0, f"{kn}: the processor baseline did not replay "
            f"through the torch N-way core")
    require(r["n_iters_simulated"] == n_ref,
            f"{kn}: {r['n_iters_simulated']} iterations simulated")
    require(got == cells_ref and r["baseline_cycles"] == base_ref,
            f"{kn}: cycles {got} / {r['baseline_cycles']} differ from the "
            f"reference's {cells_ref} / {base_ref}")
    return fig5.best_vs_best(r)


def nway_on_card(args: tuple) -> None:
    """Phase 4c: one full chunk of SpMV's 8-way L2 replay through the torch
    N-way core on the card and the numpy core on the host, bit for bit;
    host-clock times of both (median of 3, after one warm-up) and the
    CUDA-event time around the torch call."""
    import torch
    from repro_torch.core import engine
    T, seg_grp, seg_first, carried, max_run = args
    want = engine._nway_core_np(*args)
    got = engine._nway_core_torch(*args)               # warm-up
    for part, a, b in (("hit flags", got[0], want[0]),
                       ("stacks", got[1], want[1])):
        require(a.dtype == b.dtype and np.array_equal(a, b),
                f"the torch N-way core's {part} differ from numpy's on the "
                f"card")
    np_s, torch_s, event_ms = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        engine._nway_core_np(*args)
        np_s.append(time.perf_counter() - t0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        engine._nway_core_torch(*args)
        end.record()
        end.synchronize()
        torch_s.append(time.perf_counter() - t0)
        event_ms.append(start.elapsed_time(end))
    W, G = T.shape
    print(f"[4c] SpMV's first 8-way L2 replay (one 2^20-iteration chunk: "
          f"{W} x {G} tag table {T.dtype}, {len(carried)} sets, longest run "
          f"{max_run} segments): torch core on the card == numpy core, hit "
          f"flags and stacks bit for bit; numpy "
          f"{statistics.median(np_s) * 1e3:.2f} ms, torch "
          f"{statistics.median(torch_s) * 1e3:.2f} ms on the host clock "
          f"(copies in and out included), "
          f"{statistics.median(event_ms):.2f} ms between CUDA events around "
          f"the call", flush=True)
    # the whole of SpMV's processor baseline on each core, in this call
    from repro_torch.core.simulator import simulate_processor
    from repro_torch.workloads import fig5
    k = fig5.make_kernel("spmv")
    traces = list(k.full_traces.values())
    secs = {}
    for eng in ("numpy", "torch"):
        t0 = time.perf_counter()
        with engine.use(eng):
            r = simulate_processor(k.instrs_per_iter, traces, k.n_iters_full)
        secs[eng] = time.perf_counter() - t0
        require(r.cycles == REF_FIG5["spmv"][2], f"SpMV's processor baseline "
                f"on the {eng} engine: {r.cycles} cycles")
    print(f"[4c] SpMV's whole processor baseline ({k.n_iters_full} "
          f"iterations, {REF_FIG5['spmv'][2]} cycles on both): numpy engine "
          f"{secs['numpy']:.2f} s, torch engine {secs['torch']:.2f} s (host "
          f"clock)", flush=True)


def explore_knapsack(dev) -> None:
    """Phase 8: ``Compiled.explore`` on knapsack's Table-I body at 2^17
    iterations on the torch engine; the front must be the reference's."""
    import repro_torch
    from repro_torch.core import engine
    from repro_torch.kernels import _lib
    from repro_torch.workloads import fig5
    w = fig5.make_kernel("knapsack", dev)
    c = repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                            loop=True,
                            nonaliasing_carries=w.nonaliasing_carries)
    _lib.reset_counts()
    engine.reset_walls()
    t0 = time.perf_counter()
    with engine.use("torch"):
        res = c.explore(traces=list(w.full_traces.values()),
                        n_iters=DSE_ITERS, max_candidates=12,
                        use_rescache=False)
    wall = time.perf_counter() - t0
    launched = _lib.counts()["running_max"]
    front = tuple((x.resources["num_stages"], x.fifo_bits, x.cycles)
                  for x in res.front)
    walls = ", ".join(f"{k} {v:.2f} s" for k, v in
                      sorted(engine.walls().items()))
    print(f"[8] explore(knapsack, {DSE_ITERS} iterations, 12 candidates, "
          f"torch engine): {len(res.evaluated())} simulated, front (stages, "
          f"FIFO bits, cycles) {list(front)} in {wall:.2f} s (engine "
          f"phases: {walls}; {launched} running_max launches)", flush=True)
    require(front == REF_DSE, f"the DSE front {front} != the reference's "
            f"{REF_DSE}")
    require(len(res.evaluated()) == REF_DSE_EVALUATED,
            f"{len(res.evaluated())} candidates simulated, the reference "
            f"{REF_DSE_EVALUATED}")
    require(launched > 0, "the DSE launched no running_max on the card")
    require(all(f.compiled is not None and f.compiled.device.type == "cuda"
                for f in res.front), "a front point has no CUDA artifact")


def _spawned_setup(q) -> None:
    """A spawned process's set-up: what a pool or daemon worker imports
    before its first chunk."""
    import repro_torch.core.chunkgraph  # noqa: F401
    import repro_torch.serve.worker  # noqa: F401
    q.put(time.time())


def shard_and_serve(c, traces: list, mem, n: int) -> None:
    """Phase 9: the Fig. 5 SpMV ACP cell through the chunk-graph pool
    (``workers=4``) and through a resolution daemon (``server=``), each
    equal to the reference's cycles; the daemon must have served the
    request and must exit on ``shutdown``."""
    import multiprocessing
    import shutil
    from repro_torch import serve
    from repro_torch.core import chunkgraph, engine, rescache
    from repro_torch.core.simulator import simulate_dataflow_many
    stages = c.sim_stages(traces=traces)
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    t0 = time.time()
    probe = ctx.Process(target=_spawned_setup, args=(q,))
    probe.start()
    spawn_s = q.get(timeout=120) - t0
    probe.join(timeout=60)
    with engine.use("torch"):
        runs = chunkgraph._POOL_RUNS
        engine.reset_walls()
        t0 = time.perf_counter()
        sharded = simulate_dataflow_many(
            stages, {"ACP": mem}, n, fifo_depths=(FIFO_DEPTH,), workers=4,
            use_rescache=False, collect_stalls=False)[("ACP", FIFO_DEPTH)]
        shard_s = time.perf_counter() - t0
        require(chunkgraph._POOL_RUNS == runs + 1,
                "workers=4: the chunk-graph pool did not engage")
        print(f"[9] SpMV ACP, {n} iterations, workers=4 (chunk-graph pool, "
              f"torch engine): dataflow {sharded.cycles} cycles (reference "
              f"{REF_DATAFLOW_CYCLES}) in {shard_s:.2f} s (engine phases, "
              f"the workers' summed in: {_walls()}); a spawned worker's "
              f"set-up (imports) {spawn_s:.2f} s", flush=True)
        require(sharded.cycles == REF_DATAFLOW_CYCLES,
                "workers=4: cycles differ from the reference's")

        store = os.path.join(ROOT, "build", "serve_store")
        shutil.rmtree(store, ignore_errors=True)
        rescache.clear()
        rescache.configure(enabled=True, directory=store)
        addr, pid = None, None
        try:
            t0 = time.perf_counter()
            addr = serve.ensure_daemon(workers=4)
            setup_s = time.perf_counter() - t0
            with open(addr + ".pid") as f:
                pid = int(f.read().split(".")[0])
            engine.reset_walls()
            t0 = time.perf_counter()
            served = simulate_dataflow_many(
                stages, {"ACP": mem}, n, fifo_depths=(FIFO_DEPTH,),
                collect_stalls=False, server=addr)[("ACP", FIFO_DEPTH)]
            serve_s = time.perf_counter() - t0
            st = serve.get_stats(addr)
            print(f"[9] the same through a resolution daemon "
                  f"(ensure_daemon: 4 workers, torch engine, a fresh store; "
                  f"up in {setup_s:.2f} s): dataflow {served.cycles} cycles "
                  f"in {serve_s:.2f} s (this client's engine phases: "
                  f"{_walls()}); daemon stats: accepted "
                  f"{st['admission']['accepted']}, chunks cold "
                  f"{st['dedup']['cold_chunks']} / store "
                  f"{st['dedup']['store_chunks']} / in flight "
                  f"{st['dedup']['inflight_chunks']}, jobs completed "
                  f"{st['jobs_completed']}", flush=True)
            require(served.cycles == REF_DATAFLOW_CYCLES,
                    "server=: cycles differ from the reference's")
            require(st["admission"]["accepted"] >= 1
                    and st["dedup"]["cold_chunks"] >= 1
                    and st["jobs_completed"] >= 1,
                    "the daemon did not resolve the request (resolved "
                    "locally?)")
            stopped = serve.shutdown(addr)
            addr = None
            require(stopped, "the daemon did not acknowledge shutdown")
            require(_reaped(pid, 60), "the daemon did not exit")
            pid = None
            print("[9] shutdown acknowledged; the daemon's process exited",
                  flush=True)
        finally:
            if addr is not None:
                serve.shutdown(addr)
            if pid is not None and not _reaped(pid, 10):
                os.kill(pid, 9)
                _reaped(pid, 10)
            rescache.clear()
            rescache.configure(enabled=False)


def _train_batch(cfg, torch) -> dict:
    """Phase 11a's batch for ``cfg``: the synthetic stream's step 0 at
    seed 1 (2 x 16 tokens), or seeded embeddings and those labels where
    the config takes embeddings; on the CPU."""
    from repro_torch.data import DataConfig, synthetic_stream
    tokens = next(synthetic_stream(DataConfig(2, 16, cfg.vocab_size,
                                              seed=1)))["tokens"]
    if cfg.frontend_stub:
        emb = np.random.default_rng(1).normal(
            size=(2, 16, cfg.d_model)).astype(np.float32)
        return {"embeds": torch.from_numpy(emb),
                "labels": torch.from_numpy(tokens[:, 1:])}
    return {"tokens": torch.from_numpy(tokens)}


def _max_err(got, want, *, rtol: float, scale_atol: float = 0.0,
             atol: float = 0.0) -> tuple[float, bool]:
    """Largest |got − want| over the aligned leaves of two trees, and
    whether every leaf is within atol + scale_atol·max|want_leaf| +
    rtol·|want| (the CPU tests' ``_leaves_close``)."""
    from repro_torch import tree
    worst, ok = 0.0, True
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        d = (g - w).abs()
        worst = max(worst, float(d.max()))
        bound = atol + scale_atol * float(w.abs().max()) + rtol * w.abs()
        ok = ok and bool((d <= bound).all())
    return worst, ok


def _adamw_plain(params, mu, nu, opt_cfg):
    """The first AdamW step (count 1, LR scale 1) from the moments ``mu``
    and ``nu``, leaf by leaf in fp32 on the CPU: the reference's formula
    ``(m/b1c)/(sqrt(v/b2c)+eps) + wd·p`` with its decay mask."""
    from repro_torch import tree
    from repro_torch.optim.adamw import _decay_mask
    b1c, b2c = 1 - opt_cfg.b1, 1 - opt_cfg.b2
    out = []
    for (path, p), m, v in zip(tree.flatten_with_paths(params),
                               tree.leaves(mu), tree.leaves(nu)):
        p32, m, v = p.float().cpu(), m.float().cpu(), v.float().cpu()
        u = (m / b1c) / ((v / b2c).sqrt() + opt_cfg.eps)
        if opt_cfg.weight_decay and _decay_mask(path, p):
            u = u + opt_cfg.weight_decay * p32
        out.append((p32 - opt_cfg.lr * u).to(p.dtype))
    return tree.unflatten(params, out)


def train_on_card(dev) -> None:
    """Phase 11: training on the card (see the module docstring)."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch import tree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ARCH_IDS, load_config, reduced
    from repro_torch.data import DataConfig, synthetic_stream
    from repro_torch.kernels import _lib
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import AdamWConfig, init_opt_state

    cpu = torch.device("cpu")

    # (a) one train step of each reduced config, fp32, card vs CPU
    opt_cfg = AdamWConfig()
    for arch in ARCH_IDS:
        cfg = reduced(load_config(arch))
        params = init_params(torch.Generator().manual_seed(0), cfg, cpu)
        batch = _train_batch(cfg, torch)
        # warmup 0: the first step already takes the whole LR
        step = make_train_step(cfg, opt_cfg, total_steps=10, warmup_steps=0)

        def run(d):
            p = tree.tree_map(lambda t: t.to(d), params)
            st = TrainState(p, init_opt_state(p, opt_cfg),
                            torch.zeros((), dtype=torch.int32, device=d))
            return step(st, {k: v.to(d) for k, v in batch.items()})

        (sc, mc), (sg, mg) = run(cpu), run(dev)
        errs = {}
        for k, want in mc.items():
            got = float(mg[k])
            rtol = 1e-3 if k == "grad_norm" else 1e-4
            errs[k] = abs(got - float(want))
            require(errs[k] <= rtol * abs(float(want)) + 1e-12,
                    f"[11a] {arch}: {k} {got} on the card vs {float(want)} "
                    f"on the CPU (rtol {rtol})")
        # the moments carry the grads: card vs CPU at the three-step
        # test's bars; the card's params against the plain AdamW step
        # from the card's own moments at apply_updates' test bars (card
        # vs CPU params are printed: where a grad is within a few eps of
        # 0, Adam's first step g/(|g|+eps) magnifies its rounding up to
        # the whole LR)
        bars = {"mu": (sg.opt["mu"], sc.opt["mu"], dict(rtol=1e-3,
                                                        scale_atol=1e-4)),
                "nu": (sg.opt["nu"], sc.opt["nu"], dict(rtol=1e-3,
                                                        scale_atol=1e-4)),
                "params vs the plain step": (
                    sg.params, _adamw_plain(params, sg.opt["mu"],
                                            sg.opt["nu"], opt_cfg),
                    dict(rtol=1e-6, atol=1e-7))}
        for k, (got, want, bar) in bars.items():
            errs[k], ok = _max_err(got, want, **bar)
            require(ok, f"[11a] {arch}: {k} after the step, max|Δ| "
                        f"{errs[k]:.3g} over {bar}")
        errs["params card vs CPU"], _ = _max_err(sg.params, sc.params,
                                                 rtol=0.0)
        print(f"[11a] {arch} (reduced, fp32), one train step card vs CPU: "
              + ", ".join(f"{k} max|Δ| {v:.3g}" for k, v in errs.items()),
              flush=True)

    # (b) SmolLM-135M whole, bf16 params, fp32 moments
    _free()
    cfg = load_config("smollm-135m")
    n_params = cfg.param_count()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = (6 * n_params * tokens
             + 12 * cfg.num_layers * cfg.d_model * TRAIN_SEQ * tokens)
    kw = dict(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, lr=TRAIN_LR,
              ckpt_every=TRAIN_CKPT_EVERY, seed=0, device=dev)
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as ckdir:
        _lib.reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = train_loop(cfg, steps=TRAIN_STEPS, ckpt_dir=ckdir, **kw)
        wall = time.perf_counter() - t0
        launched = {k: v for k, v in _lib.counts().items() if v}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        losses = out["losses"]
        require(len(losses) == TRAIN_STEPS
                and all(np.isfinite(x) for x in losses),
                f"[11b] losses: {losses}")
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        require(last < first, f"[11b] the loss did not fall: mean of the "
                              f"first 5 {first}, of the last 5 {last}")
        require(not launched, f"[11b] the training path launched hand "
                              f"kernels: {launched}")
        state = out["state"]
        restored, at = Checkpointer(ckdir).restore(state)
        require(at == TRAIN_STEPS and all(
            torch.equal(a.view(torch.int16), b.view(torch.int16))
            if a.dtype == torch.bfloat16 else torch.equal(a, b)
            for a, b in zip(tree.leaves(restored), tree.leaves(state))),
            "[11b] the restored checkpoint differs from the state in "
            "memory")
    med = statistics.median(out["step_s"][3:])
    print(f"[11b] smollm-135m bf16 ({n_params} params, {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, tied), "
          f"{TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens, lr "
          f"{TRAIN_LR}, a checkpoint every {TRAIN_CKPT_EVERY} steps: loss "
          + ", ".join(f"step {i} {losses[i]:.4f}"
                      for i in (0, 10, 20, TRAIN_STEPS - 1))
          + f"; mean of the first 5 {first:.4f} > of the last 5 {last:.4f}"
          f"; {wall:.2f} s in all (host clock)", flush=True)
    print(f"[11b] median step over steps 3-{TRAIN_STEPS - 1} "
          f"{med * 1e3:.2f} ms (host clock, the loss read back) = "
          f"{tokens / med:.0f} tokens/s; model FLOP/s (6*N*tokens + "
          f"12*L*d*S*tokens = 6*{n_params}*{tokens} + 12*{cfg.num_layers}*"
          f"{cfg.d_model}*{TRAIN_SEQ}*{tokens} = {flops / 1e12:.3f} TFLOP a "
          f"step) {flops / med / 1e12:.1f} TFLOP/s = "
          f"{100 * flops / med / BF16_TC_OPS_PER_S:.1f} % of the bf16 dense "
          f"peak {BF16_TC_OPS_PER_S / 1e12:.0f} TFLOP/s; peak allocated "
          f"{peak:.2f} GiB; no hand kernel launched; the checkpoint of step "
          f"{TRAIN_STEPS} restores bit for bit", flush=True)
    step_fn = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR),
                              total_steps=TRAIN_STEPS,
                              warmup_steps=max(1, TRAIN_STEPS // 20))
    batch = {"tokens": torch.from_numpy(next(synthetic_stream(
        DataConfig(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size, seed=0),
        start_step=TRAIN_STEPS))["tokens"]).to(dev)}
    traced = profiled(lambda: step_fn(state, batch), "train_step")
    busy = traced["busy"]
    print("[11b] one train step under torch.profiler: "
          + ("device busy not measured (no device spans in the trace)"
             if busy is None else
             f"device busy {busy:.2f} ms = {100 * busy / (med * 1e3):.1f} % "
             f"of the untraced median step; {traced['launches']} kernel "
             f"launches; the five longest device ops: "
             + "; ".join(f"{n[:110]} {ms:.2f} ms ({k}x)"
                         for n, ms, k in traced["top"])), flush=True)
    del state, restored, batch

    # (c) recovery from an injected failure, and a resume
    with tempfile.TemporaryDirectory(dir=scratch) as ckdir:
        failed = train_loop(cfg, steps=TRAIN_STEPS, ckpt_dir=ckdir,
                            fail_at=TRAIN_FAIL_AT, **kw)
    with tempfile.TemporaryDirectory(dir=scratch) as ckdir:
        train_loop(cfg, steps=TRAIN_CUT, ckpt_dir=ckdir,
                   schedule_steps=TRAIN_STEPS, **kw)
        resumed = train_loop(cfg, steps=TRAIN_STEPS, ckpt_dir=ckdir,
                             schedule_steps=TRAIN_STEPS, **kw)
    final = out["final_loss"]
    require(failed["failures"] == failed["restores"] == 1,
            f"[11c] failures {failed['failures']}, restores "
            f"{failed['restores']}")
    for name, run in (("recovered", failed), ("resumed", resumed)):
        require(abs(run["final_loss"] - final) <= 1e-3 * abs(final),
                f"[11c] {name} final loss {run['final_loss']} vs "
                f"{final} uninterrupted (rtol 1e-3)")
    print(f"[11c] failure injected at step {TRAIN_FAIL_AT}: failures 1, "
          f"restores 1 (from step {TRAIN_CKPT_EVERY}), final loss "
          f"{failed['final_loss']:.6f} (bit for bit the uninterrupted "
          f"{final:.6f}: {failed['final_loss'] == final}); {TRAIN_CUT} steps "
          f"then resumed to {TRAIN_STEPS}: final loss "
          f"{resumed['final_loss']:.6f} (bit for bit: "
          f"{resumed['final_loss'] == final})", flush=True)
    del out, failed, resumed
    _free()

    # (d) the guard: the attention kernel under autograd raises
    cp = dataclasses.replace(cfg, attn_impl="pallas")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cp, dev)
    batch = {"tokens": torch.from_numpy(next(synthetic_stream(DataConfig(
        2, 256, cfg.vocab_size, seed=0)))["tokens"]).to(dev)}
    st = TrainState(params, init_opt_state(params, opt_cfg),
                    torch.zeros((), dtype=torch.int32, device=dev))
    try:
        make_train_step(cp, opt_cfg)(st, batch)
        raised = ""
    except NotImplementedError as e:
        raised = str(e)
    require("reference cannot differentiate" in raised,
            f"[11d] a train step through the attention kernel did not "
            f"raise the guard's error ({raised!r})")
    _lib.reset_counts()
    with torch.no_grad():
        lk, _ = loss_fn(params, batch, cp)
    n_fa = _lib.counts()["flash_attention"]
    with torch.no_grad():
        lf, _ = loss_fn(params, batch, cfg)
    require(n_fa == cfg.num_layers, f"[11d] flash_attention launched {n_fa} "
                                    f"times, not {cfg.num_layers}")
    require(abs(float(lk) - float(lf)) <= 1e-2 * abs(float(lf)),
            f"[11d] loss through the kernels {float(lk)} vs {float(lf)}")
    print(f"[11d] a train step with attn_impl='pallas' raises "
          f"NotImplementedError (\"{raised[:60]}...\"); under "
          f"torch.no_grad() the same loss launches flash_attention {n_fa} "
          f"times: {float(lk):.5f}, the plain path {float(lf):.5f} (bf16, "
          f"rtol 1e-2)", flush=True)
    del params, st
    _free()


def reports_on_card(served: tuple) -> None:
    """Phase 12a: the decode-step dataflow report of the served
    SmolLM-135M (phase 6b's bf16 params on the card) and of all ten
    architectures at full width from abstract params, each held to the
    reference's (``REF_REPORTS``); no kernel may launch; no request gives
    the "unavailable" string."""
    import torch
    from repro_torch.configs import ARCH_IDS, load_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import init_params
    text, wall, quiet = served
    require(report_key(text) == REF_REPORTS["smollm-135m"],
            f"the served smollm-135m's report is not the reference's:\n{text}")
    require(quiet, "the served model's report launched a kernel")
    print(f"[12a] served smollm-135m (bf16 on the card, batch "
          f"{REPORT_BATCH}, max_len {REPORT_MAX_LEN}): "
          f"{text.splitlines()[0]} — == reference, in {wall:.3f} s",
          flush=True)
    reqs = [Request(i, np.zeros(4, np.int32), 2) for i in range(REPORT_BATCH)]
    before = _lib.counts()
    walls = []
    for arch in ARCH_IDS:
        cfg = load_config(arch)
        t0 = time.perf_counter()
        server = BatchedServer(cfg, init_params(None, cfg, "meta"),
                               max_len=REPORT_MAX_LEN)
        report = server.dataflow_report(reqs)
        walls.append(time.perf_counter() - t0)
        require(report_key(report) == REF_REPORTS[arch],
                f"{arch}: the report is not the reference's:\n{report}")
        counts = report_key(report)[0]
        print(f"[12a] {arch} full width, abstract params: {counts[0]} ops -> "
              f"{counts[1]} stages, {counts[2]} channels ({counts[3]} "
              f"B/token), {len(report_key(report)[2])} stage lines == "
              f"reference, in {walls[-1]:.3f} s", flush=True)
    empty = server.dataflow_report([])
    require(empty.startswith("(dataflow analysis unavailable:"),
            f"dataflow_report([]): {empty!r}")
    require(_lib.counts() == before, "a report launched a kernel")
    print(f"[12a] ten reports in {sum(walls):.3f} s, no kernel launched; "
          f"dataflow_report([]) = {empty!r}", flush=True)
    torch.cuda.empty_cache()


def faults_on_card(dev) -> dict:
    """Phase 12b: F6 and F7 on the card.  fp32 SmolLM-135M serves phase
    6's 8 prompts of 512 tokens with a ``max_len`` of 520 and 32 new
    tokens (24 steps past the end): the kernels' path and the plain path
    must serve the same tokens.  A prompt with ids V, V + 3, −1 and −V − 2
    must serve without a device-side assert, with prefill and decode
    logits within 1e-3 of the CPU port's on the same weights and the same
    tokens.  Reduced Qwen2.5 (int8 cache) and DeepSeek-V3 (MLA, naive and
    absorbed) decode past ``max_len`` on the card and on the CPU: logits
    within 1e-3, greedy tokens equal.  Returns the hand kernels'
    launches on the fp32 kernels' path."""
    import dataclasses

    import torch
    from repro_torch import tree
    from repro_torch.configs import load_config, reduced
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import decode_step, init_params, prefill

    cfg = dataclasses.replace(load_config("smollm-135m"), dtype="float32")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    tokens, reqs = _traffic(cfg, dev)
    max_len = PROMPT_LEN + 8
    served, launches = {}, {}
    for impl in ("pallas", "full"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        _lib.reset_counts()
        t0 = time.perf_counter()
        res = BatchedServer(c, params, max_len=max_len).serve(reqs)
        wall = time.perf_counter() - t0
        launches[impl] = _lib.counts()
        served[impl] = np.array([r.tokens for r in res])
        print(f"[12b] smollm-135m fp32 {impl!r}, max_len {max_len}, {GEN} new "
              f"tokens ({PROMPT_LEN + GEN - max_len} steps past the end): "
              f"{_serving_line(res, wall)}", flush=True)
    require(np.array_equal(served["pallas"], served["full"]),
            "past max_len the kernels' tokens differ from the plain path's")
    require(launches["pallas"]["decode_attention"] == GEN * cfg.num_layers,
            f"decode_attention launches past max_len: "
            f"{launches['pallas']['decode_attention']}")
    V = cfg.vocab_size
    ids = np.array([[1, 2, V, V + 3, -1, -V - 2, 4, 5]], np.int32)
    cp = dataclasses.replace(cfg, attn_impl="pallas")
    host = tree.tree_map(lambda t: t.cpu(), params)
    worst = 0.0
    with torch.inference_mode():
        got = {}
        for where, p in (("card", params), ("cpu", host)):
            d = dev if where == "card" else torch.device("cpu")
            logits, cache = prefill(p, torch.from_numpy(ids).to(d), cp, 16)
            step, _ = decode_step(p, torch.tensor([V + 3], device=d), cache,
                                  ids.shape[1], cp)
            got[where] = (logits.cpu(), step.cpu())
        torch.cuda.synchronize()
        for a, b in zip(got["card"], got["cpu"]):
            worst = max(worst, float((a - b).abs().max()))
            require(torch.allclose(a, b, rtol=1e-3, atol=1e-3),
                    f"ids out of range: card vs CPU logits max|Δ| "
                    f"{float((a - b).abs().max())}")
    print(f"[12b] prompt with ids V, V+3, -1, -V-2 (V = {V}) and a decode "
          f"step on id V+3: served on the card without a device-side "
          f"assert; prefill and decode logits card vs CPU max|Δ| "
          f"{worst:.3g} (rtol=atol=1e-3)", flush=True)
    del params, host
    _free()
    rng = np.random.default_rng(5)
    for arch, change in (("qwen2.5-14b", {"kv_cache_dtype": "int8"}),
                         ("deepseek-v3-671b", {"mla_absorbed": False}),
                         ("deepseek-v3-671b", {"mla_absorbed": True})):
        c = dataclasses.replace(reduced(load_config(arch)), **change)
        host = init_params(torch.Generator().manual_seed(0), c, "cpu")
        card = tree.tree_map(lambda t: t.to(dev), host)
        prompt = rng.integers(0, c.vocab_size, size=(2, 8)).astype(np.int32)
        worst, toks = 0.0, {}
        with torch.inference_mode():
            out = {}
            for where, p, d in (("cpu", host, torch.device("cpu")),
                                ("card", card, dev)):
                logits, cache = prefill(p, torch.from_numpy(prompt).to(d),
                                        c, 10)
                seq = [logits.cpu()]
                for step in range(6):            # lengths 8..13 of 10 slots
                    # both devices decode the CPU's greedy tokens
                    tok = out.get("cpu", seq)[step].argmax(-1)
                    logits, cache = decode_step(p, tok.to(d), cache,
                                                8 + step, c)
                    seq.append(logits.cpu())
                out[where] = seq
                toks[where] = [t.argmax(-1).tolist() for t in seq]
        for a, b in zip(out["card"], out["cpu"]):
            worst = max(worst, float((a - b).abs().max()))
        require(worst <= 1e-3 * max(1.0, max(float(b.abs().max())
                                            for b in out["cpu"])),
                f"{arch} {change} past max_len: card vs CPU max|Δ| {worst}")
        require(toks["card"] == toks["cpu"],
                f"{arch} {change} past max_len: card tokens differ")
        print(f"[12b] reduced {arch} {change}: prefill of 8 then 6 decode "
              f"steps against 10 slots, card vs CPU logits max|Δ| "
              f"{worst:.3g}, greedy tokens equal", flush=True)
        del card, host
    _free()
    return {"12b smollm-135m past max_len": launches["pallas"]}


def examples_and_paper(dev) -> dict:
    """Phase 12c: each example's ``main()`` on the card, then Fig. 2,
    Table II and ``sweep --smoke``, each held to the reference's
    constants; each one's wall and hand-kernel launches.  The examples'
    printout goes to ``build/chip_smoke_examples.txt``."""
    import contextlib
    import hashlib
    import io
    import shutil

    from repro_torch.examples import (quickstart, serve_decode,
                                      spmv_dataflow, train_lm)
    from repro_torch.kernels import _lib
    from repro_torch.workloads import fig2_schedule, sweep, table2

    launches, log = {}, []

    def run(name: str, fn, *args):
        _lib.reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn(*args)
        wall = time.perf_counter() - t0
        launches[f"12c {name}"] = {k: n for k, n in _lib.counts().items()
                                   if n}
        log.append(f"==== {name} ({wall:.2f} s)\n{buf.getvalue()}")
        return out, buf.getvalue(), wall

    _, text, wall = run("examples.quickstart", quickstart.main, [])
    require(text.count("OK (== direct call)") == 3
            and "backend systolic  : unavailable" in text
            and "systolic stream (4 stages, 6 microbatches): OK" in text,
            f"quickstart:\n{text}")
    require(all(f"({n} cycles)" in text for n in REF_QUICKSTART_CYCLES),
            f"quickstart's simulation is not the reference's:\n{text}")
    print(f"[12c] examples.quickstart: three backends == direct call, "
          f"systolic unavailable, stream OK, simulation cycles "
          f"{REF_QUICKSTART_CYCLES} == reference, in {wall:.2f} s", flush=True)
    _, text, wall = run("examples.spmv_dataflow", spmv_dataflow.main, [])
    require(REF_SPMV_EXAMPLE_LINE in text and "BSR SpMV" in text,
            f"spmv_dataflow:\n{text}")
    n = launches["12c examples.spmv_dataflow"]
    require(n.get("spmv_bsr", 0) >= 1, f"spmv_dataflow launched {n}")
    print(f"[12c] examples.spmv_dataflow (the main path): report, "
          f"{REF_SPMV_EXAMPLE_LINE!r} == reference, BSR product == dense; "
          f"launches {n}, in {wall:.2f} s", flush=True)
    tokens, text, wall = run("examples.serve_decode", serve_decode.main, [])
    require(all(len(t) == 16 for kv in tokens.values() for t in kv),
            f"serve_decode:\n{text}")
    print(f"[12c] examples.serve_decode: bf16 and int8 caches served 4 x 16 "
          f"tokens, first request {tokens['bf16'][0][:6]} / "
          f"{tokens['int8'][0][:6]}; launches "
          f"{launches['12c examples.serve_decode']}, in {wall:.2f} s",
          flush=True)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_train_lm")
    shutil.rmtree(ckpt, ignore_errors=True)
    out, text, wall = run("examples.train_lm", train_lm.main,
                          ["--ckpt-dir", ckpt])
    shutil.rmtree(ckpt, ignore_errors=True)
    losses = out["losses"]
    print(f"[12c] examples.train_lm: reduced smollm, {len(losses)} steps, "
          f"loss {sum(losses[:10]) / 10:.3f} -> {sum(losses[-10:]) / 10:.3f}"
          f" (must fall), in {wall:.2f} s", flush=True)
    text, _, wall = run("workloads.fig2_schedule", fig2_schedule.main, [])
    require(hashlib.sha256(text.encode()).hexdigest()
            == "".join(REF_FIG2_SHA256)
            and f"{REF_FIG2_CONVENTIONAL_CYCLES} cycles" in text,
            f"Fig. 2 text is not the reference's:\n{text}")
    print(f"[12c] workloads.fig2_schedule: text == reference (SHA-256), in "
          f"{wall:.2f} s", flush=True)
    out, _, wall = run("workloads.table2", table2.main, ["--out", ""])
    got = {r["kernel"]: (r["nodes"], r["stages_dataflow"],
                         r["stages_conventional"], r["channels"],
                         r["channel_bytes_per_token"], r["duplicated_ops"],
                         r["ops_per_stage"], r["op_instances_conventional"],
                         r["op_instances_dataflow"]) for r in out["rows"]}
    require(got == REF_TABLE2, f"Table II rows: {got}")
    print(f"[12c] workloads.table2: four rows == reference, in {wall:.2f} s",
          flush=True)
    # the --smoke grid's tasks and measure_perf, as run_sweep(smoke=True)
    # runs them, with the trace store off; its worker-scaling probe (8 x
    # 2^20 iterations, streamed and sharded) is left out: phase 9 shards
    # the Fig. 5 SpMV cell already
    def smoke_sweep() -> dict:
        from repro_torch.core import rescache
        from repro_torch.workloads import ALL_KERNELS
        rescache.configure(enabled=False)
        t0 = time.perf_counter()
        rows = sweep.run_tasks(sweep._tasks(
            True, tuple(ALL_KERNELS)[:2], (0.5, 1.0), None, None, None))
        perf = sweep.measure_perf()
        return {"rows": rows, "perf": perf,
                "wall_s": time.perf_counter() - t0}

    out, _, wall = run("workloads.sweep --smoke", smoke_sweep)
    got = tuple((r["kernel"], r["mem"], r.get("transform") or "none",
                 r["words_per_cycle"], r["dataflow_cycles"],
                 r["conventional_cycles"]) for r in out["rows"])
    require(got == REF_SWEEP_SMOKE, f"sweep --smoke cycles: {got}")
    print(f"[12c] workloads.sweep --smoke: {len(got)} grid points' cycles == "
          f"reference (the grid and measure_perf {out['wall_s']:.2f} s; the "
          f"worker-scaling probe left out), launches "
          f"{launches['12c workloads.sweep --smoke']}, in {wall:.2f} s",
          flush=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_examples.txt"),
              "w") as f:
        f.write("\n".join(log))
    return launches


def _walls() -> str:
    from repro_torch.core import engine
    return ", ".join(f"{k} {v:.2f} s" for k, v in
                     sorted(engine.walls().items())) or "none"


def _reaped(pid: int, timeout: float) -> bool:
    """Wait up to ``timeout`` s for this process's child ``pid`` to exit,
    reaping it."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            done, _ = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:         # already reaped
            return True
        if done:
            return True
        if time.monotonic() > deadline:
            return False
        time.sleep(0.1)


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
