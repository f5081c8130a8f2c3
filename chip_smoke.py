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
13. the multi-rank executors: four ranks (``launch.mesh.spawn``, gloo,
   all on the card, tensors shifted through pinned host buffers) after
   the one-process references here; (a) SmolLM-135M's 30 blocks as 3
   stages of 10 on 3 ranks (``pipeline_apply``), 8 microbatches of 1 x
   512 tokens from phase 6's traffic embedded first; ``flash_attention``
   alone at the path's q 1 x 9 x 512 x 64 against its plain version
   (phase 5's bars); the same blocks in sequence in this process through
   the kernels against the plain attention (fp32 rtol=atol=1e-4; bf16
   within 2e-2 of the scale or twice the plain bf16 path's own error),
   then the pipeline against the kernels' run in sequence (fp32 as
   before, bf16 at phase 6b's bar), ``flash_attention`` launched 80
   times on each rank; (b) the gradient of mean(y²) through the pipeline
   (fp32, the plain attention) against ``pipeline_apply_emulated``'s
   autograd here, every leaf within 1e-4·|g| + 1e-4·max|g|; (c) each of
   the 3 ranks' whole fp32 gradient of the LM loss on its own
   microbatch reduced by ``compress_tree_psum`` within S · ½ · the
   shared scale of each chunk of the fp32 ``all_reduce``, with the bytes
   each rank hands the collectives; (d) the quickstart kernel on the ``systolic``
   backend and a 6-microbatch stream on its sharded pipeline over the 4
   ranks (rtol 1e-6), and ``decoupled_gather_staged`` of phase 7's 4,096
   rows on ``systolic`` bit for bit; with the route, walls, the shift's
   ms a tick and each rank's peak memory;
14. the production dry run (launches no hand kernel): (a) the card's
   constants (``runtime/sharding.py``) against
   ``get_device_properties(0).total_memory`` and ``nvidia-smi``; every
   leaf's spec of the ten architectures at full width, on the 16×16 and
   2×16×16 meshes, under the train, serve ``tp`` / ``2d`` and
   ``ep_serve``, cache and batch rules, held to ``REF_DRYRUN_SPECS`` (a
   digest an architecture); one rank's argument bytes of all 64
   applicable cells under the reference's 16 GiB HBM, held to
   ``REF_DRYRUN_ARGS``; the cells whose serve policy the card's 80 GB
   changes, printed; (b) ``launch.dryrun.run_cell`` on a fake world
   (device type ``cuda``) for the ten ``decode_32k`` cells on 16×16,
   SmolLM-135M's and DeepSeek-V3's ``train_4k``, SmolLM-135M's
   ``prefill_32k``, RWKV-6's
   ``long_500k`` and DeepSeek-V3's ``decode_32k`` ``absorbed_ep``
   variant: each ``ok``, its argument bytes those of the rules (under
   the card's HBM), its dataflow census the reference's
   (``REF_DRYRUN_CENSUS``; a train cell's ``REF_TRAIN_CENSUS``, as in
   16a), with its collectives, FLOPs, peak, roofline
   terms and fit printed; (c) Qwen2.5-14B's and DeepSeek-V3's
   ``decode_32k`` on 16×16: the census's local shapes must be the
   rules' leaf by leaf and its argument bytes the rules'; rank 0's
   shards are allocated on the card at those shapes, from a seeded
   generator, with nothing else freed meanwhile (the previous cell's
   shards all released and Python's garbage collected before the first
   is measured); each allocation's requested
   bytes must be its leaf's bytes exactly, and the growth of
   ``torch.cuda.memory_allocated()`` at least the shards in whole
   512-byte blocks and at most the rules' bytes plus 512 bytes a
   tensor;
15. the core calls and elastic checkpoints (launch no hand kernel): (a)
   ``decoupled_call`` of ``tanh(2·table[idx])`` (table f32[2^20], 2^16
   indices, negative ones wrapping) and of the quickstart kernel under
   the four policies on CUDA tensors, each output bit for bit the
   function called directly on the card, each program's stage count that
   of the CPU trace; ``ChannelSpec.from_example`` of a nested dict of
   fp32, bf16, int8 and int64 CUDA tensors and ``None``, packed and
   unpacked bit for bit, its ``width`` the CPU's; (b) SmolLM-135M's train
   state at published widths (bf16 params, fp32 moments, 1.35 GB) saved
   from this process, then, on 4 gloo ranks sharing the card
   (host-staged), restored with ``shardings=train_state_shardings`` on
   2×2 and 4×1 ``("data", "model")`` meshes, saved sharded from the 2×2
   state (every rank gathers, rank 0 writes, ``wait`` is a barrier) and
   restored on both meshes again: every rank's every local shard bit for
   bit the chunk of the plain restore, on ``cuda``; the sharded
   checkpoint restored whole here equals the state;
   ``prefetched(sharding=)``'s 3 batches of 8 x 1,025 tokens each rank's
   chunk of the unsharded stream, on each mesh; a shape mismatch raises
   ``ValueError`` naming the leaf; each rank's restore walls and bytes
   held, beside the card's name and power limit;
16. the train cells' dataflow census and the lowered train step (launch
   no hand kernel): (a) ``launch.dryrun.dataflow_census`` of every
   architecture's ``train_4k`` cell at published widths on ``meta`` —
   the train step traced with ``value_and_grad`` and AdamW lowered into
   the CDFG (``core/autodiff.py``; each segment body one ``cdfg.scan``
   partially evaluated as JAX does, its attention scan, WKV recurrence or
   Mamba selective scans nested in it, DeepSeek-V3's MTP layer lowered
   inline) — equal to the reference's census (``REF_TRAIN_CENSUS``,
   channel bytes included) for all ten; each cell's wall; (b) SmolLM-135M
   at published widths, its train step as the census lowers it, run by
   the ``sequential`` backend on the card, 3 steps of 2 x 512 tokens
   from step 200 (LR scale ~1), against ``make_train_step``: in fp32 at
   PERF.md §2's three-step bars (loss and metrics rtol 1e-4, each
   params leaf's change within 1e-3 of its L2 norm, the elements beyond
   0.1·lr printed, mu/nu rtol 1e-3 + 1e-4·max); in the published bf16
   the first step's loss (rtol 1e-4 of make_train_step's) and, against
   an fp32 step from the same params (the two bf16 backwards round on
   their own), its gradient norm, each params leaf's change and each
   moment row at ``BF16_BARS``, the later steps' drift printed; the
   segment's reverse scan replaying its transposed body's equations
   (their count printed); no hand kernel launched; both walls; (c)
   ``python -m
   repro_torch.launch.dryrun --arch smollm-135m --shape train_4k --mesh
   single``: exit 0, its record ``ok`` and carrying the 16a census;
   (d) the reduced DeepSeek-V3 on the chunked attention route (1 x
   2,100 tokens, fp32): ``loss_and_grads`` lowered as the census lowers
   it — each segment's hoisted mask ``scan``, forward and reverse
   ``scan``, the MTP layer inline with its attention's forward and
   reverse ``scan`` — and run by the ``sequential`` backend, against
   ``loss_and_grads``: loss and metrics rtol 1e-4, every gradient leaf
   rtol 1e-4 + 1e-4·max|g|; the segments' transposes replaying their
   transposed bodies' equations (their count printed); no hand kernel
   launched; the walls and the peak GiB; (e) the same for RWKV-6 1.6B
   whole at published widths (24 layers, 32 heads of 64) and the reduced
   Jamba (Mamba, attention and MoE in one unit), fp32, 1 x 256 tokens
   each: the WKV recurrence and the Mamba scans nested in the segment's
   forward scan, their transposed scans in its reverse scan, no
   ``torch.autograd`` in any transpose; beside the card's name and power
   limit;
10. one JSON line listing every kernel with its launches on its main path
   (phases 3-4b for the SpMV kernels, run (b) of phase 6 for attention,
   phase 7 for the kernel API), on each path of phase 12 and summed over
   phase 13's ranks, the design
   those launches took, its error against the plain version, its times
   and its bound (the attention rows also at Qwen2.5-14B's shape, with
   6c's launches); then the
   ``nvidia-smi`` line; then the result line.

Any failed phase exits non-zero before the result line.  Without a CUDA
device, or outside the repository, the script exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import math
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

#: phase 13: SmolLM-135M whole, pipelined over 3 ranks that share the card
#: under gloo (stages of 10 blocks), 8 microbatches of 1 x 512 tokens from
#: phase 6's traffic; 13d's systolic runs take a fourth rank
PIPE_STAGES, PIPE_MICROBATCHES, PIPE_RANKS = 3, 8, 4
PIPE_TIMEOUT_S = 600

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

#: RWKV-6 1.6B's bf16 prefill of phase 6e, host clock, on an NVIDIA H100
#: 80GB HBM3 at 700.00 W (PERF.md §5), with the WKV recurrence a Python
#: loop over time: printed beside the wall of its ``cdfg.scan``
RWKV_LOOP_PREFILL_S = 1.0200

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


#: the dataflow census's fields, in the reference's order
_CENSUS_KEYS = ("ops", "memory_ops", "long_ops", "stages", "channels",
                "channel_bytes", "pipeline_ii")


def _census(*values: int) -> dict:
    return dict(zip(_CENSUS_KEYS, values))


#: one rank's argument bytes of every applicable dry-run cell under the
#: reference's 16 GiB HBM (``tests/test_torch_sharding.py`` holds them to
#: the reference's PartitionSpecs; 48 equal XLA's
#: ``mem_argument_size_in_bytes`` in ``experiments/dryrun``, 16 exceed it
#: by the leaves the step never reads, which XLA drops)
REF_DRYRUN_ARGS = {
    'jamba-1.5-large-398b__train_4k__16x16': 15_600_240_712,
    'jamba-1.5-large-398b__train_4k__2x16x16': 7_814_639_656,
    'jamba-1.5-large-398b__prefill_32k__16x16': 3_122_587_648,
    'jamba-1.5-large-398b__prefill_32k__2x16x16': 1_565_126_656,
    'jamba-1.5-large-398b__decode_32k__16x16': 3_762_432_036,
    'jamba-1.5-large-398b__decode_32k__2x16x16': 1_885_048_852,
    'jamba-1.5-large-398b__long_500k__16x16': 4_334_800_904,
    'jamba-1.5-large-398b__long_500k__2x16x16': 2_777_470_984,
    'qwen2.5-14b__train_4k__16x16': 582_365_256,
    'qwen2.5-14b__train_4k__2x16x16': 293_773_352,
    'qwen2.5-14b__prefill_32k__16x16': 1_847_447_552,
    'qwen2.5-14b__prefill_32k__2x16x16': 1_847_316_480,
    'qwen2.5-14b__decode_32k__16x16': 5_068_410_916,
    'qwen2.5-14b__decode_32k__2x16x16': 3_457_798_164,
    'olmo-1b__train_4k__16x16': 50_253_896,
    'olmo-1b__train_4k__2x16x16': 25_126_952,
    'olmo-1b__prefill_32k__16x16': 160_235_520,
    'olmo-1b__prefill_32k__2x16x16': 160_104_448,
    'olmo-1b__decode_32k__16x16': 2_307_457_060,
    'olmo-1b__decode_32k__2x16x16': 1_233_715_220,
    'smollm-135m__train_4k__16x16': 5_866_696,
    'smollm-135m__train_4k__2x16x16': 3_109_032,
    'smollm-135m__prefill_32k__16x16': 17_142_400,
    'smollm-135m__prefill_32k__2x16x16': 17_011_328,
    'smollm-135m__decode_32k__16x16': 394_367_652,
    'smollm-135m__decode_32k__2x16x16': 205_623_956,
    'command-r-plus-104b__train_4k__16x16': 4_209_885_256,
    'command-r-plus-104b__train_4k__2x16x16': 2_120_794_152,
    'command-r-plus-104b__prefill_32k__16x16': 842_186_752,
    'command-r-plus-104b__prefill_32k__2x16x16': 424_263_680,
    'command-r-plus-104b__decode_32k__16x16': 5_136_891_940,
    'command-r-plus-104b__decode_32k__2x16x16': 2_571_616_276,
    'rwkv6-1.6b__train_4k__16x16': 68_677_704,
    'rwkv6-1.6b__train_4k__2x16x16': 37_621_800,
    'rwkv6-1.6b__prefill_32k__16x16': 199_577_600,
    'rwkv6-1.6b__prefill_32k__2x16x16': 199_446_528,
    'rwkv6-1.6b__decode_32k__16x16': 207_179_812,
    'rwkv6-1.6b__decode_32k__2x16x16': 203_247_636,
    'rwkv6-1.6b__long_500k__16x16': 200_298_504,
    'rwkv6-1.6b__long_500k__2x16x16': 200_298_504,
    'deepseek-v3-671b__train_4k__16x16': 26_752_980_040,
    'deepseek-v3-671b__train_4k__2x16x16': 13_381_640_744,
    'deepseek-v3-671b__prefill_32k__16x16': 5_361_632_256,
    'deepseek-v3-671b__prefill_32k__2x16x16': 2_681_846_272,
    'deepseek-v3-671b__decode_32k__16x16': 6_512_706_596,
    'deepseek-v3-671b__decode_32k__2x16x16': 3_257_383_444,
    'llama4-scout-17b-a16e__train_4k__16x16': 4_217_764_936,
    'llama4-scout-17b-a16e__train_4k__2x16x16': 2_111_365_672,
    'llama4-scout-17b-a16e__prefill_32k__16x16': 844_155_904,
    'llama4-scout-17b-a16e__prefill_32k__2x16x16': 422_574_592,
    'llama4-scout-17b-a16e__decode_32k__16x16': 4_065_119_268,
    'llama4-scout-17b-a16e__decode_32k__2x16x16': 2_033_056_276,
    'musicgen-large__train_4k__16x16': 367_370_248,
    'musicgen-large__train_4k__2x16x16': 185_671_688,
    'musicgen-large__prefill_32k__16x16': 572_268_544,
    'musicgen-large__prefill_32k__2x16x16': 438_050_816,
    'musicgen-large__decode_32k__16x16': 6_746_284_068,
    'musicgen-large__decode_32k__2x16x16': 3_525_058_580,
    'chameleon-34b__train_4k__16x16': 2_421_506_056,
    'chameleon-34b__train_4k__2x16x16': 1_214_726_152,
    'chameleon-34b__prefill_32k__16x16': 5_361_909_760,
    'chameleon-34b__prefill_32k__2x16x16': 4_825_038_848,
    'chameleon-34b__decode_32k__16x16': 7_509_393_444,
    'chameleon-34b__decode_32k__2x16x16': 5_898_780_692,
}

#: a sha256 an architecture of every leaf's spec (``dryrun_spec_digests``;
#: the rules held leaf by leaf to the reference's in
#: ``tests/test_torch_sharding.py``)
REF_DRYRUN_SPECS = {
    'jamba-1.5-large-398b':
        'bf399bbbf039595c0277c9456beb2c9e'
        '8d6fc3335c87c0ac68f7e93e8e640ee6',
    'qwen2.5-14b':
        'e1725a9f23a963dbc5a2ac4e8ce275d2'
        'f68b481bc4c26af753e3f4a9a82cd910',
    'olmo-1b':
        'a69c3f7adf08a659da09491c691f0128'
        '2cd67c851d7e02f12a877e030adbbad2',
    'smollm-135m':
        '264322a504c7495896c69369f4af602b'
        '868edc20cea6fbb3ef463fd3a4a63d46',
    'command-r-plus-104b':
        'cf3846128b85342159f65b1582b0bc4a'
        '19cfd91e37b0c9cdf43af4d613cda836',
    'rwkv6-1.6b':
        '38265a6800556f47789ef8c5b5dabf17'
        '0aa74d3a036c3ee0ef942510d382f4be',
    'deepseek-v3-671b':
        '7ea8f6eeb366f44fd4d6a3350fc6c030'
        '7448ba89acb8697d29213345bc45ce2a',
    'llama4-scout-17b-a16e':
        '89d710bf3865297c3c40d41c9763abb2'
        '73d19e1d6f37017e3f2d9d7d2f92d12a',
    'musicgen-large':
        'edee102fe8a447749ac4180f14830d11'
        '494c11039c497ff77748ab14bf489b9a',
    'chameleon-34b':
        'a1ea7570d0268ed3561e91c16958646d'
        '78c87fc75dd2dd2f33f6cb03f44a9daa',
}

#: the reference's dataflow census of the decode, prefill and long cells
#: (``repro.launch.dryrun.dataflow_census`` under jax 0.9.0, full width),
#: and DeepSeek-V3's absorbed decode: ops, memory ops, long ops, stages,
#: channels, channel bytes, pipeline II
REF_DRYRUN_CENSUS = {
    ('jamba-1.5-large-398b', 'decode_32k'):
        _census(24, 1, 9, 10, 10, 54_527_488, 1),
    ('jamba-1.5-large-398b', 'prefill_32k'):
        _census(23, 1, 10, 10, 11, 171_811_274_792, 1),
    ('jamba-1.5-large-398b', 'long_500k'):
        _census(24, 1, 9, 10, 10, 425_996, 1),
    ('qwen2.5-14b', 'decode_32k'):
        _census(24, 1, 9, 10, 10, 90_965_504, 1),
    ('qwen2.5-14b', 'prefill_32k'):
        _census(23, 1, 10, 10, 11, 107_386_765_508, 1),
    ('olmo-1b', 'decode_32k'):
        _census(22, 1, 7, 8, 9, 29_951_488, 1),
    ('olmo-1b', 'prefill_32k'):
        _census(21, 1, 8, 8, 10, 34_372_321_348, 1),
    ('smollm-135m', 'decode_32k'):
        _census(24, 1, 9, 10, 10, 26_641_920, 1),
    ('smollm-135m', 'prefill_32k'):
        _census(23, 1, 10, 10, 11, 12_092_178_556, 1),
    ('command-r-plus-104b', 'decode_32k'):
        _census(28, 1, 8, 9, 10, 162_530_816, 1),
    ('command-r-plus-104b', 'prefill_32k'):
        _census(27, 1, 9, 9, 11, 257_710_620_932, 1),
    ('rwkv6-1.6b', 'decode_32k'):
        _census(28, 1, 8, 9, 10, 38_798_848, 1),
    ('rwkv6-1.6b', 'prefill_32k'):
        _census(27, 1, 9, 9, 11, 42_962_255_972, 1),
    ('rwkv6-1.6b', 'long_500k'):
        _census(28, 1, 8, 9, 10, 303_116, 1),
    ('deepseek-v3-671b', 'decode_32k'):
        _census(25, 1, 10, 11, 11, 86_377_984, 1),
    ('deepseek-v3-671b', 'prefill_32k'):
        _census(26, 1, 12, 12, 15, 165_368_824_064, 1),
    ('llama4-scout-17b-a16e', 'decode_32k'):
        _census(24, 1, 9, 10, 10, 116_557_312, 1),
    ('llama4-scout-17b-a16e', 'prefill_32k'):
        _census(23, 1, 10, 10, 11, 107_386_765_508, 1),
    ('musicgen-large', 'decode_32k'):
        _census(28, 1, 8, 9, 10, 6_292_992, 1),
    ('musicgen-large', 'prefill_32k'):
        _census(22, 0, 8, 8, 10, 38_667_288_772, 1),
    ('chameleon-34b', 'decode_32k'):
        _census(24, 1, 9, 10, 10, 54_527_488, 1),
    ('chameleon-34b', 'prefill_32k'):
        _census(18, 0, 9, 9, 10, 154_631_405_764, 1),
    ('deepseek-v3-671b+absorbed', 'decode_32k'):
        _census(25, 1, 10, 11, 11, 86_377_984, 1),
}


#: phase 16a: the reference's dataflow census of every architecture's
#: ``train_4k`` cell (``repro.launch.dryrun.dataflow_census`` under jax
#: 0.9.0, full width): ops, memory ops, long ops, stages, channels,
#: channel bytes, pipeline II (``tests/test_torch_train_census.py`` holds
#: it to the live reference's, and the port's to it)
REF_TRAIN_CENSUS = {
    "jamba-1.5-large-398b":
        _census(2860, 2, 1388, 1389, 3066, 425_045_627_574_978, 1),
    "qwen2.5-14b": _census(510, 2, 231, 232, 447, 99_366_822_127_704, 1),
    "olmo-1b": _census(365, 2, 155, 156, 317, 14_808_769_365_852, 1),
    "smollm-135m": _census(411, 2, 183, 184, 361, 12_184_684_874_416, 1),
    "command-r-plus-104b":
        _census(514, 2, 228, 229, 445, 313_584_188_491_943, 1),
    "rwkv6-1.6b": _census(781, 2, 367, 368, 741, 47_925_040_071_492, 1),
    "deepseek-v3-671b":
        _census(1957, 9, 888, 889, 1792, 442_814_851_796_744, 1),
    "llama4-scout-17b-a16e":
        _census(546, 2, 247, 248, 499, 113_658_917_270_664, 1),
    "musicgen-large": _census(480, 0, 214, 215, 432, 69_294_819_919_188, 1),
    "chameleon-34b": _census(428, 0, 193, 194, 376, 157_234_581_014_544, 1),
    # the two options of the train step no published config sets: the
    # segment's body under ``jax.checkpoint``, the chunked Mamba scan
    # (chunk 16)
    "smollm-135m+remat": _census(395, 2, 182, 183, 319, 716_107_034_288, 1),
    "jamba-1.5-large-398b+chunked":
        _census(2923, 2, 1388, 1389, 3120, 2_646_935_289_010_926, 1),
}


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

    # -- 13. the multi-rank pipeline, compression and systolic backend -------
    t13 = time.perf_counter()
    phase13 = pipelined_smollm(dev)
    print(f"[13] phase 13 in {time.perf_counter() - t13:.2f} s", flush=True)

    # -- 14. the production dry run on a fake world -----------------------------
    t14 = time.perf_counter()
    before = dict(_lib.counts())
    dryrun_phase(dev, smi)
    require(dict(_lib.counts()) == before,
            "phase 14 launched a hand kernel")
    print(f"[14] phase 14 in {time.perf_counter() - t14:.2f} s", flush=True)

    # -- 15. the core calls on the card; elastic checkpoints on ranks ---------
    t15 = time.perf_counter()
    before = dict(_lib.counts())
    core_calls_on_card(dev)
    elastic_checkpoints(dev, smi)
    require(dict(_lib.counts()) == before,
            "phase 15 launched a hand kernel")
    print(f"[15] phase 15 in {time.perf_counter() - t15:.2f} s", flush=True)

    # -- 16. the train cells' census; the lowered train step ----------------
    t16 = time.perf_counter()
    train_census_on_card(smi)
    lowered_step_on_card(dev, smi)
    dryrun_cli_train_cell(smi)
    lowered_mtp_grads_on_card(dev, smi)
    lowered_recurrent_grads_on_card(dev, smi)
    print(f"[16] phase 16 in {time.perf_counter() - t16:.2f} s", flush=True)

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
        # this kernel's launches on each of phase 12's paths, and summed
        # over phase 13's ranks
        row["phase12_launches"] = {path: n[row["name"]] for path, n in
                                   phase12.items() if n.get(row["name"])}
        if phase13.get(row["name"]):
            row["phase13_launches"] = phase13[row["name"]]
    print(json.dumps({"kernels": [{k: row[k] for k in
                                   (*keys, "qwen2.5-14b", "phase12_launches",
                                    "phase13_launches")
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
          f"{_serving_line(res, wall)} (the recurrence a Python loop over "
          f"time: prefill {RWKV_LOOP_PREFILL_S:.4f} s); {_memory(dev)}; "
          f"{traced}", flush=True)
    del params
    _free()


def mamba_chunked_loop(dt, A, Bc, Cc, x, chunk: int = 16):
    """Mamba's chunked scan as the Python loop over chunks it was before
    it became a ``cdfg.scan`` (``ssm._selective_scan_chunked``): what the
    scan must equal bit for bit on tensors."""
    import torch
    B, L, dI = x.shape
    h = torch.zeros((B, dI, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    ys = []
    for c0 in range(0, L, chunk):
        dtc, bcc = dt[:, c0:c0 + chunk], Bc[:, c0:c0 + chunk]
        ccc, xc = Cc[:, c0:c0 + chunk], x[:, c0:c0 + chunk]
        cum = torch.cumsum(dtc[..., None] * A, dim=1)
        h_part = torch.exp(cum) * h[:, None]
        contrib = (dtc * xc)[..., None] * bcc[:, :, None, :]
        dec = torch.exp(cum[:, :, None] - cum[:, None])
        dec = torch.where(mask[None, :, :, None, None], dec, 0.0)
        hs = h_part + torch.einsum("bijdn,bjdn->bidn", dec, contrib)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, ccc))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_layer(dev) -> None:
    """Phase 6f: one Jamba-1.5-Large Mamba layer at full width, fp32; the
    chunked scan (a ``cdfg.scan`` over chunks) bit for bit the Python
    loop over chunks it replaced (:func:`mamba_chunked_loop`)."""
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
        scan = ssm._selective_scan_chunked
        ssm._selective_scan_chunked = mamba_chunked_loop
        try:
            t0 = time.perf_counter()
            loop_c = ssm.mamba_apply(p, x, chunked)
            torch.cuda.synchronize()
            t_loop = time.perf_counter() - t0
        finally:
            ssm._selective_scan_chunked = scan
        same = torch.equal(whole_c, loop_c)
        del loop_c
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
    require(same, "6f the chunked scan is not bit for bit the loop over "
            "chunks it replaced")
    print(f"[6f] jamba-1.5-large-398b Mamba layer, fp32, full width "
          f"(d_model {cfg.d_model}, d_inner {s.d_inner}, d_state "
          f"{s.d_state}, dt_rank {s.dt_rank}; {n_params} params), batch "
          f"{SERVE_BATCH}: mamba_apply over {PROMPT_LEN} then {GEN} "
          f"mamba_decode steps == mamba_apply over {n} (max|Δ| {worst:.3g}), "
          f"chunked scan == sequential (max|Δ| {err_c:.3g}; rtol=atol=1e-3);"
          f" the chunked scan bit for bit the loop over chunks it "
          f"replaced; mamba_apply over {n}: sequential {t_seq:.3f} s, "
          f"chunked {t_chunk:.3f} s (the loop over chunks {t_loop:.3f} s, "
          f"after it); decode {t_dec * 1e3:.3f} ms/step (host clock, one "
          f"layer); {_memory(dev)}", flush=True)
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


def _pipe_model(dev, dtype: str, impl: str, num_layers: int | None,
                microbatches: int, seq: int) -> tuple:
    """Phase 13's model on ``dev``: SmolLM-135M at its published widths
    (``num_layers`` blocks, default all 30), random weights from seed 0 as
    phase 6; returns (cfg, params, the blocks stacked as ``PIPE_STAGES``
    stages of equal depth, the stage function, the embedded microbatches
    (M, 1, seq, d) and their tokens (M, 1, seq))."""
    import dataclasses

    import torch
    from repro_torch import tree
    from repro_torch.configs import load_config
    from repro_torch.models import init_params, layers, transformer
    cfg = load_config("smollm-135m")
    depth = num_layers or cfg.num_layers
    cfg = dataclasses.replace(
        cfg, dtype=dtype, attn_impl=impl, num_layers=depth,
        segments=(dataclasses.replace(cfg.segments[0], repeats=depth),))
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    tokens = _traffic(cfg, dev)[0][:microbatches, None, :seq]
    with torch.no_grad():
        mbs = layers.embedding_apply(params["embed"], tokens)
    per = depth // PIPE_STAGES
    stacked = tree.tree_map(
        lambda *ls: torch.stack(ls).reshape(PIPE_STAGES, per, *ls[0].shape),
        *[rep[0] for rep in params["segment_0"]])
    spec = cfg.segments[0].unit[0]

    def stage(p, x):
        # the model's own blocks, one after another
        for i in range(per):
            x = transformer._layer_apply(tree.tree_map(lambda q: q[i], p), x,
                                         spec, cfg, {})
        return x
    return cfg, params, stacked, stage, mbs, tokens


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn) -> tuple:
    """``fn()`` and its wall in s (host clock, the card synchronised)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _sequential(stacked, stage, mbs):
    """The pipeline's blocks run in sequence in one process, microbatch by
    microbatch."""
    from repro_torch import tree
    ys = []
    for x in mbs:
        for s in range(PIPE_STAGES):
            x = stage(tree.tree_map(lambda q, s=s: q[s], stacked), x)
        ys.append(x)
    import torch
    return torch.stack(ys)


def pipeline_rank(num_layers: int | None, microbatches: int, seq: int
                  ) -> dict:
    """Phase 13 on one of ``PIPE_RANKS`` ranks (``launch.mesh.spawn``):
    ranks 0-2 form the pipeline's group and run 13a-13c; every rank runs
    13d.  Returns this rank's outputs, launches, walls and peak memory."""
    import torch
    import torch.distributed as dist
    from repro_torch import _device, tree
    from repro_torch.core import pipeline_apply
    from repro_torch.core.collectives import Collectives
    from repro_torch.kernels import _lib
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = _device.get_device()
    rank = dist.get_rank()
    pipe = dist.new_group(list(range(PIPE_STAGES)))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out: dict = {"rank": rank}
    if rank < PIPE_STAGES:
        # 13a: the forward in bf16 through the kernels, then in fp32
        *_, stacked, stage, mbs, _ = _pipe_model(
            dev, "bfloat16", "pallas", num_layers, microbatches, seq)
        with torch.no_grad():
            pipeline_apply(stage, stacked, mbs, group=pipe)       # warm-up
            _lib.reset_counts()
            y, out["pipe_s"] = _timed(
                dev, lambda: pipeline_apply(stage, stacked, mbs, group=pipe))
            out["launches"] = _lib.counts()
            out["routes"] = _lib.routes()["flash_attention"]
            out["bf16"] = y
            comm = Collectives(pipe, dev)
            out["route"] = comm.route
            act = mbs[0].contiguous()
            for _ in range(3):
                comm.ppermute(act)
            reps = 20
            _, wall = _timed(dev, lambda: [comm.ppermute(act)
                                           for _ in range(reps)])
            out["shift_ms"] = wall / reps * 1e3
            out["shift_bytes"] = act.numel() * act.element_size()
        del stacked, mbs
        _, _, stacked, stage, mbs, _ = _pipe_model(
            dev, "float32", "pallas", num_layers, microbatches, seq)
        with torch.no_grad():
            out["fp32"] = pipeline_apply(stage, stacked, mbs, group=pipe)
        # 13b: the gradient of mean(y²) through the pipeline (fp32, the
        # plain attention: the kernels have no backward)
        cfg, params, stacked, stage, mbs, tokens = _pipe_model(
            dev, "float32", "auto", num_layers, microbatches, seq)
        leaves = [leaf.requires_grad_() for leaf in tree.leaves(stacked)]

        def grads():
            y = pipeline_apply(stage, stacked, mbs, group=pipe)
            return torch.autograd.grad((y ** 2).mean(), leaves)
        g, out["grad_s"] = _timed(dev, grads)
        _, out["grad_warm_s"] = _timed(dev, grads)
        # this rank's share: nonzero only in its own slice
        out["grads"] = [x[rank] for x in g]
        out["grads_elsewhere"] = max(
            float(torch.cat([x[:rank].flatten(), x[rank + 1:].flatten()])
                  .abs().max()) if x.shape[0] > 1 else 0.0 for x in g)
        del g, stacked, leaves
        out.update(_reduce_grads(dev, pipe, cfg, params, tokens[rank]))
        del params
    out.update(_systolic_on_ranks(dev, seq, microbatches))
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def _reduce_grads(dev, pipe, cfg, params, tokens) -> dict:
    """13c on a pipeline rank: SmolLM-135M's whole fp32 gradient of the LM
    loss on this rank's microbatch, reduced over the pipeline's group with
    ``compress_tree_psum`` and with a plain fp32 ``all_reduce``; the
    compressed sum held to S · ½ · the shared scale of each chunk (plus
    1e-4 of it for the fp32 division and the plain sum's rounding)."""
    import torch
    from repro_torch import tree
    from repro_torch.core.collectives import Collectives
    from repro_torch.models import loss_fn
    from repro_torch.optim.compress import (_chunks, _psum_chunks,
                                            compress_tree_psum)
    leaves = [leaf.requires_grad_() for leaf in tree.leaves(params)]
    loss, _ = loss_fn(params, {"tokens": tokens}, cfg)
    grads = list(torch.autograd.grad(loss, leaves))
    comp, comp_s = _timed(dev, lambda: compress_tree_psum(grads, pipe))
    # again: the staging buffers pinned by the first call are reused
    _, comp_warm_s = _timed(dev, lambda: compress_tree_psum(grads, pipe))
    comm = Collectives(pipe, dev)
    S = comm.size
    plain, plain_s = _timed(dev, lambda: [comm.psum(g) for g in grads])
    # the whole gradient as one tensor: the wire and the staging copies
    # without the per-leaf collectives (first call, then again)
    flat = torch.cat([g.flatten() for g in grads])
    one = {}
    for name, fn in (("int8", lambda: _psum_chunks(_chunks(flat, 256),
                                                   comm)),
                     ("fp32", lambda: comm.psum(flat))):
        _, cold = _timed(dev, fn)
        _, one[name] = _timed(dev, fn)
        one[name + "_cold"] = cold
    del flat
    worst, ratio, n = 0.0, 0.0, 0
    for g, c, p in zip(grads, comp, plain):
        shared = comm.pmax(_chunks(g, 256).abs().amax(dim=1)) / 127.0
        err = _chunks(c - p, 256).abs()
        bound = S * shared[:, None] * (0.5 + 1e-4)
        worst = max(worst, float(err.max()))
        ratio = max(ratio, float((err / bound.clamp_min(1e-30)).max()))
        n += g.numel()
    nchunks = sum(-(-g.numel() // 256) for g in grads)
    # what a rank hands the collectives: the int32 codes of whole chunks
    # and one fp32 maximum a chunk, against the fp32 values
    return {"reduce_values": n, "reduce_err": worst, "reduce_ratio": ratio,
            "compressed_s": comp_s, "compressed_warm_s": comp_warm_s,
            "plain_reduce_s": plain_s, "flat": one,
            "fp32_bytes": 4 * n, "compressed_bytes": 4 * 256 * nchunks
            + 4 * nchunks, "loss": float(loss.detach())}


def _systolic_on_ranks(dev, seq: int, microbatches: int) -> dict:
    """13d on every rank: the quickstart kernel (4 stages) through the
    ``systolic`` backend and a 6-microbatch stream through its sharded
    pipeline, each against the direct call (rtol 1e-6); the staged gather
    of phase 7 (``microbatches`` × ``seq`` of 49,152 × 576 bf16 rows) on
    ``systolic`` against ``decoupled_gather_ref``, bit for bit."""
    import torch
    import torch.distributed as dist
    from repro_torch import dataflow_jit
    from repro_torch.configs import load_config
    from repro_torch.kernels import (decoupled_gather_ref,
                                     decoupled_gather_staged)
    from repro_torch.models import layers

    @dataflow_jit(stream_argnums=(1,))
    def quickstart(table, idx, w):
        return torch.tanh(table[idx] * w) + 1.0

    qt = torch.arange(1024, dtype=torch.float32, device=dev)
    qi = torch.tensor([3, 997, 41, 512, 7, 800, 64, 2], dtype=torch.int32,
                      device=dev)
    qw = torch.tensor(1.5, device=dev)
    direct = quickstart.__wrapped__(qt, qi, qw)
    c = quickstart.lower(qt, qi, qw)                  # compiled untimed
    dist.barrier()        # the pipeline's ranks arrive later than the 4th
    got, call_s = _timed(dev, lambda: quickstart(qt, qi, qw,
                                                 backend="systolic"))
    stream = torch.stack([(qi + t) % 1024 for t in range(6)])
    run = c.schedule.pipeline.build_sharded()
    outs, stream_s = _timed(dev, lambda: run(qt, stream, qw)[0])
    want = torch.stack([quickstart.__wrapped__(qt, s, qw) for s in stream])
    cfg = load_config("smollm-135m")
    table = layers.embedding_init(torch.Generator(device=dev).manual_seed(0),
                                  cfg.vocab_size, cfg.d_model,
                                  torch.bfloat16, dev)["table"]
    idx = _traffic(cfg, dev)[0][:microbatches, :seq].flatten()
    staged, staged_s = _timed(dev, lambda: decoupled_gather_staged(
        idx, table, backend="systolic"))
    return {"quickstart_stages": c.num_stages,
            "quickstart_ok": bool(torch.allclose(got, direct, rtol=1e-6,
                                                 atol=0.0)),
            "stream_ok": bool(torch.allclose(outs, want, rtol=1e-6,
                                             atol=0.0)),
            "gather_ok": bool(torch.equal(staged,
                                          decoupled_gather_ref(idx, table))),
            "gather_rows": idx.numel(), "systolic_s": call_s,
            "stream_s": stream_s, "staged_s": staged_s}


def _attention_at_path_shape(dev, seq: int) -> dict:
    """``flash_attention`` alone at phase 13's per-microbatch shape (q 1 x
    9 x ``seq`` x 64, k/v 1 x 3 x ``seq`` x 64, causal) against its plain
    version, at phase 5's bars: bf16 rtol=atol=2e-2, fp32 1e-4."""
    import torch
    from repro_torch.configs import load_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    cfg = load_config("smollm-135m")
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn((1, h, seq, cfg.head_dim), generator=gen,
                           device=dev).to(torch.bfloat16)
               for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    errs = {}
    for name, dtype, tol in (("bf16", torch.bfloat16, 2e-2),
                             ("fp32", torch.float32, 1e-4)):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        got = flash_attention(qq, kk, vv, causal=True).float()
        want = ref.flash_attention_ref(qq, kk, vv, causal=True).float()
        errs[name] = float((got - want).abs().max())
        require(torch.allclose(got, want, rtol=tol, atol=tol),
                f"13a flash_attention {name} at q {tuple(q.shape)} vs its "
                f"plain version: max err {errs[name]}")
    return errs


def pipelined_smollm(dev, num_layers: int | None = None,
                     microbatches: int = PIPE_MICROBATCHES,
                     seq: int = PROMPT_LEN) -> dict:
    """Phase 13: the multi-rank executors on the card.  The one-process
    references run here first; then ``PIPE_RANKS`` ranks share the card
    under gloo (:func:`pipeline_rank`).  13a: ``flash_attention`` alone
    at the path's shape against its plain version; SmolLM-135M's blocks
    (all 30, or ``num_layers``) in sequence here, through the kernels
    against the plain attention (fp32 at rtol=atol=1e-4, bf16 within
    2e-2 of the scale or twice the plain bf16 path's own error), then
    pipelined over 3 ranks against the kernels' run in sequence (fp32 as
    before, bf16 at phase 6b's bar), with ``flash_attention`` launched
    once a block and microbatch on each rank; 13b: the gradient of mean(y²) through
    the pipeline (fp32, plain attention) against ``torch.autograd`` of
    ``pipeline_apply_emulated`` here, every leaf within 1e-4·|g| +
    1e-4·max|g|; 13c: each rank's whole fp32 gradient reduced with
    ``compress_tree_psum`` within its bound of the fp32 ``all_reduce``;
    13d: the ``systolic`` backend.  Returns the launches summed over the
    ranks."""
    import torch
    from repro_torch import tree
    from repro_torch.core import gpipe_bubble_fraction, pipeline_apply_emulated
    from repro_torch.launch.mesh import spawn
    S, M = PIPE_STAGES, microbatches
    seq_out = {}
    with torch.no_grad():
        call_err = _attention_at_path_shape(dev, seq)
        # the blocks in sequence in one process, through the kernels and
        # through the plain attention, in bf16 and in fp32
        for dtype in ("bfloat16", "float32"):
            for impl in ("pallas", "full"):
                _, _, stacked, stage, mbs, _ = _pipe_model(
                    dev, dtype, impl, num_layers, M, seq)
                if (dtype, impl) == ("bfloat16", "pallas"):
                    _sequential(stacked, stage, mbs)               # warm-up
                    y, seq_s = _timed(
                        dev, lambda: _sequential(stacked, stage, mbs))
                else:
                    y = _sequential(stacked, stage, mbs)
                seq_out[dtype, impl] = y.float().cpu()
    seq16, seq32 = seq_out["bfloat16", "pallas"], seq_out["float32", "pallas"]
    plain16, plain32 = seq_out["bfloat16", "full"], seq_out["float32", "full"]
    cfg, _, stacked, stage, mbs, _ = _pipe_model(
        dev, "float32", "auto", num_layers, M, seq)
    leaves = [leaf.requires_grad_() for leaf in tree.leaves(stacked)]
    y = pipeline_apply_emulated(stage, stacked, mbs, S)
    want = [g.detach() for g in torch.autograd.grad((y ** 2).mean(), leaves)]
    depth = cfg.num_layers
    del stacked, leaves, y, mbs
    _free()
    t0 = time.perf_counter()
    res = spawn(pipeline_rank, PIPE_RANKS, num_layers, M, seq,
                backend="gloo", device=dev.type, timeout_s=PIPE_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    pipe = res[:S]
    # 13a: the kernels' path in sequence against the plain path: fp32 at
    # rtol=atol=1e-4; bf16 within the larger of 2e-2 of the plain
    # output's scale and twice the plain bf16 path's own error (its
    # distance to plain fp32): both bf16 paths round on their own, so
    # their distance may reach the sum of their errors.  Then the
    # pipeline against the kernels' path in sequence: fp32 as before,
    # bf16 at phase 6b's bar (the larger of 2e-2 of the scale and the
    # plain bf16 path's own error)
    noise = float((plain16 - plain32).abs().max())
    scale = float(plain16.abs().max())
    bar16 = max(2e-2 * scale, noise)
    kern16 = float((seq16 - plain16).abs().max())
    kern16_32 = float((seq16 - plain32).abs().max())
    kern32 = float((seq32 - plain32).abs().max())
    require(bool(torch.isfinite(seq16).all())
            and kern16 <= max(2e-2 * scale, 2 * noise),
            f"13a bf16 pallas vs full in sequence: max |Δ| {kern16} > both "
            f"2e-2 * {scale} and twice the plain path's bf16 error {noise}")
    require(torch.allclose(seq32, plain32, rtol=1e-4, atol=1e-4),
            f"13a fp32 pallas vs full in sequence: max |Δ| {kern32}")
    for r in pipe:
        y16, y32 = r["bf16"].float(), r["fp32"]
        require(bool(torch.isfinite(y16).all()) and y16.shape == seq16.shape,
                f"13a rank {r['rank']}: bf16 output {tuple(y16.shape)} or "
                f"not finite")
        err16 = float((y16 - seq16).abs().max())
        require(err16 <= bar16,
                f"13a rank {r['rank']}: bf16 pipelined vs sequential max "
                f"|Δ| {err16} > both 2e-2 * {scale} and the plain path's "
                f"bf16 error {noise}")
        err32 = float((y32 - seq32).abs().max())
        require(torch.allclose(y32, seq32, rtol=1e-4, atol=1e-4),
                f"13a rank {r['rank']}: fp32 pipelined vs sequential max "
                f"|Δ| {err32}")
    launches = {k: sum(r["launches"][k] for r in pipe)
                for k in pipe[0]["launches"]}
    per_rank = [r["launches"]["flash_attention"] for r in pipe]
    require(per_rank == [depth // S * M] * S,
            f"13a flash_attention launches per rank {per_rank}, expected "
            f"{depth // S} blocks x {M} microbatches on each")
    require(all(r["routes"] == {"mma.sync": depth // S * M} for r in pipe),
            f"13a bf16 prefill launches by design: "
            f"{[r['routes'] for r in pipe]}, expected all on mma.sync")
    bit = all(torch.equal(r["bf16"].float(), seq16) for r in pipe)
    worst16 = max(float((r["bf16"].float() - seq16).abs().max())
                  for r in pipe)
    print(f"[13a] smollm-135m, {depth} blocks as {S} stages of {depth // S} "
          f"on {S} ranks sharing {dev} (route {pipe[0]['route']!r}), {M} "
          f"microbatches of 1x{seq}: flash_attention alone at q "
          f"1x{cfg.num_heads}x{seq}x{cfg.head_dim} vs plain max|Δ| bf16 "
          f"{call_err['bf16']:.3g} (2e-2), fp32 {call_err['fp32']:.3g} "
          f"(1e-4); in sequence, pallas vs full max|Δ| bf16 {kern16:.4g} "
          f"(bar the larger of 2e-2 * {scale:.4g} and twice the plain bf16 "
          f"path's own {noise:.4g}; pallas bf16 to full fp32 "
          f"{kern16_32:.4g}), fp32 {kern32:.3g} (rtol=atol=1e-4); "
          f"pipelined vs in sequence max|Δ| bf16 {worst16:.4g} (bit for "
          f"bit: {bit}; bar {bar16:.4g}), fp32 "
          f"{max(float((r['fp32'] - seq32).abs().max()) for r in pipe):.3g}"
          f"; flash_attention launches {per_rank} = "
          f"{launches['flash_attention']} in all (mma.sync); walls (host "
          f"clock): pipelined {max(r['pipe_s'] for r in pipe):.4f} s vs "
          f"sequential in one process {seq_s:.4f} s; bubble fraction "
          f"(S-1)/(M+S-1) = {gpipe_bubble_fraction(S, M):.3f}; shift of "
          f"{pipe[0]['shift_bytes']} bytes "
          f"{max(r['shift_ms'] for r in pipe):.3f} ms a tick", flush=True)
    # 13b
    worst, elsewhere = 0.0, max(r["grads_elsewhere"] for r in pipe)
    for i, w in enumerate(want):
        w = w.cpu()
        for s, r in enumerate(pipe):
            g, ws = r["grads"][i], w[s]
            tol = 1e-4 * ws.abs() + 1e-4 * float(w.abs().max())
            worst = max(worst, float((g - ws).abs().max()))
            require(bool(((g - ws).abs() <= tol).all()),
                    f"13b leaf {i} stage {s}: max|Δ| "
                    f"{float((g - ws).abs().max())} beyond 1e-4·|g| + "
                    f"1e-4·max|g|")
    require(elsewhere == 0.0, f"13b a rank's gradient share reached "
            f"another stage's slice ({elsewhere})")
    print(f"[13b] grad of mean(y²) through the pipeline (fp32, attn 'auto'),"
          f" {len(want)} leaves x {S} stages: max|Δ| vs pipeline_apply_"
          f"emulated's autograd {worst:.3g} (1e-4·|g| + 1e-4·max|g|); each "
          f"rank's share zero off its slice; wall "
          f"{max(r['grad_s'] for r in pipe):.3f} s, again "
          f"{max(r['grad_warm_s'] for r in pipe):.3f} s", flush=True)
    # 13c
    n = pipe[0]["reduce_values"]
    ratio = max(r["reduce_ratio"] for r in pipe)
    require(ratio <= 1.0, f"13c compressed_psum beyond S·½·scale: "
            f"{ratio:.4f} of the bound")
    print(f"[13c] data-parallel reduce of the whole fp32 gradient ({n} "
          f"values, losses {[round(r['loss'], 4) for r in pipe]}) over "
          f"{S} ranks: compress_tree_psum vs the fp32 all_reduce max|Δ| "
          f"{max(r['reduce_err'] for r in pipe):.3g} = {ratio:.4f} of "
          f"S·½·scale; a rank hands the collectives "
          f"{pipe[0]['compressed_bytes']} bytes (int32 codes of whole "
          f"chunks + fp32 chunk maxima) against {pipe[0]['fp32_bytes']} "
          f"(fp32); walls (host clock): compress_tree_psum "
          f"{max(r['compressed_s'] for r in pipe):.3f} s, again "
          f"{max(r['compressed_warm_s'] for r in pipe):.3f} s, the fp32 "
          f"all_reduce leaf by leaf "
          f"{max(r['plain_reduce_s'] for r in pipe):.3f} s; the gradient "
          f"as one tensor (first call in brackets): compressed "
          f"{max(r['flat']['int8'] for r in pipe):.3f} "
          f"[{max(r['flat']['int8_cold'] for r in pipe):.3f}] s, fp32 "
          f"{max(r['flat']['fp32'] for r in pipe):.3f} "
          f"[{max(r['flat']['fp32_cold'] for r in pipe):.3f}] s",
          flush=True)
    # 13d
    for r in res:
        require(r["quickstart_stages"] == 4 and r["quickstart_ok"]
                and r["stream_ok"] and r["gather_ok"],
                f"13d rank {r['rank']}: quickstart "
                f"{r['quickstart_stages']} stages, systolic == direct "
                f"{r['quickstart_ok']}, stream {r['stream_ok']}, staged "
                f"gather bit for bit {r['gather_ok']}")
    peak = [round(r["peak_gib"], 2) for r in res] if "peak_gib" in res[0] \
        else "not measured"
    print(f"[13d] systolic backend on {PIPE_RANKS} ranks: the quickstart "
          f"kernel (4 stages) == direct call, a 6-microbatch stream == "
          f"direct calls, decoupled_gather_staged of "
          f"{res[0]['gather_rows']} rows (3 stages) bit for bit "
          f"decoupled_gather_ref; walls {max(r['systolic_s'] for r in res):.3f}"
          f" / {max(r['stream_s'] for r in res):.3f} / "
          f"{max(r['staged_s'] for r in res):.3f} s", flush=True)
    print(f"[13] ranks' wall {spawn_s:.2f} s (start-up included); peak "
          f"GiB allocated per rank {peak}", flush=True)
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


# ---------------------------------------------------------------------------
# Phase 14: the production dry run
# ---------------------------------------------------------------------------

#: the production meshes' axis sizes
DRYRUN_MESHES = {"16x16": {"data": 16, "model": 16},
                 "2x16x16": {"pod": 2, "data": 16, "model": 16}}
#: the reference's HBM (a TPU v5e's 16 GiB), which decides its serve policy
REF_HBM_BYTES = 16 * 2**30


def dryrun_arguments(hbm_bytes: int) -> dict:
    """One rank's argument bytes of every applicable (arch, shape, mesh)
    cell, by the rules alone, the serve policy under ``hbm_bytes``."""
    from repro_torch.configs import ARCH_IDS, SHAPES, load_config
    from repro_torch.configs.base import cell_is_applicable
    from repro_torch.launch import steps
    out = {}
    for arch in ARCH_IDS:
        cfg = load_config(arch)
        for shape in SHAPES:
            if not cell_is_applicable(cfg, SHAPES[shape]):
                continue
            for mesh, sizes in DRYRUN_MESHES.items():
                _, args, specs = steps.cell_inputs(cfg, shape, sizes,
                                                   hbm_bytes=hbm_bytes)
                out[f"{arch}__{shape}__{mesh}"] = steps.argument_bytes(
                    args, specs, sizes)
    return out


def dryrun_spec_digests() -> dict:
    """A sha256 an architecture of every leaf's spec (path, shape, spec,
    one line each) on both meshes under the train rules, serve ``tp`` and
    ``2d`` with and without ``ep_serve``, the cache rules (decode_32k and,
    where it applies, long_500k) and the batch rules."""
    import hashlib
    from repro_torch import tree
    from repro_torch.configs import ARCH_IDS, SHAPES, load_config
    from repro_torch.configs.base import cell_is_applicable
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.runtime import sharding as shr
    out = {}
    for arch in ARCH_IDS:
        cfg = load_config(arch)
        params = M.init_params(None, cfg, "meta")
        pbytes = steps._param_bytes(params)
        lines = []

        def add(tag, tree_, specs):
            for (path, leaf), sp in zip(tree.flatten_with_paths(tree_),
                                        steps._spec_leaves(specs)):
                lines.append(f"{tag} {path} {tuple(leaf.shape)} {sp}")

        for mesh, sizes in DRYRUN_MESHES.items():
            add(f"{mesh} train", params, shr.params_specs(sizes, params))
            for hbm in (2**62, 1):                  # tp, then 2d
                for ep in (False, True):
                    add(f"{mesh} serve hbm={hbm} ep={ep}", params,
                        shr.params_specs_serve(sizes, params, pbytes,
                                               ep_serve=ep, hbm_bytes=hbm))
            for shape in ("decode_32k", "long_500k"):
                if cell_is_applicable(cfg, SHAPES[shape]):
                    cache = M.input_specs(cfg, shape)["cache"]
                    add(f"{mesh} cache {shape}", cache,
                        shr.tree_specs(sizes, cache, shr.cache_pspec))
            for shape in SHAPES:
                for key, t in M.input_specs(cfg, shape).items():
                    if key != "cache":
                        lines.append(f"{mesh} batch {shape} {key} "
                                     f"{shr.batch_pspec(sizes, t.shape)}")
        out[arch] = hashlib.sha256("\n".join(lines).encode()).hexdigest()
    return out


#: phase 14b's cells: (arch, shape, variant, config overrides, ep_serve)
DRYRUN_CELLS = (
    *((a, "decode_32k", None, {}, False) for a in (
        "jamba-1.5-large-398b", "qwen2.5-14b", "olmo-1b", "smollm-135m",
        "command-r-plus-104b", "rwkv6-1.6b", "deepseek-v3-671b",
        "llama4-scout-17b-a16e", "musicgen-large", "chameleon-34b")),
    ("smollm-135m", "train_4k", None, {}, False),
    ("deepseek-v3-671b", "train_4k", None, {}, False),
    ("smollm-135m", "prefill_32k", None, {}, False),
    ("rwkv6-1.6b", "long_500k", None, {}, False),
    ("deepseek-v3-671b", "decode_32k", "absorbed_ep",
     {"mla_absorbed": True}, True),
)


def dryrun_phase(dev, smi: str) -> None:
    """Phase 14 (module docstring)."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import SHAPES, load_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import mesh as lm
    from repro_torch.runtime import sharding as shr

    # -- 14a. the card's constants, the rules, the argument bytes ----------
    total = torch.cuda.get_device_properties(0).total_memory
    require(shr.HBM_BYTES_PER_CHIP == total,
            f"HBM_BYTES_PER_CHIP {shr.HBM_BYTES_PER_CHIP} != the card's "
            f"{total}")
    require("H100" in smi, f"not an H100: {smi}")
    print(f"[14a] card constants: HBM {total:,} B (get_device_properties), "
          f"peak bf16 {shr.PEAK_FLOPS_BF16:.4g} FLOP/s, HBM "
          f"{shr.HBM_BW:.4g} B/s, link {shr.ICI_BW_PER_LINK:.4g} B/s; "
          f"{smi}", flush=True)
    t0 = time.perf_counter()
    digests = dryrun_spec_digests()
    bad = [a for a in REF_DRYRUN_SPECS if digests.get(a) !=
           REF_DRYRUN_SPECS[a]]
    require(not bad and len(digests) == 10,
            f"specs differ from the reference's: {bad}")
    ref_args = dryrun_arguments(REF_HBM_BYTES)
    require(ref_args == REF_DRYRUN_ARGS and len(ref_args) == 64,
            f"argument bytes differ from the reference's: "
            f"{ {k: v for k, v in ref_args.items() if REF_DRYRUN_ARGS.get(k) != v} }")
    card_args = dryrun_arguments(shr.HBM_BYTES_PER_CHIP)
    moved = sorted(k for k in card_args if card_args[k] != ref_args[k])
    print(f"[14a] specs of 10 architectures x 2 meshes x (train, serve "
          f"tp/2d x ep_serve, cache, batch) equal the reference's; "
          f"argument bytes of 64 cells equal the reference's "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    print(f"[14a] cells whose serve policy the card's HBM changes "
          f"(2d -> tp): {moved}", flush=True)

    # -- 14b. run_cell on the fake world ----------------------------------------
    for arch, shape, variant, over, ep in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, multi_pod=False, save=False,
                              variant=variant, overrides=over, ep_serve=ep,
                              device=dev)
        require(rec["status"] == "ok",
                f"{arch} {shape} {variant}: {rec.get('traceback')}")
        cfg = dataclasses.replace(load_config(arch), **over)
        _, args, specs = steps.cell_inputs(cfg, shape,
                                           DRYRUN_MESHES["16x16"],
                                           ep_serve=ep)
        want = steps.argument_bytes(args, specs, DRYRUN_MESHES["16x16"])
        require(rec["mem_argument_size_in_bytes"] == want,
                f"{arch} {shape}: argument bytes "
                f"{rec['mem_argument_size_in_bytes']} != the rules' {want}")
        key = (arch + ("+absorbed" if over else ""), shape)
        want = (REF_TRAIN_CENSUS[arch] if SHAPES[shape].kind == "train"
                else REF_DRYRUN_CENSUS[key])
        require(rec["dataflow"] == want,
                f"{key}: census {rec['dataflow']} != the reference's {want}")
        c, r = rec["coll"], rec["roofline"]
        print(f"[14b] {arch} {shape}{' ' + variant if variant else ''}: ok "
              f"in {rec['total_s']} s (trace {rec['trace_s']:.2f} s); args "
              f"{rec['mem_argument_size_in_bytes']:,} B, out "
              f"{rec['mem_output_size_in_bytes']:,} B, peak "
              f"{rec['peak_bytes']:,} B; rank FLOPs {rec['rank_flops']:.4g},"
              f" bytes {rec['rank_bytes']:.4g}; collectives "
              f"{ {k: (c['count'][k], c[k]) for k in c['count'] if c['count'][k]} }"
              f" total {c['total']:,} B; roofline compute "
              f"{r['t_compute_s']:.4g} s, memory {r['t_memory_s']:.4g} s, "
              f"collective {r['t_collective_s']:.4g} s ({r['dominant']}); "
              f"fits HBM {rec['fit']['fits_hbm']}; census the reference's",
              flush=True)

    # -- 14c. rank 0's shards for real on the card ---------------------------
    import gc
    gen = torch.Generator(device=dev).manual_seed(0)
    sizes = DRYRUN_MESHES["16x16"]
    for arch in ("qwen2.5-14b", "deepseek-v3-671b"):
        cfg = load_config(arch)
        with lm.fake_world(256):
            mesh = lm.make_production_mesh(False, dev)
            rec = steps.lower_cell(cfg, "decode_32k", mesh)
        _, args, specs = steps.cell_inputs(cfg, "decode_32k", sizes)
        want = steps.argument_bytes(args, specs, sizes)
        require(rec["mem_argument_size_in_bytes"] == want,
                f"{arch}: the census's argument bytes "
                f"{rec['mem_argument_size_in_bytes']:,} != the rules' "
                f"{want:,}")
        for (path, leaf), sp, got in zip(tree.flatten_with_paths(args),
                                         steps._spec_leaves(specs),
                                         rec["local_shapes"], strict=True):
            rule = shr.local_shape(sizes, leaf.shape, sp)
            require(tuple(got) == rule,
                    f"{arch} {path}: the census's local shape {got} != "
                    f"the rules' {rule}")

        def requested() -> int:
            return torch.cuda.memory_stats()["requested_bytes.all.current"]

        torch.cuda.synchronize()
        # a warm cache hands out whole cached blocks up to 1 MB larger
        # than asked: measure on fresh segments
        gc.collect()
        torch.cuda.empty_cache()
        base, base_req = torch.cuda.memory_allocated(), requested()
        held, off = [], []
        for (path, leaf), shp in zip(tree.flatten_with_paths(args),
                                     rec["local_shapes"], strict=True):
            before = requested()
            t = torch.empty(shp, dtype=leaf.dtype, device=dev)
            if leaf.dtype.is_floating_point:
                t.normal_(generator=gen)
            else:
                t.random_(0, 2**15, generator=gen)
            held.append(t)
            if requested() - before != t.numel() * t.element_size():
                off.append((path, requested() - before,
                            t.numel() * t.element_size()))
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - base
        asked = requested() - base_req
        slack = 512 * len(held)
        # the allocator's least: each tensor in whole 512-byte blocks
        blocks = sum(max(512, -(-t.numel() * t.element_size() // 512) * 512)
                     for t in held)
        require(not off and asked == want,
                f"{arch}: the allocator was asked for {asked:,} B for "
                f"{want:,} B of shards; leaves off (path, asked, bytes): "
                f"{off[:5]}")
        require(blocks <= grown <= want + slack,
                f"{arch}: {grown:,} B allocated for {want:,} B of shards "
                f"in {blocks:,} B of blocks (slack {slack:,})")
        print(f"[14c] {arch} decode_32k: rank 0's {len(held)} shards at the "
              f"rules' local shapes allocated on the card: the allocator "
              f"was asked for {asked:,} B, the rules' bytes, leaf by leaf; "
              f"memory_allocated grew {grown:,} B (+{grown - want:,} B; "
              f"512-byte blocks +{blocks - want:,} B, bound 512 B x "
              f"{len(held)} = {slack:,})", flush=True)
        # ``t`` too: it holds the last shard, whose release inside the next
        # cell's loop would count against that cell
        del held, t
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 15: the core calls on the card; elastic checkpoints on ranks
# ---------------------------------------------------------------------------

#: phase 15a: the gather feeding a transcendental, table f32[2^20] and
#: 2^16 indices in [-2^20, 2^20) (negative ones wrap)
CORE_TABLE, CORE_INDICES = 1 << 20, 1 << 16
POLICIES = ("paper", "fused", "maximal", "cost_aware")
#: phase 15b: SmolLM-135M's train state at published widths (bf16 params,
#: fp32 moments) restored on ELASTIC_RANKS gloo ranks sharing the card,
#: on these ("data", "model") meshes; ELASTIC_BATCHES prefetched batches
#: of ELASTIC_BATCH x (ELASTIC_SEQ + 1) tokens
ELASTIC_RANKS = 4
ELASTIC_MESHES = ((2, 2), (4, 1))
ELASTIC_BATCH, ELASTIC_SEQ, ELASTIC_BATCHES = 8, 1024, 3
ELASTIC_TIMEOUT_S = 600


def _gather_tanh(table, idx):
    import torch
    return torch.tanh(table[idx] * 2.0)


def _quickstart(table, idx, w):
    import torch
    return torch.tanh(table[idx] * w) + 1.0


def _bits(t):
    """``t``'s bit patterns (bf16 / fp16 / fp32 / fp64 as ints of their
    width), so ``torch.equal`` compares bits, not values."""
    import torch
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()]) if t.is_floating_point() else t


def core_calls_on_card(dev) -> None:
    """Phase 15a: ``decoupled_call`` of ``tanh(2·table[idx])`` and of the
    quickstart kernel under the four policies on CUDA tensors, each
    output bit for bit the function called directly on the card, each
    program's stage count that of the CPU trace of the same function;
    ``ChannelSpec.from_example`` of a nested dict of fp32, bf16, int8 and
    int64 CUDA tensors (and ``None``), packed and unpacked bit for bit,
    its ``width`` the CPU's."""
    import torch
    from repro_torch import tree
    from repro_torch.core import ChannelSpec, decoupled_call
    gen = torch.Generator().manual_seed(15)
    table = torch.randn(CORE_TABLE, generator=gen)
    idx = torch.randint(-CORE_TABLE, CORE_TABLE, (CORE_INDICES,),
                        generator=gen, dtype=torch.int32)
    qs = (torch.arange(1024, dtype=torch.float32),
          torch.tensor([3, 997, 41, 512, 7, 800, 64, 2], dtype=torch.int32),
          torch.tensor(1.5))
    stages = {}
    t0 = time.perf_counter()
    for fn, cpu_args in ((_gather_tanh, (table, idx)), (_quickstart, qs)):
        args = tuple(a.to(dev) for a in cpu_args)
        want = fn(*args)
        for policy in POLICIES:
            staged = decoupled_call(fn, *args, policy=policy)
            got = staged(*args)
            on_cpu = decoupled_call(fn, *cpu_args, policy=policy)
            n, n_cpu = len(staged.program), len(on_cpu.program)
            require(got.device.type == dev.type and torch.equal(
                _bits(got), _bits(want)),
                f"15a {fn.__name__} {policy}: the staged program differs "
                f"from the direct call on the card")
            require(n == n_cpu, f"15a {fn.__name__} {policy}: {n} stages on "
                    f"the card, {n_cpu} in the CPU trace")
            stages[fn.__name__, policy] = n
    _sync(dev)
    call_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(16)
    example = {
        "w": {"b": torch.randn(3, 5, generator=g).to(torch.bfloat16),
              "a": torch.randn(7, generator=g)},
        "i8": torch.randint(-128, 128, (13,), generator=g,
                            dtype=torch.int8),
        "seq": [torch.tensor([2 ** 40 + 3, -7, 2 ** 62], dtype=torch.int64),
                None, torch.tensor(0.25)],
    }
    on_card = tree.tree_map(lambda t: t if t is None else t.to(dev),
                            example)
    t0 = time.perf_counter()
    spec = ChannelSpec.from_example(on_card)
    word = spec.pack(on_card)
    back = spec.unpack(word)
    _sync(dev)
    spec_s = time.perf_counter() - t0
    cpu_width = ChannelSpec.from_example(example).width
    # leaf by path: ``back``'s dicts hold their keys sorted
    got = dict(tree.flatten_with_paths(back))
    want = dict(tree.flatten_with_paths(on_card))
    require(word.device.type == dev.type and spec.width == cpu_width
            and got.keys() == want.keys() and all(
                (a is None and want[k] is None) or (
                    a.device == want[k].device and a.dtype == want[k].dtype
                    and torch.equal(_bits(a), _bits(want[k])))
                for k, a in got.items())
            and list(back) == sorted(on_card),
            f"15a ChannelSpec: width {spec.width} (CPU {cpu_width}) or the "
            f"round trip differs")
    print(f"[15a] decoupled_call on {dev}: "
          f"tanh(2·table[idx]) (table f32[{CORE_TABLE}], idx "
          f"i32[{CORE_INDICES}]) stages "
          f"{[stages['_gather_tanh', p] for p in POLICIES]} and the "
          f"quickstart kernel {[stages['_quickstart', p] for p in POLICIES]}"
          f" ({'/'.join(POLICIES)}; the CPU trace's the same), each output "
          f"bit for bit the direct call; wall {call_s:.3f} s (traces "
          f"included); ChannelSpec.from_example of {len(want)} leaves "
          f"(fp32, bf16, int8, int64, None) on {dev}: width {spec.width} "
          f"words (CPU {cpu_width}), round trip bit for bit, "
          f"{spec_s * 1e3:.2f} ms", flush=True)


def elastic_state(cfg, dev, seed: int):
    """A whole train state of ``cfg`` on ``dev`` from ``seed``: params
    and moments N(0, 0.02²) in their dtypes, ``count`` and ``step`` 7."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import steps
    abstract = steps.abstract_train_state(cfg, steps.adamw.AdamWConfig())
    gen = torch.Generator(device=dev).manual_seed(seed)

    def fill(t):
        if not t.is_floating_point():
            return torch.full(t.shape, 7, dtype=t.dtype, device=dev)
        return (torch.randn(t.shape, generator=gen, device=dev)
                * 0.02).to(t.dtype)
    return tree.tree_map(fill, abstract)


def _chunk(t, mesh, placements):
    """This rank's chunk of the whole ``t`` by ``placements``: each mesh
    dim that shards tensor dim ``d`` takes its coordinate's piece of
    ``torch.chunk``, in mesh-dim order."""
    import torch
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            t = torch.chunk(t, mesh.size(i), dim=p.dim)[coord[i]]
    return t


def _shards_match(state, want, mesh, device_type: str) -> tuple:
    """Whether every leaf of the placed ``state`` holds, on a
    ``device_type`` device, this rank's chunk of the whole ``want``, bit
    for bit; and the bytes the rank holds."""
    from repro_torch import tree
    import torch
    ok, held = True, 0
    for got, w in zip(tree.leaves(state), tree.leaves(want), strict=True):
        local = got.to_local()
        exp = _chunk(w, mesh, got.placements)
        ok &= (got.device_mesh is mesh and local.device.type == device_type
               and local.dtype == w.dtype and local.shape == exp.shape
               and torch.equal(_bits(local), _bits(exp)))
        held += local.numel() * local.element_size()
    return ok, held


def elastic_rank(plain_dir: str, sharded_dir: str, cfg, batch: int,
                 seq: int, batches: int, seed: int) -> dict:
    """Phase 15b on one of the ranks (``launch.mesh.spawn``): restore the
    one-process checkpoint in ``plain_dir`` with
    ``shardings=train_state_shardings`` on each of ``ELASTIC_MESHES``;
    save the 2×2 state sharded into ``sharded_dir`` and restore that on
    each mesh; each time, hold every leaf's local shard to the chunk of
    the plain restore (the whole state on this rank's device).  Then
    ``prefetched(sharding=)``'s batches against the chunks of the
    unsharded stream, and a shape mismatch.  Returns flags, walls and
    bytes."""
    import torch
    import torch.distributed as dist
    from repro_torch import _device
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data.pipeline import (DataConfig, prefetched,
                                           synthetic_stream)
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import steps
    dev = _device.get_device()
    # host-clock marks of this rank's parts: entry (time.time(), against
    # the spawn's start), meshes, the yardstick, batches, the mismatch
    out: dict = {"rank": dist.get_rank(), "entered": time.time()}
    t0 = time.perf_counter()
    abstract = steps.abstract_train_state(cfg, steps.adamw.AdamWConfig())
    meshes = {dims: lm.make_mesh(dims, ("data", "model"), dev.type)
              for dims in ELASTIC_MESHES}
    out["meshes_s"] = time.perf_counter() - t0
    plain, sharded = Checkpointer(plain_dir), Checkpointer(sharded_dir)
    t0 = time.perf_counter()
    want, _ = plain.restore(abstract)          # the yardstick, whole
    _sync(dev)
    out["yardstick_s"] = time.perf_counter() - t0

    def restore_on(ck, dims, tag):
        mesh = meshes[dims]
        sh = steps.train_state_shardings(mesh, abstract)
        t0 = time.perf_counter()
        state, step = ck.restore(abstract, shardings=sh)
        _sync(dev)
        wall = time.perf_counter() - t0
        ok, held = _shards_match(state, want, mesh, dev.type)
        out[tag, dims] = {"ok": ok, "s": wall, "bytes": held, "step": step}
        return state

    on22 = restore_on(plain, (2, 2), "plain")
    restore_on(plain, (4, 1), "plain")
    # the 2×2 state saved sharded: every rank gathers, rank 0 writes
    t0 = time.perf_counter()
    sharded.save(11, on22)
    sharded.wait()
    out["save_s"] = time.perf_counter() - t0
    out["latest"] = sharded.latest_step()
    del on22
    for dims in ELASTIC_MESHES:
        restore_on(sharded, dims, "sharded")
    # the prefetched batches' chunks
    t0 = time.perf_counter()
    data = DataConfig(batch_size=batch, seq_len=seq,
                      vocab_size=cfg.vocab_size, seed=seed)
    for dims, mesh in meshes.items():
        tok = torch.empty((batch, seq + 1), dtype=torch.int32, device="meta")
        bsh = steps.batch_shardings(mesh, {"tokens": tok})["tokens"]
        fifo = prefetched(synthetic_stream(data), depth=2, sharding=bsh)
        whole = synthetic_stream(data)
        ok = True
        for _ in range(batches):
            got = next(fifo)["tokens"]
            exp = _chunk(torch.from_numpy(next(whole)["tokens"]).to(dev),
                         mesh, got.placements)
            local = got.to_local()
            ok &= (got.device_mesh is mesh
                   and local.device.type == dev.type
                   and torch.equal(local, exp))
        out["batches", dims] = {"ok": ok, "placements": str(got.placements),
                                "local": tuple(local.shape)}
    out["batches_s"] = time.perf_counter() - t0
    # a stored shape that differs from the example's
    t0 = time.perf_counter()
    bad = steps.abstract_train_state(cfg, steps.adamw.AdamWConfig())
    table = bad.params["embed"]["table"]
    bad.params["embed"]["table"] = torch.empty(
        (table.shape[0] + 4, table.shape[1]), dtype=table.dtype,
        device="meta")
    try:
        plain.restore(bad, shardings=steps.train_state_shardings(
            meshes[2, 2], bad))
        out["mismatch"] = "restored"
    except ValueError as e:
        out["mismatch"] = str(e)
    out["mismatch_s"] = time.perf_counter() - t0
    out["left"] = time.time()
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def elastic_checkpoints(dev, smi: str, cfg=None, batch: int = ELASTIC_BATCH,
                        seq: int = ELASTIC_SEQ) -> dict:
    """Phase 15b: SmolLM-135M's train state (``cfg``: the published
    config) saved from this process, then restored, re-saved sharded and
    restored again on ``ELASTIC_RANKS`` gloo ranks that share the card
    (:func:`elastic_rank`); the sharded checkpoint restored whole here
    must equal the state.  Prints each rank's restore walls and bytes
    held beside the card; returns the ranks' results."""
    import shutil
    import tempfile

    import torch
    from repro_torch import tree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import load_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import spawn
    cfg = cfg or load_config("smollm-135m")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="elastic-", dir=os.path.join(ROOT,
                                                                "build"))
    plain_dir, sharded_dir = (os.path.join(work, d) for d in ("plain",
                                                              "sharded"))
    try:
        state = elastic_state(cfg, dev, seed=15)
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree.leaves(state))
        t0 = time.perf_counter()
        Checkpointer(plain_dir).save(7, state, blocking=True)
        save_s = time.perf_counter() - t0
        cpu = [t.cpu() for t in tree.leaves(state)]
        n_leaves = len(cpu)
        del state
        _free()
        t0, started = time.perf_counter(), time.time()
        res = spawn(elastic_rank, ELASTIC_RANKS, plain_dir, sharded_dir,
                    cfg, batch, seq, ELASTIC_BATCHES, 15, backend="gloo",
                    device=dev.type, timeout_s=ELASTIC_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        whole, step = Checkpointer(sharded_dir).restore(
            steps.abstract_train_state(cfg, steps.adamw.AdamWConfig()))
        whole_s = time.perf_counter() - t0
        same = all(torch.equal(_bits(a.cpu()), _bits(b))
                   for a, b in zip(tree.leaves(whole), cpu, strict=True))
        del whole, cpu
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r in res:
        for key, v in r.items():
            if isinstance(key, tuple) and key[0] in ("plain", "sharded",
                                                     "batches"):
                require(v["ok"], f"15b rank {r['rank']} {key}: a local "
                        f"shard differs from the chunk of the whole")
        require(r["latest"] == 11, f"15b rank {r['rank']}: latest step "
                f"{r['latest']} after the sharded save's wait")
        require("embed/table" in r["mismatch"], f"15b rank {r['rank']}: "
                f"a shape mismatch gave {r['mismatch']!r}")
    require(same and step == 11, "15b the sharded save restored whole in "
            "one process differs from the state")
    for r in res:
        walls = ", ".join(
            f"{tag} on {a}x{b} {r[tag, (a, b)]['s']:.3f} s / "
            f"{r[tag, (a, b)]['bytes']:,} B"
            for tag in ("plain", "sharded") for a, b in ELASTIC_MESHES)
        print(f"[15b] rank {r['rank']}: restore wall / bytes held: {walls};"
              f" sharded save + wait {r['save_s']:.3f} s; batches "
              f"{[r['batches', d]['local'] for d in ELASTIC_MESHES]} local; "
              f"peak {r.get('peak_gib', float('nan')):.2f} GiB; host clock: "
              f"start-up {r['entered'] - started:.2f} s, meshes "
              f"{r['meshes_s']:.2f} s, yardstick restore "
              f"{r['yardstick_s']:.2f} s, batches {r['batches_s']:.2f} s, "
              f"mismatch {r['mismatch_s']:.2f} s, return "
              f"{started + spawn_s - r['left']:.2f} s", flush=True)
    print(f"[15b] {cfg.name} train state, {nbytes:,} B ({n_leaves} leaves)"
          f", saved from one process in {save_s:.3f} s, the sharded "
          f"save restored whole here in {whole_s:.3f} s; "
          f"{ELASTIC_RANKS} gloo ranks sharing the card, meshes "
          f"{ELASTIC_MESHES}: every local shard bit for bit the chunk of "
          f"the plain restore; the sharded checkpoint restored whole here "
          f"equals the state; {ELASTIC_BATCHES} prefetched batches of "
          f"{batch}x{seq + 1} per mesh each rank's chunk; shape mismatch "
          f"raises ValueError; ranks' wall {spawn_s:.2f} s (start-up "
          f"included); card: {smi}", flush=True)
    return res


# ---------------------------------------------------------------------------
# Phase 16: the train cells' dataflow census; the lowered train step
# ---------------------------------------------------------------------------

#: phase 16b: SmolLM-135M's lowered train step, 2 sequences of 512 tokens,
#: three steps in each of fp32 and bf16 from step 200 (the end of
#: ``make_train_step``'s warmup: LR scale ~1)
LOWERED_BATCH, LOWERED_SEQ, LOWERED_STEPS, LOWERED_FROM = 2, 512, 3, 200


def _change_err(got, want, before) -> float:
    """The largest, over leaves, of ``‖(got − before) − (want −
    before)‖₂ / ‖want − before‖₂`` (fp64 on the CPU): how far one run's
    change of the params is from another's.  A leaf ``want`` did not
    move (a bf16 norm scale of 1, whose ulp is above lr) counts 0 if
    ``got`` left it as it was too, else inf."""
    from repro_torch import tree
    worst = 0.0
    for g, w, b in zip(tree.leaves(got), tree.leaves(want),
                       tree.leaves(before), strict=True):
        g, w, b = (t.detach().double().cpu() for t in (g, w, b))
        d, e = float((w - b).norm()), float((g - w).norm())
        worst = max(worst, e / d if d else (math.inf if e else 0.0))
    return worst


def lowered_step_inputs(dev) -> tuple:
    """Phase 16b's SmolLM-135M config, AdamW config, batches (seeded) and
    initial fp32 params (seeded) on ``dev``."""
    import torch
    from repro_torch.configs import load_config
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    base = load_config("smollm-135m")
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, base.vocab_size, (LOWERED_BATCH, LOWERED_SEQ + 1)).astype(
            np.int32)).to(dev)} for _ in range(LOWERED_STEPS)]
    init = M.init_params(torch.Generator(device=dev).manual_seed(0), base,
                         dev)
    return base, adamw.AdamWConfig(), batches, init


def lowered_step_state(cfg, opt_cfg, init):
    """The train state 16b starts from: ``init`` in ``cfg``'s dtype, zero
    moments, step ``LOWERED_FROM``."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    params = tree.tree_map(lambda t: t.to(cfg.torch_dtype), init)
    return steps.TrainState(params, adamw.init_opt_state(params, opt_cfg),
                            torch.tensor(LOWERED_FROM, dtype=torch.int32,
                                         device=params["embed"]["table"]
                                         .device))


def fp32_yardstick(cfg, opt_cfg, state, batch) -> dict:
    """16b's bf16 yardstick: one fp32 ``make_train_step`` from ``state``'s
    bf16 params cast up, so that only the bf16 steps' own rounding parts
    them from it: its new params cast back to ``cfg``'s dtype and its
    moments, in the reference's layout, and its gradient norm."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    p32 = tree.tree_map(lambda t: t.float(), state.params)
    s32, m32 = steps.make_train_step(
        dataclasses.replace(cfg, dtype="float32"), opt_cfg)(
        steps.TrainState(p32, adamw.init_opt_state(p32, opt_cfg),
                         state.step.clone()), batch)
    s32 = steps.stack_train_state(s32)
    return dict(params=tree.tree_map(lambda t: t.to(cfg.torch_dtype),
                                     s32.params),
                opt={k: s32.opt[k] for k in ("mu", "nu")},
                grad_norm=float(m32["grad_norm"]))


def _row_dists(got: dict, want: dict) -> dict:
    """Each moment row's relative L2 distance ``‖got − want‖₂ /
    ‖want‖₂`` (fp32), keyed ``(moment, path, row)``: a row is one repeat
    of a segment leaf (the reference's layout), or a whole other leaf.
    A row ``want`` holds at zero counts 0 if ``got`` does too, else
    inf."""
    from repro_torch import tree
    out = {}
    for k in ("mu", "nu"):
        for (path, g), w in zip(tree.flatten_with_paths(got[k]),
                                tree.leaves(want[k]), strict=True):
            g, w = g.detach().float(), w.detach().float()
            if not str(path[0]).startswith("segment_"):
                g, w = g[None], w[None]
            d = (g - w).flatten(1).norm(dim=1).tolist()
            n = w.flatten(1).norm(dim=1).tolist()
            for i, (e, m) in enumerate(zip(d, n)):
                out[(k, path, i)] = e / m if m else (math.inf if e else 0.0)
    return out


def bf16_readings(first: dict, metrics: dict, same: dict, start) -> dict:
    """How far the first bf16 step of each side (``lowered``, and
    ``step``: make_train_step's), from the params ``start``, is from the
    fp32 yardstick ``same`` (:func:`fp32_yardstick`): the gradient
    norm's relative distance, a params leaf's change
    (:func:`_change_err`) and the worst moment row (:func:`_row_dists`);
    and the largest ratio, over moment rows, of the lowered step's
    distance to make_train_step's, with the row it is at."""
    rows, out = {}, {}
    for w in ("lowered", "step"):
        rows[w] = _row_dists(first[w].opt, same["opt"])
        out[w] = dict(grad_norm=abs(metrics[w]["grad_norm"]
                                    - same["grad_norm"]) / same["grad_norm"],
                      change=_change_err(first[w].params, same["params"],
                                         start),
                      moment=max(rows[w].values()))
    ratio, where = max((rows["lowered"][k] / max(rows["step"][k], 1e-6), k)
                       for k in rows["step"])
    out["moment_ratio"], out["moment_where"] = ratio, str(where)
    return out


#: 16b's bf16 bars, each on the lowered step's first bf16 step against
#: an fp32 step from the same params (two bf16 backwards, JAX's
#: transposed equations and autograd, round on their own), set from the
#: readings of ``scripts/bf16_step_bars.py`` (PERF.md §2: three sound
#: runs alike; a planted fault): ``grad_norm``, the gradient norm's
#: relative distance (sound 5.2e-4, make_train_step's 8.4e-4);
#: ``change``, a params leaf's change as a multiple of make_train_step's
#: (sound 1.004; Adam's first step is ~lr·sign(g), so this reads signs,
#: not scale); ``moment``, a moment row's distance as a multiple of
#: make_train_step's at that row (sound 1.39; one row of one leaf's
#: gradient scaled by 1.03 reads 3.3)
BF16_BARS = {"grad_norm": 7.5e-4, "change": 1.25, "moment": 1.75}


def hold_bf16(r: dict, phase: str) -> None:
    """Fail unless the :func:`bf16_readings` ``r`` are within
    :data:`BF16_BARS`."""
    low, step = r["lowered"], r["step"]
    require(low["grad_norm"] <= BF16_BARS["grad_norm"], f"{phase} bf16 "
            f"gradient norm {low['grad_norm']:.3g} from the fp32 step's "
            f"(make_train_step's {step['grad_norm']:.3g}), beyond "
            f"{BF16_BARS['grad_norm']:g}")
    require(low["change"] <= BF16_BARS["change"] * step["change"],
            f"{phase} bf16 params: a leaf's change {low['change']:.3g} of "
            f"its L2 norm from the fp32 step's, beyond "
            f"{BF16_BARS['change']:g} x make_train_step's "
            f"({step['change']:.3g})")
    require(r["moment_ratio"] <= BF16_BARS["moment"], f"{phase} bf16 "
            f"moments: at {r['moment_where']} {r['moment_ratio']:.3g} x "
            f"make_train_step's distance from the fp32 step's, beyond "
            f"{BF16_BARS['moment']:g}")


#: the 16a cells beyond the published configs: an option of the train
#: step on one of them (:func:`train_config`)
TRAIN_VARIANTS = ("smollm-135m+remat", "jamba-1.5-large-398b+chunked")


def train_config(name: str, load=None):
    """The config of a 16a cell: an architecture's (``load``, default the
    port's ``load_config``), with ``+remat`` each segment's body under
    ``jax.checkpoint``, with ``+chunked`` its Mamba scans the chunked
    one (chunk 16)."""
    import dataclasses

    from repro_torch.configs import load_config
    arch, _, variant = name.partition("+")
    cfg = (load or load_config)(arch)
    if variant == "remat":
        return dataclasses.replace(cfg, remat=True)
    if variant == "chunked":
        return dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, scan_impl="chunked", chunk=16))
    return cfg


def train_census_on_card(smi: str) -> None:
    """Phase 16a: every architecture's ``train_4k`` census at published
    widths on ``meta`` equal to the reference's outright, channel bytes
    included, and SmolLM-135M's under remat and Jamba-1.5-Large's with
    the chunked Mamba scan; each cell's wall."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import dryrun
    print(f"[16a] card: {smi}", flush=True)
    for arch in (*ARCH_IDS, *TRAIN_VARIANTS):
        t0 = time.perf_counter()
        got = dryrun.dataflow_census(train_config(arch), "train_4k")
        wall = time.perf_counter() - t0
        want = REF_TRAIN_CENSUS[arch]
        require(dict(got) == want, f"16a {arch}: census {got}, the "
                f"reference's is {want}")
        print(f"[16a] {arch}: ops {got['ops']}, memory ops "
              f"{got['memory_ops']}, long ops {got['long_ops']}, stages "
              f"{got['stages']}, channels {got['channels']} "
              f"({got['channel_bytes']:,} B), II {got['pipeline_ii']}; "
              f"equal to the reference; in {wall:.2f} s", flush=True)


def replayed(e) -> int:
    """The equations the lowered body of the ``scan`` equation ``e``
    replays in one run, a nested scan's as many times as it steps, a
    ``remat2`` or ``closed_call`` body's each time it runs."""
    if e.prim != "scan":
        graph = e.params.get("jaxpr") or e.params["call_jaxpr"]
        return _replayed(graph.eqns)
    body, n_c, n_k = e.impl.args
    return e.invars[n_c + n_k].aval.shape[0] * _replayed(body.eqns)


def _replayed(eqns) -> int:
    return sum(replayed(q) if q.prim in ("scan", "remat2", "closed_call")
               else 1 for q in eqns)


def transposes_replayed(graph) -> int:
    """The equations the reverse ``scan`` equations of a lowered step
    replay in one run (:func:`replayed`); raises unless every scan of the
    step replays a lowered body."""
    from repro_torch.core import cdfg
    total = 0
    for e in graph.eqns:
        if e.prim != "scan":
            continue
        require(getattr(e.impl, "func", None) is cdfg._run_loop,
                "a scan of the lowered step does not replay a lowered body")
        if e.impl.keywords.get("reverse"):
            total += replayed(e)
    return total


@contextlib.contextmanager
def autograd_calls():
    """The calls of ``torch.autograd.grad`` / ``backward`` made inside
    the block (a list it fills), the functions themselves unchanged."""
    import torch
    calls: list = []
    saved = torch.autograd.grad, torch.autograd.backward

    def grad(*args, **kwargs):
        calls.append("grad")
        return saved[0](*args, **kwargs)

    def backward(*args, **kwargs):
        calls.append("backward")
        return saved[1](*args, **kwargs)
    torch.autograd.grad, torch.autograd.backward = grad, backward
    try:
        yield calls
    finally:
        torch.autograd.grad, torch.autograd.backward = saved


def lowered_step_on_card(dev, smi: str) -> None:
    """Phase 16b: SmolLM-135M's train step lowered by the census's front
    end (``dryrun.train_compiled``) and run by the ``sequential`` backend
    on the card, against ``make_train_step``, three steps from the same
    state and batches; no hand kernel launched."""
    import dataclasses

    import torch
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import _lib
    from repro_torch.launch import dryrun, steps

    B, S = LOWERED_BATCH, LOWERED_SEQ
    shape = InputShape("train", S, B, "train")
    base, opt_cfg, batches, init = lowered_step_inputs(dev)
    before = dict(_lib.counts())
    runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        state = lowered_step_state(cfg, opt_cfg, init)
        same = (fp32_yardstick(cfg, opt_cfg, state, batches[0])
                if dtype == "bfloat16" else None)
        t0 = time.perf_counter()
        comp = dryrun.train_compiled(cfg, shape, device=dev,
                                     backend="sequential")
        compile_s = time.perf_counter() - t0
        replayed = transposes_replayed(comp.graph)
        require(replayed > 0, "16b no transposed body replayed")
        step = steps.make_train_step(cfg, opt_cfg)
        lowered = start = steps.stack_train_state(state)
        n = len(tree.leaves(lowered))
        walls, metrics = {"step": [], "lowered": []}, {"step": [],
                                                       "lowered": []}
        first = None
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            walls["step"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            out = comp(tuple(tree.leaves(lowered)), tuple(tree.leaves(batch)))
            torch.cuda.synchronize()
            walls["lowered"].append(time.perf_counter() - t0)
            lowered = tree.unflatten(lowered, list(out[:n]))
            metrics["step"].append({k: float(v) for k, v in m.items()})
            metrics["lowered"].append(dict(zip(m, map(float, out[n:]))))
            if first is None:
                first = dict(step=steps.stack_train_state(state),
                             lowered=lowered)
        runs[dtype] = dict(step=steps.stack_train_state(state),
                           lowered=lowered, start=start,
                           first=first, metrics=metrics, walls=walls,
                           compile_s=compile_s, stages=comp.num_stages,
                           replayed=replayed, same=same)
        del comp, state, lowered
        _free()
    require(dict(_lib.counts()) == before,
            "16b the lowered step launched a hand kernel")

    f32 = runs["float32"]
    for i, (a, b) in enumerate(zip(f32["metrics"]["lowered"],
                                   f32["metrics"]["step"])):
        for k in b:
            require(abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), f"16b fp32 "
                    f"{k} step {i}: lowered {a[k]} vs step {b[k]}")
    low, want = f32["lowered"], f32["step"]
    require(int(low.step) == int(want.step) == LOWERED_FROM + LOWERED_STEPS
            and int(low.opt["count"]) == LOWERED_STEPS,
            "16b fp32 step counts")
    require(all(m["lr"] > 0.99 * opt_cfg.lr for m in f32["metrics"]["step"]),
            "16b the steps ran inside the warmup")
    # Adam's first steps move an element by ~lr·g/|g|: where |g| is at
    # the rounding level of the two backwards its sign may differ, so the
    # elements are printed and each leaf's change held as a whole
    p_err, _ = _max_err(low.params, want.params, rtol=0)
    n_far = sum(int(((a - b).abs() > 0.1 * opt_cfg.lr).sum()) for a, b in
                zip(tree.leaves(low.params), tree.leaves(want.params)))
    c_err = _change_err(low.params, want.params, f32["start"].params)
    require(c_err <= 1e-3, f"16b fp32 params: a leaf's change {c_err:.3g} "
            f"of its L2 norm from make_train_step's, beyond 1e-3")
    m_err = {}
    for k in ("mu", "nu"):
        m_err[k], ok = _max_err(low.opt[k], want.opt[k], rtol=1e-3,
                                scale_atol=1e-4)
        require(ok, f"16b fp32 {k} beyond rtol 1e-3 + 1e-4·max")
    print(f"[16b] SmolLM-135M fp32, {B} x {S} tokens, {LOWERED_STEPS} "
          f"steps: lowered ({f32['stages']} stages) == make_train_step at "
          f"the three-step bars: losses "
          f"{[m['loss'] for m in f32['metrics']['lowered']]}"
          f", params' change {c_err:.3g} of its L2 norm (bar 1e-3), params "
          f"max|Δ| {p_err:.3g} ({n_far} elements beyond 0.1·lr = "
          f"{0.1 * opt_cfg.lr:.3g}), mu {m_err['mu']:.3g}, nu "
          f"{m_err['nu']:.3g}", flush=True)

    # bf16: the first step from one state (LR scale ~1), the loss and
    # lr those of make_train_step (the same forward); its gradient norm,
    # params and moments held against an fp32 step from the same params
    # (BF16_BARS).  Later steps part further on rounding: printed.
    bf = runs["bfloat16"]
    a, b = bf["metrics"]["lowered"][0], bf["metrics"]["step"][0]
    for k, rtol in (("loss", 1e-4), ("lm_loss", 1e-4), ("lr", 0.0)):
        require(abs(a[k] - b[k]) <= rtol * abs(b[k]), f"16b bf16 {k} step "
                f"0: lowered {a[k]} vs step {b[k]}")
    r = bf16_readings(bf["first"], dict(lowered=a, step=b), bf["same"],
                      bf["start"].params)
    hold_bf16(r, "16b")
    loss_d = [abs(x["loss"] - y["loss"]) for x, y in
              zip(bf["metrics"]["lowered"], bf["metrics"]["step"])]
    p_err, _ = _max_err(bf["lowered"].params, bf["step"].params, rtol=0)
    print(f"[16b] SmolLM-135M bf16 (published), {B} x {S} tokens: the "
          f"first step's loss that of make_train_step; against an fp32 "
          f"step from the same params (lowered / make_train_step): "
          f"gradient norm {r['lowered']['grad_norm']:.3g} / "
          f"{r['step']['grad_norm']:.3g} away (bar "
          f"{BF16_BARS['grad_norm']:g}), a params leaf's change "
          f"{r['lowered']['change']:.3g} / {r['step']['change']:.3g} of its "
          f"L2 norm (bar {BF16_BARS['change']:g} x make_train_step's), a "
          f"moment row {r['lowered']['moment']:.3g} / "
          f"{r['step']['moment']:.3g} of its L2 norm, the worst row's "
          f"ratio {r['moment_ratio']:.3g} (bar {BF16_BARS['moment']:g}, at "
          f"{r['moment_where']}); after {LOWERED_STEPS} steps: loss "
          f"|Δ| by step {[f'{d:.3g}' for d in loss_d]}, params max|Δ| "
          f"{p_err:.3g}; no hand kernel launched", flush=True)
    print(f"[16b] the segment's transpose ran its transposed body's "
          f"equations: {f32['replayed']} replayed a step, no "
          f"torch.autograd", flush=True)
    for dtype, run in runs.items():
        print(f"[16b] walls {dtype}: compile {run['compile_s']:.2f} s; a "
              f"step make_train_step "
              f"{[round(w, 4) for w in run['walls']['step']]} s, lowered "
              f"{[round(w, 4) for w in run['walls']['lowered']]} s; card: "
              f"{smi}", flush=True)


#: phase 16d: the reduced DeepSeek-V3 on the chunked attention route, one
#: sequence of 2,100 tokens (the MTP layer's 2,099 keys: three chunks of
#: 1,024, the last padded)
MTP_BATCH, MTP_SEQ = 1, 2100

#: phase 16e: RWKV-6 1.6B whole and the reduced Jamba, one sequence of
#: 256 tokens each, fp32
RECURRENT_BATCH, RECURRENT_SEQ = 1, 256


def lowered_grads(dev, cfg, batch_size: int, seq: int, phase: str,
                  adjust=None) -> dict:
    """``loss_and_grads`` of ``cfg`` (fp32) on params and one batch from
    seed 0, lowered as the census lowers it (``cdfg.leaves(grad=)``) and
    run by the ``sequential`` backend on the card, against
    ``loss_and_grads`` (autograd) on the same params and batch: loss and
    metrics rtol 1e-4, every gradient leaf rtol 1e-4 + 1e-4·max|g|
    (PERF.md §2); the transposes replaying their transposed bodies'
    equations, none ``torch.autograd``; no hand kernel launched.  Returns
    the readings: the loss and its distance, the worst leaf's share of
    its bar, the equations replayed, the scan equations, the walls and
    the peak GiB.  ``adjust(params)``, when given, sets some of the
    params (in place) before both runs."""
    import torch
    from repro_torch import tree
    from repro_torch.core import cdfg
    from repro_torch.dataflow import compile as dataflow_compile
    from repro_torch.kernels import _lib
    from repro_torch.launch import steps
    from repro_torch.models import layers, model as M

    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           dev)
    if adjust is not None:
        adjust(params)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch_size, seq + 1)).astype(np.int32)).to(
            dev)}
    stacked = M.transformer.stack_repeats(params)

    def value_and_grads(p_leaves, b_leaves):
        (loss, metrics), grads = steps.loss_and_grads(
            tree.unflatten(stacked, list(p_leaves)),
            tree.unflatten(batch, list(b_leaves)), cfg)
        return (loss, *tree.leaves(metrics), *tree.leaves(grads))

    before = dict(_lib.counts())
    t0 = time.perf_counter()
    with cdfg.leaves(index=[(layers, "take")],
                     scan=[(M.transformer, "_segment_forward")],
                     grad=[(steps, "loss_and_grads")]):
        comp = dataflow_compile(value_and_grads, tuple(tree.leaves(stacked)),
                                tuple(tree.leaves(batch)),
                                backend="sequential", device=dev,
                                use_cache=False)
    compile_s = time.perf_counter() - t0
    scans = sum(e.prim == "scan" for e in comp.graph.eqns)
    replayed = transposes_replayed(comp.graph)
    require(replayed > 0, f"{phase} no transposed body replayed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with autograd_calls() as calls:
        out = comp(tuple(tree.leaves(stacked)), tuple(tree.leaves(batch)))
        torch.cuda.synchronize()
    lowered_s = time.perf_counter() - t0
    require(not calls, f"{phase} the lowered step called torch.autograd "
            f"({len(calls)} times)")
    t0 = time.perf_counter()
    (loss, metrics), grads = steps.loss_and_grads(params, batch, cfg)
    torch.cuda.synchronize()
    autograd_s = time.perf_counter() - t0
    require(dict(_lib.counts()) == before, f"{phase} a hand kernel "
            f"launched")
    want = [loss, *tree.leaves(metrics)]
    for name, a, b in zip(["loss", *metrics], out[:len(want)], want):
        require(abs(float(a) - float(b)) <= 1e-4 * abs(float(b)),
                f"{phase} {name}: lowered {float(a)!r}, loss_and_grads "
                f"{float(b)!r}")
    worst = 0.0
    for (path, g), w in zip(tree.flatten_with_paths(tree.unflatten(
            stacked, list(out[len(want):]))), tree.leaves(
            M.transformer.stack_repeats(grads)), strict=True):
        tol = 1e-4 * float(w.abs().max()) + 1e-4 * w.abs()
        ratio = float(((g - w).abs() / tol.clamp_min(1e-30)).max())
        require(ratio <= 1.0, f"{phase} grad {path}: {ratio:.3g} times "
                f"the bar rtol 1e-4 + 1e-4·max|g|")
        worst = max(worst, ratio)
    return dict(loss=float(out[0]), rel=abs(float(out[0]) - float(loss))
                / abs(float(loss)), worst=worst, leaves=len(out) - len(want),
                replayed=replayed, scans=scans, compile_s=compile_s,
                lowered_s=lowered_s, autograd_s=autograd_s,
                peak=torch.cuda.max_memory_allocated(dev) / 2**30,
                params=sum(t.numel() for t in tree.leaves(params)))


def lowered_mtp_grads_on_card(dev, smi: str) -> None:
    """Phase 16d: the reduced DeepSeek-V3 (fp32, ``attn_impl="chunked"``)
    whose ``loss_and_grads`` is lowered as the census lowers it — the MTP
    layer inline, its chunked attention one ``scan`` partially evaluated
    and one reverse ``scan`` — and run by the ``sequential`` backend on
    the card, against ``loss_and_grads`` (:func:`lowered_grads`)."""
    import dataclasses

    from repro_torch.configs import load_config, reduced

    cfg = dataclasses.replace(reduced(load_config("deepseek-v3-671b")),
                              attn_impl="chunked")
    r = lowered_grads(dev, cfg, MTP_BATCH, MTP_SEQ, "16d")
    require(r["scans"] == 3 * len(cfg.segments) + 2,
            f"16d {r['scans']} scan equations, not each segment's three "
            f"(its hoisted mask scan, forward, reverse) and the MTP "
            f"attention's two")
    print(f"[16d] card: {smi}; reduced DeepSeek-V3 fp32, {MTP_BATCH} x "
          f"{MTP_SEQ} tokens on the chunked route (the MTP layer's "
          f"attention one forward and one reverse scan): "
          f"{_lowered_line(r)}", flush=True)


def _lowered_line(r: dict) -> str:
    """What :func:`lowered_grads` read, as one line."""
    return (f"loss {r['loss']:.6f}, {r['rel']:.3g} from loss_and_grads' "
            f"(bar 1e-4), {r['leaves']} gradient leaves within rtol 1e-4 + "
            f"1e-4·max|g| (worst {r['worst']:.3g} of the bar); the "
            f"transposes replayed {r['replayed']} equations of their "
            f"transposed bodies, no torch.autograd; no hand kernel "
            f"launched; compile {r['compile_s']:.2f} s, the lowered value "
            f"and gradients {r['lowered_s']:.2f} s, loss_and_grads "
            f"{r['autograd_s']:.2f} s; peak {r['peak']:.2f} GiB allocated")


#: Mamba's initial step ``dt`` (its ``dt_bias`` the inverse softplus of
#: it) in the 16e model with the chunked scan: with the reference's
#: ``dt_bias`` of 0 (a step of ~0.69), ``exp(cum_i − cum_j)`` over a
#: chunk of 16 overflows in the masked upper triangle, and the gradient
#: there, 0·inf, is NaN in JAX and autograd alike
MAMBA_DT = 0.01


def mamba_dt_bias(params) -> None:
    """Every Mamba mixer's ``dt_bias`` set to the inverse softplus of
    :data:`MAMBA_DT` (Mamba's own initial step), in place."""
    for seg in (v for k, v in params.items() if k.startswith("segment_")):
        for rep in seg:
            for layer in rep:
                if "A_log" in layer["mixer"]:
                    layer["mixer"]["dt_bias"].fill_(
                        math.log(math.expm1(MAMBA_DT)))


def mamba_layer_model(cfg):
    """``cfg`` (Jamba-1.5-Large's) cut to one layer: its Mamba mixer and a
    dense MLP at full width, the body of a one-repeat segment, the Mamba
    scan the chunked one (chunk 16)."""
    import dataclasses

    from repro_torch.configs.base import LayerSpec, Segment
    return dataclasses.replace(
        cfg, num_layers=1, segments=(Segment(unit=(
            LayerSpec(mixer="mamba", mlp="dense"),), repeats=1),),
        ssm=dataclasses.replace(cfg.ssm, scan_impl="chunked", chunk=16))


def lowered_recurrent_grads_on_card(dev, smi: str) -> None:
    """Phase 16e: RWKV-6 1.6B whole at published widths (24 layers, 32
    heads of 64), the reduced Jamba (Mamba, attention and MoE in one
    unit), SmolLM-135M whole under remat and one Jamba-1.5-Large Mamba
    layer at full width with the chunked scan (:func:`mamba_layer_model`),
    fp32, one sequence of 256 tokens each: ``loss_and_grads`` lowered as
    the census lowers it — the WKV recurrence and the Mamba selective or
    chunk scans each a scan nested in the segment's, partially evaluated
    as JAX does, and their transposed scans nested in the segment's
    reverse scan; under remat the reverse scan's body one ``remat2``
    equation recomputing the repeat — and run by the ``sequential``
    backend on the card, against ``loss_and_grads``
    (:func:`lowered_grads`)."""
    import dataclasses

    from repro_torch.configs import load_config, reduced

    for name, cfg, adjust in (
            ("RWKV-6 1.6B whole", load_config("rwkv6-1.6b"), None),
            ("reduced Jamba", reduced(load_config("jamba-1.5-large-398b")),
             None),
            ("SmolLM-135M whole under remat",
             train_config("smollm-135m+remat"), None),
            (f"one Jamba-1.5-Large Mamba layer, chunked scan (dt_bias "
             f"for dt {MAMBA_DT})",
             mamba_layer_model(load_config("jamba-1.5-large-398b")),
             mamba_dt_bias)):
        cfg = dataclasses.replace(cfg, dtype="float32")
        r = lowered_grads(dev, cfg, RECURRENT_BATCH, RECURRENT_SEQ, "16e",
                          adjust)
        print(f"[16e] {name} fp32 ({r['params']:,} params, "
              f"{cfg.num_layers} layers, d_model {cfg.d_model}), "
              f"{RECURRENT_BATCH} x {RECURRENT_SEQ} tokens: "
              f"{_lowered_line(r)}; card: {smi}", flush=True)


def dryrun_cli_train_cell(smi: str) -> None:
    """Phase 16c: the dry run's CLI on SmolLM-135M's ``train_4k`` cell on
    the 16x16 fake world (device type ``cuda``): exit 0, the record's
    ``dataflow`` the phase 16a census."""
    out = os.path.join(ROOT, "build", "dryrun_16c")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "train_4k", "--mesh", "single", "--out",
         out], cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"16c the CLI exited {proc.returncode}: "
            f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    with open(os.path.join(out, "smollm-135m__train_4k__16x16.json")) as f:
        rec = json.load(f)
    census = rec.get("dataflow")
    require(rec["status"] == "ok"
            and census == REF_TRAIN_CENSUS["smollm-135m"],
            f"16c the record: {rec.get('status')} {census}")
    print(f"[16c] python -m repro_torch.launch.dryrun --arch smollm-135m "
          f"--shape train_4k --mesh single: exit 0, record ok with dataflow "
          f"{census}, trace {rec['trace_s']:.2f} s, cell "
          f"{rec['total_s']:.1f} s, CLI wall {wall:.2f} s; card: {smi}",
          flush=True)


if __name__ == "__main__":
    main()
