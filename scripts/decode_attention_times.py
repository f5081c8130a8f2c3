#!/usr/bin/env python3
"""Times of the port's ``decode_attention`` kernel on one NVIDIA GPU, for one
tree of the port, so that two trees can be compared on one card.

    python3 scripts/decode_attention_times.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default; an unpacked older commit's to compare).  Run the
trees in turns in one session (A, B, B, A): cards and power limits differ
between machines.  Prints one JSON line:

* ``kernel_ms``: the bf16 kernel on q (8, 9, 64) against (8, 3, 552, 64)
  caches at length 513 (``chip_smoke.py`` phase 5's inputs), median of 20
  replays of a CUDA graph of 10 calls (its cache warm in the L2);
* ``step_ms``: the summed spans of the ``decode_kernel`` launches in one
  traced decode step of SmolLM-135M (bf16, random weights from seed 0,
  8 prompts of 512 tokens, ``attn_impl="pallas"``), from
  ``torch.profiler`` — 30 layers' caches exceed the L2, so each launch
  finds its cache cold — and ``step_busy_ms``, the step's device busy
  time;
* ``card``: ``nvidia-smi``'s name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, HQ, HKV, S, D, LENGTH = 8, 9, 3, 552, 64, 513
PROMPT_LEN, KERNEL = 512, "decode_kernel"


def graph_ms(fn, reps: int = 20, per_graph: int = 10) -> float:
    """Median device time of one call of ``fn`` in ms, from replays of a
    CUDA graph of ``per_graph`` calls (the host's enqueue time left out)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
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
    return statistics.median(times)


def traced_ms(fn) -> tuple[float, float]:
    """(ms of the ``KERNEL`` spans, device busy ms) of one call of ``fn``
    under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", "decode_attention_times_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "dur" in e]
    named = sum(e["dur"] for e in events if e.get("cat") == "kernel"
                and KERNEL in e.get("name", ""))
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return named / 1e3, busy / 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch is timed")
    src = os.path.abspath(ap.parse_args().src)
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import repro_torch
    from repro_torch.configs import load_config
    from repro_torch.kernels.flash_attention import decode_attention
    from repro_torch.models import decode_step, init_params, prefill

    dev = torch.device("cuda")
    repro_torch.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    q, kc, vc = randn(B, HQ, D), randn(B, HKV, S, D), randn(B, HKV, S, D)
    lengths = torch.full((B,), LENGTH, dtype=torch.int32, device=dev)
    kernel_ms = graph_ms(lambda: decode_attention(q, kc, vc, lengths))

    cfg = dataclasses.replace(load_config("smollm-135m"), attn_impl="pallas")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, PROMPT_LEN)).astype(np.int32)
    tokens = torch.from_numpy(prompts).to(dev)
    with torch.inference_mode():
        logits, cache = prefill(params, tokens, cfg, S)

        def step():
            decode_step(params, logits.argmax(-1), cache, PROMPT_LEN, cfg)
        step()                                  # warm-up
        step_ms, busy_ms = traced_ms(step)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": os.path.relpath(src, ROOT),
                      "kernel_ms": kernel_ms,
                      "step_ms": step_ms, "step_busy_ms": busy_ms,
                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
