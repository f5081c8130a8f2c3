#!/usr/bin/env python3
"""Peak memory and step time of the port's train step on one NVIDIA GPU,
with AdamW on the stacked layout and on the per-repeat one, for one tree
of the port, so that two trees can be compared on one card.

    python3 scripts/train_memory.py [--src DIR] [--arch ARCH]

``--src`` names the ``src`` directory whose ``repro_torch`` is measured
(this checkout's by default; an unpacked older commit's to compare).
``launch/steps.make_train_step`` stacks each segment's repeats (one
tensor a unit path: params, grads and both moments copied) before
``optim/adamw.apply_updates`` and unstacks after, so that a segment's
update costs a few launches a unit path rather than a repeat.  This
script runs that step (``make_train_step``) and the same step with
``apply_updates`` on the per-repeat tree as it is (``per_repeat``), in
turns (``make_train_step``, ``per_repeat``, ``per_repeat``,
``make_train_step``); in a tree older than the stacking both are its
``_foreach_*`` update.  The model is ``ARCH`` (default
``olmo-1b``) at full width and depth in bf16, random weights from seed
0, 4 steps of 2 sequences of 512 random tokens from step 200 (past the
warmup).  Prints one JSON line:

* ``state_gib``: params and moments, GiB;
* ``runs``: for each turn, the layout, the peak of
  ``torch.cuda.max_memory_allocated`` over its steps above what was
  allocated before them (GiB), and each step's milliseconds on the host
  clock (the card synchronised);
* ``card``: ``nvidia-smi``'s name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, START, STEPS = 2, 512, 200, 4


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch is measured")
    ap.add_argument("--arch", default="olmo-1b")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import repro_torch
    from repro_torch import tree
    from repro_torch.configs import load_config
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import warmup_cosine

    dev = torch.device("cuda")
    repro_torch.set_device(dev)
    cfg = load_config(args.arch)
    opt_cfg = adamw.AdamWConfig()
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)).to(dev)}
        for _ in range(STEPS)]
    train_step = steps.make_train_step(cfg, opt_cfg)

    def per_repeat(state, batch):
        (_, metrics), grads = steps.loss_and_grads(state.params, batch, cfg)
        lr_scale = warmup_cosine(state.step, warmup_steps=200,
                                 total_steps=10_000)
        params, opt, info = adamw.apply_updates(state.params, grads,
                                                state.opt, opt_cfg, lr_scale)
        metrics.update(info)
        return steps.TrainState(params, opt, state.step + 1), metrics

    def fresh():
        params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             dev)
        return steps.TrainState(params, adamw.init_opt_state(params, opt_cfg),
                                torch.tensor(START, dtype=torch.int32,
                                             device=dev))

    state = fresh()
    state_b = sum(t.numel() * t.element_size() for t in
                  tree.leaves((state.params, state.opt)))
    del state
    runs = []
    for name in ("make_train_step", "per_repeat", "per_repeat",
                 "make_train_step"):
        step = train_step if name == "make_train_step" else per_repeat
        state = fresh()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
        runs.append({"layout": name,
                     "peak_gib": (torch.cuda.max_memory_allocated() - base)
                     / 2**30,
                     "step_ms": ms, "loss": losses})
        del state, metrics
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"src": args.src, "arch": args.arch, "tokens": [B, S],
                      "state_gib": state_b / 2**30, "runs": runs,
                      "card": card}))


if __name__ == "__main__":
    main()
