#!/usr/bin/env python3
"""Decode time of the port's server on one NVIDIA GPU, for one tree of the
port, so that two trees can be compared on one card.

    python3 scripts/serve_times.py [--src DIR] [--arch ARCH]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default; an unpacked older commit's to compare).  Run the
trees in turns on one machine (A, B, B, A): host clocks differ between
machines.  The model is ``ARCH`` (default ``smollm-135m``, the model of
``chip_smoke.py`` phase 6b) at full width in bf16 with random weights
from seed 0 and ``attn_impl="pallas"``, serving ``chip_smoke.py``'s
traffic: 8 prompts of 512 tokens, 32 new tokens each, ``max_len`` 552.
Prints one JSON line:

* ``decode_ms``: ``BatchedServer.serve``'s decode milliseconds a step on
  the host clock, for each of 3 served batches after a warm-up;
* ``decode_ms_after_report``: the same after one ``dataflow_report`` of
  the batch, so that the report's effect on serving shows in one
  process; ``null`` for a tree whose ``dataflow_report`` raises
  ``NotImplementedError`` (a tree older than the report, timed only as
  the other side of an A/B);
* ``card``: ``nvidia-smi``'s name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, PROMPT_LEN, GEN = 8, 512, 32


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--arch", default="smollm-135m")
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import repro_torch
    from repro_torch.configs import load_config
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import init_params

    dev = torch.device("cuda")
    repro_torch.set_device(dev)
    cfg = dataclasses.replace(load_config(args.arch), attn_impl="pallas")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, PROMPT_LEN)).astype(np.int32)
    reqs = [Request(i, prompts[i], GEN) for i in range(B)]
    server = BatchedServer(cfg, params, max_len=PROMPT_LEN + GEN + 8)
    server.serve(reqs)                          # warm-up

    def decode_ms() -> list[float]:
        return [server.serve(reqs)[0].decode_s * 1e3 for _ in range(3)]

    before = decode_ms()
    after = None
    try:
        report = server.dataflow_report(reqs)
    except NotImplementedError:
        report = None
    if report is not None:
        after = decode_ms()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": os.path.relpath(src, ROOT), "arch": args.arch,
                      "decode_ms": before, "decode_ms_after_report": after,
                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
