#!/usr/bin/env python3
"""Digests of the recurrent models' serving outputs on one NVIDIA GPU, for
one tree of the port, so that two trees can be compared bit for bit on
one card.

    python3 scripts/ssm_serving_digest.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` runs (this
checkout's by default; an unpacked older commit's to compare).  The
models and inputs are those of ``chip_smoke.py`` phases 6e and 6f, from
seed 0: RWKV-6 1.6B whole at published widths, 8 prompts of 512 tokens,
in fp32 and in bf16, a prefill and 32 greedy decode steps each; one
Jamba-1.5-Large Mamba layer at full width in fp32, ``mamba_apply`` with
the sequential scan over 544 positions and over the first 512, then 32
``mamba_decode`` steps.  Prints one JSON line: the SHA-256 of each
output's bytes (RWKV-6's prefill logits, its greedy tokens and every
decode step's logits, by dtype; the Mamba layer's outputs and final
state), three prefill walls by dtype (host clock, after one warm-up
prefill) and ``nvidia-smi``'s name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, PROMPT_LEN, GEN = 8, 512, 32
MAX_LEN = PROMPT_LEN + GEN + 8
PREFILLS = 3


def _digest(*tensors) -> str:
    import torch
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch runs")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import load_config
    from repro_torch.models import decode_step, init_params, prefill, ssm
    dev = torch.device("cuda")
    out: dict = {"src": os.path.abspath(args.src)}

    cfg = load_config("rwkv6-1.6b")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, PROMPT_LEN)).astype(np.int32)).to(dev)
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = init_params(torch.Generator(device=dev).manual_seed(0), c,
                             dev)
        with torch.inference_mode():
            prefill(params, tokens, c, MAX_LEN)              # warm-up
            walls = []
            for _ in range(PREFILLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = prefill(params, tokens, c, MAX_LEN)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            out[f"rwkv_{dtype}_prefill_s"] = walls
            first = logits
            steps, toks = [], []
            for i in range(GEN):
                tok = logits.argmax(-1).to(torch.int32)
                toks.append(tok)
                logits, cache = decode_step(params, tok, cache,
                                            PROMPT_LEN + i, c)
                steps.append(logits)
        out[f"rwkv_{dtype}_prefill_logits"] = _digest(first)
        out[f"rwkv_{dtype}_tokens"] = _digest(torch.stack(toks))
        out[f"rwkv_{dtype}_decode_logits"] = _digest(*steps)
        del params, cache, logits, first, steps
        torch.cuda.empty_cache()

    cfg = dataclasses.replace(load_config("jamba-1.5-large-398b"),
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = ssm.mamba_init(gen, cfg, dev)
    x = torch.randn((B, PROMPT_LEN + GEN, cfg.d_model), generator=gen,
                    device=dev)
    with torch.inference_mode():
        whole = ssm.mamba_apply(p, x, cfg)
        head, cache = ssm.mamba_apply(p, x[:, :PROMPT_LEN], cfg,
                                      return_cache=True)
        ys = []
        for i in range(GEN):
            y, cache = ssm.mamba_decode(p, x[:, PROMPT_LEN + i:PROMPT_LEN
                                             + i + 1], cache, cfg)
            ys.append(y)
    out["mamba_apply"] = _digest(whole)
    out["mamba_prefill_and_cache"] = _digest(head, cache["h"],
                                             cache["conv"])
    out["mamba_decode"] = _digest(*ys, cache["h"])
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
