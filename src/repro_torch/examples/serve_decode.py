"""Batched serving example: prefill + decode with KV cache, int8 option.

Run:  ``python -m repro_torch.examples.serve_decode [--device cpu]``

Shows the serving path end to end on a reduced Qwen2.5 config: batched
prefill builds the cache, decode streams tokens; the int8 KV-cache
feature is toggled to show the greedy outputs at half the cache bytes.
On the card every attention call takes the hand-written kernels
(``attn_impl="pallas"``; the int8 cache decodes through the plain
chunked path, as in the reference).  The weights are random, drawn from
a seeded ``torch.Generator``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import _device
from ..configs import load_config, reduced
from ..launch.serve import BatchedServer, Request
from ..models import init_params


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "repro_torch.examples.serve_decode")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    dev = _device.get_device(ap.parse_args(argv).device)
    _device.set_device(dev)
    cfg = dataclasses.replace(
        reduced(load_config("qwen2.5-14b"), max_repeats=2),
        attn_impl="pallas")
    rng = np.random.default_rng(0)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)

    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=(12,))
                    .astype(np.int32), 16) for i in range(4)]

    out = {}
    for kv_dtype in ("bf16", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
        server = BatchedServer(c, params, max_len=64)
        t0 = time.perf_counter()
        results = server.serve(reqs)
        dt = time.perf_counter() - t0
        toks = sum(len(r.tokens) for r in results)
        print(f"kv={kv_dtype:5s}: {toks} tokens in {dt:.2f}s "
              f"({toks / dt:.1f} tok/s) "
              f"first request: {results[0].tokens[:6]}")
        out[kv_dtype] = [r.tokens for r in results]
    return out


if __name__ == "__main__":
    main()
