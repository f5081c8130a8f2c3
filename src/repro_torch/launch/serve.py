"""LM serving demo: batched prefill that builds the KV cache, then greedy
decode in lockstep — the port of the reference's ``launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m

serves random-weight SmolLM-135M at full width on the CUDA card, with
every attention call on the hand-written kernels (``attn_impl="pallas"``).
``--reduced`` shrinks the model as the reference's tests do, and
``--device cpu`` runs on the CPU through the kernels' plain versions.

The demo is the template end to end: prefill is the burst-access stage,
the KV cache is the customized memory partition, and decode steps stream
it back.  The decode-step dataflow report and the resolution daemon's
subcommands (``daemon``, ``stats``, ``shutdown``) are not ported yet and
raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

_REPORT_LATER = ("the decode-step dataflow report needs torch.fx lowering "
                 "rules for the transformer step (ROADMAP: \"The "
                 "decode-step dataflow report\")")
_DAEMON_LATER = ("the resolution daemon is the serving-tier slice "
                 "(ROADMAP: \"core/chunkgraph.py and the serving tier\")")


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int


@dataclasses.dataclass
class Result:
    id: int
    tokens: list
    prefill_s: float
    decode_s: float             # per generated token


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BatchedServer:
    """Static-batch server: groups requests, prefills once, decodes in
    lockstep.  Runs on the device that holds ``params``.  ``greedy`` is
    the reference's flag: both of its settings take the argmax there, and
    so here."""

    def __init__(self, cfg, params, *, max_len: int = 256,
                 greedy: bool = True):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.greedy = greedy
        self.device = params["embed"]["table"].device

    def dataflow_report(self, requests: list[Request]) -> str:
        raise NotImplementedError(_REPORT_LATER)

    @torch.inference_mode()
    def serve(self, requests: list[Request]) -> list[Result]:
        from ..models import decode_step, prefill
        B = len(requests)
        S = max(len(r.prompt) for r in requests)
        # left-align prompts; pad right with zeros (masked by position)
        prompts = np.zeros((B, S), np.int32)
        for i, r in enumerate(requests):
            prompts[i, :len(r.prompt)] = r.prompt
        t0 = time.perf_counter()
        logits, cache = prefill(self.params,
                                torch.from_numpy(prompts).to(self.device),
                                self.cfg, self.max_len)
        _sync(self.device)
        prefill_s = time.perf_counter() - t0

        gen = max(r.max_new_tokens for r in requests)
        tokens = []
        tok = logits.argmax(-1)
        t1 = time.perf_counter()
        for step in range(gen):
            tokens.append(tok)
            logits, cache = decode_step(self.params, tok, cache, S + step,
                                        self.cfg)
            tok = logits.argmax(-1)
        _sync(self.device)
        decode_s = time.perf_counter() - t1

        seq = torch.stack(tokens, 1).cpu().numpy()  # (B, gen)
        return [Result(r.id, seq[i, :r.max_new_tokens].tolist(), prefill_s,
                       decode_s / gen) for i, r in enumerate(requests)]


def _demo_main(argv: list[str]) -> None:
    from .._device import get_device
    from ..configs.base import load_config, reduced as reduce_config
    from ..models import init_params

    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    cfg = load_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    device = get_device(args.device)
    rng = np.random.default_rng(0)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device)
    server = BatchedServer(cfg, params,
                           max_len=args.prompt_len + args.gen + 8)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    size=(args.prompt_len,)).astype(np.int32),
                    args.gen)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    results = server.serve(reqs)
    dt = time.perf_counter() - t0
    tok_total = sum(len(r.tokens) for r in results)
    print(f"served {len(results)} requests, {tok_total} tokens on {device} "
          f"in {dt:.2f}s ({tok_total / dt:.1f} tok/s); "
          f"prefill {results[0].prefill_s:.3f}s, "
          f"decode {results[0].decode_s * 1e3:.1f} ms/tok")
    for r in results[:2]:
        print(f"  req {r.id}: {r.tokens[:8]}...")


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("daemon", "stats", "shutdown"):
        raise NotImplementedError(f"{argv[0]}: {_DAEMON_LATER}")
    _demo_main(argv)


if __name__ == "__main__":
    main()
