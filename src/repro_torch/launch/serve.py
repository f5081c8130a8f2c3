"""LM serving demo: batched prefill that builds the KV cache, then greedy
decode in lockstep — the port of the reference's ``launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m

serves a random-weight model of any of the ten architectures
(``configs.ARCH_IDS``) at full width on the CUDA card, with every GQA
attention call on the hand-written kernels (``attn_impl="pallas"``).
``--reduced`` shrinks the model as the reference's tests do, and
``--device cpu`` runs on the CPU through the kernels' plain versions.
The largest models need more than one card at full depth (ROADMAP).

The demo is the template end to end: prefill is the burst-access stage,
the KV cache is the customized memory partition, and decode steps stream
it back.  ``BatchedServer.dataflow_report`` gives the Algorithm-1
stage/channel analysis of the decode step at a batch's shape, traced on
``meta`` tensors (no weights are read, no kernel is launched).

The resolution daemon's control commands::

    python -m repro_torch.launch.serve daemon [--store-dir D] [--device cpu]
    python -m repro_torch.launch.serve stats
    python -m repro_torch.launch.serve shutdown

``daemon`` serves the resolution store in the foreground; its workers run
on its device (``--device``, default the card) and engine
(``$REPRO_TORCH_ENGINE``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time
from typing import Any

import numpy as np
import torch

log = logging.getLogger("repro_torch.serve")


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
        """Stage/channel report of the decode step for this batch shape
        (the reference's: the step at length 8 of a ``max_len`` cache).
        Never raises: a failed analysis returns ``"(dataflow analysis
        unavailable: <type>: <message>)"``."""
        try:
            return decode_report(self.cfg, self.params, len(requests),
                                 self.max_len)
        except Exception as e:  # noqa: BLE001 — the report is best-effort
            return f"(dataflow analysis unavailable: {type(e).__name__}: {e})"

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


# ---------------------------------------------------------------------------
# The decode step's dataflow report
# ---------------------------------------------------------------------------

def _sorted_paths(tree: Any, prefix: tuple = ()) -> list[tuple]:
    """Leaf paths in the order ``jax`` flattens a tree: dict keys sorted,
    sequence items in order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _sorted_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _sorted_paths(v, prefix + (i,))]
    return [prefix]


def reference_order(tree: dict) -> list[tuple]:
    """The leaf paths of a port's params or cache tree in the order of
    the reference's leaves.  The reference stacks a segment's repeats on
    a leading axis, so under ``segment_<i>`` (``[repeat][unit]`` here)
    its order is unit, then the layer's sorted paths, then repeat."""
    out = []
    for key in sorted(tree):
        sub = tree[key]
        if not key.startswith("segment_"):
            out += [(key,) + p for p in _sorted_paths(sub)]
            continue
        for j in range(len(sub[0])):
            out += [(key, r, j) + p for p in _sorted_paths(sub[0][j])
                    for r in range(len(sub))]
    return out


def _at(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def decode_step_leaves():
    """The block in which ``torch.fx`` traces ``decode_step`` as the
    reference's jaxpr: the embedding's wrap-then-clamp read is the one
    node ``x[idx]``, and each segment's loop over its repeats one
    ``scan`` equation (:func:`repro_torch.core.cdfg.leaves`)."""
    from ..core import cdfg
    from ..models import layers, transformer
    return cdfg.leaves(index=[(layers, "take")],
                       scan=[(transformer, "_segment_decode")])


def decode_report(cfg, params: dict, batch: int, max_len: int) -> str:
    """The dataflow report of ``decode_step`` at ``batch`` sequences of a
    ``max_len`` cache holding 8 tokens (the reference's step)
    (:func:`decode_compiled`)."""
    return decode_compiled(cfg, params, batch, max_len).report()


def decode_compiled(cfg, params: dict, batch: int, max_len: int):
    """``decode_step`` at ``batch`` sequences of a ``max_len`` cache
    holding 8 tokens, compiled by the dataflow driver for ``meta``
    tensors: shapes and dtypes of ``params`` only (on any device, or
    ``meta`` from ``init_params(None, cfg, "meta")``).  The graph's
    inputs are the parameter leaves, the token and the cache leaves,
    each tree's leaves in :func:`reference_order`, so region names are
    the reference's; each segment is one ``scan`` equation
    (:func:`decode_step_leaves`)."""
    from .. import tree
    from ..dataflow import compile as dataflow_compile
    from ..models import decode_step, init_cache
    if batch < 1:
        raise ValueError(f"a decode step needs at least one sequence, "
                         f"got a batch of {batch}")
    meta = tree.tree_map(lambda t: t.to("meta"), params)
    cache = init_cache(cfg, batch, max_len, "meta")
    p_order, c_order = reference_order(meta), reference_order(cache)
    p_paths = [p for p, _ in tree.flatten_with_paths(meta)]
    c_paths = [p for p, _ in tree.flatten_with_paths(cache)]

    def step(p_leaves, token, c_leaves):
        p = dict(zip(p_order, p_leaves))
        c = dict(zip(c_order, c_leaves))
        return decode_step(tree.unflatten(meta, [p[k] for k in p_paths]),
                           token,
                           tree.unflatten(cache, [c[k] for k in c_paths]),
                           8, cfg)

    with decode_step_leaves():
        compiled = dataflow_compile(
            step, tuple(_at(meta, k) for k in p_order),
            torch.zeros(batch, dtype=torch.int32, device="meta"),
            tuple(_at(cache, k) for k in c_order),
            backend="eager", device="meta", use_cache=False)
    return compiled


# ---------------------------------------------------------------------------
# Resolution daemon CLI
# ---------------------------------------------------------------------------

def _serve_cli(argv: list[str]) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="resolution daemon control")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("daemon", help="run the resolution daemon in "
                                      "the foreground")
    d.add_argument("--socket", default=None,
                   help="AF_UNIX path or host:port (default: the "
                        "store's canonical socket)")
    d.add_argument("--workers", type=int, default=None,
                   help="pool width (default: cores - 1, min 2)")
    d.add_argument("--store-dir", default=None,
                   help="rescache store directory to serve")
    d.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu': the device of the "
                        "daemon and its workers")
    d.add_argument("--max-queued-chunks", type=int, default=4096,
                   help="global admission cap on queued chunks")
    d.add_argument("--max-client-chunks", type=int, default=4096,
                   help="per-client outstanding-chunks budget")
    d.add_argument("--retry-budget", type=int, default=None,
                   help="chunk re-dispatches tolerated per job after "
                        "worker deaths")
    d.add_argument("--throttle", type=float, default=0.0,
                   help="seconds to sleep before each chunk dispatch "
                        "(test/debug knob)")
    d.add_argument("--no-journal", action="store_true",
                   help="disable the append-only journal (stats reset "
                        "on restart; in-flight jobs are not resumed)")
    d.add_argument("--speculate-after", type=float, default=None,
                   help="floor seconds before a straggling chunk earns "
                        "a speculative duplicate dispatch (0 disables; "
                        "default REPRO_SPECULATE_AFTER_S or 30)")
    d.add_argument("--speculate-factor", type=float, default=4.0,
                   help="chunk is a straggler past this multiple of "
                        "the observed median chunk wall")
    for name in ("stats", "shutdown"):
        sp = sub.add_parser(name)
        sp.add_argument("--socket", default=None)
    args = p.parse_args(argv)
    if args.cmd == "daemon":
        from .._device import get_device, set_device
        from ..core import rescache
        from ..serve import ResolutionDaemon
        set_device(get_device(args.device))
        if args.store_dir:
            rescache.configure(enabled=True, directory=args.store_dir)
        daemon = ResolutionDaemon(
            address=args.socket, workers=args.workers,
            max_queued_chunks=args.max_queued_chunks,
            max_client_chunks=args.max_client_chunks,
            retry_budget=args.retry_budget, throttle_s=args.throttle,
            journal=not args.no_journal,
            speculate_after_s=args.speculate_after,
            speculate_factor=args.speculate_factor)
        log.info("resolution daemon at %s (%d workers, store %s)",
                 daemon.address, daemon.workers, daemon.store_dir)
        daemon.serve_forever()
        return 0
    if args.cmd == "stats":
        from ..serve import ServeUnavailable, get_stats
        try:
            print(json.dumps(get_stats(args.socket), indent=2,
                             sort_keys=True))
        except ServeUnavailable as e:
            print(str(e), file=sys.stderr)
            return 1
        return 0
    from ..serve import shutdown
    ok = shutdown(args.socket)
    print("daemon stopped" if ok else "no daemon answered")
    return 0 if ok else 1


def _demo_main(argv: list[str]) -> None:
    from .._device import get_device
    from ..configs.base import load_config, reduced as reduce_config
    from ..models import init_params

    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    p.add_argument("--arch", required=True,
                   help="one of configs.ARCH_IDS, e.g. qwen2.5-14b")
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
        logging.basicConfig(level=logging.INFO)
        raise SystemExit(_serve_cli(argv))
    _demo_main(argv)


if __name__ == "__main__":
    main()
