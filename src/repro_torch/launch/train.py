"""Training entry point: config-driven, checkpointed, fault-tolerant.

The port of the reference's ``launch/train.py``.  Usage (CPU-scale
example — the quickstart):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch smollm-135m --reduced --steps 50 --batch 8 --seq 64 \\
        --device cpu --ckpt-dir /tmp/run0

Without ``--device cpu`` it trains on the CUDA card (and raises where
there is none); drop ``--reduced`` for the published widths.
Auto-resumes from the newest checkpoint in ``--ckpt-dir``; the data
pipeline is deterministic in the step index, so a resumed run consumes
exactly the batches it would have seen uninterrupted.  Training runs no
hand-written kernel: the configs train with ``attn_impl="auto"`` as the
reference's do, and the kernels have no backward (a kernel under
autograd raises).
"""

from __future__ import annotations

import argparse
import logging
import time

import torch

from .._device import get_device
from ..checkpoint.checkpointer import Checkpointer
from ..configs.base import load_config, reduced as reduce_config
from ..data.pipeline import DataConfig, prefetched, synthetic_stream
from ..models import init_params
from ..optim import adamw
from ..runtime.fault_tolerance import StepFailure, StragglerPolicy
from .steps import TrainState, make_train_step

log = logging.getLogger("repro_torch.train")


def train_loop(cfg, *, steps: int, batch_size: int, seq_len: int,
               ckpt_dir: str | None = None, ckpt_every: int = 20,
               lr: float = 3e-4, seed: int = 0,
               fail_at: int | None = None,
               schedule_steps: int | None = None,
               log_every: int = 10,
               device: str | torch.device | None = None) -> dict:
    """Returns the final metrics dict: the loss history, failures,
    restores, straggler reuse, the final loss and state, and each step's
    host seconds (``step_s``, the step and its loss read back; after a
    restore, the replayed steps').

    ``schedule_steps``: total LR-schedule horizon; pass the final target
    when training in restartable chunks so a resumed run sees the same
    schedule as an uninterrupted one.  ``device``: where the model trains
    (default: the port's device policy, the card).
    """
    dev = get_device(device)
    horizon = schedule_steps or steps
    opt_cfg = adamw.AdamWConfig(lr=lr)
    step_fn = make_train_step(cfg, opt_cfg, total_steps=horizon,
                              warmup_steps=max(1, horizon // 20))

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         dev)
    state = TrainState(params, adamw.init_opt_state(params, opt_cfg),
                       torch.zeros((), dtype=torch.int32, device=dev))
    if ckpt is not None and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(state)
        log.info("resumed from step %d", start_step)

    dcfg = DataConfig(batch_size=batch_size, seq_len=seq_len,
                      vocab_size=cfg.vocab_size, seed=seed)

    def make_source(at_step: int):
        return prefetched(synthetic_stream(dcfg, start_step=at_step),
                          depth=dcfg.prefetch_depth, device=dev)

    source = make_source(start_step)
    straggler = StragglerPolicy()

    losses: list[float] = []
    step_s: list[float] = []
    failures = restores = 0
    injected = set()
    t0 = time.time()
    step = start_step
    while step < steps:
        t_step = time.perf_counter()
        try:
            if (fail_at is not None and step == fail_at
                    and step not in injected):
                injected.add(step)
                raise StepFailure(f"injected failure at step {step}")
            batch = straggler.next_batch(source)
            state, metrics = step_fn(state, {"tokens": batch["tokens"]})
        except NotImplementedError:
            raise   # a step that cannot run is no failure to recover from
        except (StepFailure, RuntimeError) as e:
            # Recovery = restore state AND rewind the loop + data stream to
            # the checkpoint step; the deterministic pipeline then replays
            # exactly the batches an uninterrupted run would have seen.
            failures += 1
            if ckpt is not None:
                # a checkpoint still being written counts: wait for it
                # before asking for the latest one
                ckpt.wait()
            if ckpt is None or ckpt.latest_step() is None:
                raise
            log.warning("step %d failed (%s); restoring", step, e)
            state, at = ckpt.restore(state)
            restores += 1
            del losses[at - start_step:]
            del step_s[at - start_step:]
            step = at
            source = make_source(at)
            continue
        loss = float(metrics["loss"])
        losses.append(loss)
        step_s.append(time.perf_counter() - t_step)
        if step % log_every == 0 or step == steps - 1:
            log.info("step %4d loss %.4f (%.2f s/step)", step, loss,
                     (time.time() - t0) / max(1, step - start_step + 1))
        step += 1
        if ckpt is not None and step % ckpt_every == 0:
            ckpt.save(step, state)
    if ckpt is not None:
        ckpt.save(steps, state, blocking=True)
    return {
        "losses": losses,
        "failures": failures,
        "restores": restores,
        "straggler_reuse": straggler.reused,
        "final_loss": losses[-1] if losses else None,
        "state": state,
        "step_s": step_s,
    }


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true",
                   help="shrink to CPU-smoke size (keeps structure)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--fail-at", type=int, default=None,
                   help="inject a failure at this step (FT demo)")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    cfg = load_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    out = train_loop(cfg, steps=args.steps, batch_size=args.batch,
                     seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, lr=args.lr,
                     fail_at=args.fail_at, device=args.device)
    print(f"final loss: {out['final_loss']:.4f}  "
          f"failures={out['failures']} restores={out['restores']} "
          f"straggler_reuse={out['straggler_reuse']}")


if __name__ == "__main__":
    main()
