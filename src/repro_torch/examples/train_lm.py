"""End-to-end training driver example: a small LM for a few hundred
steps on the synthetic pipeline, with checkpointing.

Run:  ``python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]``

This uses the same ``train_loop`` as the port's launcher — the
prefetching data FIFO (the template applied to the host boundary), the
train step, atomic checkpoints and deterministic resume.  It trains a
width-reduced SmolLM-family config (d_model 128, 4 layers) by default;
``--full`` trains the real smollm-135m (the same code path).
Checkpoints go to a new directory under ``build/`` unless ``--ckpt-dir``
names one.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

from .. import _device
from ..configs import load_config, reduced
from ..launch.train import train_loop


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m "
                                "repro_torch.examples.train_lm")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--full", action="store_true",
                   help="train the real smollm-135m config")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    dev = _device.get_device(args.device)
    _device.set_device(dev)

    cfg = load_config("smollm-135m")
    if not args.full:
        cfg = reduced(cfg, d_model=128, max_repeats=4)
    ckpt_dir = args.ckpt_dir
    if ckpt_dir is None:
        os.makedirs("build", exist_ok=True)
        ckpt_dir = tempfile.mkdtemp(prefix="train_lm_", dir="build")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    out = train_loop(cfg, steps=args.steps, batch_size=8, seq_len=128,
                     ckpt_dir=ckpt_dir, ckpt_every=50, lr=1e-3, device=dev)
    k = max(1, min(10, args.steps // 2))     # two disjoint windows
    first = sum(out["losses"][:k]) / k
    last = sum(out["losses"][-k:]) / k
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({(first - last) / first * 100:.1f}% reduction)")
    print(f"checkpoints in {ckpt_dir}")
    assert last < first, "training did not reduce loss"
    return out


if __name__ == "__main__":
    main()
