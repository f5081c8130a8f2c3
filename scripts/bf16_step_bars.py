#!/usr/bin/env python3
"""The readings ``chip_smoke.py`` phase 16b's bf16 bars (``BF16_BARS``)
are set from: SmolLM-135M's first bf16 train step from step 200 (the
phase's seeded params and first batch, 2 sequences of 512 tokens), as
``dryrun.train_compiled`` lowers it (run by the ``sequential`` backend)
and as ``make_train_step`` runs it, each read against one fp32 step from
the same params (``chip_smoke.bf16_readings``).

    python3 scripts/bf16_step_bars.py

Needs the card.  Prints one JSON line:

* ``sound``: ``RUNS`` pairs of the two steps from the same state (a bf16
  backward whose sums use atomics may round otherwise from run to run),
  each pair's readings and whether ``chip_smoke.hold_bf16`` holds them;
* ``planted``: the lowered step with one fault planted at a time: the
  gradient of one repeat's row of one leaf (``FAULT_LEAF``,
  ``FAULT_ROW``) scaled by each of ``FAULTS`` before AdamW reads it, as
  a wrong transpose of that weight would leave it; read against the
  first sound run's ``make_train_step``, and whether the bars hold;
* ``bars`` and ``device`` (``nvidia-smi``'s name and power limit).
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as C  # noqa: E402

RUNS = 3
#: the planted fault's leaf (the reference's layout), repeat and factors
FAULT_LEAF = ("segment_0", 0, "mixer", "w_v")
FAULT_ROW = 15
FAULTS = (1.1, 1.03, 1.01)


@contextlib.contextmanager
def planted(factor: float):
    """While a step is traced, scale the gradient of ``FAULT_LEAF``'s row
    ``FAULT_ROW`` by ``factor`` on its way into AdamW."""
    import torch
    from repro_torch import tree
    from repro_torch.launch import steps
    apply = steps._apply_updates

    def faulty(params, grads, opt, opt_cfg, lr_scale):
        new = []
        for path, g in tree.flatten_with_paths(grads):
            if path == FAULT_LEAF:
                r = FAULT_ROW
                g = torch.cat((g[:r], g[r:r + 1] * factor, g[r + 1:]))
            new.append(g)
        return apply(params, tree.unflatten(grads, new), opt, opt_cfg,
                     lr_scale)
    steps._apply_updates = faulty
    try:
        yield
    finally:
        steps._apply_updates = apply


def held(r: dict) -> bool:
    """Whether ``chip_smoke.hold_bf16`` holds the readings ``r``."""
    try:
        C.hold_bf16(r, "bars")
    except SystemExit:
        return False
    return True


def main() -> None:
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, steps
    C.require(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py
    dev = torch.device("cuda")
    base, opt_cfg, batches, init = C.lowered_step_inputs(dev)
    cfg = dataclasses.replace(base, dtype="bfloat16")
    state, batch = C.lowered_step_state(cfg, opt_cfg, init), batches[0]
    same = C.fp32_yardstick(cfg, opt_cfg, state, batch)
    start = steps.stack_train_state(state)
    leaves, n = tuple(tree.leaves(start)), len(tree.leaves(start))
    shape = InputShape("train", C.LOWERED_SEQ, C.LOWERED_BATCH, "train")
    step = steps.make_train_step(cfg, opt_cfg)

    def compiled():
        return dryrun.train_compiled(cfg, shape, device=dev,
                                     backend="sequential")

    def run(comp, keys):
        out = comp(leaves, tuple(tree.leaves(batch)))
        return (tree.unflatten(start, list(out[:n])),
                dict(zip(keys, map(float, out[n:]))))

    def readings(got, want):
        r = C.bf16_readings(dict(lowered=got[0], step=want[0]),
                            dict(lowered=got[1], step=want[1]), same,
                            start.params)
        r["held"] = held(r)
        return r

    comp, sound, first = compiled(), [], None
    for _ in range(RUNS):
        new, m = step(state, batch)
        want = (steps.stack_train_state(new),
                {k: float(v) for k, v in m.items()})
        first = first or want
        sound.append(readings(run(comp, want[1]), want))
    del comp
    planted_r = {}
    for factor in FAULTS:
        with planted(factor):
            comp = compiled()
        planted_r[str(factor)] = readings(run(comp, first[1]), first)
        del comp
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(dict(sound=sound, planted=planted_r,
                          fault=dict(leaf=list(map(str, FAULT_LEAF)),
                                     row=FAULT_ROW),
                          bars=C.BF16_BARS, device=smi)))


if __name__ == "__main__":
    main()
