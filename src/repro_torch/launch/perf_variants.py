"""§Perf variants: re-run three chosen dry-run cells with each
optimization variant and record them beside the baselines.

The port of the reference's ``launch/perf_variants.py``, with its cells
and variants:

  A. deepseek-v3-671b × decode_32k  — worst roofline fraction
  B. deepseek-v3-671b × train_4k    — most collective-bound
  C. qwen2.5-14b × decode_32k       — the decode step is the decoupled
                                       memory stage of the paper

Run:  python -m repro_torch.launch.perf_variants [--out build/dryrun]
      [--device cpu]
"""

from __future__ import annotations

import argparse

from .dryrun import run_cell

VARIANTS = [
    # cell A
    ("deepseek-v3-671b", "decode_32k", "absorbed",
     {"mla_absorbed": True}, False),
    ("deepseek-v3-671b", "decode_32k", "absorbed_ep",
     {"mla_absorbed": True}, True),
    ("deepseek-v3-671b", "decode_32k", "absorbed_ep_int8a2a",
     {"mla_absorbed": True, "moe": {"dispatch_dtype": "int8"}}, True),
    # cell B
    ("deepseek-v3-671b", "train_4k", "int8a2a",
     {"moe": {"dispatch_dtype": "int8"}}, False),
    ("deepseek-v3-671b", "train_4k", "int8a2a_devlim",
     {"moe": {"dispatch_dtype": "int8", "route_groups": 16,
              "route_device_limit": 4}}, False),
    # cell C
    ("qwen2.5-14b", "decode_32k", "int8kv",
     {"kv_cache_dtype": "int8"}, False),
]


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.perf_variants",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="build/dryrun")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu': the mesh's device")
    args = p.parse_args(argv)
    n_err = 0
    for arch, shape, name, overrides, ep in VARIANTS:
        rec = run_cell(arch, shape, multi_pod=False, variant=name,
                       overrides=overrides, ep_serve=ep, out_dir=args.out,
                       device=args.device)
        n_err += rec["status"] == "error"
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
