"""Readings of the judged numbers over many seeds in one process, for
setting the limits of ``check.py``: the program as the configuration
states it (the lower readings); with ``--arena-dtype int8``, the program's
own path one precision below the configuration's bf16 arena (the control,
which has to fail); with ``--nprobe N``, the program serving at nprobe
``N`` in place of the configuration's (the probe control: a search that
leaves out lists it should read, which has to fail too). One JSON line a
seed on standard output.

    python3 -m vdb_bench.readings --workload ref-10m-768.b64 \\
        --seeds 11,12,13 --seconds 51 [--arena-dtype int8] [--nprobe 24]

Needs a CUDA card, as ``run.py`` does; the benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys


def at_nprobe(cell, nprobe: int):
    """``cell`` with its configuration serving at ``nprobe``: the stated
    nprobe and the engine's ``default_nprobe`` both changed."""
    cell = copy.copy(cell)
    cfg = copy.deepcopy(cell.config)
    cfg["index"]["nprobe"] = int(nprobe)
    cfg["engine_overrides"] = {**cfg.get("engine_overrides", {}),
                               "default_nprobe": int(nprobe)}
    cell.config = cfg
    return cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, one run each")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--arena-dtype", default=None,
                   help="engine arena dtype in place of the configuration's")
    p.add_argument("--nprobe", type=int, default=0,
                   help="nprobe in place of the configuration's")
    args = p.parse_args(argv)
    import torch

    from vdb_bench import harness, spec

    if not torch.cuda.is_available():
        print("vdb_bench.readings: no CUDA card", file=sys.stderr)
        return 3
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    if args.nprobe:
        cell = at_nprobe(cell, args.nprobe)
    extra = {"arena_dtype": args.arena_dtype} if args.arena_dtype else {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(cell, seed, args.seconds, False,
                             extra_overrides=extra)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "arena_dtype": args.arena_dtype or "as stated",
                          "nprobe": cell.config["index"]["nprobe"],
                          "correct": r["correct"], "checks": r["checks"],
                          "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
