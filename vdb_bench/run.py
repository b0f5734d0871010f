"""Run one cell of the benchmark once and print its result line.

    python3 -m vdb_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, the harness
(``vdb_bench/``) and the system under test,
``cuda_acceleratedvectordatabaseengine_tpu_torch``. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the judgement compared, beside its limit. The same
numbers are the last lines of standard error. Everything else goes to
standard error.

Exits without a result when no CUDA card is visible (or fewer than the
cell asks for), when the system under test cannot be imported, or when
the process has loaded JAX or the JAX package by the window's close.
"""

from __future__ import annotations

import argparse
import json
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_acceleratedvectordatabaseengine_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from vdb_bench import spec

    try:
        cell = spec.resolve(spec.load_benchmark(), args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"vdb_bench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"vdb_bench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 3
    try:
        import cuda_acceleratedvectordatabaseengine_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"vdb_bench: the system under test does not import: {e}",
              file=sys.stderr)
        return 4
    from vdb_bench import harness

    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace))
    leaked = forbidden_modules()
    if leaked:
        print(f"vdb_bench: the process loaded {', '.join(leaked)}",
              file=sys.stderr)
        return 5
    for name, (value, limit) in result["checks"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
