#!/usr/bin/env python3
"""K1 at the headline shape, on the card.

Builds the index of the port's headline harness (``tools/bench``: by
default 10M x 768, int8 residual, nlist 4096, batch 8192, auto nprobe) and
prints its result line. Then, on that index at the served nprobe and
depth (2k under multi-assignment), it times K1's row step against its
plain version and the bound of its work, and traces one host-to-host
search (device ms of each stage beside the median batch of 5), as
``chip_smoke.py`` phase 19b does (``phase_bench_index_checks``), and
prints that as a second JSON line. Takes ``tools.bench``'s flags. Run
from the repository root on a machine with a card:

    python3 scripts/k1_headline_shape.py
    python3 scripts/k1_headline_shape.py --skew zipf --batch 4096
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from cuda_acceleratedvectordatabaseengine_tpu_torch.tools import (  # noqa: E402
    bench,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.device import (  # noqa: E402
    resolve_device,
)


def main(argv=None) -> int:
    args = bench.parse_args(argv)
    keep = {}
    print(json.dumps(bench.run(args, resolve_device(args.device), keep=keep)),
          flush=True)
    k_dev = 2 * args.k if args.multi_assign_eps > 0 else args.k
    check = chip_smoke.phase_bench_index_checks(keep, args.k, k_dev)
    print(json.dumps({"k1_headline_shape": {
        "batch": args.batch, "nprobe": keep["nprobe"], "k": k_dev,
        **check}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
