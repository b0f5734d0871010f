"""End-to-end throughput benchmark CLI with the reference's CSV schema
(port of the JAX package's ``tools/benchmark.py``): columns
vectors,dimension,nlist,nprobe,k,train_time,add_time,search_time,qps,latency_ms
(the reference's ``bench/benchmark.cpp:181-196``); default workload
1M×128 / nlist 1024 / nprobe 10 / k 10 / 10K queries in batches of 64.

The corpus is generated on the device (``torch.randn`` in bf16 from an
explicit generator): a host → device upload of it measures nothing about
the engine. Train and add times end with a device synchronise.

    python -m cuda_acceleratedvectordatabaseengine_tpu_torch.tools.benchmark \\
        --vectors 1000000 --dimension 768 --nlist 1024
"""

from __future__ import annotations

import argparse
import csv
import sys
import time

import numpy as np

HEADER = ["vectors", "dimension", "nlist", "nprobe", "k", "train_time",
          "add_time", "search_time", "qps", "latency_ms"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="vdb benchmark → CSV")
    p.add_argument("--vectors", type=int, default=1_000_000)
    p.add_argument("--dimension", type=int, default=128)
    p.add_argument("--nlist", type=int, default=1024)
    p.add_argument("--nprobe", type=int, default=10)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--queries", type=int, default=10_000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--csv", default="-", help="output file (default stdout)")
    p.add_argument("--device", default=None,
                   help="device to run on (default: cuda)")
    args = p.parse_args(argv)

    import torch

    from cuda_acceleratedvectordatabaseengine_tpu_torch import (
        IVFFlatConfig,
        IVFFlatIndex,
        SearchParams,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.tools import (
        synchronize,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(42)
    x = torch.randn((args.vectors, args.dimension), generator=gen,
                    device=dev, dtype=torch.bfloat16)
    synchronize(dev)

    idx = IVFFlatIndex(IVFFlatConfig(
        dimension=args.dimension, nlist=args.nlist, dtype=args.dtype,
        train_sample_per_list=64,
    ), device=dev)
    t0 = time.time()
    idx.train_from_device(x)
    synchronize(dev)
    train_time = time.time() - t0

    t0 = time.time()
    idx.build_from_device(x)
    synchronize(dev)
    add_time = time.time() - t0
    del x

    gq = torch.Generator(device=dev).manual_seed(7)
    queries = torch.randn((args.queries, args.dimension), generator=gq,
                          device=dev, dtype=torch.float32).cpu().numpy()
    params = SearchParams(nprobe=args.nprobe, k=args.k)
    idx.search(queries[: args.batch], params)  # warm up

    t0 = time.time()
    lat = []
    for start in range(0, args.queries, args.batch):
        t1 = time.time()
        idx.search(queries[start:start + args.batch], params)
        lat.append((time.time() - t1) * 1000)
    search_time = time.time() - t0
    qps = args.queries / search_time
    latency_ms = float(np.mean(lat))

    row = [
        args.vectors, args.dimension, args.nlist, args.nprobe, args.k,
        round(train_time, 3), round(add_time, 3), round(search_time, 3),
        round(qps, 1), round(latency_ms, 3),
    ]
    out = sys.stdout if args.csv == "-" else open(args.csv, "w", newline="")
    try:
        w = csv.writer(out)
        w.writerow(HEADER)
        w.writerow(row)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
