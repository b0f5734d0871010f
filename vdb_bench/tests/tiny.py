"""A cell cut to a size a CPU test run can hold: the sift-1m-128
configuration at 20,000 × 32, nlist 64, nprobe 8 (8 groups of 8 balls),
with small mixes."""

import copy

from vdb_bench import spec

CLOSED = {"loop": "closed", "callers": 2, "queries_per_request": 16, "k": 10}
OPEN = {"loop": "open", "rate_per_s": 200, "workers": 16,
        "queries_per_request": 1, "k": 10}


def tiny_cell(mix=CLOSED) -> spec.Cell:
    cell = spec.resolve(spec.load_benchmark(), "sift-1m-128.b64")
    cfg = copy.deepcopy(cell.config)
    cfg["index"].update(n=20_000, dim=32, nlist=64, nprobe=8)
    cfg["corpus"].update(balls=64, group=8, group_radius=4.0, queries=256)
    cfg["engine_overrides"] = {"default_nprobe": 8}
    cell.config, cell.traffic = cfg, dict(mix)
    return cell
