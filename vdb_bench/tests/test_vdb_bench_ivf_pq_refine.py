"""The index kind ``ivf_pq_refine`` on the CPU: the tiny cell's corpus
(``tests/tiny.py``) served through a resident IVF-PQ index with its exact
rerank and judged by the harness; a depth planted below the
configuration's shows in ``rerank_rows`` and fails the recall limit; K2's
bound and its reader."""

import copy

import numpy as np
import pytest
import torch

from vdb_bench import harness, roofline_pq, spec
from vdb_bench.harness import Run
from vdb_bench.tests.tiny import CLOSED, tiny_cell

SEED = 2**31 + 77
CELL = "ivfpq-10m-768.b64"
R = 256
# Limits of the tiny cell, from its readings on the CPU (1.5-s and 3-s
# windows, one seed): recall 1.0 at depth 256 of about 2,500 probed slots
# (m 8, 4 dimensions a code), 0.978 at 64, 0.905 at 32; dist_err 7.1e-07
LIMITS = {"missing": 0, "malformed": 0, "dist_err": 2e-05,
          "recall_at_10": 0.95}


def _cell(rerank_k=R) -> spec.Cell:
    """The tiny cell's sizes as the IVF-PQ configuration: m 8 of dim 32,
    served by the cell's kind with the cell's metrics."""
    real = spec.resolve(spec.load_benchmark(), CELL)
    cell = tiny_cell(CLOSED)
    cfg = copy.deepcopy(cell.config)
    cfg["name"] = "tiny-ivfpq-20k-32"
    cfg["index"].update(kind=real.config["index"]["kind"], m=8, nbits=8,
                        raw_dtype="bfloat16", rerank_k=rerank_k,
                        train_iters=40)
    cfg["limits"] = dict(LIMITS)
    cell.config, cell.kind = cfg, real.kind
    cell.end_to_end, cell.per_layer = real.end_to_end, real.per_layer
    return cell


def test_the_cell_names_the_kind():
    cell = spec.resolve(spec.load_benchmark(), CELL)
    assert cell.config["index"]["kind"] == "ivf_pq_refine"
    assert cell.kind.__file__ == str(spec.HERE / "kinds" / "ivf_pq_refine.py")
    assert cell.kind.search_fields(cell.config) == {"use_exact_rerank": True}
    assert cell.kind.create_args(cell.config) == (96, 8, "")
    assert {m["name"] for m in cell.per_layer} >= {
        "k2_roofline", "rerank_ms", "rerank_rows", "pq_search_host_ms"}
    assert not {m["name"] for m in cell.per_layer} & {"k1_roofline",
                                                      "search_host_ms"}


def test_the_kind_serves_and_is_judged():
    r = harness.run_cell(_cell(), SEED, 1.5, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["dist_err"][0] < 1e-6
    assert set(r["metrics"]) == {"qps", "recall_at_10", "setup_s"}


def test_a_depth_below_the_configuration_shows_and_fails():
    """The planted fault: the index built at an eighth of the depth the
    configuration states reads fewer rows a query, and its recall falls
    below the limit."""
    sound = harness.run_cell(_cell(), SEED, 3.0, True, device="cpu")
    planted = harness.run_cell(_cell(R // 8), SEED, 3.0, True,
                               device="cpu")
    assert sound["correct"], sound["checks"]
    assert sound["metrics"]["rerank_rows"]["value"] == R
    assert planted["metrics"]["rerank_rows"]["value"] == R // 8
    assert sound["metrics"]["rerank_ms"]["value"] == 0.0    # no card
    assert sound["metrics"]["pq_search_host_ms"]["value"] > 0
    assert not planted["correct"]
    assert (planted["checks"]["recall_at_10"][0]
            < LIMITS["recall_at_10"]
            <= sound["checks"]["recall_at_10"][0])


def test_the_k2_bound_counts_what_the_scan_needs():
    # 2 queries, 2 probes each, lists 0 and 1 shared; 100 and 50 rows
    probe = torch.tensor([[0, 1], [1, 0]])
    counts = torch.tensor([100, 50, 7])
    b = roofline_pq.grouped_pq_scan_bound(probe, counts, cap_s=128, dim=32,
                                          msub=8)
    tables = 2 * 4 * 2 * 8 * 256
    assert b["flops"] == tables + 8 * (2 * 150)
    assert b["bytes"] == ((8 + 4) * 150 + (8 * 256 * 4 + 2 * 32 + 2 * 32) * 4
                          + 2 * 2 * 128 * 4)
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx(b["bytes"] / 3.35e12)


def test_k2_roofline_reads_k2_kernels_over_searches():
    read = spec.load_reader("k2_roofline")
    window = {"span_us": (0.0, 1000.0),
              "device": [(10.0, 30.0, "pq_table_kernel", "kernel"),
                         (30.0, 130.0, "void pq_table_scan_kernel<1>",
                          "kernel"),
                         (140.0, 400.0, "grouped_scan_tc_kernel", "kernel")],
              "ranges": [(5.0, 8.0, "ivf_pq.upload"),
                         (8.0, 9.0, "ivf_pq.coarse_probe"),
                         (1500.0, 1600.0, "ivf_pq.upload")]}
    run = Run(windows=[window], log=lambda m: None,
              batch_bounds=lambda: [60e-6, 20e-6])
    # one search inside the window, its bound the mean (40 µs), K2 120 µs
    assert read(run) == pytest.approx(100.0 * 40 / 120)
    run.batch_bounds = lambda: []
    assert read(run) is None
    no_k2 = dict(window, device=window["device"][2:])
    assert read(Run(windows=[no_k2], log=lambda m: None,
                    batch_bounds=lambda: [1.0])) is None


def test_the_search_readers_read_ivf_pq_ranges_and_stages():
    window = {"span_us": (0.0, 1000.0), "device": [],
              "ranges": [(0.0, 300.0, "ivf_pq.upload"),
                         (300.0, 800.0, "ivf_pq.coarse_probe"),
                         (900.0, 1200.0, "ivf_pq.finalize"),
                         (1100.0, 1300.0, "ivf_pq.upload")]}
    host = spec.load_reader("pq_search_host_ms")
    assert host(Run(windows=[window])) == pytest.approx(1.1)
    # a search replayed from CUDA graphs: its shortlist range in place of
    # the coarse probe's
    graphed = dict(window, ranges=[(0.0, 100.0, "ivf_pq.upload"),
                                   (100.0, 200.0, "ivf_pq.shortlist"),
                                   (200.0, 300.0, "ivf_pq.rerank"),
                                   (400.0, 500.0, "ivf_pq.finalize")])
    assert host(Run(windows=[graphed])) == pytest.approx(0.3)
    assert host(Run(windows=[])) is None
    stages = {"rerank": {"p50": 1.5, "mean": 2.0},
              "rerank_rows": {"p50": 2048.0, "mean": 2000.0}}
    assert spec.load_reader("rerank_ms")(Run(stages=stages)) == 1.5
    assert spec.load_reader("rerank_rows")(Run(stages=stages)) == 2000.0
    assert spec.load_reader("rerank_ms")(Run(stages={})) is None
    assert spec.load_reader("rerank_rows")(Run(stages={})) is None


def test_the_kind_bounds_each_answered_request():
    cell = spec.resolve(spec.load_benchmark(), CELL)
    cols = {"rows": np.array([[0, 1], [2, 3], [1, 2]]),
            "status": np.array([0, 0, 1])}
    pool = torch.eye(4, 8)
    live = Run(centroids=torch.eye(3, 8), counts=torch.tensor([10, 20, 30]),
               scan_slots=128, m=4)
    cfg = copy.deepcopy(cell.config)
    cfg["index"].update(nprobe=2, dim=8)
    out = cell.kind.bounds(cols, pool, live, cfg, 10)
    assert len(out) == int((cols["status"] == 0).sum()) == 2
    assert all(b > 0 for b in out)
