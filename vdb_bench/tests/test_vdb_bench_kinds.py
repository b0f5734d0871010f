"""Index kinds found by name: a configuration's ``index.kind`` loads
``kinds/<kind>.py``; a missing or unknown kind is refused before a run
looks for a card; and a second kind, resident IVF-PQ with its exact
rerank, enters a copy of the harness as one new file and is served and
judged there on the CPU."""

import functools
import json
import shutil

import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_pq import (
    IVFPQIndex,
)
from vdb_bench import harness, readers, run, spec
from vdb_bench.harness import Run
from vdb_bench.tests.tiny import CLOSED, tiny_cell

SEED = 2**31 + 77

# The kind as a later configuration would add it: one new file, nothing
# else of the harness edited.
IVF_PQ_KIND = '''
"""Resident IVF-PQ: 8-bit codes on the card, the raw rows kept there
for the exact rerank, which every request asks for."""

import time

import numpy as np

from vdb_bench.harness import _sync


def create_args(cfg):
    return int(cfg["index"]["m"]), 8, ""


def search_fields(cfg):
    return {"use_exact_rerank": True}


def build(engine, cfg, x, dev):
    from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_pq \\
        import IVFPQConfig, IVFPQIndex

    st = engine.get_state(cfg["name"])
    index = IVFPQIndex(IVFPQConfig(
        dimension=st.config["dimension"], nlist=st.config["nlist"],
        m=st.config["m"], nbits=st.config["nbits"],
        metric=st.config["metric"], raw_dtype=st.config["dtype"],
        keep_raw=True), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    index.train_from_device(x)
    _sync(dev)
    t1 = time.perf_counter()
    index.add_from_device(x, np.arange(x.shape[0], dtype=np.uint64))
    _sync(dev)
    return index, t1 - t0, time.perf_counter() - t1


def facts(index):
    return {"summary": f"codes {tuple(index.code_arena.shape)} "
                       f"{index.code_arena.dtype}, raw rows "
                       f"{index.raw.arena.dtype}",
            "arena_bytes": index.memory_stats()["total_bytes"]}


def bounds(cols, pool_dev, live, cfg, k):
    return []
'''

# Limits of the tiny IVF-PQ cell, set from its readings on the CPU (1.5-s
# windows; five seeds sound, three with the planted fault or the control):
LIMITS = {
    # a failed request or a short answer: exact
    "missing": 0,
    # an id outside the corpus or twice, distances not ascending: exact
    "malformed": 0,
    # the rerank's fp32 distance to the bf16 raw row: sound 6.98e-07 to
    # 8.50e-07; an answer altered where it is produced 0.656 to 1.87; the
    # IVF-Flat cells' 2e-05
    "dist_err": 2e-05,
    # ADC shortlists of 40 at m 8 (4 dimensions a code) on a corpus whose
    # every query lies as far from 8 lists' balls: sound 0.937 to 0.950;
    # served at nprobe 6 of 8 (the probe control) 0.715 to 0.761; the
    # limit leaves the sound readings the wider room
    "recall_at_10": 0.83,
}


def _copy(tmp_path):
    """``vdb_bench/`` and ``BENCHMARK.json`` copied to ``tmp_path``."""
    base = tmp_path / "vdb_bench"
    shutil.copytree(spec.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return base, spec.load_benchmark()


def _add_cell(tmp_path, bench, cfg, traffic):
    """A configuration file, a mix file and a cell pairing them, in the
    copy."""
    base = tmp_path / "vdb_bench"
    (base / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (base / "traffic" / "closed-tiny.json").write_text(json.dumps(traffic))
    bench["configs"].append({"name": cfg["name"], "source": "x",
                             "file": f"vdb_bench/configs/{cfg['name']}.json",
                             "reduced": [], "why": "y"})
    bench["workloads"].append({"name": f"{cfg['name']}.b16",
                               "config": cfg["name"],
                               "traffic": "closed-tiny", "chips": 1,
                               "why": "z"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return f"{cfg['name']}.b16"


@pytest.mark.parametrize("kind", [None, "ivf_hnsw", "../kinds/ivf_flat"],
                         ids=["missing", "unknown", "a-path"])
def test_a_missing_or_unknown_kind_is_refused(tmp_path, monkeypatch,
                                              capsys, kind):
    base, bench = _copy(tmp_path)
    cfg = json.loads((base / "configs" / "sift-1m-128.json").read_text())
    cfg["name"] = "other-1m-128"
    cfg["index"].pop("kind")
    if kind is not None:
        cfg["index"]["kind"] = kind
    cell = _add_cell(tmp_path, bench, cfg, CLOSED)
    with pytest.raises(ValueError, match=r"no index kind .*have: ivf_flat"):
        spec.resolve(spec.load_benchmark(tmp_path), cell, base=base)
    # the command refuses it before it looks for a card: exit 2, no result
    monkeypatch.setattr(spec, "load_benchmark",
                        functools.partial(spec.load_benchmark, tmp_path))
    monkeypatch.setattr(spec, "resolve",
                        functools.partial(spec.resolve, base=base))
    assert run.main(["--workload", cell, "--seed", str(SEED),
                     "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "no index kind" in out.err


def test_every_configuration_names_a_kind_that_is_there():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.resolve(bench, w["name"])
        kind = cell.config["index"]["kind"]
        assert spec.kind_path(kind) == spec.HERE / "kinds" / f"{kind}.py"
        for fn in ("create_args", "search_fields", "build", "facts",
                   "bounds"):
            assert callable(getattr(cell.kind, fn)), (kind, fn)


def _pq_cell(tmp_path):
    """The tiny cell's sizes (``tests/tiny.py``) as an IVF-PQ
    configuration, m 8 of dim 32, in a copy of the harness that holds the
    kind as a new file."""
    base, bench = _copy(tmp_path)
    assert not (base / "kinds" / "ivf_pq.py").exists()
    (base / "kinds" / "ivf_pq.py").write_text(IVF_PQ_KIND)
    cfg = tiny_cell().config
    cfg["name"] = "tiny-pq-20k-32"
    cfg["index"].update(kind="ivf_pq", m=8)
    cfg["limits"] = dict(LIMITS)
    cell = _add_cell(tmp_path, bench, cfg, CLOSED)
    cell = spec.resolve(spec.load_benchmark(tmp_path), cell, base=base)
    assert cell.kind.__file__ == str(base / "kinds" / "ivf_pq.py")
    return cell


def _run(cell):
    return harness.run_cell(cell, SEED, 1.5, False, device="cpu")


def test_an_ivf_pq_kind_added_as_a_new_file_serves_and_is_judged(tmp_path):
    cell = _pq_cell(tmp_path)
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["checks"]["missing"][0] == 0
    assert r["checks"]["malformed"][0] == 0
    assert r["failed"] == 0 and r["attempted"] > 0
    # qps lists the cells it reports in; device_gb reads only on a card
    assert set(r["metrics"]) == {"recall_at_10", "setup_s"}
    # its scan is not K1: no bound, so k1_roofline reads nothing, not 0,
    # even from a window that holds a K1 launch
    assert cell.kind.bounds(None, None, None, cell.config, 10) == []
    window = {"span_us": (0.0, 100.0),
              "device": [(10.0, 30.0, readers.K1_KERNEL, "kernel")],
              "ranges": [(5.0, 8.0, readers.BATCH_RANGE)]}
    read = spec.load_reader("k1_roofline")
    assert read(Run(windows=[window], log=lambda m: None,
                    batch_bounds=lambda: cell.kind.bounds(
                        None, None, None, cell.config, 10))) is None


def test_an_answer_altered_in_ivf_pq_search_fails(tmp_path, monkeypatch):
    orig = IVFPQIndex.search_async

    def search_async(self, queries, params=None):
        fin = orig(self, queries, params)

        def altered():
            d, ids = fin()
            ids = ids.copy()
            ids[0, 0] = (ids[0, 0] + np.uint64(1)) % np.uint64(20_000)
            return d, ids
        return altered

    monkeypatch.setattr(IVFPQIndex, "search_async", search_async)
    r = _run(_pq_cell(tmp_path))
    assert not r["correct"]
    assert r["checks"]["dist_err"][0] > r["checks"]["dist_err"][1]
