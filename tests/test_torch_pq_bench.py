"""PyTorch port, the IVF-PQ harnesses on the CPU against the JAX system's
scripts on the same inputs: ``tools/pq_capacity.py`` against
``scripts/dev_pq_capacity.py`` on the JAX script's store, and
``tools/pq_sweep.py`` against ``scripts/dev_pq_sweep.py`` on the
anisotropic corpus, with and without OPQ.

The two packages draw their corpora, queries and k-means from different
generators, so each JAX script runs with spies on the JAX package that
record what it handed the package: the rows it encoded, the queries it
searched and the quantizers it trained. The port's tool then runs on those
rows and queries (its ``rows`` / ``queries`` seams, which ``main`` never
sets) with its training replaced by the recorded quantizers, and must
give the JAX script's recall up to ties."""

import json

import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu.models import (
    ivf_pq as jax_ivf_pq,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_pq import (
    IVFPQIndex,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.tools import (
    pq_capacity as pc,
    pq_sweep as ps,
    streaming_bench as sb,
)
from test_torch_streaming_bench import run_jax, run_port

torch.set_num_threads(1)
CPU = torch.device("cpu")
BATCH, K = 64, 10
GEOMETRY = ["--n", "20000", "--dim", "32", "--nlist", "64", "--nprobe", "8",
            "--batch", str(BATCH), "--n-batches", "2"]
STREAM_FLAGS = GEOMETRY + ["--hot-clusters", "4", "--cache-frac", "0.5"]
PQCAP_FLAGS = GEOMETRY + ["--m", "8", "--rerank", "0,32,64@0.3"]
SWEEP_FLAGS = ["--n", "20000", "--dim", "32", "--nlist", "64", "--m", "8",
               "--max-batch", str(BATCH), "--n-batches", "1", "--nprobe",
               "8", "--aniso", "0.5", "--config", "64:0", "--config",
               "64:16", "--config", "64:16:k16"]
# recall@10 over one corpus, one query batch and one set of quantizers:
# the packages may order an entry tied at the k-th distance differently,
# each such tie moving recall by 1/(B·k); allowed: 2 tied entries, plus
# the JAX line's rounding to 4 decimals
RECALL_TOL = 2 / (BATCH * K) + 5e-5
# the margin's mean kept candidates a query: 2 ties moving one query's
# count by one each, plus the JAX line's rounding to 1 decimal
KEPT_TOL = 2 / BATCH + 0.05


def run_jax_recorded(name, argv, monkeypatch) -> tuple[list[dict], dict]:
    """The JAX script's JSON lines, and what it handed the JAX package:
    ``rows`` (every row it encoded, fp32, in id order), ``queries`` (the
    first batch it searched through ``_ivf_pq_search_device``) and
    ``index`` (the index it built, with its quantizers)."""
    seen = {"rows": {}, "queries": None, "index": None}
    add = jax_ivf_pq.IVFPQIndex.add_from_device
    search = jax_ivf_pq._ivf_pq_search_device

    def add_spy(self, x, ids=None):
        seen["index"] = self
        seen["rows"][int(ids[0])] = np.asarray(x).astype(np.float32)
        return add(self, x, ids)

    def search_spy(queries, *args, **kwargs):
        if seen["queries"] is None:
            seen["queries"] = np.asarray(queries, np.float32)
        return search(queries, *args, **kwargs)

    with monkeypatch.context() as mp:
        mp.setattr(jax_ivf_pq.IVFPQIndex, "add_from_device", add_spy)
        mp.setattr(jax_ivf_pq, "_ivf_pq_search_device", search_spy)
        lines = run_jax(name, argv)
    seen["rows"] = np.concatenate([seen["rows"][s]
                                   for s in sorted(seen["rows"])])
    return lines, seen


def recorded_rows(rows, dtype):
    """``rows(start, m)`` over the recorded rows, as a tool asks for
    them."""
    return lambda start, m: torch.from_numpy(rows[start:start + m]).to(
        dtype)


def t(a):
    return None if a is None else torch.from_numpy(np.asarray(a,
                                                              np.float32))


@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    """A store directory written by the JAX script's streaming harness."""
    sd = tmp_path_factory.mktemp("jax_store")
    run_jax("dev_streaming_bench", STREAM_FLAGS + ["--store-dir", str(sd)])
    return sd


def test_pq_capacity_points_match_jax(jax_store, monkeypatch):
    """The JAX script on its store, then the port's tool on the same store
    with the JAX script's rows, codebooks, queries and truth (its
    ``truth_pqcap.npz``): the points carry the same names and keys, each
    recall is the JAX point's up to ties, ``mean_reranked`` is set only
    under a margin and then the JAX point's up to ties, and the rerank
    lifts recall. (On the CPU the index's ``auto`` scan is the gather ADC;
    ``test_pq_sweep_matches_jax`` names K2, whose plain version runs.)"""
    flags = PQCAP_FLAGS + ["--store-dir", str(jax_store)]
    want, seen = run_jax_recorded("dev_pq_capacity", flags, monkeypatch)
    codebooks = t(seen["index"].codebooks)

    def train_pq(self, gen, residuals):
        self.codebooks = codebooks.to(self.device)

    monkeypatch.setattr(IVFPQIndex, "_train_pq", train_pq)
    monkeypatch.setattr(sb, "require_maker", lambda sd, dev: None)
    args = pc.parse_args(flags + ["--device", "cpu"])
    keep = {}
    summary = pc.run(args, CPU,
                     rows=recorded_rows(seen["rows"], torch.bfloat16),
                     keep=keep)
    assert len(want) == 4                      # three points, the summary
    np.testing.assert_array_equal(keep["truth"], np.load(
        jax_store / "truth_pqcap.npz")["truth"])
    assert set(summary) - pc.ADDED_KEYS == set(want[-1])
    assert summary["device"] == "cpu"
    got = summary["points"]
    for g, w in zip(got, want[-1]["points"], strict=True):
        assert g["name"] == w["name"]
        assert set(g) - pc.ADDED_POINT_KEYS == set(w)
        assert abs(g["recall_at_10"] - w["recall_at_10"]) <= RECALL_TOL, (
            g, w)
        assert (g["mean_reranked"] is not None) == (g["margin"] is not None)
        assert (g["margin"] is not None) == ("@" in g["name"])
        if g["margin"] is not None:
            assert abs(g["mean_reranked"] - w["mean_reranked"]) <= KEPT_TOL
    assert [p["name"] for p in got] == [
        "adc_only", "adc+host_rerank_32", "adc+host_rerank_64@m0.3"]
    assert got[1]["recall_at_10"] > got[0]["recall_at_10"] + 0.1


def test_pq_capacity_refuses_a_store_it_did_not_write(jax_store):
    """The JAX script's store has no port ``maker``: regenerated rows would
    not be its rows, so the run raises before building anything."""
    with pytest.raises(ValueError, match="cannot be regenerated"):
        run_port(pc.main, PQCAP_FLAGS + ["--store-dir", str(jax_store)])


@pytest.mark.parametrize("opq", [False, True])
def test_pq_sweep_matches_jax(opq, monkeypatch):
    """``--aniso 0.5`` with and without OPQ, configs ``64:0``, ``64:16``
    and ``64:16:k16``: the port's tool on the JAX script's warped rows and
    queries, with its coarse quantizer, codebooks and rotation, prints one
    line a config with the JAX line's keys, each recall the JAX line's up
    to ties, and ``shortlist_containment`` (set only under ``kN``) the
    same up to ties."""
    flags = SWEEP_FLAGS + (["--opq"] if opq else [])
    want, seen = run_jax_recorded("dev_pq_sweep", flags, monkeypatch)
    jidx = seen["index"]
    trained = {"centroids": t(jidx.centroids), "codebooks": t(jidx.codebooks),
               "opq_R": t(jidx.opq_R)}
    assert (trained["opq_R"] is not None) == opq

    def train_from_device(self, x_dev):
        for name, value in trained.items():
            setattr(self, name, None if value is None
                    else value.to(self.device))
        self.trained = True

    monkeypatch.setattr(IVFPQIndex, "train_from_device", train_from_device)
    args = ps.parse_args(flags + ["--device", "cpu"])
    got = ps.run(args, CPU, rows=recorded_rows(seen["rows"], torch.float32),
                 queries=seen["queries"])
    assert seen["queries"].shape == (BATCH, 32)
    assert [g["config"] for g in got] == [w["config"] for w in want] == [
        "64:0", "64:16", "64:16:k16"]
    for g, w in zip(got, want):
        assert set(g) - ps.ADDED_KEYS == set(w)
        assert abs(g["recall"] - w["recall"]) <= RECALL_TOL, (g, w)
        assert (g["shortlist_containment"] is not None) == (
            ":k" in g["config"])
        assert (w["shortlist_containment"] is None) == (
            g["shortlist_containment"] is None)
        if w["shortlist_containment"] is not None:
            assert abs(g["shortlist_containment"]
                       - w["shortlist_containment"]) <= RECALL_TOL, (g, w)
        assert g["opq"] is opq and g["aniso"] == 0.5
        assert g["k2_launches"] == 0 and g["device"] == "cpu"
    # the kN line returns the whole reranked shortlist: its top 10 are the
    # 64:16 line's, and it holds at least what they hold
    assert got[2]["recall"] == got[1]["recall"]
    assert got[2]["shortlist_containment"] >= got[2]["recall"]


def test_config_grammar():
    assert ps.parse_config("512:0", 32, 10) == (512, 0, 32, 10)
    assert ps.parse_config("2048:40:p16", 32, 10) == (2048, 40, 16, 10)
    assert ps.parse_config("512:128:k128", 32, 10) == (512, 128, 32, 128)
    assert ps.parse_config("64", 8, 10) == (64, 0, 8, 10)
    with pytest.raises(ValueError):
        ps.parse_config("512:40:x3", 32, 10)
    assert ps.parse_args([]).config == ["512:0", "512:40", "2048:40"]
    assert json.dumps(ps.parse_args(["--config", "64:1"]).config) == \
        '["64:1"]'
