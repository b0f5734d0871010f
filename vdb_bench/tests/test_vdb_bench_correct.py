"""The judgement that decides ``correct``, driven through whole runs at a
size the CPU holds: a sound run passes; the controls (the program's own
int8 arena, the precision below the configuration's bf16; the program
serving at three quarters of the stated nprobe) and each fault the served
path can have, planted under the timed path, fail it."""

import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu_torch.models import ivf_flat
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat import (
    IVFFlatIndex,
)
from vdb_bench import harness
from vdb_bench.readings import at_nprobe
from vdb_bench.tests.tiny import CLOSED, OPEN, tiny_cell

SEED = 2**31 + 99


def _run(mix=CLOSED, cell=None, **kw):
    return harness.run_cell(cell or tiny_cell(mix), SEED, 1.5, False,
                            device="cpu", **kw)


def _probes_broken(monkeypatch, fault):
    """Pass each batch's probe set ``[B, nprobe]`` through ``fault`` on its
    way from the coarse probe to the list scan."""
    orig = ivf_flat.scan_flat

    def scan_flat(impl, q, arena, arena_sq, counts, probe_ids, *a, **kw):
        return orig(impl, q, arena, arena_sq, counts, fault(probe_ids),
                    *a, **kw)

    monkeypatch.setattr(ivf_flat, "scan_flat", scan_flat)


def _broken(monkeypatch, fault):
    """Wrap ``IVFFlatIndex.search_async`` so each batch's answer passes
    through ``fault(d, ids)`` where it is produced."""
    orig = IVFFlatIndex.search_async

    def search_async(self, queries, params=None):
        fin = orig(self, queries, params)
        return lambda: fault(*fin())

    monkeypatch.setattr(IVFFlatIndex, "search_async", search_async)


@pytest.mark.parametrize("mix", [CLOSED, OPEN], ids=["closed", "open"])
def test_a_sound_run_is_correct(mix):
    r = _run(mix)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["dist_err"][0] < r["checks"]["dist_err"][1] / 5


def test_the_control_fails():
    r = _run(extra_overrides={"arena_dtype": "int8"})
    assert not r["correct"]
    assert r["checks"]["dist_err"][0] > r["checks"]["dist_err"][1]


def test_the_probe_control_fails():
    r = _run(cell=at_nprobe(tiny_cell(), 6))
    assert not r["correct"]
    assert r["checks"]["recall_at_10"][0] < r["checks"]["recall_at_10"][1]


def test_a_wrong_list_in_the_probe_fails(monkeypatch):
    def last_wrong(p):
        p = p.clone()
        p[:, -1] = (p[:, -1] + 32) % 64
        return p

    _probes_broken(monkeypatch, last_wrong)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["recall_at_10"][0] < r["checks"]["recall_at_10"][1]


def test_a_scan_that_skips_a_quarter_of_its_lists_fails(monkeypatch):
    keep = torch.tensor([0, 2, 3, 4, 6, 7])     # two of the eight dropped
    _probes_broken(monkeypatch, lambda p: p[:, keep.to(p.device)])
    r = _run()
    assert not r["correct"]
    assert r["checks"]["recall_at_10"][0] < r["checks"]["recall_at_10"][1]


def test_a_run_served_at_another_nprobe_is_refused(monkeypatch):
    orig = harness.serving_params

    def six(engine, name, k):
        params = orig(engine, name, k)
        params.nprobe = 6
        return params

    monkeypatch.setattr(harness, "serving_params", six)
    with pytest.raises(ValueError, match="nprobe 6"):
        _run()


@pytest.mark.parametrize("mix", [CLOSED, OPEN], ids=["closed", "open"])
def test_half_of_the_batch_left_out_fails(monkeypatch, mix):
    _broken(monkeypatch, lambda d, ids: (d[:(len(d) + 1) // 2],
                                         ids[:(len(ids) + 1) // 2]))
    r = _run(mix)
    assert not r["correct"]
    assert r["checks"]["missing"][0] > 0


def test_an_answer_altered_where_it_is_produced_fails(monkeypatch):
    def alter(d, ids):
        ids = ids.copy()
        ids[0, 0] = (ids[0, 0] + np.uint64(1)) % np.uint64(20_000)
        return d, ids

    _broken(monkeypatch, alter)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["dist_err"][0] > r["checks"]["dist_err"][1]
