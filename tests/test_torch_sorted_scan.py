"""PyTorch port, the sorted full-row scan (K3): its plain version against
the JAX package's Pallas sorted kernel in interpret mode, on the same numpy
inputs (CPU)."""

import numpy as np
import pytest
import torch
from test_torch_scan import _atol, _jax_args, _make, _np, _torch_args

from cuda_acceleratedvectordatabaseengine_tpu.ops.distance import (
    Metric as JMetric,
)
from cuda_acceleratedvectordatabaseengine_tpu.ops.pallas_scan import (
    scan_probed_lists_pallas_sorted as j_sorted,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import sorted_scan
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.sorted_scan import (
    _pair_table,
    _sorted_rows_reference,
    scan_probed_lists_sorted,
    scan_probed_lists_sorted_reference,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)


def _case(rng, variant, metric, **kw):
    """``_make`` state; variant "int8_raw" keeps the per-row scales and
    drops the anchors (both packages take the same inputs either way)."""
    s = _make(rng, "int8" if variant.startswith("int8") else variant,
              metric, **kw)
    if variant == "int8_raw":
        s["anchors"] = None
    return s


def _both(s, k, metric, m=8, **extra):
    targs, tkw = _torch_args(s)
    jargs, jkw = _jax_args(s)
    ref = _np(j_sorted(*jargs, k, JMetric.parse(metric), interpret=True,
                       **jkw, **extra))
    got = _np(scan_probed_lists_sorted(*targs, k, Metric.parse(metric),
                                       m_budget=m, **tkw, **extra))
    return got, ref


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
@pytest.mark.parametrize("variant",
                         ["float32", "bfloat16", "int8", "int8_raw"])
def test_sorted_matches_jax(rng, variant, metric):
    """Every metric over fp32 / bf16 / int8 + scale ± anchor arenas, with
    -1 probes and lists shorter than k."""
    s = _case(rng, variant, metric)
    got, ref = _both(s, 6, metric)
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s, metric))
    assert got[1].dtype == np.int32 and got[0].shape == (12, 6)


def test_sorted_scan_capacity_prefix(rng):
    s = _case(rng, "int8", "L2", cap=384, max_count=200)
    scap = int(s["counts"].max())
    got, ref = _both(s, 8, "L2", scan_capacity=scap)
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s, "L2"))
    full, _ = _both(s, 8, "L2")
    np.testing.assert_array_equal(got[0], full[0])


def test_sorted_slot_striping(rng):
    """A slot-striped shard (local slot j holds logical j·2 + 1) scans
    local counts and reports logical positions."""
    s = _case(rng, "float32", "L2", cap=128)
    extra = dict(slot_stride=2, slot_offset=1, global_capacity=256)
    s["counts"] = (s["counts"] * 2).astype(np.int32)   # global counts
    got, ref = _both(s, 6, "L2", **extra)
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s, "L2"))
    live = got[1][got[1] >= 0]
    assert (live % 2 == 1).all()                       # odd logical slots


def test_sorted_deep_k_pads(rng):
    """k 100 over fewer valid slots: the tail pads with (+inf, -1) as the
    JAX top-k does; no per-list depth cap."""
    s = _case(rng, "int8", "L2", nlist=8, cap=128, batch=6, nprobe=2,
              max_count=40)
    got, ref = _both(s, 100, "L2")
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s, "L2"))
    fin = np.isfinite(got[0])
    assert (got[1][~fin] == -1).all() and (~fin).any()


def test_sorted_hot_list_and_rows_contract(rng):
    """Many pairs on one list span several list-rows; rows land at their
    (b, p) place, +inf past each list's count and for -1 probes."""
    s = _case(rng, "float32", "InnerProduct", nlist=4, batch=40, nprobe=2,
              short_lists=False)
    s["probe"][:, 0] = 1                          # every query probes list 1
    s["probe"][:, 1] = np.where(np.arange(40) % 3, 0, -1)
    targs, _ = _torch_args(s)
    q, arena, sq, counts, probe = targs
    row_list, table = _pair_table(probe, 4, 8)
    assert int((row_list == 1).sum()) == 5        # 40 pairs / m = 8
    rows = _sorted_rows_reference(q, arena, sq, counts, row_list, table, 2,
                                  80, Metric.INNER_PRODUCT, 128).numpy()
    rows = rows.reshape(40, 2, 128)
    expect = -np.einsum("bd,bsd->bs", s["q"], s["stored"][s["probe"][:, 0]])
    live = np.arange(128)[None, :] < s["counts"][1]
    np.testing.assert_allclose(rows[:, 0][:, live[0]],
                               expect[:, live[0]], rtol=1e-5, atol=1e-5)
    assert np.isinf(rows[:, 0][:, ~live[0]]).all()
    assert np.isinf(rows[s["probe"][:, 1] < 0, 1]).all()
    got, ref = _both(s, 5, "InnerProduct")
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s, "InnerProduct"))


def test_sorted_probe_chunks_merge_exactly(rng, monkeypatch):
    """A row budget far below one batch splits the probe axis; the merged
    top-k equals the one-chunk result."""
    s = _case(rng, "int8", "L2", nprobe=6)
    targs, tkw = _torch_args(s)
    one = _np(scan_probed_lists_sorted_reference(*targs, 7, Metric.L2,
                                                 **tkw))
    monkeypatch.setattr(sorted_scan, "FULL_ROW_BYTES", 12 * 128 * 4 * 2)
    assert sorted_scan.probe_chunk(12, 6, 128) == 2
    many = _np(scan_probed_lists_sorted_reference(*targs, 7, Metric.L2,
                                                  **tkw))
    np.testing.assert_array_equal(one[0], many[0])
    assert_topk_match(*one, *many, rtol=0.0, atol=0.0)


def test_sorted_cpu_wrapper_takes_plain_version(rng):
    s = _case(rng, "int8", "L2")
    targs, tkw = _torch_args(s)
    before = sorted_scan.LAUNCHES
    a = scan_probed_lists_sorted(*targs, 5, Metric.L2, m_budget=8, **tkw)
    b = scan_probed_lists_sorted_reference(*targs, 5, Metric.L2, m_budget=8,
                                           **tkw)
    assert sorted_scan.LAUNCHES == before == 0
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


def test_sorted_matches_jax_gather_at_k100(rng):
    """Deep k on the sorted scan equals the JAX gather scan (fp32-exact)."""
    from cuda_acceleratedvectordatabaseengine_tpu.ops.scan import (
        scan_probed_lists as j_gather,
    )

    s = _case(rng, "int8", "L2", nlist=8, cap=128, batch=6, nprobe=3)
    jargs, jkw = _jax_args(s)
    ref = _np(j_gather(*jargs, 100, JMetric.L2, **jkw))
    targs, tkw = _torch_args(s)
    got = _np(scan_probed_lists_sorted(*targs, 100, Metric.L2, **tkw))
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s, "L2"))
    assert got[0].shape == ref[0].shape == (6, 100)
