"""PyTorch port, probed-list scans: the gather scan and the grouped scan's
plain version against the JAX package's gather scan and its Pallas grouped
kernel (interpret mode), on the same numpy inputs (CPU)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu.ops.distance import (
    Metric as JMetric,
)
from cuda_acceleratedvectordatabaseengine_tpu.ops.pallas_scan import (
    scan_probed_lists_pallas_grouped as j_grouped,
)
from cuda_acceleratedvectordatabaseengine_tpu.ops.scan import (
    scan_probed_lists as j_gather,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import grouped_scan
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.grouped_scan import (
    _grouped_rows_reference,
    _n_rows_bound,
    _pack_pairs_into_rows,
    auto_m_budget,
    scan_probed_lists_grouped,
    scan_probed_lists_grouped_reference,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.scan import (
    scan_probed_lists,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)


def _make(rng, dtype, metric, nlist=8, cap=128, dim=32, batch=12, nprobe=4,
          short_lists=True, max_count=None):
    """Arena state in numpy for both packages: stored rows, their fp32
    squared norms, and (int8) per-row scales with residual anchors."""
    x = rng.standard_normal((nlist, cap, dim)).astype(np.float32)
    q = rng.standard_normal((batch, dim)).astype(np.float32)
    if metric == "Cosine":
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    counts = rng.integers(1, (max_count or cap) + 1, nlist).astype(np.int32)
    if short_lists:
        counts[:2] = [0, 3]                 # shorter than k
    scale = anchors = None
    if dtype == "int8":
        anchors = 0.3 * rng.standard_normal((nlist, dim)).astype(np.float32)
        res = x - anchors[:, None, :]
        scale = (np.maximum(np.abs(res).max(-1), 1e-12) / 127.0).astype(
            np.float32)
        stored = np.clip(np.round(res / scale[..., None]), -127, 127).astype(
            np.int8)
        deq = stored.astype(np.float32) * scale[..., None] + anchors[:, None]
    elif dtype == "bfloat16":
        stored = x.astype(ml_dtypes.bfloat16)
        deq = stored.astype(np.float32)
    else:
        stored = deq = x
    sq = (deq * deq).sum(-1).astype(np.float32)
    probe = np.stack([rng.choice(nlist, nprobe, replace=False)
                      for _ in range(batch)]).astype(np.int32)
    probe[0, -1] = -1
    probe[5, :2] = -1
    return dict(q=q, stored=stored, sq=sq, counts=counts, probe=probe,
                scale=scale, anchors=anchors)


def _torch_args(s):
    st = s["stored"]
    arena = (torch.from_numpy(st.astype(np.float32)).to(torch.bfloat16)
             if st.dtype == ml_dtypes.bfloat16 else torch.from_numpy(st))
    opt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return (torch.from_numpy(s["q"]), arena, torch.from_numpy(s["sq"]),
            torch.from_numpy(s["counts"]), torch.from_numpy(s["probe"])), \
        dict(arena_scale=opt(s["scale"]), arena_anchors=opt(s["anchors"]))


def _jax_args(s, widen_bf16=False):
    st = s["stored"]
    if widen_bf16 and st.dtype == ml_dtypes.bfloat16:
        # The JAX gather scan rounds the query to bf16 on a bf16 arena; the
        # port keeps the query fp32 (as the Pallas kernels do), so the
        # gather reference gets the same stored values widened to fp32.
        st = st.astype(np.float32)
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return (jnp.asarray(s["q"]), jnp.asarray(st), jnp.asarray(s["sq"]),
            jnp.asarray(s["counts"]), jnp.asarray(s["probe"])), \
        dict(arena_scale=opt(s["scale"]), arena_anchors=opt(s["anchors"]))


def _atol(s, metric):
    # fp32 dots summed in another order: error scales with ‖q‖²
    return 1e-5 * (s["q"] ** 2).sum(1) if metric != "Cosine" else 1e-5


def _np(res):
    return [np.asarray(a) for a in res]


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_scans_match_jax(rng, dtype, metric):
    s = _make(rng, dtype, metric)
    k = 6
    m = 8 if metric == "L2" else 16
    targs, tkw = _torch_args(s)
    jm = JMetric.parse(metric)
    tm = Metric.parse(metric)
    jgs = _np(j_gather(*_jax_args(s, widen_bf16=True)[0], k, jm,
                       **_jax_args(s)[1]))
    jpg = _np(j_grouped(*_jax_args(s)[0], k, jm, interpret=True, m_budget=m,
                        **_jax_args(s)[1]))
    tgs = _np(scan_probed_lists(*targs, k, tm, **tkw))
    tgr = _np(scan_probed_lists_grouped_reference(*targs, k, tm, m_budget=m,
                                                  **tkw))
    atol = _atol(s, metric)
    for port in (tgs, tgr):
        for ref in (jgs, jpg):
            assert_topk_match(*port, *ref, rtol=1e-5, atol=atol)
    # row 5 probes two lists only; short list 0 contributes nothing
    assert tgr[1].dtype == np.int32 and (tgr[1] >= -1).all()


def test_hot_list_spans_several_rows(rng):
    """Many queries on one list (more than one list-row) stay exact."""
    s = _make(rng, "int8", "L2", nlist=4, batch=40, nprobe=2,
              short_lists=False)
    s["probe"][:, 0] = 1                     # every query probes list 1
    s["probe"][:, 1] = np.where(np.arange(40) % 2, 0, 2)
    targs, tkw = _torch_args(s)
    pack = _pack_pairs_into_rows(targs[4], 4, 8, 80)
    assert int((pack.row_list == 1).sum()) == 5      # 40 queries / m=8
    k = 5
    ref = _np(j_grouped(*_jax_args(s)[0], k, JMetric.L2, interpret=True,
                        m_budget=8, **_jax_args(s)[1]))
    got = _np(scan_probed_lists_grouped_reference(*targs, k, Metric.L2,
                                                  m_budget=8, **tkw))
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s, "L2"))


@pytest.mark.parametrize("nlist, m, batch, nprobe", [
    (4, 8, 6, 2), (16, 8, 64, 4), (64, 32, 37, 8), (7, 64, 1, 3),
    (256, 16, 64, 32),
])
def test_pack_counts_read_nothing_back(rng, monkeypatch, nlist, m, batch,
                                       nprobe):
    """The pack's list counts (``index_add_`` of ones: no read-back to
    the host) equal ``bincount(minlength=nlist + 1)``, and the whole pack
    equals the pack built on ``bincount``'s counts, with invalid probes
    (-1, key ``nlist``) and a list that every query probes."""
    probe = rng.integers(0, nlist, (batch, nprobe))
    probe[rng.random(probe.shape) < 0.2] = -1
    probe[:, 0] = nlist - 1                  # probed by every query
    probe = torch.from_numpy(probe).int()
    key = probe.reshape(-1).long()
    key_sorted = torch.where(key >= 0, key, nlist).sort(stable=True)[0]
    counts = grouped_scan._group_counts(key_sorted, nlist + 1)
    want = torch.bincount(key_sorted, minlength=nlist + 1)
    assert counts.dtype == want.dtype and torch.equal(counts, want)
    n_rows = _n_rows_bound(batch * nprobe, nlist, m)
    new = _pack_pairs_into_rows(probe, nlist, m, n_rows)
    monkeypatch.setattr(grouped_scan, "_group_counts",
                        lambda k, n: torch.bincount(k, minlength=n))
    old = _pack_pairs_into_rows(probe, nlist, m, n_rows)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_scan_capacity_prefix(rng):
    """Scanning only the occupied prefix gives the full-capacity result."""
    s = _make(rng, "float32", "L2", cap=384, max_count=200)
    targs, tkw = _torch_args(s)
    k = 8
    full = _np(scan_probed_lists_grouped_reference(*targs, k, Metric.L2,
                                                   m_budget=8, **tkw))
    pref = _np(scan_probed_lists_grouped_reference(
        *targs, k, Metric.L2, m_budget=8,
        scan_capacity=int(s["counts"].max()), **tkw))
    ref = _np(j_grouped(*_jax_args(s)[0], k, JMetric.L2, interpret=True,
                        m_budget=8, scan_capacity=int(s["counts"].max()),
                        **_jax_args(s)[1]))
    np.testing.assert_array_equal(pref[0], full[0])
    assert_topk_match(*pref, *ref, rtol=1e-5, atol=_atol(s, "L2"))


def test_rows_reference_contract(rng):
    """Per-row outputs: ascending, ties to the smaller slot, (+inf, -1)
    for empty query slots, sentinel rows and lists shorter than k."""
    s = _make(rng, "float32", "InnerProduct", nlist=4, batch=6, nprobe=2)
    targs, _ = _torch_args(s)
    q, arena, sq, counts, probe = targs
    arena[2, 10] = arena[2, 4]               # an exact tie inside list 2
    pack = _pack_pairs_into_rows(probe, 4, 8, 6)
    out_d, out_s = _grouped_rows_reference(
        q, arena, sq, counts, pack.row_list, pack.qrow_table, 5,
        Metric.INNER_PRODUCT, 128,
    )
    d, sl = out_d.numpy(), out_s.numpy()
    fin = np.isfinite(d)
    assert (sl[~fin] == -1).all() and (sl[fin] >= 0).all()
    assert (np.diff(np.where(fin, d, 3e38), axis=-1) >= 0).all()
    sentinel = pack.row_list.numpy() >= 4
    assert not fin[sentinel].any()
    assert not fin[pack.qrow_table.numpy() < 0].any()
    short = pack.row_list.numpy() == 1       # list 1 holds 3 rows
    if short.any():
        assert fin[short].sum(-1).max() <= 3
    # tie: slot 4 is listed before slot 10 wherever both appear
    for r, mm in zip(*np.nonzero(pack.row_list.numpy()[:, None] == 2)):
        row = sl[r, mm].tolist()
        if 4 in row and 10 in row:
            assert row.index(4) < row.index(10)


def test_cpu_wrapper_takes_plain_version(rng):
    s = _make(rng, "int8", "L2")
    targs, tkw = _torch_args(s)
    before = grouped_scan.LAUNCHES
    a = scan_probed_lists_grouped(*targs, 5, Metric.L2, m_budget=8, **tkw)
    b = scan_probed_lists_grouped_reference(*targs, 5, Metric.L2,
                                            m_budget=8, **tkw)
    assert grouped_scan.LAUNCHES == before == 0
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


@pytest.mark.parametrize("pairs,nlist,expect", [
    (64, 4096, 8), (4 * 4096, 4096, 16), (32 * 1024, 1024, 48),
    (10 ** 7, 16, 64),
])
def test_auto_m_budget_matches_jax(pairs, nlist, expect):
    from cuda_acceleratedvectordatabaseengine_tpu.ops.pallas_scan import (
        auto_m_budget as j_auto,
    )

    assert auto_m_budget(pairs, nlist) == j_auto(pairs, nlist) == expect
