"""PyTorch port, the grouped ADC scan (kernel K2's plain version) against
the JAX package's Pallas kernel ``scan_probed_codes_pallas_grouped`` in
interpret mode, and the port's gather ADC against the JAX package's XLA ADC,
on identical numpy state (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu.models.ivf_pq import (
    _ivf_pq_search_device as j_search,
)
from cuda_acceleratedvectordatabaseengine_tpu.ops.distance import (
    Metric as JMetric,
)
from cuda_acceleratedvectordatabaseengine_tpu.ops.pallas_scan import (
    scan_probed_codes_pallas_grouped as j_grouped_pq,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_pq import (
    _ivf_pq_search_device as t_search,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import (
    grouped_pq_scan,
    grouped_scan,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.grouped_pq_scan import (
    _pq_pair_rows_reference,
    scan_probed_codes_grouped,
    scan_probed_codes_grouped_reference,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)

NLIST, MSUB, DSUB = 8, 4, 8
DIM = MSUB * DSUB


def _make(rng, nlist=NLIST, cap=128, batch=12, nprobe=4, max_count=None,
          msub=MSUB, dsub=DSUB, short_lists=True):
    """PQ state in numpy for both packages: codes, codebooks, centroids,
    the stored norms ‖c_l + r̂‖², counts with short lists, queries and
    probes with −1 entries."""
    dim = msub * dsub
    cb = (0.5 * rng.standard_normal((msub, 256, dsub))).astype(np.float32)
    cen = rng.standard_normal((nlist, dim)).astype(np.float32)
    codes_t = rng.integers(0, 256, (nlist, msub, cap)).astype(np.uint8)
    dec = cb[np.arange(msub)[None, :, None], codes_t.astype(np.int64)]
    x = dec.transpose(0, 2, 1, 3).reshape(nlist, cap, dim) + cen[:, None]
    code_sq = (x * x).sum(-1).astype(np.float32)
    counts = rng.integers(1, (max_count or cap) + 1, nlist).astype(np.int32)
    if short_lists:
        counts[:2] = [0, 3]                  # shorter than k
    q = (cen[rng.integers(0, nlist, batch)]
         + rng.standard_normal((batch, dim))).astype(np.float32)
    probe = np.stack([rng.choice(nlist, nprobe, replace=False)
                      for _ in range(batch)]).astype(np.int32)
    probe[0, -1] = -1
    probe[5, :2] = -1
    return dict(q=q, codes_t=codes_t, code_sq=code_sq, counts=counts,
                cen=cen, cb=cb, probe=probe)


_ORDER = ("q", "codes_t", "code_sq", "counts", "cen", "cb", "probe")


def _targs(s):
    return tuple(torch.from_numpy(s[n].copy()) for n in _ORDER)


def _jargs(s):
    return tuple(jnp.asarray(s[n]) for n in _ORDER)


def _atol(s):
    # fp32 dots summed in another order: error scales with ‖q‖²
    return 1e-5 * (s["q"] ** 2).sum(1)


def _np(res):
    return [np.asarray(a) for a in res]


@pytest.mark.parametrize("mode", ["topk", "k_inner", "emit_full"])
@pytest.mark.parametrize("metric", ["L2", "InnerProduct"])
def test_grouped_pq_scan_matches_jax(rng, metric, mode):
    s = _make(rng)
    k = 40 if mode == "emit_full" else 10
    kw = {}
    if mode == "k_inner":
        kw["k_inner"] = 4
    if mode == "emit_full":
        kw["emit_full"] = True
    ref = _np(j_grouped_pq(*_jargs(s), k, JMetric.parse(metric),
                           interpret=True, m_budget=8, **kw))
    got = _np(scan_probed_codes_grouped_reference(
        *_targs(s), k, Metric.parse(metric), **kw))
    assert got[0].shape == got[1].shape == (12, k)
    assert got[1].dtype == np.int32
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s))
    if mode == "k_inner":
        # the per-list shortlist holds at most k_inner candidates per list
        for row in got[1]:
            lists = row[row >= 0] // 128
            assert np.bincount(lists).max() <= 4


def test_hot_list_spans_several_rows(rng):
    """Many queries on one list (more than one list-row) stay exact."""
    s = _make(rng, nlist=4, batch=40, nprobe=2, short_lists=False)
    s["probe"][:, 0] = 1                     # every query probes list 1
    s["probe"][:, 1] = np.where(np.arange(40) % 2, 0, 2)
    k = 5
    ref = _np(j_grouped_pq(*_jargs(s), k, JMetric.L2, interpret=True,
                           m_budget=8))
    got = _np(scan_probed_codes_grouped_reference(*_targs(s), k, Metric.L2))
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s))


@pytest.mark.parametrize("emit_full", [False, True])
def test_scan_capacity_prefix(rng, emit_full):
    """Scanning only the occupied prefix gives the full-capacity result."""
    s = _make(rng, cap=384, max_count=200)
    k = 40 if emit_full else 8
    kw = dict(emit_full=emit_full)
    full = _np(scan_probed_codes_grouped_reference(*_targs(s), k, Metric.L2,
                                                   **kw))
    scap = int(s["counts"].max())
    pref = _np(scan_probed_codes_grouped_reference(
        *_targs(s), k, Metric.L2, scan_capacity=scap, **kw))
    ref = _np(j_grouped_pq(*_jargs(s), k, JMetric.L2, interpret=True,
                           m_budget=8, scan_capacity=scap, **kw))
    np.testing.assert_array_equal(pref[0], full[0])
    assert_topk_match(*pref, *ref, rtol=1e-5, atol=_atol(s))


def test_odd_subspace_width(rng):
    """dsub 5 (D 30 with m 6): the kernel's unaligned decode path."""
    s = _make(rng, msub=6, dsub=5, batch=8, nprobe=3)
    ref = _np(j_grouped_pq(*_jargs(s), 7, JMetric.L2, interpret=True,
                           m_budget=8))
    got = _np(scan_probed_codes_grouped_reference(*_targs(s), 7, Metric.L2))
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s))


def test_rows_reference_contract(rng):
    """Per-pair outputs in both modes, in (b, p) order: top-k ascending
    with ties to the smaller slot and (+inf, -1) padding; full rows +inf
    past each list's end and on pairs of probe -1."""
    s = _make(rng, nlist=4, batch=6, nprobe=2)
    q, codes_t, code_sq, counts, cen, cb, probe = _targs(s)
    codes_t[2, :, 10] = codes_t[2, :, 4]     # an exact tie inside list 2
    code_sq[2, 10] = code_sq[2, 4]
    args = (q, codes_t, code_sq, counts, cen, cb, probe)
    out_d, out_s = _pq_pair_rows_reference(*args, 5, Metric.L2, 128)
    full_d, none = _pq_pair_rows_reference(*args, 5, Metric.L2, 128,
                                           emit_full=True)
    assert none is None and full_d.shape == (12, 128)
    assert out_d.shape == out_s.shape == (12, 5)
    d, sl, fd = out_d.numpy(), out_s.numpy(), full_d.numpy()
    fin = np.isfinite(d)
    assert (sl[~fin] == -1).all() and (sl[fin] >= 0).all()
    assert (np.diff(np.where(fin, d, 3e38), axis=-1) >= 0).all()
    lists = s["probe"].reshape(-1)
    dead = lists < 0
    assert dead.any()
    assert not fin[dead].any() and not np.isfinite(fd[dead]).any()
    past_end = np.arange(128)[None, :] >= counts.numpy()[lists.clip(0)][:,
                                                                       None]
    assert not np.isfinite(fd[past_end]).any()
    assert np.isfinite(fd[~past_end & ~dead[:, None]]).all()
    # the top-k rows are the sorted heads of the full rows
    np.testing.assert_array_equal(np.sort(fd[~dead], -1)[:, :5], d[~dead])
    for pair in np.nonzero(lists == 2)[0]:
        row = sl[pair].tolist()
        if 4 in row and 10 in row:
            assert row.index(4) < row.index(10)


def test_cpu_wrapper_takes_plain_version(rng):
    s = _make(rng)
    before = grouped_pq_scan.LAUNCHES
    for kw in (dict(), dict(emit_full=True), dict(k_inner=3)):
        a = scan_probed_codes_grouped(*_targs(s), 6, Metric.L2, **kw)
        b = scan_probed_codes_grouped_reference(*_targs(s), 6, Metric.L2,
                                                **kw)
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
        np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    assert grouped_pq_scan.LAUNCHES == before == 0


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_gather_adc_matches_jax_xla_adc(rng, metric):
    """The port's search device half on the gather ADC (coarse probe, ADC,
    cosine halving) against the JAX package's XLA path, at the bound the
    JAX package holds its own two ADC paths to (rtol = atol = 2e-4)."""
    s = _make(rng, short_lists=True)
    if metric == "Cosine":
        s["q"] /= np.linalg.norm(s["q"], axis=1, keepdims=True)
    nprobe, k = 5, 8
    jm = JMetric.parse(metric)
    ref = _np(j_search(jnp.asarray(s["q"]), jnp.asarray(s["cen"]),
                       jnp.asarray(s["cb"]), jnp.asarray(s["codes_t"]),
                       jnp.asarray(s["code_sq"]), jnp.asarray(s["counts"]),
                       None, None, None, None, nprobe, k, jm, 0, "xla"))
    got = _np(t_search(*(torch.from_numpy(s[n].copy()) for n in (
        "q", "cen", "cb", "codes_t", "code_sq", "counts")),
        None, None, None, None, nprobe, k, Metric.parse(metric), 0,
        "gather"))
    assert_topk_match(*got, *ref, rtol=2e-4, atol=2e-4)


def test_k1_epilogue_unchanged_by_k_inner(rng):
    """K1's results: the epilogue with k_inner = k (or None) is the old
    epilogue, and shallower rows with k_inner give the same best hit."""
    nlist, cap, dim, batch, nprobe, k = 8, 128, 16, 10, 4, 6
    arena = torch.from_numpy(rng.standard_normal((nlist, cap, dim)).astype(
        np.float32))
    sq = (arena * arena).sum(-1)
    counts = torch.from_numpy(rng.integers(20, cap, nlist).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((batch, dim)).astype(np.float32))
    probe = torch.from_numpy(np.stack([
        rng.choice(nlist, nprobe, replace=False) for _ in range(batch)
    ]).astype(np.int32))
    pack = grouped_scan._pack_pairs_into_rows(probe, nlist, 8, 12)
    rows = grouped_scan._grouped_rows_reference(
        q, arena, sq, counts, pack.row_list, pack.qrow_table, k, Metric.L2,
        cap)
    args = (pack, batch, nprobe, k, nlist, cap, 1, 0)
    base = grouped_scan._grouped_epilogue(*rows, *args)
    for ki in (None, k):
        got = grouped_scan._grouped_epilogue(*rows, *args, k_inner=ki)
        np.testing.assert_array_equal(got[0].numpy(), base[0].numpy())
        np.testing.assert_array_equal(got[1].numpy(), base[1].numpy())
    whole = grouped_scan.scan_probed_lists_grouped_reference(
        q, arena, sq, counts, probe, k, Metric.L2, m_budget=8)
    np.testing.assert_array_equal(whole[1].numpy(), base[1].numpy())
    shallow = grouped_scan._grouped_rows_reference(
        q, arena, sq, counts, pack.row_list, pack.qrow_table, 2, Metric.L2,
        cap)
    short = grouped_scan._grouped_epilogue(*shallow, *args, k_inner=2)
    np.testing.assert_array_equal(short[1].numpy()[:, 0],
                                  base[1].numpy()[:, 0])
