"""PyTorch port, the table form of the grouped ADC scan (kernel K2 on the
GPU): the plain version of the table kernel against numpy float64, and a
CPU model of the scan kernel's arithmetic (fp32 table entries, each an
in-order sum over ``dsub``; the entries of a slot's codes added in subspace
order; plus ``q · centroid``) against the port's plain decode-and-dot
version and against the JAX package's Pallas kernel in interpret mode, on
the same numpy inputs.

Tolerance: ``1e-5 · |d| + 1e-5 · ‖q‖²``. All three compute the same fp32
distance from sums taken in different orders (one D-long dot; ``m`` partial
dots of ``dsub`` added afterwards), and the rounding of such a sum scales
with the products' size, which ``‖q‖²`` bounds here (``‖q‖ ≈ ‖x‖``)."""

import numpy as np
import pytest
import torch
from test_torch_pq_scan import _atol, _jargs, _make, _np, _targs

from cuda_acceleratedvectordatabaseengine_tpu.ops.distance import (
    Metric as JMetric,
)
from cuda_acceleratedvectordatabaseengine_tpu.ops.pallas_scan import (
    scan_probed_codes_pallas_grouped as j_grouped_pq,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import (
    grouped_pq_scan as gps,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)


def _table_model(q, cb):
    """The table kernel's sums: fp32, ``e`` ascending, one thread a
    codeword."""
    msub, ks, dsub = cb.shape
    qs = q.reshape(q.shape[0], msub, 1, dsub)
    acc = torch.zeros((q.shape[0], msub, ks), dtype=torch.float32)
    for e in range(dsub):
        acc = acc + qs[..., e] * cb[None, :, :, e]
    return acc


def _pair_rows_table_model(q, codes_t, code_sq, counts, centroids, codebooks,
                           probe, k, metric, cap_s, emit_full=False):
    """CPU model of the scan kernel, same contract as
    ``_pq_pair_rows_reference``: per pair ``qx = (Σ_j T[b, j, code_j]) +
    q·centroid`` with the table entries added in subspace order in fp32."""
    batch, nprobe = probe.shape
    nlist, msub, _ = codes_t.shape
    table = _table_model(q, codebooks)
    width = cap_s if emit_full else k
    out_d = torch.full((batch * nprobe, width), float("inf"))
    out_s = None if emit_full else torch.full((batch * nprobe, k), -1,
                                              dtype=torch.int32)
    for b in range(batch):
        qsq = (q[b] * q[b]).sum()
        for p in range(nprobe):
            lst = int(probe[b, p])
            if lst < 0 or lst >= nlist:
                continue
            lim = min(int(counts[lst]), cap_s)
            acc = torch.zeros(lim, dtype=torch.float32)
            for j in range(msub):
                acc = acc + table[b, j, codes_t[lst, j, :lim].long()]
            qx = acc + (q[b] * centroids[lst]).sum()
            if metric == Metric.L2:
                d = (qsq - 2.0 * qx + code_sq[lst, :lim]).clamp_min(0.0)
            elif metric == Metric.INNER_PRODUCT:
                d = -qx
            else:
                d = 1.0 - qx
            row = b * nprobe + p
            if emit_full:
                out_d[row, :lim] = d
                continue
            vals, cols = torch.sort(d, stable=True)
            kk = min(k, lim)
            out_d[row, :kk] = vals[:kk]
            out_s[row, :kk] = cols[:kk].int()
    return out_d, out_s


def _scan_model(s, k, metric, **kw):
    return _np(gps._scan_codes_grouped(
        _pair_rows_table_model, *_targs(s), k, metric,
        kw.pop("slot_stride", 1), kw.pop("slot_offset", 0),
        kw.pop("global_capacity", None), kw.pop("k_inner", None),
        kw.pop("emit_full", False), kw.pop("scan_capacity", None)))


@pytest.mark.parametrize("msub,dsub,batch", [(4, 8, 12), (6, 5, 3), (3, 4, 1),
                                             (16, 1, 5)])
def test_tables_reference_matches_float64(rng, msub, dsub, batch):
    """``T[b, j, c] = Σ_e q[b, j·dsub + e] · codebooks[j, c, e]``: the plain
    version and the model of the kernel's sum order against float64."""
    cb = rng.standard_normal((msub, 256, dsub)).astype(np.float32)
    q = rng.standard_normal((batch, msub * dsub)).astype(np.float32)
    want = np.einsum("bje,jce->bjc",
                     q.astype(np.float64).reshape(batch, msub, dsub),
                     cb.astype(np.float64))
    # fp32 sums of dsub products of size ≤ |q_j|·|c|
    bound = 1e-6 * np.einsum(
        "bje,jce->bjc", np.abs(q).reshape(batch, msub, dsub), np.abs(cb))
    for fn in (gps._pq_tables_reference, _table_model):
        got = fn(torch.from_numpy(q), torch.from_numpy(cb))
        assert got.shape == (batch, msub, 256) and got.dtype == torch.float32
        assert (np.abs(got.numpy() - want) <= bound + 1e-12).all()


def test_table_sum_is_the_decoded_dot(rng):
    """Σ_j T[b, j, code_j] is q · (decoded residual): the identity the
    kernel rests on, in float64."""
    s = _make(rng, msub=6, dsub=5)
    cb, q = s["cb"].astype(np.float64), s["q"].astype(np.float64)
    codes = s["codes_t"][3].astype(np.int64)                  # [m, cap]
    dec = cb[np.arange(6)[:, None], codes]                    # [m, cap, dsub]
    dot = np.einsum("be,ce->bc", q, dec.transpose(1, 0, 2).reshape(-1, 30))
    table = np.einsum("bje,jce->bjc", q.reshape(-1, 6, 5), cb)
    summed = table[:, np.arange(6)[:, None], codes].sum(1)
    np.testing.assert_allclose(summed, dot, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["topk", "k_inner", "emit_full"])
@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
@pytest.mark.parametrize("msub,dsub", [(4, 4), (6, 5)])
def test_table_model_matches_plain_and_jax(rng, msub, dsub, metric, mode):
    """The kernel's arithmetic against the plain decode-and-dot version and
    the JAX kernel (interpret), with -1 probes, an empty list and lists
    shorter than k."""
    s = _make(rng, msub=msub, dsub=dsub, batch=8, nprobe=3)
    if metric == "Cosine":
        s["q"] /= np.linalg.norm(s["q"], axis=1, keepdims=True)
    k = 40 if mode == "emit_full" else 10
    kw = {}
    if mode == "k_inner":
        kw["k_inner"] = 4
    if mode == "emit_full":
        kw["emit_full"] = True
    tm = Metric.parse(metric)
    model = _scan_model(s, k, tm, **kw)
    plain = _np(gps.scan_probed_codes_grouped_reference(*_targs(s), k, tm,
                                                        **kw))
    ref = _np(j_grouped_pq(*_jargs(s), k, JMetric.parse(metric),
                           interpret=True, m_budget=8, **kw))
    assert model[0].shape == model[1].shape == (8, k)
    assert_topk_match(*model, *plain, rtol=1e-5, atol=_atol(s))
    assert_topk_match(*model, *ref, rtol=1e-5, atol=_atol(s))


def test_table_model_list_past_counts_and_prefix(rng):
    """Slots at or past a list's count never appear, and scanning only the
    occupied prefix changes nothing (both modes)."""
    s = _make(rng, cap=384, max_count=200, batch=6, nprobe=3)
    s["codes_t"][:, :, 200:] = 0      # stale codes past every count ...
    s["code_sq"][:, 200:] = -1e9      # ... that would win if they were read
    scap = int(s["counts"].max())
    for kw in (dict(), dict(emit_full=True)):
        k = 40 if kw else 8
        full = _scan_model(s, k, Metric.L2, **kw)
        pref = _scan_model(s, k, Metric.L2, scan_capacity=scap, **kw)
        np.testing.assert_array_equal(full[0], pref[0])
        np.testing.assert_array_equal(full[1], pref[1])
        ref = _np(j_grouped_pq(*_jargs(s), k, JMetric.L2, interpret=True,
                               m_budget=8, scan_capacity=scap, **kw))
        assert_topk_match(*pref, *ref, rtol=1e-5, atol=_atol(s))
        pos = pref[1][pref[1] >= 0]
        assert (pos % 384 < s["counts"][pos // 384]).all()


def test_pair_rows_model_equals_plain_rows(rng):
    """Per-pair rows of the model and of the plain version: +inf in the same
    places, finite entries within the tolerance, (b, p) order."""
    s = _make(rng, nlist=4, batch=6, nprobe=2)
    args = _targs(s)
    atol = float(_atol(s).max())
    for emit_full in (False, True):
        md, ms = _pair_rows_table_model(*args, 5, Metric.L2, 128,
                                        emit_full=emit_full)
        pd, ps = gps._pq_pair_rows_reference(*args, 5, Metric.L2, 128,
                                             emit_full=emit_full)
        fm, fp = torch.isfinite(md), torch.isfinite(pd)
        assert torch.equal(fm, fp)
        assert float((md[fm] - pd[fp]).abs().max()) <= atol
        if not emit_full:
            assert torch.equal(ms < 0, ps < 0)


@pytest.mark.parametrize("batch,nprobe,want", [
    (512, 32, 32), (1, 32, 1), (16, 32, 2), (64, 8, 2), (4096, 32, 32),
    (1, 1, 1), (100, 20, 7)])
def test_probes_per_cta(batch, nprobe, want):
    """The grid rule on a 132-SM card: a small batch splits its probes until
    the grid fills two CTAs an SM; a large one keeps a query's probes in as
    few CTAs as its 8 warps allow."""
    ppc = gps.probes_per_cta(batch, nprobe, 132)
    assert ppc == want
    assert 1 <= ppc <= nprobe


def test_table_fits_smem_by_shape():
    assert gps.table_fits_smem(96, 768)
    assert gps.table_fits_smem(224, 768)
    assert not gps.table_fits_smem(256, 512)
    # the chunk rule: a table transient of at most TABLE_BYTES
    assert gps.TABLE_BYTES // (96 * gps.KS * 4) == 2730
