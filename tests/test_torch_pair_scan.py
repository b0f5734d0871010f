"""PyTorch port, the pair full-row scan (K4): its plain version against the
JAX package's Pallas pair kernel in interpret mode, on the same numpy
inputs (CPU). K4 recomputes each slot's norm from the stored block and
takes no scale or anchor, so it is held to the JAX K4, not to K1. On the
GPU int8 and bf16 arenas run packed into list-rows (K3's packing) with each
list's norms formed once from its block: the plain version of that packed
step is held to the pair-order plain version and to the JAX kernel."""

import numpy as np
import pytest
import torch
from test_torch_scan import _atol, _jax_args, _make, _np, _torch_args

from cuda_acceleratedvectordatabaseengine_tpu.ops.distance import (
    Metric as JMetric,
)
from cuda_acceleratedvectordatabaseengine_tpu.ops.pallas_scan import (
    scan_probed_lists_pallas as j_pairs,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import pair_scan
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.pair_scan import (
    _pair_list_rows_reference,
    _pair_rows_reference,
    _scan_pairs,
    scan_probed_lists_pairs,
    scan_probed_lists_pairs_reference,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.sorted_scan import (
    _pair_table,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)


def _atol_raw(s, metric):
    """An int8 arena is scanned as raw codes (|x| up to 127): the fp32
    rounding scale is ‖q‖·‖x‖ and ‖x‖², not ‖q‖²."""
    if s["stored"].dtype != np.int8:
        return _atol(s, metric)
    x = s["stored"].astype(np.float32)
    xmax = (x * x).sum(-1).max()
    return 1e-5 * (np.sqrt((s["q"] ** 2).sum(1) * xmax) + xmax)


def _both(s, k, metric, **extra):
    targs, _ = _torch_args(s)
    jargs, _ = _jax_args(s)
    ref = _np(j_pairs(*jargs, k, JMetric.parse(metric), interpret=True,
                      **extra))
    got = _np(scan_probed_lists_pairs(*targs, k, Metric.parse(metric),
                                      **extra))
    return got, ref


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_pairs_match_jax(rng, dtype, metric):
    """Every metric over fp32 / bf16 arenas and raw int8 codes, with -1
    probes and lists shorter than k."""
    s = _make(rng, dtype, metric)
    got, ref = _both(s, 6, metric)
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol_raw(s, metric))
    assert got[1].dtype == np.int32 and got[0].shape == (12, 6)


def test_pairs_ignore_arena_sq(rng):
    """A deliberately wrong ``arena_sq`` changes neither package's result:
    the norms come from the stored block."""
    s = _make(rng, "bfloat16", "L2")
    good, ref = _both(s, 6, "L2")
    s["sq"] = np.full_like(s["sq"], 1e6)
    bad, ref_bad = _both(s, 6, "L2")
    np.testing.assert_array_equal(good[0], bad[0])
    np.testing.assert_array_equal(good[1], bad[1])
    np.testing.assert_array_equal(ref[0], ref_bad[0])
    assert_topk_match(*bad, *ref_bad, rtol=1e-5, atol=_atol(s, "L2"))


def test_pairs_scan_capacity_and_striping(rng):
    s = _make(rng, "float32", "L2", cap=384, max_count=200)
    got, ref = _both(s, 8, "L2", scan_capacity=int(s["counts"].max()))
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s, "L2"))
    s = _make(rng, "bfloat16", "InnerProduct")
    s["counts"] = (2 * s["counts"]).astype(np.int32)
    extra = dict(slot_stride=2, slot_offset=0, global_capacity=256)
    got, ref = _both(s, 6, "InnerProduct", **extra)
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s, "InnerProduct"))
    assert (got[1][got[1] >= 0] % 2 == 0).all()


def test_pairs_deep_k_pads(rng):
    s = _make(rng, "float32", "L2", batch=6, nprobe=2, max_count=40)
    got, ref = _both(s, 100, "L2")
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s, "L2"))
    assert (got[1][~np.isfinite(got[0])] == -1).all()


def test_pair_rows_contract(rng):
    """Row b·P + p holds query b against list probe[b, p], norms from the
    block, +inf past the count and for -1 probes."""
    s = _make(rng, "bfloat16", "L2", nlist=4, batch=6, nprobe=2)
    targs, _ = _torch_args(s)
    q, arena, _, counts, probe = targs
    rows = _pair_rows_reference(q, arena, counts, probe, Metric.L2,
                                128).numpy().reshape(6, 2, 128)
    x = s["stored"].astype(np.float32)
    for b in range(6):
        for p in range(2):
            l = s["probe"][b, p]
            if l < 0:
                assert np.isinf(rows[b, p]).all()
                continue
            c = s["counts"][l]
            d = ((s["q"][b] - x[l, :c]) ** 2).sum(-1)
            np.testing.assert_allclose(rows[b, p, :c], d, rtol=1e-4,
                                       atol=1e-4)
            assert np.isinf(rows[b, p, c:]).all()


def test_pairs_cpu_wrapper_takes_plain_version(rng):
    s = _make(rng, "bfloat16", "Cosine")
    targs, _ = _torch_args(s)
    before = pair_scan.LAUNCHES
    a = scan_probed_lists_pairs(*targs, 5, Metric.COSINE)
    b = scan_probed_lists_pairs_reference(*targs, 5, Metric.COSINE)
    assert pair_scan.LAUNCHES == before == 0
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


def _packed_rows(m):
    """The row step as the GPU path of int8 / bf16 arenas runs it: pairs
    sorted by list and packed into list-rows of width ``m``, block norms
    once per list."""
    def rows(q, arena, counts, probe, metric, cap_s):
        row_list, table = _pair_table(probe, arena.shape[0], m)
        return _pair_list_rows_reference(q, arena, counts, row_list, table,
                                         probe.shape[1], probe.numel(),
                                         metric, cap_s)
    return rows


@pytest.mark.parametrize("m", [1, 4, 64])
@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_list_row_packing_with_block_norms(rng, dtype, metric, m):
    """List-rows with block norms give the rows of the pair-order plain
    version (same +inf places: -1 probes, an empty list, slots past the
    count) and the top-k of the JAX pair kernel (interpret), on raw int8
    codes, bf16 and fp32 arenas, at a width below, at and above a list's
    share of the pairs."""
    s = _make(rng, dtype, metric)
    targs, _ = _torch_args(s)
    q, arena, sq, counts, probe = targs
    tm = Metric.parse(metric)
    cap = arena.shape[1]
    packed = _packed_rows(m)(q, arena, counts, probe, tm, cap)
    pairs = _pair_rows_reference(q, arena, counts, probe, tm, cap)
    assert packed.shape == pairs.shape == (probe.numel(), cap)
    fk, fp = torch.isfinite(packed), torch.isfinite(pairs)
    assert torch.equal(fk, fp)
    atol = float(np.max(_atol_raw(s, metric)))
    assert float((packed[fk] - pairs[fp]).abs().max()) <= atol
    got = _np(_scan_pairs(_packed_rows(m), q, arena, counts, probe, 6, tm,
                          1, 0, None, None))
    jargs, _ = _jax_args(s)
    ref = _np(j_pairs(*jargs, 6, JMetric.parse(metric), interpret=True))
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol_raw(s, metric))


def test_list_row_packing_hot_list_and_prefix(rng):
    """A list probed by every query (several list-rows) and a scanned
    prefix shorter than the capacity."""
    s = _make(rng, "bfloat16", "L2", nlist=4, batch=40, nprobe=2, cap=384,
              max_count=200, short_lists=False)
    s["probe"][:, 0] = 1
    s["probe"][:, 1] = np.where(np.arange(40) % 2, 0, 2)
    targs, _ = _torch_args(s)
    q, arena, sq, counts, probe = targs
    scap = int(s["counts"].max())
    got = _np(_scan_pairs(_packed_rows(8), q, arena, counts, probe, 8,
                          Metric.L2, 1, 0, None, scap))
    jargs, _ = _jax_args(s)
    ref = _np(j_pairs(*jargs, 8, JMetric.L2, interpret=True,
                      scan_capacity=scap))
    assert_topk_match(*got, *ref, rtol=1e-5, atol=_atol(s, "L2"))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_kernel_path_packs_every_dtype_into_list_rows(rng, dtype,
                                                     monkeypatch):
    """The CUDA row step sorts and packs the pairs of every arena dtype,
    fp32 included, into list-rows for the one list-row kernel (its launcher
    patched with the packed plain version here, on the CPU), whose rows
    equal the pair-order plain version's."""
    calls = []

    def launch(q, arena, counts, row_list, table, nprobe, n_pairs, metric,
               cap_s):
        calls.append((arena.dtype, tuple(table.shape)))
        return _pair_list_rows_reference(q, arena, counts, row_list, table,
                                         nprobe, n_pairs, metric, cap_s)

    monkeypatch.setattr(pair_scan, "_pair_list_rows_cuda", launch)
    monkeypatch.setattr(pair_scan, "kernel_max_m", lambda dim, dt: 64)
    s = _make(rng, dtype, "L2")
    q, arena, _, counts, probe = _torch_args(s)[0]
    cap = arena.shape[1]
    got = pair_scan._pair_rows_cuda(q, arena, counts, probe, Metric.L2, cap)
    ref = _pair_rows_reference(q, arena, counts, probe, Metric.L2, cap)
    assert len(calls) == 1 and calls[0][0] == arena.dtype
    assert calls[0][1][1] <= 64
    fk = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), fk)
    atol = float(np.max(_atol_raw(s, "L2")))
    assert float((got[fk] - ref[fk]).abs().max()) <= atol
