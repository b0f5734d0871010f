"""PyTorch port, the arithmetic of the tensor-core flat scans (K1, K3) on
fp32 arenas: each fp32 arena value split into three bf16 planes as the
kernel splits it in registers (``csrc/tc_scan.cuh`` ``split_f32x2``, the
split of ``grouped_scan.split_query_bf16x3``), and a numpy model of the
kernels' sums (six of the nine plane products, each exact; a fresh fp32
accumulator per 32-wide chunk of D whose adds truncate toward zero; the
chunks summed rounded to nearest, in the kernels' element order) against
the JAX package's grouped and sorted Pallas kernels (interpret mode) and
float64, on the same numpy inputs."""

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
from cuda_acceleratedvectordatabaseengine_tpu.ops.pallas_scan import (
    scan_probed_lists_pallas_sorted as j_sorted,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.grouped_scan import (
    query_planes,
    scan_probed_lists_grouped_reference,
    split_query_bf16x3,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.sorted_scan import (
    scan_probed_lists_sorted_reference,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)

RTOL = 1e-5       # distances: relative ...
ATOL_QSQ = 1e-5   # ... plus this × ‖q‖² (fp32 sums in another order)
CHUNK = 32        # D elements per fresh accumulator on an fp32 arena
# (query plane, arena plane) of each product the kernel sums, in its order:
# mm, lh, hl (2⁻¹⁶ of the dot), mh, hm (2⁻⁸), hh; 0 hi, 1 mid, 2 lo
SIX = ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))
THREE = ((1, 0), (0, 1), (0, 0))
LO_EXACT = 2.0 ** -110   # below it the lo plane underflows bf16
LO_STEP = 2.0 ** -133    # bf16's smallest subnormal


def _bits(sign, exponent, mantissa):
    return ((sign.astype(np.uint32) << 31) | (exponent.astype(np.uint32) << 23)
            | mantissa.astype(np.uint32)).view(np.float32)


def _split_case(rng, case):
    """fp32 arena values [rows, D] for one split case."""
    shape = (12, 48)
    if case == "wide_span":        # magnitudes 1e-30 .. 1e30, both signs
        mag = 10.0 ** rng.uniform(-30, 30, shape)
        return (mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    if case == "large":            # up to 1e38, below bf16's largest value
        return (rng.uniform(-1.0, 1.0, shape) * 1e38).astype(np.float32)
    if case == "negatives":
        return -np.abs(rng.standard_normal(shape)).astype(np.float32)
    if case == "full_mantissa":    # random significand bits, |x| ≥ 2^-110
        return _bits(rng.integers(0, 2, shape),
                     rng.integers(127 - 110, 255, shape),
                     rng.integers(0, 1 << 23, shape))
    if case == "powers_of_two":    # hi carries everything: mid = lo = 0
        return (rng.choice([-1.0, 1.0], shape)
                * 2.0 ** rng.integers(-120, 120, shape)).astype(np.float32)
    if case == "near_underflow":   # |x| in [2^-110, 2^-100): still exact
        return _bits(rng.integers(0, 2, shape),
                     rng.integers(127 - 110, 127 - 100, shape),
                     rng.integers(0, 1 << 23, shape))
    raise ValueError(case)


@pytest.mark.parametrize("case", ["wide_span", "large", "negatives",
                                  "full_mantissa", "powers_of_two",
                                  "near_underflow"])
def test_arena_split_reconstructs_values_exactly(rng, case):
    x = _split_case(rng, case)
    planes = split_query_bf16x3(torch.from_numpy(x))
    hi, mid, lo = (p.double().numpy() for p in planes)
    np.testing.assert_array_equal(hi + mid + lo, x.astype(np.float64))
    # each plane is the bf16 rounding (ml_dtypes, round to nearest even) of
    # what the planes above it leave
    x64 = x.astype(np.float64)
    np.testing.assert_array_equal(
        hi, x.astype(ml_dtypes.bfloat16).astype(np.float64))
    np.testing.assert_array_equal(
        mid, (x64 - hi).astype(np.float32).astype(ml_dtypes.bfloat16)
        .astype(np.float64))
    assert (np.abs(lo) <= np.abs(mid)).all()
    assert (np.abs(mid) <= np.abs(hi)).all()
    if case == "powers_of_two":
        assert not mid.any() and not lo.any()


def test_arena_split_below_the_lo_planes_range(rng):
    """Under 2⁻¹¹⁰ the lo plane falls below bf16's subnormal step 2⁻¹³³ and
    rounds to it: the planes then miss the value by at most half a step,
    fp32 subnormals included; zero splits into zeros."""
    x = _bits(rng.integers(0, 2, (16, 64)), rng.integers(0, 127 - 110,
                                                         (16, 64)),
              rng.integers(0, 1 << 23, (16, 64)))
    x[0, :8] = 0.0
    planes = split_query_bf16x3(torch.from_numpy(x)).double().numpy()
    x64 = x.astype(np.float64)
    err = np.abs(planes.sum(0) - x64)
    assert (err <= LO_STEP / 2).all()
    assert (err[np.abs(x64) >= LO_EXACT] == 0).all()
    assert not planes[:, 0, :8].any()


def test_query_planes_for_every_arena_dtype(rng):
    q = torch.from_numpy(rng.standard_normal((5, 40)).astype(np.float32))
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        planes = query_planes(q, dtype)
        assert planes.dtype == torch.bfloat16
        assert tuple(planes.shape) == (3, 5, 40)
        assert planes.is_contiguous()
        np.testing.assert_array_equal(planes.double().sum(0).numpy(),
                                      q.double().numpy())
    with pytest.raises(ValueError):
        query_planes(q, torch.float16)


def _trunc_f32(x):
    """float64 to float32 rounded toward zero, as an mma's add into its
    fp32 accumulator rounds."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _mma_steps(dim):
    """The kernels' k-steps on an fp32 arena: for each 32-wide chunk of D,
    the 16 elements each of its two ``mma.m16n8k16`` reads (lane c of a
    fragment quad owns elements 8 c .. 8 c + 7 of the chunk, four to a
    k-step)."""
    for d0 in range(0, dim, CHUNK):
        yield [[e for e in (d0 + 8 * c + 4 * j + r for c in range(4)
                            for r in range(4)) if e < dim]
               for j in range(2)]


def _planes(x):
    return split_query_bf16x3(torch.from_numpy(x)).double().numpy()


def _plane_qx(q, x, products=SIX):
    """q . x of each query [B, D] with each of its slots [B, S, D] as the
    kernels form it on an fp32 arena: for each 32-wide chunk of D, the
    ``products`` (each k-step's 16 exact bf16 products summed exactly)
    added into a fresh fp32 accumulator with truncation, the chunks'
    partial dots then summed in fp32 rounded to nearest."""
    qp, xp = _planes(q), _planes(x)
    total = np.zeros(x.shape[:2], np.float32)
    for chunk in _mma_steps(q.shape[1]):
        acc = np.zeros(x.shape[:2], np.float32)
        for a, b in products:
            for idx in chunk:
                prod = np.einsum("bd,bsd->bs", qp[a][:, idx], xp[b][..., idx])
                acc = _trunc_f32(acc.astype(np.float64) + prod)
        total = (total.astype(np.float64) + acc).astype(np.float32)
    return total


def _fma_loop_qx(q, x):
    """q . x as one fp32 FMA chain over D (the CUDA-core loop the tensor
    cores replaced): each step rounds q_d · x_d + acc once, to nearest."""
    acc = np.zeros(x.shape[:2], np.float32)
    for d in range(q.shape[1]):
        acc = (acc.astype(np.float64) + q[:, None, d].astype(np.float64)
               * x[..., d]).astype(np.float32)
    return acc


def _make(rng, metric, nlist=8, cap=96, dim=40, batch=12, nprobe=4):
    """An fp32 arena (raw rows, stored norms) and queries with a wide
    spread of magnitudes, so that the mid and lo planes of both matter."""
    x = (rng.standard_normal((nlist, cap, dim))
         * 10.0 ** rng.uniform(-1, 1, (nlist, cap, dim))).astype(np.float32)
    q = (rng.standard_normal((batch, dim))
         * 10.0 ** rng.uniform(-2, 2, (batch, dim))).astype(np.float32)
    if metric == "Cosine":
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    counts = rng.integers(1, cap + 1, nlist).astype(np.int32)
    counts[:2] = [0, 3]                     # shorter than k
    sq = (x * x).sum(-1).astype(np.float32)
    probe = np.stack([rng.choice(nlist, nprobe, replace=False)
                      for _ in range(batch)]).astype(np.int32)
    probe[0, -1] = -1
    return dict(q=q, x=x, sq=sq, counts=counts, probe=probe)


def _plane_scan(s, k, metric):
    """The whole flat scan on the modelled six-product dots: ``(dists
    [B, k], pos [B, k])`` with positions ``list · cap + slot``."""
    q, probe = s["q"], s["probe"].astype(np.int64)
    batch, nprobe = probe.shape
    cap = s["x"].shape[1]
    lists = np.maximum(probe, 0)
    blocks = s["x"][lists].reshape(batch, nprobe * cap, -1)
    qx = _plane_qx(q, blocks).astype(np.float32).reshape(batch, nprobe, cap)
    if metric == Metric.L2:
        qsq = (q * q).sum(-1, dtype=np.float32)[:, None, None]
        d = np.maximum(qsq - np.float32(2) * qx + s["sq"][lists], 0)
    elif metric == Metric.INNER_PRODUCT:
        d = -qx
    else:
        d = np.float32(1) - qx
    valid = ((np.arange(cap) < s["counts"][lists][..., None])
             & (probe >= 0)[..., None])
    d = np.where(valid, d, np.inf).reshape(batch, nprobe * cap)
    cols = np.argsort(d, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(d, cols, 1)
    pos = np.take_along_axis(lists, cols // cap, 1) * cap + cols % cap
    return vals, np.where(np.isfinite(vals), pos, -1).astype(np.int32)


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_six_plane_scan_matches_jax_kernels(rng, metric):
    """On an fp32 arena the modelled kernel equals the JAX package's K1 and
    K3 (interpret mode) and the port's plain K1 and K3 within the scans'
    tolerance, ids up to ties."""
    s = _make(rng, metric)
    k = 6
    jm, tm = JMetric.parse(metric), Metric.parse(metric)
    got = _plane_scan(s, k, tm)
    atol = ATOL_QSQ * (s["q"].astype(np.float64) ** 2).sum(1)
    jargs = (jnp.asarray(s["q"]), jnp.asarray(s["x"]), jnp.asarray(s["sq"]),
             jnp.asarray(s["counts"]), jnp.asarray(s["probe"]))
    refs = [j_grouped(*jargs, k, jm, interpret=True, m_budget=8),
            j_sorted(*jargs, k, jm, interpret=True)]
    targs = (torch.from_numpy(s["q"]), torch.from_numpy(s["x"]),
             torch.from_numpy(s["sq"]), torch.from_numpy(s["counts"]),
             torch.from_numpy(s["probe"]), k, tm)
    refs += [scan_probed_lists_grouped_reference(*targs, m_budget=8),
             scan_probed_lists_sorted_reference(*targs, m_budget=8)]
    for ref in refs:
        assert_topk_match(*got, *(np.asarray(a) for a in ref), rtol=RTOL,
                          atol=atol)


def _near_rows(rng, aligned_lo=False, nlist=16, cap=64, dim=768):
    """A raw fp32 arena of randn list centres with rows 0.25 around them,
    and one query 0.1 around a row of each list, probing that list: |q . x|
    near ‖q‖² ≈ 820, where fp32 sums lose the most. ``aligned_lo`` sets the
    low 16 significand bits of every arena value to 0x403F, the largest lo
    plane that keeps its value's sign (63 units of the last place): the
    case where the lo planes' products add up instead of cancelling."""
    centres = rng.standard_normal((nlist, 1, dim))
    x = (centres + 0.25 * rng.standard_normal((nlist, cap, dim))).astype(
        np.float32)
    q = (x[:, 0].astype(np.float64)
         + 0.1 * rng.standard_normal((nlist, dim))).astype(np.float32)
    if aligned_lo:
        bits = (x.view(np.uint32) & np.uint32(0xFFFF0000)) | np.uint32(0x403F)
        x = bits.view(np.float32)
    return q, x


def _share(q, x, qx, sq32=None):
    """Worst share of the scans' tolerance by which L2 distances from the
    fp32 dots ``qx`` (and the fp32 slot norms ``sq32``, by default numpy's
    fp32 sums) lie from float64."""
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    qsq = (q64 * q64).sum(1)[:, None]
    d64 = qsq - 2.0 * np.einsum("bd,bsd->bs", q64, x64) + (x64 * x64).sum(-1)
    qsq32 = (q * q).sum(1, dtype=np.float32)[:, None]
    if sq32 is None:
        sq32 = (x * x).sum(-1, dtype=np.float32)
    d = (qsq32 - np.float32(2) * qx.astype(np.float32) + sq32).astype(
        np.float64)
    return (np.abs(d - d64) / (RTOL * np.abs(d64) + ATOL_QSQ * qsq)).max()


@pytest.mark.parametrize("aligned_lo", [False, True])
def test_six_plane_dot_is_fp32_accurate(rng, aligned_lo):
    """At D 768 with |q . x| near ‖q‖²: the modelled kernel's L2 distances
    lie from float64 by at most the share of the scans' tolerance that an
    fp32 FMA loop over D takes, and well inside it. Three products (hh, hm,
    mh) are not enough: where the lo planes line up they leave 2⁻¹⁶ of the
    dot and the distances leave the tolerance."""
    q, x = _near_rows(rng, aligned_lo)
    assert 700 < (q.astype(np.float64) ** 2).sum(1).mean() < 950
    six = _share(q, x, _plane_qx(q, x))
    assert six <= _share(q, x, _fma_loop_qx(q, x))
    assert six < 0.1
    three = _share(q, x, _plane_qx(q, x, THREE))
    if aligned_lo:
        assert three > 1.0
    else:
        assert three > six


def _block_norms(x, fp64_chunks=True):
    """|x|² of each fp32 slot row [..., D] as K4's list-row kernel forms it
    (``csrc/tc_scan.cuh`` ``tile_mma_f32``): lane c of a fragment quad owns
    elements 8 c .. 8 c + 7 of each 32-wide chunk and sums their squares
    with fp32 FMAs. ``fp64_chunks`` (the kernel): a fresh fp32 partial a
    chunk, the partials added in fp64 over the chunks and over the quad's
    four lanes, rounded to fp32 once. Otherwise one fp32 chain a lane over
    all of D and the quad's fp32 shuffle adds (lane 0 keeps
    (l0 + l1) + (l2 + l3))."""
    dim = x.shape[-1]
    assert dim % CHUNK == 0
    v = x.reshape(*x.shape[:-1], dim // CHUNK, 4, 8).astype(np.float64)
    lanes = np.zeros((*x.shape[:-1], 4), np.float64)
    chain = np.zeros((*x.shape[:-1], 4), np.float32)
    for c in range(dim // CHUNK):
        part = chain if not fp64_chunks else np.zeros_like(chain)
        for e in range(8):   # one FMA rounds once: x² is exact in float64
            part = (part.astype(np.float64) + v[..., c, :, e] ** 2).astype(
                np.float32)
        if fp64_chunks:
            lanes += part
        else:
            chain = part
    if fp64_chunks:
        return ((lanes[..., 0] + lanes[..., 1])
                + (lanes[..., 2] + lanes[..., 3])).astype(np.float32)
    return ((chain[..., 0] + chain[..., 1])
            + (chain[..., 2] + chain[..., 3])).astype(np.float32)


def _norm_share(q, x, sq32):
    """Worst share of the scans' tolerance (its ‖q‖² term) by which the
    slot norms ``sq32`` alone lie from float64."""
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    qsq = (q64 * q64).sum(1)[:, None]
    return (np.abs(sq32 - (x64 * x64).sum(-1)) / (ATOL_QSQ * qsq)).max()


@pytest.mark.parametrize("aligned_lo", [False, True])
def test_block_norms_of_fp32_values_are_fp32_accurate(rng, aligned_lo):
    """K4 on an fp32 arena forms each slot's |x|² from the fp32 values in
    the tile it stages (not from their hi plane). At D 768 with |x|² near
    ‖q‖² ≈ 820, the kernel's order (fp32 partials a chunk, added in fp64)
    keeps the norms within 0.02 of the scans' tolerance, several times
    closer than one fp32 chain a lane over D (192 FMAs), and the L2
    distances from the modelled six-product dots and these norms stay
    under 0.1 of it."""
    q, x = _near_rows(rng, aligned_lo)
    kernel = _block_norms(x)
    chain = _block_norms(x, fp64_chunks=False)
    np.testing.assert_allclose(kernel, (x.astype(np.float64) ** 2).sum(-1),
                               rtol=1e-6)
    assert _norm_share(q, x, kernel) < 0.02
    assert _norm_share(q, x, kernel) * 3 < _norm_share(q, x, chain)
    hi = x.astype(ml_dtypes.bfloat16).astype(np.float64)
    assert _norm_share(q, x, (hi * hi).sum(-1)) > 1.0   # the hi plane's
    assert _share(q, x, _plane_qx(q, x), kernel) < 0.1
