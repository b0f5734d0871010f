"""PyTorch port, the arithmetic of the tensor-core flat scans (K1, K3 on
int8 / bf16 arenas): the fp32 query split into three bf16 planes, and a
model of the kernels' sums in torch on the CPU (exact products, mma adds
truncated toward zero, a fresh accumulator per 64-wide chunk of D, in the
kernels' element order) against float64 and against the JAX package's
gather scan and its Pallas grouped kernel (interpret mode), on the same
numpy inputs."""

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
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops.grouped_scan import (
    scan_probed_lists_grouped_reference,
    split_query_bf16x3,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.testing import (
    assert_topk_match,
)

torch.set_num_threads(1)

RTOL = 1e-5       # distances: relative ...
ATOL_QSQ = 1e-5   # ... plus this × ‖q‖² (fp32 sums in another order)


def _split_case(rng, case):
    """Queries [B, D] for one split case."""
    if case == "normal_span":      # magnitudes 1e-6 .. 1e6, both signs
        mag = 10.0 ** rng.uniform(-6, 6, (16, 64))
        return (mag * rng.choice([-1.0, 1.0], mag.shape)).astype(np.float32)
    if case == "negatives":
        return -np.abs(rng.standard_normal((8, 32))).astype(np.float32)
    if case == "zeros":
        q = rng.standard_normal((8, 32)).astype(np.float32)
        q[:, ::3] = 0.0
        q[2] = 0.0
        return q
    if case == "dim_not_multiple_of_8":
        return rng.standard_normal((5, 13)).astype(np.float32)
    if case == "full_mantissa":    # every fp32 significand bit set at random
        bits = (rng.integers(0, 1 << 23, (8, 40), dtype=np.uint32)
                | (rng.integers(100, 154, (8, 40), dtype=np.uint32) << 23)
                | (rng.integers(0, 2, (8, 40), dtype=np.uint32) << 31))
        return bits.view(np.float32)
    if case == "powers_of_two":    # hi carries everything; mid = lo = 0
        return (2.0 ** rng.integers(-20, 20, (4, 24))).astype(np.float32)
    raise ValueError(case)


SPLIT_CASES = ["normal_span", "negatives", "zeros", "dim_not_multiple_of_8",
               "full_mantissa", "powers_of_two"]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_reconstructs_query_exactly(rng, case):
    q = _split_case(rng, case)
    planes = split_query_bf16x3(torch.from_numpy(q))
    assert planes.dtype == torch.bfloat16
    assert tuple(planes.shape) == (3,) + q.shape
    total = planes.double().sum(0).numpy()
    np.testing.assert_array_equal(total, q.astype(np.float64))
    # each plane is the bf16 rounding of what the planes above it leave
    hi, mid, lo = (p.double().numpy() for p in planes)
    np.testing.assert_array_equal(
        hi, q.astype(ml_dtypes.bfloat16).astype(np.float64))
    assert (np.abs(lo) <= np.abs(mid)).all()
    assert (np.abs(mid) <= np.abs(hi)).all()


def _make(rng, dtype, metric, nlist=8, cap=96, dim=40, batch=12, nprobe=4):
    """Arena state in numpy for both packages: stored rows, their fp32
    squared norms, and (int8) per-row scales with residual anchors; queries
    with a wide spread of magnitudes, so the mid and lo planes matter."""
    x = rng.standard_normal((nlist, cap, dim)).astype(np.float32)
    q = (rng.standard_normal((batch, dim))
         * 10.0 ** rng.uniform(-2, 2, (batch, dim))).astype(np.float32)
    if metric == "Cosine":
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    counts = rng.integers(1, cap + 1, nlist).astype(np.int32)
    counts[:2] = [0, 3]                     # shorter than k
    scale = anchors = None
    if dtype == "int8":
        anchors = 0.3 * rng.standard_normal((nlist, dim)).astype(np.float32)
        res = x - anchors[:, None, :]
        scale = (np.maximum(np.abs(res).max(-1), 1e-12) / 127.0).astype(
            np.float32)
        stored = np.clip(np.round(res / scale[..., None]), -127, 127).astype(
            np.int8)
        deq = stored.astype(np.float32) * scale[..., None] + anchors[:, None]
    else:
        stored = x.astype(ml_dtypes.bfloat16)
        deq = stored.astype(np.float32)
    sq = (deq * deq).sum(-1).astype(np.float32)
    probe = np.stack([rng.choice(nlist, nprobe, replace=False)
                      for _ in range(batch)]).astype(np.int32)
    probe[0, -1] = -1
    return dict(q=q, stored=stored, sq=sq, counts=counts, probe=probe,
                scale=scale, anchors=anchors)


def _arena(s):
    st = s["stored"]
    if st.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(st.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(st)


def _trunc_f32(x):
    """float64 to float32 rounded toward zero, as an mma's add into its
    fp32 accumulator rounds."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _mma_steps(dim):
    """The kernels' k-steps: for each 64-wide chunk of D, the 16 elements
    each of its four ``mma.m16n8k16`` reads (lane c of a fragment quad owns
    elements 16 c .. 16 c + 15 of the chunk, four to a k-step)."""
    for d0 in range(0, dim, 64):
        yield [[d0 + 16 * c + 4 * j + r for c in range(4) for r in range(4)
                if d0 + 16 * c + 4 * j + r < dim] for j in range(4)]


def _three_plane_qx(q, arena, lists, promote=True):
    """q . x for each query and each slot of its probed lists, as the
    tensor-core kernels form it: for each 64-wide chunk of D, the lo, mid
    and hi planes' k-steps (16 exact bf16 products each) added into a fresh
    fp32 accumulator with truncation, the chunks' partial dots then summed
    in fp32 rounded to nearest. ``promote=False``: one accumulator over all
    of D, as a kernel without the per-chunk sums would form it."""
    planes = split_query_bf16x3(q).double()                  # [3, B, D]
    blocks = arena[lists].double()                           # [B, P, c, D]
    total = torch.zeros(blocks.shape[:3])
    acc = torch.zeros(blocks.shape[:3])
    for chunk in _mma_steps(q.shape[1]):
        if promote:
            acc = torch.zeros(blocks.shape[:3])
        for p in (2, 1, 0):
            for idx in chunk:
                prod = torch.einsum("bd,bpsd->bps", planes[p][:, idx],
                                    blocks[..., idx])
                acc = _trunc_f32(acc.double() + prod)
        if promote:
            total = total + acc
    return total if promote else acc


def _three_plane_scan(s, k, metric):
    """The whole flat scan on the emulated three-plane dots: ``(dists
    [B, k], pos [B, k])`` with positions ``list · cap + slot``."""
    q = torch.from_numpy(s["q"])
    arena = _arena(s)
    probe = torch.from_numpy(s["probe"]).long()
    batch, nprobe = probe.shape
    cap = arena.shape[1]
    lists = probe.clamp_min(0)
    qx = _three_plane_qx(q, arena, lists)
    if s["scale"] is not None:
        qx = qx * torch.from_numpy(s["scale"])[lists]
    if s["anchors"] is not None:
        anc = torch.from_numpy(s["anchors"])[lists]          # [B, P, D]
        qx = qx + (q[:, None, :] * anc).sum(-1, keepdim=True)
    if metric == Metric.L2:
        qsq = (q * q).sum(-1)[:, None, None]
        d = (qsq - 2.0 * qx + torch.from_numpy(s["sq"])[lists]).clamp_min(0)
    elif metric == Metric.INNER_PRODUCT:
        d = -qx
    else:
        d = 1.0 - qx
    slot = torch.arange(cap)
    valid = ((slot < torch.from_numpy(s["counts"]).long()[lists][..., None])
             & (probe >= 0)[..., None])
    d = torch.where(valid, d, float("inf")).reshape(batch, nprobe * cap)
    vals, cols = torch.topk(d, k, dim=1, largest=False, sorted=True)
    pos = torch.gather(lists, 1, cols // cap) * cap + cols % cap
    pos = torch.where(torch.isfinite(vals), pos, -1).int()
    return vals.numpy(), pos.numpy()


def _atol(s):
    return ATOL_QSQ * (s["q"].astype(np.float64) ** 2).sum(1)


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_three_plane_scan_matches_jax(rng, dtype, metric):
    s = _make(rng, dtype, metric)
    k = 6
    jm = JMetric.parse(metric)
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    jkw = dict(arena_scale=opt(s["scale"]), arena_anchors=opt(s["anchors"]))
    # The JAX gather scan rounds the query to bf16 on a bf16 arena; the
    # kernels keep it exact, so the gather gets the stored values widened.
    gather_st = (s["stored"].astype(np.float32)
                 if s["stored"].dtype == ml_dtypes.bfloat16 else s["stored"])
    jargs = (jnp.asarray(s["q"]), jnp.asarray(s["stored"]),
             jnp.asarray(s["sq"]), jnp.asarray(s["counts"]),
             jnp.asarray(s["probe"]))
    ref_gather = [np.asarray(a) for a in j_gather(
        jargs[0], jnp.asarray(gather_st), *jargs[2:], k, jm, **jkw)]
    ref_pallas = [np.asarray(a) for a in j_grouped(
        *jargs, k, jm, interpret=True, m_budget=8, **jkw)]
    got = _three_plane_scan(s, k, Metric.parse(metric))
    for ref in (ref_gather, ref_pallas):
        assert_topk_match(*got, *ref, rtol=RTOL, atol=_atol(s))
    # and the port's plain grouped scan, which keeps the fp32 loop's order
    opt_t = lambda a: None if a is None else torch.from_numpy(a)  # noqa
    plain = scan_probed_lists_grouped_reference(
        torch.from_numpy(s["q"]), _arena(s), torch.from_numpy(s["sq"]),
        torch.from_numpy(s["counts"]), torch.from_numpy(s["probe"]), k,
        Metric.parse(metric), m_budget=8, arena_scale=opt_t(s["scale"]),
        arena_anchors=opt_t(s["anchors"]))
    assert_topk_match(*got, *(t.numpy() for t in plain), rtol=RTOL,
                      atol=_atol(s))


def _near_rows(rng, dtype, nlist=16, cap=64, dim=768):
    """A raw arena (no anchor) of randn list centres with rows 0.25 around
    them, and one query 0.1 around a row of each list, probing that list:
    |q . x| near ‖q‖² ≈ D, where fp32 accumulation loses the most. int8
    codes carry a per-row scale of about 1/40."""
    centres = rng.standard_normal((nlist, 1, dim))
    x = centres + 0.25 * rng.standard_normal((nlist, cap, dim))
    scale = None
    if dtype == "int8":
        scale = np.full((nlist, cap), 1 / 40, np.float32)
        stored = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
        deq = stored.astype(np.float64) * scale[..., None]
    else:
        stored = x.astype(ml_dtypes.bfloat16)
        deq = stored.astype(np.float64)
    q = (deq[:, 0] + 0.1 * rng.standard_normal((nlist, dim))).astype(
        np.float32)
    return q, stored, scale, deq


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_three_plane_dot_is_fp32_accurate(rng, dtype):
    """At D 768 on a raw arena, with |q . x| near ‖q‖²: the L2 distances of
    the modelled kernel (truncating mma adds, a fresh accumulator per 64-wide
    chunk) lie well inside the scans' tolerance against float64, several
    times closer than with one accumulator over all of D; and the hi plane
    alone (a query rounded to bf16) is far off."""
    q, stored, scale, deq = _near_rows(rng, dtype)
    s = dict(stored=stored)
    arena = _arena(s)
    lists = torch.arange(q.shape[0])[:, None]                # [B, 1]
    qt = torch.from_numpy(q)
    q64 = q.astype(np.float64)
    qsq = (q64 * q64).sum(1)[:, None, None]
    xsq64 = (deq * deq).sum(-1)[:, None, :]                  # [B, 1, c]
    exact = np.einsum("bd,bsd->bs", q64, deq)[:, None, :]
    d64 = qsq - 2.0 * exact + xsq64
    limit = RTOL * np.abs(d64) + ATOL_QSQ * qsq
    qsq32 = (qt * qt).sum(1)[:, None, None]
    xsq32 = torch.from_numpy(xsq64.astype(np.float32))

    def share(qx):                                           # of the limit
        if scale is not None:
            qx = qx * torch.from_numpy(scale)[lists]
        d = (qsq32 - 2.0 * qx + xsq32).double().numpy()
        return (np.abs(d - d64) / limit).max()

    promoted = share(_three_plane_qx(qt, arena, lists))
    single = share(_three_plane_qx(qt, arena, lists, promote=False))
    assert promoted < 0.2
    assert single > 4 * promoted
    hi_only = torch.einsum("bd,bsd->bs",
                           split_query_bf16x3(qt)[0].double(),
                           arena.double())[:, None, :]
    mag = np.einsum("bd,bsd->bs", np.abs(q64), np.abs(
        stored.astype(np.float64)))[:, None, :]
    exact_codes = np.einsum("bd,bsd->bs", q64,
                            stored.astype(np.float64))[:, None, :]
    assert (np.abs(hi_only.numpy() - exact_codes) / mag).max() > 1e-4
