"""PyTorch port, product quantization ops: encode / decode / ADC tables /
gather lookup / codebook refresh against the JAX package on identical numpy
inputs, and codebook + OPQ training by quality (the two packages draw
different random numbers) (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_acceleratedvectordatabaseengine_tpu.ops import pq as jpq
from cuda_acceleratedvectordatabaseengine_tpu_torch.ops import pq

torch.set_num_threads(1)


def _anisotropic(rng, n, dim, decay=0.85):
    """Correlated gaussian whose principal axes straddle subspace
    boundaries (the geometry of the JAX package's OPQ tests)."""
    spectrum = decay ** np.arange(dim)
    basis, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    z = rng.standard_normal((n, dim)) * spectrum
    return (z @ basis.T).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))   # an owned copy


def _recon_err(x, codes, codebooks):
    """Mean squared reconstruction error, in numpy float64."""
    m, _, dsub = codebooks.shape
    dec = codebooks[np.arange(m)[None, :], codes.astype(np.int64)]
    return float(np.mean((x.astype(np.float64)
                          - dec.reshape(len(x), -1)) ** 2))


def _codeword_dist(x, codes, codebooks):
    """‖x_j − codebook_j[code_j]‖² per (row, subspace), float64."""
    m, _, dsub = codebooks.shape
    xs = x.reshape(len(x), m, dsub).astype(np.float64)
    c = codebooks[np.arange(m)[None, :], codes.astype(np.int64)]
    return ((xs - c) ** 2).sum(-1)


def test_pq_encode_matches_jax(rng):
    x = rng.standard_normal((600, 32)).astype(np.float32)
    cb = rng.standard_normal((4, 256, 8)).astype(np.float32)
    got = pq.pq_encode(_t(x), _t(cb), chunk_size=256).numpy()
    ref = np.asarray(jpq.pq_encode(jnp.asarray(x), jnp.asarray(cb)))
    assert got.dtype == np.uint8 and got.shape == (600, 4)
    # Codes agree except at near-ties, where both codewords are equally
    # near (fp32 sums in another order may pick either).
    d_got = _codeword_dist(x, got, cb)
    d_ref = _codeword_dist(x, ref, cb)
    differ = got != ref
    assert differ.mean() < 0.01
    np.testing.assert_allclose(d_got[differ], d_ref[differ], rtol=1e-5)


def test_pq_decode_tables_lookup_match_jax(rng):
    cb = rng.standard_normal((4, 256, 8)).astype(np.float32)
    codes = rng.integers(0, 256, (50, 4)).astype(np.uint8)
    np.testing.assert_allclose(
        pq.pq_decode(_t(codes), _t(cb)).numpy(),
        np.asarray(jpq.pq_decode(jnp.asarray(codes), jnp.asarray(cb))),
        rtol=1e-5)
    r = rng.standard_normal((6, 32)).astype(np.float32)
    tab = pq.pq_distance_tables(_t(r), _t(cb)).numpy()
    tab_j = np.asarray(jpq.pq_distance_tables(jnp.asarray(r),
                                              jnp.asarray(cb)))
    assert tab.shape == (6, 4, 256)
    # a table entry is a difference of O(10) terms: absolute floor 1e-5·‖r‖²
    np.testing.assert_allclose(tab, tab_j, rtol=1e-5, atol=1e-4)
    codes_t = rng.integers(0, 256, (6, 4, 40)).astype(np.uint8)
    np.testing.assert_allclose(
        pq.pq_adc_lookup(_t(tab_j), _t(codes_t)).numpy(),
        np.asarray(jpq.pq_adc_lookup(jnp.asarray(tab_j),
                                     jnp.asarray(codes_t))),
        rtol=1e-5, atol=1e-5)


def test_refresh_codebooks_and_orthonormalize_match_jax(rng):
    x = rng.standard_normal((700, 16)).astype(np.float32)
    cb = rng.standard_normal((4, 32, 4)).astype(np.float32)
    codes = rng.integers(0, 30, (700, 4)).astype(np.uint8)  # 2 unused words
    got = pq._refresh_codebooks(_t(x), _t(codes), _t(cb),
                                chunk_size=256).numpy()
    ref = np.asarray(jpq._refresh_codebooks(jnp.asarray(x),
                                            jnp.asarray(codes),
                                            jnp.asarray(cb), chunk_size=256))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[:, 30:], cb[:, 30:])  # kept as is
    q, _ = np.linalg.qr(rng.standard_normal((16, 16)))
    near = (q + 1e-3 * rng.standard_normal((16, 16))).astype(np.float32)
    np.testing.assert_allclose(
        pq._orthonormalize(_t(near)).numpy(),
        np.asarray(jpq._orthonormalize(jnp.asarray(near))),
        rtol=1e-5, atol=1e-6)


def test_train_product_quantizer_quality_matches_jax(rng):
    x = _anisotropic(rng, 3000, 32)
    cb_t = pq.train_product_quantizer(
        _t(x), 8, ks=32, iters=8,
        generator=torch.Generator().manual_seed(0)).numpy()
    cb_j = np.asarray(jpq.train_product_quantizer(
        jax.random.PRNGKey(0), jnp.asarray(x), m=8, ks=32, iters=8))
    assert cb_t.shape == cb_j.shape == (8, 32, 4)
    err_t = _recon_err(x, pq.pq_encode(_t(x), _t(cb_t)).numpy(), cb_t)
    err_j = _recon_err(x, np.asarray(jpq.pq_encode(jnp.asarray(x),
                                                   jnp.asarray(cb_j))), cb_j)
    assert err_t <= 1.10 * err_j, (err_t, err_j)


def test_opq_fit_quality_matches_jax_and_beats_plain_pq(rng):
    x = _anisotropic(rng, 3000, 32)
    gen = torch.Generator().manual_seed(0)
    R, cb = pq.opq_fit(_t(x), 8, ks=32, iters=8, opq_iters=4, generator=gen)
    R_j, cb_j = jpq.opq_fit(jax.random.PRNGKey(0), jnp.asarray(x), m=8,
                            ks=32, iters=8, opq_iters=4)
    xr = (_t(x) @ R).numpy()
    xr_j = np.asarray(jnp.asarray(x) @ R_j)
    err_t = _recon_err(xr, pq.pq_encode(_t(xr), cb).numpy(), cb.numpy())
    err_j = _recon_err(xr_j, np.asarray(jpq.pq_encode(jnp.asarray(xr_j),
                                                      cb_j)), np.asarray(cb_j))
    assert err_t <= 1.10 * err_j, (err_t, err_j)
    cb_plain = pq.train_product_quantizer(
        _t(x), 8, ks=32, iters=8,
        generator=torch.Generator().manual_seed(0)).numpy()
    err_plain = _recon_err(x, pq.pq_encode(_t(x), _t(cb_plain)).numpy(),
                           cb_plain)
    assert err_t <= err_plain, (err_t, err_plain)


def test_opq_rotation_is_isometric_at_high_dim(rng):
    """The bound of the JAX package's test of the same name: the published
    rotation is an isometry to fp32 roundoff at D 128."""
    dim = 128
    x = _anisotropic(rng, 8000, dim, decay=0.96)
    R, _ = pq.opq_fit(_t(x), 16, ks=32, iters=3, opq_iters=3,
                      generator=torch.Generator().manual_seed(0))
    R64 = R.numpy().astype(np.float64)
    dev = np.abs(R64.T @ R64 - np.eye(dim)).max()
    assert dev < 2e-5, dev


@pytest.mark.parametrize("fn", ["train_product_quantizer", "opq_fit"])
def test_training_is_seeded(rng, fn):
    x = _t(_anisotropic(rng, 600, 16))
    kw = dict(ks=16, iters=3)
    if fn == "opq_fit":
        kw["opq_iters"] = 2
    a = getattr(pq, fn)(x, 4, generator=torch.Generator().manual_seed(3),
                        **kw)
    b = getattr(pq, fn)(x, 4, generator=torch.Generator().manual_seed(3),
                        **kw)
    for u, v in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
