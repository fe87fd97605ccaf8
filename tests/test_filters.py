"""Frequency-domain filter family properties (SoA)."""

import numpy as np
import pytest

import jax.numpy as jnp

from fft_restoration_tpu.ops.wiener import cls_filter, inverse_filter, wiener_filter
from fft_restoration_tpu.models.filters import apply_filter
from fft_restoration_tpu.parallel.sharded_pipeline import profile_phases_sharded
from fft_restoration_tpu.parallel.mesh import make_mesh


def _soa(rng, shape):
    return (
        jnp.asarray(rng.standard_normal(shape).astype(np.float32)),
        jnp.asarray(rng.standard_normal(shape).astype(np.float32)),
    )


def test_wiener_matches_complex_formula(rng):
    G = _soa(rng, (8, 16))
    H = _soa(rng, (8, 16))
    K = 0.05
    fr, fi = wiener_filter(G, H, K)
    g = np.asarray(G[0]) + 1j * np.asarray(G[1])
    h = np.asarray(H[0]) + 1j * np.asarray(H[1])
    ref = g * np.conj(h) / (np.abs(h) ** 2 + K)
    assert np.abs((np.asarray(fr) + 1j * np.asarray(fi)) - ref).max() < 1e-5


def test_inverse_filter_is_wiener_limit(rng):
    G = _soa(rng, (4, 8))
    H = _soa(rng, (4, 8))
    inv = inverse_filter(G, H)
    wie = wiener_filter(G, H, 1e-12)
    assert np.abs(np.asarray(inv[0]) - np.asarray(wie[0])).max() < 1e-3


def test_inverse_filter_guards_small_H(rng):
    G = _soa(rng, (4, 8))
    H = (jnp.zeros((4, 8)), jnp.zeros((4, 8)))
    fr, fi = inverse_filter(G, H)
    assert np.isfinite(np.asarray(fr)).all()
    assert np.abs(np.asarray(fr)).max() == 0.0


def test_cls_reduces_to_wiener_when_P_is_unit(rng):
    G = _soa(rng, (4, 8))
    H = _soa(rng, (4, 8))
    P = (jnp.ones((4, 8)), jnp.zeros((4, 8)))
    cls_out = cls_filter(G, H, P, 0.01)
    wie_out = wiener_filter(G, H, 0.01)
    assert np.abs(np.asarray(cls_out[0]) - np.asarray(wie_out[0])).max() < 1e-5


def test_apply_filter_unknown_raises(rng):
    G = _soa(rng, (4, 8))
    with pytest.raises(ValueError):
        apply_filter("bilateral", G, G, 0.01)


def test_sharded_profile_phases(rng):
    img = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
    planes, prof = profile_phases_sharded(img, 5, 30.0, mesh=make_mesh(4))
    assert planes.shape == (3, 32, 32)
    report = prof.report()
    for phase in ("FFT Image", "FFT PSF", "Wiener Filter", "IFFT"):
        assert phase in report


@pytest.mark.parametrize("filter_name", ["inverse", "cls"])
def test_xla_path_serves_all_filters(rng, filter_name):
    """inverse/cls run on the xla route as one elementwise filter
    between the library transforms, and match the matmul backend."""
    from fft_restoration_tpu.models.pipeline import restore_planes

    chans = jnp.asarray(rng.random((3, 128, 256), np.float32))
    psf = jnp.asarray(rng.random((9, 9), np.float32) / 81.0)
    got = np.asarray(
        restore_planes(chans, psf, 0.01, fft_backend="xla",
                       filter_name=filter_name)
    )
    want = np.asarray(
        restore_planes(chans, psf, 0.01, fft_backend="matmul",
                       filter_name=filter_name)
    )
    assert np.abs(got - want).max() < 1e-3, np.abs(got - want).max()
