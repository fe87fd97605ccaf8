"""Sharded (8 virtual device) pipeline vs single-chip and vs oracle —
the MPI-mode differential verification pattern (mpi.cpp:115-127), with
the virtual CPU mesh standing in for mpirun -np 8 (SURVEY.md §4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
from fft_restoration_tpu.oracle.serial import restore_channels
from fft_restoration_tpu.parallel import (
    ShardedWienerPipeline,
    make_mesh,
    sharded_restore_planes,
)
from fft_restoration_tpu.parallel.mesh import ROWS_AXIS
from fft_restoration_tpu.parallel.sharded_fft import sharded_fft2d
from fft_restoration_tpu.utils.verify import channels_equal


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def test_mesh_has_8_devices(mesh):
    assert mesh.devices.size == 8


# "xla" is the library FFT (cuFFT on a GPU mesh) inside shard_map —
# the counterpart of the reference's hybrid MPI+SIMD mode
# (fft_mpi_simd.cpp:471-629): vendor-speed local transforms inside the
# distributed skeleton.
BACKENDS = ("matmul", "radix2", "xla")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("inverse", [False, True])
def test_sharded_fft2d_matches_npfft(rng, mesh, inverse, backend):
    h, w = 64, 32
    x = rng.standard_normal((h, w)).astype(np.float32)
    fn = jax.jit(
        jax.shard_map(
            lambda re, im: sharded_fft2d(re, im, inverse, backend),
            mesh=mesh,
            check_vma=False,
            in_specs=(P(ROWS_AXIS, None), P(ROWS_AXIS, None)),
            out_specs=(P(ROWS_AXIS, None), P(ROWS_AXIS, None)),
        )
    )
    re, im = fn(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))
    ours = np.asarray(re) + 1j * np.asarray(im)
    ref = np.fft.fft2(x.astype(np.complex128))
    if inverse:
        ref = np.conj(np.fft.fft2(np.conj(x.astype(np.complex128))))  # unscaled ifft
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_planes_match_single_chip(rng, mesh, backend):
    """Sharded output matches the same backend single-device (the mesh
    changes the schedule, not the math)."""
    chans = rng.random((3, 64, 64)).astype(np.float32)
    psf = motion_blur_kernel_oracle(9, 30.0)
    from fft_restoration_tpu.models.pipeline import restore_planes

    single = np.asarray(
        restore_planes(jnp.asarray(chans), jnp.asarray(psf), 0.01, fft_backend=backend)
    )
    sharded = sharded_restore_planes(chans, psf, 0.01, mesh=mesh, fft_backend=backend)
    # matmul/radix2: the mesh runs the IDENTICAL graph -> bit-level match.
    # xla: single-device runs one 2D library call, the sharded path two
    # 1D passes around the all_to_all — same transform, different float
    # association -> f32-rounding agreement.
    tol = 1e-5 if backend == "xla" else 1e-6
    assert np.abs(single - sharded).max() < tol


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_pipeline_matches_oracle(rng, mesh, backend):
    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    sp = ShardedWienerPipeline(mesh=mesh, fft_backend=backend)
    ours = sp.restore_channels(img, 9, 30.0)

    imgf = img.astype(np.float32) / 255.0
    oracle = restore_channels(
        np.moveaxis(imgf, -1, 0), motion_blur_kernel_oracle(9, 30.0)
    )
    for tier in ("l2", "inf", "gpu"):
        report = channels_equal(ours, oracle, tier)
        assert report.passed, str(report)


def test_sharded_full_image_matches_single(rng, mesh):
    img = (rng.random((48, 48, 3)) * 255).astype(np.uint8)
    out_s = ShardedWienerPipeline(mesh=mesh).restore(img, 7, 45.0)
    out_1 = WienerDeblurPipeline(fft_backend="matmul").restore(img, 7, 45.0)
    assert np.abs(out_s.astype(int) - out_1.astype(int)).max() <= 1


@pytest.mark.parametrize("n_dev", [3, 5, 6])
def test_nonpow2_mesh_matches_single_chip(rng, n_dev):
    """Non-power-of-two meshes pad the LAYOUT only; the DFT extent and
    the normalize reduction stay at the true pow2 size, so parity with
    the single-chip restore is exact (advisor finding: the old
    extent-padding path changed the transform and failed all tiers)."""
    from fft_restoration_tpu.models.pipeline import restore_planes
    import jax.numpy as jnp

    chans = rng.random((3, 64, 64)).astype(np.float32)
    psf = motion_blur_kernel_oracle(9, 30.0)
    single = np.asarray(
        restore_planes(jnp.asarray(chans), jnp.asarray(psf), 0.01, fft_backend="matmul")
    )
    sharded = sharded_restore_planes(chans, psf, 0.01, mesh=make_mesh(n_dev))
    assert sharded.shape == single.shape
    assert np.abs(single - sharded).max() < 1e-6


def test_nonpow2_mesh_pipeline_matches_oracle(rng):
    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    sp = ShardedWienerPipeline(mesh=make_mesh(3))
    ours = sp.restore_channels(img, 9, 30.0)
    imgf = img.astype(np.float32) / 255.0
    oracle = restore_channels(
        np.moveaxis(imgf, -1, 0), motion_blur_kernel_oracle(9, 30.0)
    )
    for tier in ("l2", "inf", "gpu"):
        report = channels_equal(ours, oracle, tier)
        assert report.passed, str(report)


def test_nonpow2_mesh_cls_filter(rng):
    """CLS on a non-pow2 mesh: the periodic Laplacian must wrap at the
    TRUE extent, not the layout-pad edge."""
    chans = rng.random((1, 32, 32)).astype(np.float32)
    psf = motion_blur_kernel_oracle(7, 45.0)
    from fft_restoration_tpu.models.pipeline import restore_planes
    import jax.numpy as jnp

    single = np.asarray(
        restore_planes(
            jnp.asarray(chans), jnp.asarray(psf), 0.01,
            fft_backend="matmul", filter_name="cls",
        )
    )
    sharded = sharded_restore_planes(
        chans, psf, 0.01, mesh=make_mesh(3), filter_name="cls"
    )
    assert np.abs(single - sharded).max() < 1e-6


# ---------------------------------------------------------------------------
# 2D (batch, rows) mesh: data-parallel images x row-sharded FFTs


@pytest.mark.parametrize("n_b,n_r", [(2, 4), (4, 2), (2, 2)])
def test_batched_2d_mesh_matches_single_chip(rng, n_b, n_r):
    from fft_restoration_tpu.models.pipeline import restore_planes
    from fft_restoration_tpu.parallel import make_mesh2d, sharded_batched_restore_planes
    import jax.numpy as jnp

    imgs = rng.random((3, 2, 32, 32)).astype(np.float32)  # (B, C, Hp, Wp)
    psf = motion_blur_kernel_oracle(7, 30.0)
    single = np.asarray(
        restore_planes(jnp.asarray(imgs), jnp.asarray(psf), 0.01, fft_backend="matmul")
    )
    out = sharded_batched_restore_planes(
        imgs, psf, 0.01, mesh=make_mesh2d(n_b, n_r)
    )
    assert out.shape == imgs.shape
    # B=3 is not a multiple of n_b=2/4 -> exercises the batch layout pad
    assert np.abs(out - single).max() < 1e-6


def test_graft_entry_dryrun():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_graft_entry_compiles():
    import __graft_entry__ as g

    fn, args = g.entry()
    compiled = jax.jit(fn).lower(*args).compile()
    assert compiled is not None


def test_sharded_one_device_mesh_matches_single_chip():
    """--devices 1 forces the FULL sharded graph (shard_map, degenerate
    all_to_all, library FFTs inside) through a 1-device mesh; parity
    vs the single-device pipeline."""
    import functools

    import numpy as np
    import jax
    import jax.numpy as jnp

    from fft_restoration_tpu.models.pipeline import _restore_core
    from fft_restoration_tpu.parallel.mesh import make_mesh
    from fft_restoration_tpu.parallel.sharded_pipeline import _sharded_core

    rng = np.random.default_rng(7)
    img = rng.random((48, 64, 3)).astype(np.float32)
    mesh = make_mesh(1)
    ang, k = jnp.float32(30.0), jnp.float32(0.01)
    sh = jax.jit(
        functools.partial(
            _sharded_core, mesh=mesh, psf_length=7, fft_backend="xla",
            filter_name="wiener", white_balance=True,
        )
    )
    single = jax.jit(
        functools.partial(
            _restore_core, psf_length=7, fft_backend="xla",
            filter_name="wiener", white_balance=True,
        )
    )
    out_s, planes_s = sh(jnp.asarray(img), ang, k)
    out_1, planes_1 = single(jnp.asarray(img), ang, k)
    assert (
        float(jnp.abs(planes_s - planes_1).max()) <= 1e-5
    )
    assert int(jnp.abs(out_s.astype(int) - out_1.astype(int)).max()) <= 1
