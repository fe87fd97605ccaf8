"""Smooth-size (non-power-of-two) FFT extents and the --pad smooth
pipeline.

The reference supports non-pow2 DFT extents only through the O(n^2)
naive DFT (reference fft/fft_serial.cpp:71-87) and its drivers always
pre-pad to pow2 (serial.cpp:20,36) — up to 2x the pixels. Here smooth
n = {3,5,9,15} * 2^k sizes go straight to the library FFT (cuFFT on the
GPU) or the matmul backend's generalized four-step, and the oracle
verifies them at the SAME extents via its naive-DFT path
(oracle/serial.py pad_to) — the restored output depends on the pad
extent, so extents must match for parity.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fft_restoration_tpu.ops.fft import fft1d, fft2d
from fft_restoration_tpu.utils.padding import next_smooth_size

SMOOTH = [384, 640, 1152, 1920]


def _c(pair):
    return np.asarray(pair[0]).astype(np.complex128) + 1j * np.asarray(pair[1])


@pytest.mark.parametrize("n", SMOOTH)
@pytest.mark.parametrize("backend", ("xla", "matmul"))
def test_mixed_roundtrip_and_permutation(rng, n, backend):
    """fwd∘inv = n * identity, and the forward spectrum is np.fft's in
    natural order."""
    re = rng.standard_normal((8, n)).astype(np.float32)
    im = rng.standard_normal((8, n)).astype(np.float32)
    fr, fi = fft1d(jnp.asarray(re), jnp.asarray(im), False, backend)
    br, bi = fft1d(fr, fi, True, backend)
    assert np.abs(np.asarray(br) / n - re).max() < 1e-4
    assert np.abs(np.asarray(bi) / n - im).max() < 1e-4
    ref = np.fft.fft(re.astype(np.complex128) + 1j * im, axis=-1)
    assert np.allclose(_c((fr, fi)), ref, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("n", SMOOTH[:2])
def test_mixed_filter_sandwich_matches_natural_order(rng, n):
    """inv(wiener(fwd(x), fwd(h))) at smooth sizes == the f64
    computation."""
    re = rng.standard_normal((4, n)).astype(np.float32)
    im = rng.standard_normal((4, n)).astype(np.float32)
    h = rng.standard_normal((4, n)).astype(np.float32)
    K = 0.01
    fr, fi = fft1d(jnp.asarray(re), jnp.asarray(im), False, "xla")
    hr, hi = fft1d(jnp.asarray(h), jnp.zeros_like(jnp.asarray(h)), False, "xla")
    hr, hi = np.asarray(hr), np.asarray(hi)
    inv = 1.0 / (hr * hr + hi * hi + K)
    frn, fin = np.asarray(fr), np.asarray(fi)
    wr = (frn * hr + fin * hi) * inv
    wi = (fin * hr - frn * hi) * inv
    rr, ri = fft1d(jnp.asarray(wr), jnp.asarray(wi), True, "xla")
    ref = np.fft.fft(re.astype(np.complex128) + 1j * im, axis=-1)
    Href = np.fft.fft(h.astype(np.complex128), axis=-1)
    Wref = ref * np.conj(Href) / (np.abs(Href) ** 2 + K)
    xref = np.fft.ifft(Wref, axis=-1) * n
    err = np.abs(_c((rr, ri)) - xref).max() / (np.abs(xref).max() + 1e-12)
    assert err < 1e-4


def test_mixed_transposed_and_packed_out(rng):
    """A batched 2D transform at a smooth extent (256 x 384) matches
    np.fft.fft2 and round-trips."""
    re = rng.standard_normal((2, 256, 384)).astype(np.float32)
    im = rng.standard_normal((2, 256, 384)).astype(np.float32)
    fr, fi = fft2d(jnp.asarray(re), jnp.asarray(im), False, "xla")
    ref = np.fft.fft2(re.astype(np.complex128) + 1j * im)
    err = np.abs(_c((fr, fi)) - ref).max() / np.abs(ref).max()
    assert err < 1e-5
    br, _ = fft2d(fr, fi, True, "xla")
    assert np.abs(np.asarray(br[0]) / (256 * 384) - re[0]).max() < 1e-4


def test_mixed_validation_errors():
    from fft_restoration_tpu.models.pipeline import pad_extents

    with pytest.raises(ValueError, match="unknown pad mode"):
        pad_extents(300, 600, "mixed")
    for n in range(1, 5000, 97):
        assert next_smooth_size(n) >= n


def test_next_smooth_size_table():
    assert next_smooth_size(2160) == 2304
    assert next_smooth_size(3840) == 3840
    assert next_smooth_size(330) == 384
    assert next_smooth_size(640) == 640
    assert next_smooth_size(782) == 1024  # pow2 still wins here
    assert next_smooth_size(100) == 128  # below min_q: pow2
    # every smooth size is odd * 2^k with odd in {1,3,5,9,15}, 2^k >= 128
    for v in range(130, 5000, 37):
        n = next_smooth_size(v)
        odd = n
        while odd % 2 == 0:
            odd //= 2
        assert odd in (1, 3, 5, 9, 15) and n // odd >= 128


def test_pipeline_smooth_pad_matches_oracle_same_extents():
    """End-to-end --pad smooth parity: pipeline at smooth extents vs the
    oracle's naive-DFT path at the SAME extents (inf tier). The frame is
    fixed: the oracle-side noise below is image-dependent (0.025 INF on
    one of six seeded frames, ~5e-5 on most), so a frame drawn from the
    shared session rng would make the bound depend on test order."""
    from fft_restoration_tpu.models.pipeline import (
        WienerDeblurPipeline,
        pad_extents,
    )
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
    from fft_restoration_tpu.oracle.serial import restore_channels

    img = (np.random.default_rng(3).random((300, 600, 3)) * 255).astype(np.uint8)
    h, w = img.shape[:2]
    hp, wp = pad_extents(h, w, "smooth")
    assert (hp, wp) == (384, 640)

    pipe = WienerDeblurPipeline(fft_backend="xla", pad_mode="smooth")
    out, planes = pipe.restore_with_planes(img, 15, 30.0)

    psf = motion_blur_kernel_oracle(15, 30.0)
    chans = np.moveaxis(img.astype(np.float32) / np.float32(255.0), -1, 0)
    oracle = restore_channels(chans, psf, 0.01, pad_to=(hp, wp))
    # gpu-tier bound, not inf: at non-pow2 extents the ORACLE runs the
    # reference's naive DFT whose angles round to f32 at k*t ~ 1e5
    # (fft_serial.cpp:80 float ang) — ~1e-4 twiddle phase noise that the
    # Wiener division amplifies image-dependently (measured up to ~9e-3
    # INF). See the f64-prototype test below for the tight bound.
    assert np.abs(planes - oracle).max() < 2e-2
    mse = float(((planes - oracle) ** 2).mean())
    assert 10 * np.log10(1.0 / (mse + 1e-20)) > 40.0
    assert out.shape == img.shape and out.dtype == np.uint8


def test_pipeline_smooth_pad_matches_f64_prototype(rng):
    """The tight parity bound for smooth extents: vs a float64 np.fft
    restore at the same extents (the prototype cross-check,
    others/fft_image_restoration.py) the pipeline is ~f32-exact — the
    looser oracle bound above is the ORACLE's f32-angle naive-DFT noise,
    not the pipeline's."""
    from fft_restoration_tpu.models.pipeline import (
        WienerDeblurPipeline,
        pad_extents,
    )
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle

    img = (rng.random((300, 600, 3)) * 255).astype(np.uint8)
    h, w = img.shape[:2]
    hp, wp = pad_extents(h, w, "smooth")
    pipe = WienerDeblurPipeline(fft_backend="xla", pad_mode="smooth")
    _, planes = pipe.restore_with_planes(img, 15, 30.0)

    psf = motion_blur_kernel_oracle(15, 30.0)
    chans = np.moveaxis(img.astype(np.float64) / 255.0, -1, 0)
    K = 0.01
    ref = []
    for c in chans:
        cp = np.zeros((hp, wp)); cp[:h, :w] = c
        pp = np.zeros((hp, wp)); pp[: psf.shape[0], : psf.shape[1]] = psf
        G = np.fft.fft2(cp)
        H = np.fft.fft2(pp)
        r = np.fft.ifft2(G * np.conj(H) / (np.abs(H) ** 2 + K)).real
        lo, hi = r.min(), r.max()
        ref.append(((r - lo) / (hi - lo))[:h, :w])
    assert np.abs(planes - np.stack(ref)).max() < 2e-4


def test_pipeline_smooth_pad_matmul_backend():
    """The matmul backend's generalized four-step covers smooth extents
    too; parity vs the oracle at the same pad."""
    from fft_restoration_tpu.models.pipeline import (
        WienerDeblurPipeline,
        pad_extents,
    )
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
    from fft_restoration_tpu.oracle.serial import restore_channels

    img = (np.random.default_rng(3).random((300, 600, 3)) * 255).astype(np.uint8)
    hp, wp = pad_extents(300, 600, "smooth")
    pipe = WienerDeblurPipeline(fft_backend="matmul", pad_mode="smooth")
    _, planes = pipe.restore_with_planes(img, 15, 30.0)
    psf = motion_blur_kernel_oracle(15, 30.0)
    chans = np.moveaxis(img.astype(np.float32) / np.float32(255.0), -1, 0)
    oracle = restore_channels(chans, psf, 0.01, pad_to=(hp, wp))
    # gpu-tier bound (oracle-side naive-DFT angle noise; see above)
    assert np.abs(planes - oracle).max() < 2e-2


def test_batched_smooth_pad_matches_single(rng):
    """BatchedWienerPipeline(pad_mode='smooth') == per-image smooth
    restores (same extents, batched postproc)."""
    from fft_restoration_tpu.models.batched import BatchedWienerPipeline
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

    imgs = (rng.random((4, 300, 380, 3)) * 255).astype(np.uint8)
    batched = BatchedWienerPipeline(fft_backend="xla", pad_mode="smooth")
    singles = WienerDeblurPipeline(fft_backend="xla", pad_mode="smooth")
    outs = batched.restore(imgs, 11, 30.0)
    for i in range(imgs.shape[0]):
        one = singles.restore(imgs[i], 11, 30.0)
        d = np.abs(outs[i].astype(np.int32) - one.astype(np.int32)).max()
        assert d <= 1  # one uint8 count (batched norm partial order)


def test_oracle_pad_to_validates():
    from fft_restoration_tpu.oracle.serial import wiener_deblur

    with pytest.raises(ValueError, match="smaller than the image"):
        wiener_deblur(np.zeros((64, 64), np.float32), np.ones((3, 3), np.float32),
                      pad_to=(32, 64))


def test_cli_pad_smooth(tmp_path, rng):
    """--pad smooth end to end through the CLI incl. oracle verification
    at matching extents (exit 0 = [Success])."""
    from fft_restoration_tpu.cli import main
    from fft_restoration_tpu.utils.imageio import imwrite

    img = (rng.random((300, 380, 3)) * 255).astype(np.uint8)
    src = tmp_path / "in.png"
    imwrite(str(src), img)
    out = tmp_path / "out.png"
    # gpu tier: at mixed extents the oracle's naive DFT carries ~1e-4
    # f32-angle twiddle noise (the reference's own dft_naive_inplace
    # semantics), so the strict tiers are not a meaningful contract there
    rc = main(
        [str(src), "11", "30", "--mode", "jit", "--fft-backend", "xla",
         "--pad", "smooth", "--tier", "gpu", "-o", str(out)]
    )
    assert rc == 0
    assert out.exists()


@pytest.fixture(scope="module")
def mesh8():
    from fft_restoration_tpu.parallel.mesh import make_mesh

    return make_mesh(8)


def test_sharded_smooth_planes_match_single_chip(rng, mesh8):
    """Smooth extents through the sharded path (local transforms of the
    all_to_all conv layout) == the single-device restore at the same
    extents. Small smooth planes (3*8 x 5*8) keep the 8-device CPU mesh
    cheap; the real-extent path is covered by the pipeline tests."""
    from fft_restoration_tpu.models.pipeline import restore_planes
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
    from fft_restoration_tpu.parallel.sharded_pipeline import (
        sharded_restore_planes,
    )

    chans = rng.random((3, 24, 40)).astype(np.float32)  # 3*8, 5*8
    psf = motion_blur_kernel_oracle(5, 30.0)
    single = np.asarray(
        restore_planes(jnp.asarray(chans), jnp.asarray(psf), 0.01)
    )
    sharded = sharded_restore_planes(chans, psf, 0.01, mesh=mesh8)
    assert np.abs(single - sharded).max() < 1e-3


def test_sharded_pipeline_smooth_matches_oracle(mesh8):
    """ShardedWienerPipeline(pad_mode='smooth') end to end on the
    virtual 8-device mesh vs the oracle at the smooth extents."""
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
    from fft_restoration_tpu.oracle.serial import restore_channels
    from fft_restoration_tpu.models.pipeline import pad_extents
    from fft_restoration_tpu.parallel.sharded_pipeline import (
        ShardedWienerPipeline,
    )

    img = (np.random.default_rng(3).random((300, 380, 3)) * 255).astype(np.uint8)
    sp = ShardedWienerPipeline(
        mesh=mesh8, fft_backend="matmul", pad_mode="smooth"
    )
    ours = sp.restore_channels(img, 9, 30.0)
    hp, wp = pad_extents(300, 380, "smooth")
    imgf = img.astype(np.float32) / np.float32(255.0)
    oracle = restore_channels(
        np.moveaxis(imgf, -1, 0), motion_blur_kernel_oracle(9, 30.0),
        pad_to=(hp, wp),
    )
    # gpu-tier bound: oracle-side f32-angle naive DFT noise (see above)
    assert np.abs(ours - oracle).max() < 2e-2
