"""Richardson-Lucy iterative deconvolution vs a float64 NumPy reference.

The reference repo has no iterative restorer (Wiener only plus the
inverse/CLS lineage, others/fft_image_restoration.py); RL extends the
filter family with the classic multiplicative fixed point under the
same circular-convolution blur model (utils/blurgen.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fft_restoration_tpu.models.richardson_lucy import richardson_lucy_planes
from fft_restoration_tpu.utils.blurgen import blur_image


def _rl_ref(y, psf, iters, eps=1e-6, hp=None, wp=None):
    """float64 np.fft reference, identical model: corner-anchored PSF,
    circular convolution, min-max normalize at the end."""
    hp = hp or y.shape[-2]
    wp = wp or y.shape[-1]
    pp = np.zeros((hp, wp))
    pp[: psf.shape[0], : psf.shape[1]] = psf
    H = np.fft.fft2(pp)
    out = []
    for c in y:
        x = c.astype(np.float64).copy()
        for _ in range(iters):
            conv = np.real(np.fft.ifft2(np.fft.fft2(x) * H))
            ratio = c / (conv + eps)
            x = np.maximum(
                x * np.real(np.fft.ifft2(np.fft.fft2(ratio) * np.conj(H))),
                0.0,
            )
        out.append(np.clip(x, 0.0, 1.0))
    return np.stack(out)


@pytest.mark.parametrize("backend", ("matmul", "xla"))
def test_rl_matches_f64_reference(rng, backend):
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle

    psf = motion_blur_kernel_oracle(7, 30.0)
    y = rng.random((3, 64, 64)).astype(np.float32)
    ours = np.asarray(
        richardson_lucy_planes(
            jnp.asarray(y), jnp.asarray(psf), 8, fft_backend=backend
        )
    )
    ref = _rl_ref(y, psf, 8)
    assert np.abs(ours - ref).max() < 2e-3  # f32 loop vs f64, 8 iters


def test_rl_xla_matches_matmul(rng):
    """The library-FFT route runs the same iteration: cross-backend
    parity on a 256 x 128 stack."""
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle

    psf = motion_blur_kernel_oracle(9, 45.0)
    y = rng.random((3, 256, 128)).astype(np.float32)
    a = np.asarray(
        richardson_lucy_planes(jnp.asarray(y), jnp.asarray(psf), 6,
                               fft_backend="xla")
    )
    b = np.asarray(
        richardson_lucy_planes(jnp.asarray(y), jnp.asarray(psf), 6,
                               fft_backend="matmul")
    )
    assert np.abs(a - b).max() < 1e-3


def test_rl_mixed_radix_extents(rng):
    """RL at smooth (384 x 640) extents on the xla route."""
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle

    psf = motion_blur_kernel_oracle(7, 30.0)
    y = rng.random((3, 384, 640)).astype(np.float32)
    ours = np.asarray(
        richardson_lucy_planes(
            jnp.asarray(y), jnp.asarray(psf), 4, fft_backend="xla"
        )
    )
    ref = _rl_ref(y, psf, 4)
    assert np.abs(ours - ref).max() < 2e-3


def test_rl_actually_deblurs(rng):
    """On a synthetically blurred image (the blurgen inverse problem) RL
    must INCREASE PSNR against the sharp original."""
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
    from fft_restoration_tpu.utils.blurgen import blur_image
    from fft_restoration_tpu.utils.verify import psnr

    sharp = np.zeros((96, 96, 3), np.uint8)
    sharp[20:70, 30:40] = 255
    sharp[40:50, 10:90] = 200
    blurred = blur_image(sharp, 9, 0.0)

    # RL's PSF must match blurgen's placement (centered, rolled to the
    # corner, sum-normalized) so the restoration is shift-free; pass it
    # as a full-size corner-anchored kernel.
    h, w = 96, 96
    psf = motion_blur_kernel_oracle(9, 0.0).astype(np.float64)
    psf /= psf.sum()
    full = np.zeros((h, w))
    cy, cx = psf.shape[0] // 2, psf.shape[1] // 2
    full[h // 2 - cy : h // 2 - cy + psf.shape[0],
         w // 2 - cx : w // 2 - cx + psf.shape[1]] = psf
    psf_corner = np.roll(full, (-(h // 2), -(w // 2)), axis=(0, 1)).astype(
        np.float32
    )

    y = np.moveaxis(blurred.astype(np.float32) / 255.0, -1, 0)
    restored = np.asarray(
        richardson_lucy_planes(jnp.asarray(y), jnp.asarray(psf_corner), 25)
    )
    s = np.moveaxis(sharp.astype(np.float64) / 255.0, -1, 0)
    before = psnr(s, y.astype(np.float64), peak=1.0)
    after = psnr(s, restored.astype(np.float64), peak=1.0)
    assert after > before + 3.0, (before, after)


def test_rl_through_pipeline_and_cli(tmp_path, rng):
    """--filter rl end to end: WienerDeblurPipeline(filter_name='rl')
    and the CLI route produce a uint8 image (no oracle verify — the
    reference has no RL; parity is the f64 reference above)."""
    from fft_restoration_tpu.cli import main
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu.utils.imageio import imwrite

    img = (rng.random((80, 100, 3)) * 255).astype(np.uint8)
    pipe = WienerDeblurPipeline(
        fft_backend="matmul", filter_name="rl", rl_iters=5
    )
    out = pipe.restore(img, 7, 30.0)
    assert out.shape == img.shape and out.dtype == np.uint8

    src = tmp_path / "in.png"
    imwrite(str(src), img)
    dst = tmp_path / "out.png"
    rc = main(
        [str(src), "7", "30", "--mode", "jit", "--filter", "rl",
         "--iters", "5", "-o", str(dst)]
    )
    assert rc == 0 and dst.exists()

    rc = main(
        [str(src), "7", "30", "--mode", "sharded", "--devices", "4",
         "--filter", "rl", "--iters", "3",
         "-o", str(tmp_path / "out_sharded.png")]
    )
    assert rc == 0  # RL runs inside the shard_map body too


def test_rl_batched_matches_single():
    """BatchedWienerPipeline(filter_name='rl') runs the same iteration
    over the stack axis: per-image parity vs WienerDeblurPipeline.

    Parity is NOT bit-exact for every image: the batch path packs
    complex pairs across image boundaries (B*3 flattened planes), and
    the spectral multiply c_re = a_re*s_re - a_im*s_im mixes the two
    planes' f32 rounding, which RL's divisions then amplify — measured
    max 6 uint8 counts / mean < 0.1 over 4 iters. Where the pairing
    happens to align with the single-image grouping (the LAST image of
    an odd-B stack: planes 6,7 pair + 8 alone == c0,c1 pair + c2
    alone), output is bit-exact — pinning that the plane-wise packing
    claim in richardson_lucy.py holds exactly."""
    from fft_restoration_tpu.models.batched import BatchedWienerPipeline
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu.utils.blurgen import blur_image

    stack = []
    for i in range(3):
        s = np.zeros((72, 96, 3), np.uint8)
        s[10 + 5 * i : 50, 20 : 40 + 5 * i] = 200
        s[30:40, 10:80] = 120 + 20 * i
        stack.append(blur_image(s, 7, 30.0))
    imgs = np.stack(stack)
    batched = BatchedWienerPipeline(
        fft_backend="matmul", filter_name="rl", rl_iters=4
    ).restore(imgs, 7, 30.0)
    single = WienerDeblurPipeline(
        fft_backend="matmul", filter_name="rl", rl_iters=4
    )
    assert batched.shape == imgs.shape and batched.dtype == np.uint8
    for i in range(imgs.shape[0]):
        one = single.restore(imgs[i], 7, 30.0)
        d = np.abs(batched[i].astype(np.int16) - one.astype(np.int16))
        assert d.max() <= 8 and d.mean() <= 0.2, (i, d.max(), d.mean())
    assert d.max() == 0  # last image: aligned pairing -> bit-exact


def test_rl_tall_frame_matches_matmul(rng):
    """RL on a tall (512 x 256) stack: parity vs the matmul backend."""
    from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle

    psf = motion_blur_kernel_oracle(9, 60.0)
    y = rng.random((3, 512, 256)).astype(np.float32)
    a = np.asarray(
        richardson_lucy_planes(jnp.asarray(y), jnp.asarray(psf), 4,
                               fft_backend="xla")
    )
    b = np.asarray(
        richardson_lucy_planes(jnp.asarray(y), jnp.asarray(psf), 4,
                               fft_backend="matmul")
    )
    assert np.abs(a - b).max() < 1e-3


def test_rl_sharded_matches_single():
    """Sharded RL (fori_loop of distributed convs inside the shard_map
    body, 4 all_to_all exchanges per iteration) vs the single-chip RL.

    Deterministic input (a BLURRED smooth scene — the conditioned
    observation RL is meant for) and a 3-count budget: RL's divisions
    amplify the sharded-vs-single f32 transform rounding to a few
    counts (the intrinsic ~1e-2 plane sensitivity documented in
    richardson_lucy.py; a session-shared rng image here flaked at the
    1-count line depending on collection order)."""
    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline
    from fft_restoration_tpu.parallel.mesh import make_mesh
    from fft_restoration_tpu.parallel.sharded_pipeline import (
        ShardedWienerPipeline,
    )

    yy, xx = np.mgrid[0:48, 0:64]
    scene = np.zeros((48, 64, 3), np.float32)
    scene[..., 0] = 80 + 90 * np.sin(yy / 9.0) * np.cos(xx / 11.0)
    scene[..., 1] = 60 + 1.5 * xx
    scene[..., 2] = 70 + 2.0 * yy
    scene[12:36, 28:34] += 110
    img = blur_image(np.clip(scene, 0, 255).astype(np.uint8), 7, 45.0)
    out_s = ShardedWienerPipeline(
        mesh=make_mesh(8), fft_backend="matmul", filter_name="rl",
        rl_iters=4,
    ).restore(img, 7, 45.0)
    out_1 = WienerDeblurPipeline(
        fft_backend="matmul", filter_name="rl", rl_iters=4
    ).restore(img, 7, 45.0)
    assert np.abs(out_s.astype(int) - out_1.astype(int)).max() <= 3
