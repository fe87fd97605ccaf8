"""Row-sharded distributed 2D FFT with all-to-all transposes.

Re-design of the reference's MPI distributed FFT
(reference fft/fft_mpi.cpp:284-307): rows are block-sharded over
ranks, 1D FFTs are rank-local, and the two global transposes are
realized as collective exchanges. Where MPI packs per-destination tiles
by hand and calls MPI_Alltoallv (fft_mpi.cpp:170-279), here a single
`jax.lax.all_to_all` over the mesh axis does the reshard and XLA emits
the collective (NCCL over NVLink on a GPU host) — the pack/unpack tiling the reference hand-writes
(TILE_SIZE=32 blocking, fft_mpi.cpp:204-278) is the compiler's job.

This is structurally Ulysses-style all-to-all sequence parallelism
(SURVEY.md §5): shard one axis, all_to_all to re-shard the other,
compute locally, all_to_all back.

All functions run INSIDE shard_map: arrays are local blocks, the mesh
axis name identifies the collective group.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND, fft1d
from fft_restoration_tpu.parallel.mesh import ROWS_AXIS

SoA = Tuple[jnp.ndarray, jnp.ndarray]


def _reshard_rows_to_cols(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """(..., H/D, W) row-sharded -> (..., H, W/D) column-sharded.

    The distributed transpose's communication step (≙ fft_mpi.cpp:242-244
    MPI_Alltoallv): split the local width into D chunks, exchange, stack
    received row-blocks in device order.
    """
    return jax.lax.all_to_all(
        x, axis_name, split_axis=x.ndim - 1, concat_axis=x.ndim - 2, tiled=True
    )


def _reshard_cols_to_rows(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """(..., H, W/D) column-sharded -> (..., H/D, W) row-sharded."""
    return jax.lax.all_to_all(
        x, axis_name, split_axis=x.ndim - 2, concat_axis=x.ndim - 1, tiled=True
    )


def _fft_true(re, im, inverse: bool, backend: str, true_n: int | None) -> SoA:
    """1D DFT over the last axis at its TRUE length.

    Non-power-of-two meshes pad the global dims to device-count
    multiples so shard_map/all_to_all get even splits — but the DFT must
    still run at the pow2 (or smooth) extent to preserve oracle parity.
    The trailing layout padding is sliced off before the transform and
    zero-refilled after (zeros in = zeros out for the padded rows, so the
    pad region stays zero through the whole restore)."""
    n_pad = re.shape[-1]
    if true_n is None or true_n == n_pad:
        return fft1d(re, im, inverse, backend)
    re_t, im_t = fft1d(re[..., :true_n], im[..., :true_n], inverse, backend)
    pad = [(0, 0)] * (re.ndim - 1) + [(0, n_pad - true_n)]
    return jnp.pad(re_t, pad), jnp.pad(im_t, pad)


def sharded_fft2d_conv_fwd(
    re: jnp.ndarray,
    im: jnp.ndarray,
    backend: str = DEFAULT_FFT_BACKEND,
    axis_name: str = ROWS_AXIS,
    true_w: int | None = None,
    true_h: int | None = None,
) -> SoA:
    """Forward 2D DFT that STOPS in the transposed, column-sharded
    layout: local block (..., H/D, W) -> spectrum block (..., W/D, H).

    The reference's distributed my_dft2D does two Alltoallv per
    transform to return data row-sharded (fft_mpi.cpp:296,306). For
    convolution-style use the second exchange is pure waste — the
    elementwise filter doesn't care about layout, and the inverse
    transform can consume the transposed layout directly
    (sharded_fft2d_conv_inv). One all_to_all per transform instead of
    two: the full Wiener restore does 3 collective exchanges instead of
    the reference's 6 (the 'transpose-free FFT' formulation, cf.
    PAPERS.md arXiv:1406.5597).

    true_w/true_h: logical (pow2 or smooth) extents when the global
    layout is padded for a non-power-of-two mesh (see _fft_true).
    """
    re, im = _fft_true(re, im, False, backend, true_w)
    re = _reshard_rows_to_cols(re, axis_name)
    im = _reshard_rows_to_cols(im, axis_name)
    re = jnp.swapaxes(re, -1, -2)
    im = jnp.swapaxes(im, -1, -2)
    return _fft_true(re, im, False, backend, true_h)


def sharded_fft2d_conv_inv(
    re: jnp.ndarray,
    im: jnp.ndarray,
    backend: str = DEFAULT_FFT_BACKEND,
    axis_name: str = ROWS_AXIS,
    true_w: int | None = None,
    true_h: int | None = None,
) -> SoA:
    """Inverse of sharded_fft2d_conv_fwd: spectrum block (..., W/D, H)
    -> spatial block (..., H/D, W), unscaled. One all_to_all."""
    re, im = _fft_true(re, im, True, backend, true_h)
    re = jnp.swapaxes(re, -1, -2)
    im = jnp.swapaxes(im, -1, -2)
    re = _reshard_cols_to_rows(re, axis_name)
    im = _reshard_cols_to_rows(im, axis_name)
    return _fft_true(re, im, True, backend, true_w)


def sharded_fft2d(
    re: jnp.ndarray,
    im: jnp.ndarray,
    inverse: bool = False,
    backend: str = DEFAULT_FFT_BACKEND,
    axis_name: str = ROWS_AXIS,
) -> SoA:
    """2D DFT of a row-sharded SoA plane, inside shard_map.

    Local blocks are (..., H/D, W). Mirrors the distributed my_dft2D
    (fft_mpi.cpp:284-307): local row FFTs -> collective reshard ->
    local column FFTs -> collective reshard back. Unscaled inverse.
    """
    # 1) local row FFTs (full length W) — fft_mpi.cpp:289-292
    re, im = fft1d(re, im, inverse, backend)
    # 2) distributed transpose — fft_mpi.cpp:296
    re = _reshard_rows_to_cols(re, axis_name)
    im = _reshard_rows_to_cols(im, axis_name)
    # 3) local column FFTs (full length H, on the last axis after swap)
    re = jnp.swapaxes(re, -1, -2)
    im = jnp.swapaxes(im, -1, -2)
    re, im = fft1d(re, im, inverse, backend)
    re = jnp.swapaxes(re, -1, -2)
    im = jnp.swapaxes(im, -1, -2)
    # 4) transpose back — fft_mpi.cpp:306
    re = _reshard_cols_to_rows(re, axis_name)
    im = _reshard_cols_to_rows(im, axis_name)
    return re, im
