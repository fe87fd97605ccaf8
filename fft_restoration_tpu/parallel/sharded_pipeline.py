"""Mesh-sharded Wiener restoration: shard_map FFTs + GSPMD post-processing.

Re-design of the reference's MPI SPMD pipeline
(reference fft/fft_mpi.cpp:311-470). The mapping (SURVEY.md §2):

  MPI_Bcast of dims          -> SPMD closure constants (static shapes)
  MPI_Scatterv row blocks    -> NamedSharding placement / sharding
                                constraints on the jit inputs
  local row FFT + Alltoallv  -> parallel.sharded_fft (all_to_all, NCCL)
  local Wiener elementwise   -> local block math inside shard_map
  rank-0 global normalize    -> pmin/pmax collectives (no gather —
                                SURVEY.md §7 hard part 4)
  MPI_Gatherv                -> output NamedSharding (host gathers only
                                at np.asarray time)

The FFT core runs inside shard_map (explicit collectives); crop, Lab
white balance and uint8 conversion run as plain jnp on the global view,
auto-partitioned by GSPMD (means become psums).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND
from fft_restoration_tpu.ops.psf import make_psf
from fft_restoration_tpu.ops.wiener import wiener_filter, inverse_filter, cls_filter
from fft_restoration_tpu.parallel.mesh import ROWS_AXIS, make_mesh
from fft_restoration_tpu.parallel.sharded_fft import (
    sharded_fft2d,
    sharded_fft2d_conv_fwd,
    sharded_fft2d_conv_inv,
)
from fft_restoration_tpu.utils.padding import next_power_of_two


def _local_restore_planes(
    ch_blk: jnp.ndarray,
    psf_blk: jnp.ndarray,
    lap_blk: jnp.ndarray,
    K: jnp.ndarray,
    wy_blk: jnp.ndarray | None = None,
    wx_full: jnp.ndarray | None = None,
    *,
    hp: int,
    wp: int,
    fft_backend: str,
    filter_name: str,
    axis_name: str = ROWS_AXIS,
    edgetaper: bool = False,
    rl_iters: int = 10,
    normalize: bool = True,
) -> jnp.ndarray:
    """Per-device body (inside shard_map). Blocks: ch (C, Hpad/D, Wpad),
    psf/lap (Hpad/D, Wpad). Returns normalized restored block
    (normalize=False returns the RAW unscaled-inverse block — the
    tiled×mesh path stitches raw tiles and normalizes globally, matching
    models/pipeline.restore_planes(normalize=False); 'rl' ignores it,
    its clipped [0,1] output is already flux-calibrated).

    hp/wp are the TRUE pow2 DFT extents; Hpad/Wpad may exceed them on a
    non-power-of-two mesh, where the layout is padded to even
    device-count splits but every transform still runs at hp/wp
    (sharded_fft._fft_true), preserving exact oracle parity.

    Uses the transpose-free convolution layout (sharded_fft2d_conv_fwd/
    _inv): spectra live column-sharded+transposed, the elementwise
    filter runs there, and only 3 all_to_all exchanges happen per
    restore vs the reference's 6 (SURVEY.md §3.2)."""
    zero_p = jnp.zeros_like(psf_blk)
    tw = {"true_w": wp, "true_h": hp}
    # channel packing (models/pipeline._pack_channel_pairs): every
    # filter is a single Hermitian multiply, so channel pairs ride one
    # complex transform — same packing as single-device, preserving
    # bit-identity between the two paths
    from fft_restoration_tpu.models.pipeline import (
        _pack_channel_pairs,
        _unpack_channel_pairs,
    )

    n_chan = ch_blk.shape[-3] if ch_blk.ndim >= 3 else None
    if n_chan is not None and n_chan >= 2:
        p_re, p_im = _pack_channel_pairs(ch_blk)
    else:
        n_chan = None
        p_re, p_im = ch_blk, jnp.zeros_like(ch_blk)
    H = sharded_fft2d_conv_fwd(psf_blk, zero_p, fft_backend, axis_name, **tw)
    if edgetaper:
        # Sharded edge taper (models/edgetaper.py semantics): blend the
        # local block toward its circular blur, with the blur riding the
        # SAME conv-layout distributed FFTs (2 extra transforms = +1
        # all_to_all pair per restore). wy_blk is this device's row
        # slice of the 1D window; the layout-pad rows beyond the true
        # (hp, wp) extent keep their zeros via the valid mask.
        g0_re, g0_im = sharded_fft2d_conv_fwd(
            p_re, p_im, fft_backend, axis_name, **tw
        )
        b_re = g0_re * H[0] - g0_im * H[1]
        b_im = g0_re * H[1] + g0_im * H[0]
        b_re, b_im = sharded_fft2d_conv_inv(
            b_re, b_im, fft_backend, axis_name, **tw
        )
        inv_scale = jnp.float32(1.0 / (hp * wp))
        blk_h, blk_w = p_re.shape[-2], p_re.shape[-1]
        alpha = wy_blk[:, None] * wx_full[None, :]
        row0 = jax.lax.axis_index(axis_name) * blk_h
        gr = row0 + jax.lax.broadcasted_iota(jnp.int32, (blk_h, blk_w), 0)
        gc = jax.lax.broadcasted_iota(jnp.int32, (blk_h, blk_w), 1)
        valid = (gr < hp) & (gc < wp)
        p_re = jnp.where(
            valid, alpha * p_re + (1.0 - alpha) * b_re * inv_scale, p_re
        )
        p_im = jnp.where(
            valid, alpha * p_im + (1.0 - alpha) * b_im * inv_scale, p_im
        )
    if filter_name == "rl":
        # Richardson-Lucy inside the shard_map body: the multiplicative
        # fixed point of models/richardson_lucy.py with the convs riding
        # the conv-layout distributed FFTs — 2 convs = 4 all_to_all
        # exchanges per iteration (1 per conv_fwd/conv_inv), one traced
        # fori_loop body regardless of rl_iters. Plane-wise
        # nonlinear steps keep the channel packing valid (richardson_
        # lucy.py docstring). Output is CLIPPED to [0,1], not min-max
        # normalized (flux-preserving iteration; boundary spikes would
        # crush the stretch).
        inv_scale = jnp.float32(1.0 / (hp * wp))
        eps32 = jnp.float32(1e-6)

        def _conv(re, im, conj):
            g_re, g_im = sharded_fft2d_conv_fwd(
                re, im, fft_backend, axis_name, **tw
            )
            hr, hi = H[0], (-H[1] if conj else H[1])
            c_re = g_re * hr - g_im * hi
            c_im = g_re * hi + g_im * hr
            b_re, b_im = sharded_fft2d_conv_inv(
                c_re, c_im, fft_backend, axis_name, **tw
            )
            return b_re * inv_scale, b_im * inv_scale

        y_re, y_im = p_re, p_im

        def _body(_, x):
            x_re, x_im = x
            d_re, d_im = _conv(x_re, x_im, conj=False)
            r_re = y_re / (d_re + eps32)
            r_im = y_im / (d_im + eps32)
            g_re, g_im = _conv(r_re, r_im, conj=True)
            return (
                jnp.maximum(x_re * g_re, 0.0),
                jnp.maximum(x_im * g_im, 0.0),
            )

        x_re, x_im = jax.lax.fori_loop(0, rl_iters, _body, (y_re, y_im))
        restored = (
            x_re if n_chan is None
            else _unpack_channel_pairs(x_re, x_im, n_chan)
        )
        return jnp.clip(restored, 0.0, 1.0)

    G = sharded_fft2d_conv_fwd(p_re, p_im, fft_backend, axis_name, **tw)
    if filter_name == "wiener":
        F = wiener_filter(G, H, K)
    elif filter_name == "inverse":
        F = inverse_filter(G, H)
    elif filter_name == "cls":
        Pf = sharded_fft2d_conv_fwd(
            lap_blk, jnp.zeros_like(lap_blk), fft_backend, axis_name, **tw
        )
        F = cls_filter(G, H, Pf, K)
    else:
        raise ValueError(f"unknown filter {filter_name!r}")
    r_re, r_im = sharded_fft2d_conv_inv(F[0], F[1], fft_backend, axis_name, **tw)
    # unscaled inverse + scale-invariant normalize, matching the
    # single-device pipeline (models/pipeline.py note)
    restored = r_re if n_chan is None else _unpack_channel_pairs(r_re, r_im, n_chan)
    if not normalize:
        return restored

    # Global min-max over the TRUE padded plane (hp x wp): local reduce +
    # cross-device collectives — replaces the reference's
    # gather-to-rank-0 normalize (fft_mpi.cpp:436-452). On a non-pow2
    # mesh the layout-pad region (zeros) must not join the reduction.
    blk_h, blk_w = restored.shape[-2], restored.shape[-1]
    padded = blk_w != wp or blk_h * jax.lax.axis_size(axis_name) != hp
    if padded:
        row0 = jax.lax.axis_index(axis_name) * blk_h
        gr = row0 + jax.lax.broadcasted_iota(jnp.int32, (blk_h, blk_w), 0)
        gc = jax.lax.broadcasted_iota(jnp.int32, (blk_h, blk_w), 1)
        valid = (gr < hp) & (gc < wp)
        neg = jnp.where(valid, restored, jnp.inf)
        pos = jnp.where(valid, restored, -jnp.inf)
    else:
        neg = pos = restored
    lo = jax.lax.pmin(jnp.min(neg, axis=(-2, -1)), axis_name)
    hi = jax.lax.pmax(jnp.max(pos, axis=(-2, -1)), axis_name)
    lo = lo[..., None, None]
    hi = hi[..., None, None]
    scale = jnp.where(hi > lo, 1.0 / (hi - lo), 0.0)
    return (restored - lo) * scale


def _sharded_core(
    img_f32: jnp.ndarray,
    angle_deg: jnp.ndarray,
    K: jnp.ndarray,
    *,
    mesh: Mesh,
    psf_length: int,
    fft_backend: str,
    filter_name: str,
    white_balance: bool,
    pad_mode: str = "pow2",
    edgetaper: bool = False,
    rl_iters: int = 10,
    psf_type: str = "motion",
):
    """(H, W, 3) float32 BGR global -> (uint8 image, restored planes)."""
    from fft_restoration_tpu.models.pipeline import pad_extents

    h, w = img_f32.shape[:2]
    hp, wp = pad_extents(h, w, pad_mode)
    n_dev = mesh.devices.size
    # Non-power-of-two meshes can't evenly split pow2 dims (rows for the
    # shard, cols for the all_to_all split axis). Pad the LAYOUT only —
    # up to the next device-count multiple — while every DFT still runs
    # at the true (hp, wp) extent (sharded_fft._fft_true) and the
    # min-max normalize masks the pad region, so any mesh size is
    # bit-compatible with the single-device restore. Power-of-two meshes
    # have hpad==hp, wpad==wp.
    hpad = -(-hp // n_dev) * n_dev
    wpad = -(-wp // n_dev) * n_dev

    psf = make_psf(psf_type, psf_length, angle_deg)
    psf_pad = jnp.pad(psf, ((0, hpad - psf_length), (0, wpad - psf_length)))
    chans = jnp.moveaxis(img_f32, -1, 0)
    chans = jnp.pad(chans, ((0, 0), (0, hpad - h), (0, wpad - w)))

    # periodic Laplacian at the TRUE (hp, wp) extent (its wrap-around
    # entries sit at hp-1/wp-1, not at the layout-pad edges)
    lap = np.zeros((hpad, wpad), np.float32)
    lap[0, 0] = 4.0
    lap[0, 1] = lap[1, 0] = lap[0, wp - 1] = lap[hp - 1, 0] = -1.0
    lap = jnp.asarray(lap)

    # Row-shard the planes (≙ MPI_Scatterv, fft_mpi.cpp:372-378).
    chans = jax.lax.with_sharding_constraint(
        chans, NamedSharding(mesh, P(None, ROWS_AXIS, None))
    )
    psf_pad = jax.lax.with_sharding_constraint(
        psf_pad, NamedSharding(mesh, P(ROWS_AXIS, None))
    )

    local_fn = functools.partial(
        _local_restore_planes,
        hp=hp,
        wp=wp,
        fft_backend=fft_backend,
        filter_name=filter_name,
        edgetaper=edgetaper,
        rl_iters=rl_iters,
    )
    in_specs = [P(None, ROWS_AXIS, None), P(ROWS_AXIS, None),
                P(ROWS_AXIS, None), P()]
    operands = [chans, psf_pad, lap, K]
    if edgetaper:
        from fft_restoration_tpu.utils.taper import taper_windows

        wy, wx = taper_windows(h, w, hp, wp, psf_length)
        wy = jnp.asarray(np.pad(wy, (0, hpad - hp)))
        wx = jnp.asarray(np.pad(wx, (0, wpad - wp)))
        in_specs += [P(ROWS_AXIS), P()]
        operands += [
            jax.lax.with_sharding_constraint(
                wy, NamedSharding(mesh, P(ROWS_AXIS))
            ),
            wx,
        ]
    restored = jax.shard_map(
        local_fn,
        mesh=mesh,
        check_vma=False,
        in_specs=tuple(in_specs),
        out_specs=P(None, ROWS_AXIS, None),
    )(*operands)

    # Post-processing on the global view, PLANAR (see models/pipeline.py);
    # GSPMD partitions these, means become psums (SURVEY §7 hard part 4).
    cropped = restored[..., :h, :w]
    from fft_restoration_tpu.models.pipeline import wb_encode

    out = wb_encode(cropped, jnp.moveaxis(img_f32, -1, 0), white_balance)
    return out, cropped


# jitted shard_map executables for the mid-level plane APIs, keyed on
# (mesh, shapes, config): fresh jit objects per call would re-trace the
# whole sharded graph on every invocation (the class-based pipelines
# already cache; these module-level APIs are called per CLI size-group)
_SHARDED_JIT_CACHE = {}


def _mesh_key(mesh: Mesh):
    return (
        tuple(mesh.shape.items()),
        tuple(int(d.id) for d in mesh.devices.flat),
    )


def sharded_restore_planes(
    channels: np.ndarray,
    psf: np.ndarray,
    K: float = 0.01,
    mesh: Optional[Mesh] = None,
    fft_backend: str = DEFAULT_FFT_BACKEND,
    filter_name: str = "wiener",
) -> np.ndarray:
    """Mid-level API: restore (C, Hp, Wp) pow-2 (or smooth) planes with
    an explicit (S, S) PSF on a row-sharded mesh. Returns normalized
    planes.

    On a non-power-of-two mesh the planes are layout-padded to
    device-count multiples; the transforms still run at (Hp, Wp) and the
    padding is cropped from the result."""
    mesh = mesh or make_mesh()
    c, hp, wp = channels.shape
    n_dev = mesh.devices.size
    hpad = -(-hp // n_dev) * n_dev
    wpad = -(-wp // n_dev) * n_dev
    chan_pad = np.zeros((c, hpad, wpad), np.float32)
    chan_pad[:, :hp, :wp] = channels
    channels = chan_pad
    psf_pad = np.zeros((hpad, wpad), np.float32)
    psf_pad[: psf.shape[0], : psf.shape[1]] = psf
    lap = np.zeros((hpad, wpad), np.float32)
    lap[0, 0] = 4.0
    lap[0, 1] = lap[1, 0] = lap[0, wp - 1] = lap[hp - 1, 0] = -1.0

    key = (
        "planes", _mesh_key(mesh), channels.shape, hp, wp,
        fft_backend, filter_name,
    )
    if key not in _SHARDED_JIT_CACHE:
        local_fn = functools.partial(
            _local_restore_planes,
            hp=hp,
            wp=wp,
            fft_backend=fft_backend,
            filter_name=filter_name,
        )
        _SHARDED_JIT_CACHE[key] = jax.jit(
            jax.shard_map(
                local_fn,
                mesh=mesh,
                check_vma=False,
                in_specs=(
                    P(None, ROWS_AXIS, None),
                    P(ROWS_AXIS, None),
                    P(ROWS_AXIS, None),
                    P(),
                ),
                out_specs=P(None, ROWS_AXIS, None),
            )
        )
    fn = _SHARDED_JIT_CACHE[key]
    out = fn(
        jnp.asarray(channels, jnp.float32),
        jnp.asarray(psf_pad),
        jnp.asarray(lap),
        jnp.float32(K),
    )
    return np.asarray(out)[:, :hp, :wp]


def sharded_batched_restore_planes(
    imgs: np.ndarray,
    psf: np.ndarray,
    K: float = 0.01,
    mesh: Optional[Mesh] = None,
    fft_backend: str = DEFAULT_FFT_BACKEND,
    filter_name: str = "wiener",
    edgetaper: bool = False,
    rl_iters: int = 10,
    normalize: bool = True,
    live_hw: Optional[tuple] = None,
) -> np.ndarray:
    """Batch-AND-row-sharded restoration over a 2D (batch, rows) mesh.

    imgs: (B, C, Hp, Wp) pow-2 planes, shared (S, S) PSF. Images are
    data-parallel over the 'batch' mesh axis (zero communication); each
    image's FFT is row-sharded over 'rows' exactly like the 1D path
    (all_to_all transposes + pmin/pmax normalize, axis_name='rows').
    The batch is layout-padded to a batch-axis multiple and cropped back.
    Returns (B, C, Hp, Wp) normalized planes.

    edgetaper blends every frame toward its circular blur inside the
    shard_map body (same math as the 1D path); live_hw = (h, w) is the
    live image extent the taper window is built for (defaults to the
    full padded plane). filter_name='rl' runs the Richardson-Lucy
    fori_loop inside the body (rl_iters steps). normalize=False returns
    RAW unscaled-inverse planes — the tiled×mesh path stitches those and
    normalizes once globally.
    """
    from fft_restoration_tpu.parallel.mesh import BATCH_AXIS, make_mesh2d

    mesh = mesh or make_mesh2d(1, len(jax.devices()))
    b, c, hp, wp = imgs.shape
    n_b = mesh.shape[BATCH_AXIS]
    n_r = mesh.shape[ROWS_AXIS]
    bpad = -(-b // n_b) * n_b
    hpad = -(-hp // n_r) * n_r
    wpad = -(-wp // n_r) * n_r
    stack = np.zeros((bpad, c, hpad, wpad), np.float32)
    stack[:b, :, :hp, :wp] = imgs
    psf_pad = np.zeros((hpad, wpad), np.float32)
    psf_pad[: psf.shape[0], : psf.shape[1]] = psf
    lap = np.zeros((hpad, wpad), np.float32)
    lap[0, 0] = 4.0
    lap[0, 1] = lap[1, 0] = lap[0, wp - 1] = lap[hp - 1, 0] = -1.0

    key = (
        "batch", _mesh_key(mesh), stack.shape, hp, wp,
        fft_backend, filter_name, edgetaper, rl_iters, normalize, live_hw,
    )
    if key not in _SHARDED_JIT_CACHE:
        local_fn = functools.partial(
            _local_restore_planes,
            hp=hp,
            wp=wp,
            fft_backend=fft_backend,
            filter_name=filter_name,
            edgetaper=edgetaper,
            rl_iters=rl_iters,
            normalize=normalize,
        )
        in_specs = [
            P(BATCH_AXIS, None, ROWS_AXIS, None),
            P(ROWS_AXIS, None),
            P(ROWS_AXIS, None),
            P(),
        ]
        if edgetaper:
            in_specs += [P(ROWS_AXIS), P()]
        _SHARDED_JIT_CACHE[key] = jax.jit(
            jax.shard_map(
                local_fn,
                mesh=mesh,
                check_vma=False,
                in_specs=tuple(in_specs),
                out_specs=P(BATCH_AXIS, None, ROWS_AXIS, None),
            )
        )
    fn = _SHARDED_JIT_CACHE[key]
    operands = [
        jnp.asarray(stack),
        jnp.asarray(psf_pad),
        jnp.asarray(lap),
        jnp.float32(K),
    ]
    if edgetaper:
        from fft_restoration_tpu.utils.taper import taper_windows

        lh, lw = live_hw or (hp, wp)
        wy, wx = taper_windows(lh, lw, hp, wp, psf.shape[-1])
        operands += [
            jnp.asarray(np.pad(wy, (0, hpad - hp))),
            jnp.asarray(np.pad(wx, (0, wpad - wp))),
        ]
    out = fn(*operands)
    return np.asarray(out)[:b, :, :hp, :wp]


def sharded_batched_restore_images(
    stack_u8: np.ndarray,
    psf: np.ndarray,
    K: float = 0.01,
    mesh: Optional[Mesh] = None,
    *,
    fft_backend: str = DEFAULT_FFT_BACKEND,
    filter_name: str = "wiener",
    pad_hw: Optional[tuple] = None,
    edgetaper: bool = False,
    rl_iters: int = 10,
    white_balance: bool = True,
) -> np.ndarray:
    """(B, H, W, 3) uint8 -> (B, H, W, 3) uint8 on the 2D (batch, rows)
    mesh, the WHOLE pipeline in one jit dispatch: pad, (taper,) sharded
    restore, crop, per-frame Lab white balance, u8 encode. The WB and
    encode run as plain jnp on the global view — GSPMD partitions them
    over the batch axis, per-frame means become local reductions (the
    former host-side per-image NumPy color loop at cli.py was the batch
    path's throughput ceiling; reference contract utils.hpp:55-71 ×
    every mode, fft.hpp:9-92).

    pad_hw: DFT extents (Hp, Wp); default next_power_of_two of (H, W).
    """
    from fft_restoration_tpu.parallel.mesh import BATCH_AXIS, make_mesh2d

    mesh = mesh or make_mesh2d(1, len(jax.devices()))
    stack = np.ascontiguousarray(np.asarray(stack_u8, np.uint8))
    b, h, w = stack.shape[:3]
    hp, wp = pad_hw or (next_power_of_two(h), next_power_of_two(w))
    n_b = mesh.shape[BATCH_AXIS]
    n_r = mesh.shape[ROWS_AXIS]
    bpad = -(-b // n_b) * n_b
    hpad = -(-hp // n_r) * n_r
    wpad = -(-wp // n_r) * n_r
    if bpad > b:
        stack = np.concatenate(
            [stack, np.repeat(stack[-1:], bpad - b, axis=0)]
        )
    psf_pad = np.zeros((hpad, wpad), np.float32)
    psf_pad[: psf.shape[0], : psf.shape[1]] = psf
    lap = np.zeros((hpad, wpad), np.float32)
    lap[0, 0] = 4.0
    lap[0, 1] = lap[1, 0] = lap[0, wp - 1] = lap[hp - 1, 0] = -1.0

    key = (
        "batchimg", _mesh_key(mesh), stack.shape, hp, wp,
        fft_backend, filter_name, edgetaper, rl_iters, white_balance,
    )
    if key not in _SHARDED_JIT_CACHE:
        local_fn = functools.partial(
            _local_restore_planes,
            hp=hp,
            wp=wp,
            fft_backend=fft_backend,
            filter_name=filter_name,
            edgetaper=edgetaper,
            rl_iters=rl_iters,
        )
        in_specs = [
            P(BATCH_AXIS, None, ROWS_AXIS, None),
            P(ROWS_AXIS, None),
            P(ROWS_AXIS, None),
            P(),
        ]
        if edgetaper:
            in_specs += [P(ROWS_AXIS), P()]
        smap = jax.shard_map(
            local_fn,
            mesh=mesh,
            check_vma=False,
            in_specs=tuple(in_specs),
            out_specs=P(BATCH_AXIS, None, ROWS_AXIS, None),
        )
        batch_sharding = NamedSharding(
            mesh, P(BATCH_AXIS, None, None, None)
        )

        def full(stack_u8, psf_pad, lap, K, *taper_ops):
            imgs = (
                jax.lax.with_sharding_constraint(stack_u8, batch_sharding)
                .astype(jnp.float32)
                / jnp.float32(255.0)
            )
            chans = jnp.moveaxis(imgs, -1, 1)
            chans = jnp.pad(
                chans, ((0, 0), (0, 0), (0, hpad - h), (0, wpad - w))
            )
            restored = smap(chans, psf_pad, lap, K, *taper_ops)
            cropped = restored[..., :h, :w]
            from fft_restoration_tpu.models.pipeline import wb_encode

            return wb_encode(cropped, jnp.moveaxis(imgs, -1, 1), white_balance)

        _SHARDED_JIT_CACHE[key] = jax.jit(full)
    fn = _SHARDED_JIT_CACHE[key]
    operands = [
        jnp.asarray(stack),
        jnp.asarray(psf_pad),
        jnp.asarray(lap),
        jnp.float32(K),
    ]
    if edgetaper:
        from fft_restoration_tpu.utils.taper import taper_windows

        wy, wx = taper_windows(h, w, hp, wp, psf.shape[-1])
        operands += [
            jnp.asarray(np.pad(wy, (0, hpad - hp))),
            jnp.asarray(np.pad(wx, (0, wpad - wp))),
        ]
    out = fn(*operands)
    return np.asarray(out)[:b]


def profile_phases_sharded(
    img_bgr: np.ndarray,
    psf_length: int,
    psf_angle: float,
    K: float = 0.01,
    mesh: Optional[Mesh] = None,
    fft_backend: str = DEFAULT_FFT_BACKEND,
    profiler=None,
    psf_type: str = "motion",
):
    """Per-phase timing of the sharded pipeline, preserving the MPI
    mode's phase breakdown (fft_mpi.cpp:380-467: scatter/FFT img/FFT psf/
    wiener/IFFT/gather+post). Each phase is a separate shard_map dispatch
    with a host sync. Returns (restored planes (3,H,W), PhaseProfiler)."""
    import jax as _jax

    from fft_restoration_tpu.utils.timing import PhaseProfiler

    mesh = mesh or make_mesh()
    prof = profiler or PhaseProfiler(mode="sharded")
    img = jnp.asarray(np.asarray(img_bgr, np.float32) / np.float32(255.0))
    h, w = img.shape[:2]
    hp, wp = next_power_of_two(h), next_power_of_two(w)

    def sync(tree):
        _jax.block_until_ready(tree)

    row_sharding3 = NamedSharding(mesh, P(None, ROWS_AXIS, None))
    row_sharding2 = NamedSharding(mesh, P(ROWS_AXIS, None))

    @_jax.jit
    def pre(img):
        psf = make_psf(psf_type, psf_length, jnp.float32(psf_angle))
        chans = jnp.pad(jnp.moveaxis(img, -1, 0), ((0, 0), (0, hp - h), (0, wp - w)))
        psf_pad = jnp.pad(psf, ((0, hp - psf_length), (0, wp - psf_length)))
        return (
            _jax.lax.with_sharding_constraint(chans, row_sharding3),
            _jax.lax.with_sharding_constraint(psf_pad, row_sharding2),
        )

    def smap(fn, in_specs, out_specs):
        return _jax.jit(
            _jax.shard_map(fn, mesh=mesh, check_vma=False, in_specs=in_specs, out_specs=out_specs)
        )

    p3 = P(None, ROWS_AXIS, None)
    p2 = P(ROWS_AXIS, None)
    fft3 = smap(
        lambda r: sharded_fft2d(r, jnp.zeros_like(r), False, fft_backend),
        (p3,),
        (p3, p3),
    )
    fft2 = smap(
        lambda r: sharded_fft2d(r, jnp.zeros_like(r), False, fft_backend),
        (p2,),
        (p2, p2),
    )
    wien = smap(
        lambda gr, gi, hr, hi: wiener_filter((gr, gi), (hr, hi), jnp.float32(K)),
        (p3, p3, p2, p2),
        (p3, p3),
    )
    ifft = smap(
        lambda fr, fi: sharded_fft2d(fr, fi, True, fft_backend),
        (p3, p3),
        (p3, p3),
    )

    def _post_local(r_re):
        restored = r_re
        lo = _jax.lax.pmin(jnp.min(restored, axis=(-2, -1)), ROWS_AXIS)[..., None, None]
        hi = _jax.lax.pmax(jnp.max(restored, axis=(-2, -1)), ROWS_AXIS)[..., None, None]
        scale = jnp.where(hi > lo, 1.0 / (hi - lo), 0.0)
        return (restored - lo) * scale

    post = smap(_post_local, (p3,), p3)

    with prof.phase("Pre-process"):
        chans, psf_pad = pre(img)
        sync((chans, psf_pad))
    with prof.phase("FFT Image"):
        G = fft3(chans)
        sync(G)
    with prof.phase("FFT PSF"):
        H = fft2(psf_pad)
        sync(H)
    with prof.phase("Wiener Filter"):
        F = wien(G[0], G[1], H[0], H[1])
        sync(F)
    with prof.phase("IFFT"):
        r = ifft(F[0], F[1])
        sync(r)
    with prof.phase("Post-process"):
        planes = np.asarray(post(r[0]))[..., :h, :w]
    return planes, prof


class ShardedWienerPipeline:
    """Mesh-parallel restoration pipeline (MPI-mode parity, SURVEY.md §2).

    Same API as WienerDeblurPipeline, executed over a row-sharded device
    mesh with all_to_all distributed-transpose FFTs.
    """

    def __init__(
        self,
        mesh: Optional[Mesh] = None,
        fft_backend: str = DEFAULT_FFT_BACKEND,
        filter_name: str = "wiener",
        white_balance: bool = True,
        pad_mode: str = "pow2",
        edgetaper: bool = False,
        rl_iters: int = 10,
        psf_type: str = "motion",
    ):
        self.mesh = mesh or make_mesh()
        self.fft_backend = fft_backend
        self.filter_name = filter_name
        self.white_balance = white_balance
        # 'smooth' = minimal odd*2^k DFT extents
        # (models/pipeline.pad_extents); verified against the oracle at
        # matching extents
        self.pad_mode = pad_mode
        # border blend toward the circular blur (models/edgetaper.py),
        # run sharded inside the shard_map body
        self.edgetaper = edgetaper
        # iteration count for filter_name='rl'
        self.rl_iters = rl_iters
        self.psf_type = psf_type
        self._cache = {}

    def _compiled(self, h: int, w: int, psf_length: int):
        key = (h, w, psf_length)
        if key not in self._cache:
            fn = functools.partial(
                _sharded_core,
                mesh=self.mesh,
                psf_length=psf_length,
                fft_backend=self.fft_backend,
                filter_name=self.filter_name,
                white_balance=self.white_balance,
                pad_mode=self.pad_mode,
                edgetaper=self.edgetaper,
                rl_iters=self.rl_iters,
                psf_type=self.psf_type,
            )
            self._cache[key] = jax.jit(fn)
        return self._cache[key]

    def _put(self, img_bgr: np.ndarray):
        # explicit replicated placement on the mesh's devices
        img = np.asarray(img_bgr, np.float32) / np.float32(255.0)
        return jax.device_put(
            img, NamedSharding(self.mesh, P(None, None, None))
        )

    def restore_with_planes(
        self, img_bgr: np.ndarray, psf_length: int, psf_angle: float, K: float = 0.01
    ):
        """One device execution returning (uint8 image, float planes)."""
        img = self._put(img_bgr)
        fn = self._compiled(img.shape[0], img.shape[1], int(psf_length))
        out, planes = fn(img, jnp.float32(psf_angle), jnp.float32(K))
        return np.asarray(out), np.asarray(planes)

    def restore(
        self, img_bgr: np.ndarray, psf_length: int, psf_angle: float, K: float = 0.01
    ) -> np.ndarray:
        return self.restore_with_planes(img_bgr, psf_length, psf_angle, K)[0]

    def restore_channels(
        self, img_bgr: np.ndarray, psf_length: int, psf_angle: float, K: float = 0.01
    ) -> np.ndarray:
        return self.restore_with_planes(img_bgr, psf_length, psf_angle, K)[1]
