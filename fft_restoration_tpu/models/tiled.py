"""Tiled restoration for arbitrarily large frames.

The single-frame pipeline transforms the whole padded frame at once,
so its FFT working set grows with the image: a 16384² frame is ~12 GB
of SoA spectral planes per working copy, and even where it fits, one
giant FFT wastes the pow2 pad on non-pow2 giants. This
module bounds the TRANSFORM working set to one tile regardless of
image size, the way a production service restores gigapixel scans:
cover the frame with overlapping power-of-two tiles, deconvolve every
tile independently, and stitch the tile CORES (overlap-discard).

Correctness model: deconvolution is not local, but the Wiener/CLS
kernels' spatial support decays fast away from the blur extent, so a
margin of a few PSF lengths makes the tile interior match the global
restore; each tile is edge-tapered (models/edgetaper.py) so the
circular wrap of its own boundary does not ring into the core. The
stitched result is an APPROXIMATION of the global restore — there is
no oracle counterpart, and the CLI marks it as such — verified in
tests against the global pipeline on scenes that fit both paths
(tests/test_tiled.py).

Brightness consistency: tiles are restored RAW (restore_planes
normalize=False — the filter is linear, so same-extent raw planes are
directly comparable), stitched, then min-max normalized and white-
balanced GLOBALLY, exactly one stretch for the whole frame. Per-tile
normalization would seam at every core boundary. ('rl' tiles come back
clipped to [0,1], flux-calibrated — they are stitched and used as-is,
matching the RL pipeline's no-stretch semantics.)

Two execution paths:

* device-resident (default): the u8 frame ships to the device ONCE; a
  fori_loop gathers each tile with dynamic_slice, restores it, and
  dynamic_update_slice-stitches its core into the resident planes;
  normalize + Lab white balance run on device and only the final u8
  image crosses back: 75 MB u8 each way for a 25 MP frame, where the
  host-stitch path moves ~600 MB of f32 planes.
* host-stitch (device_stitch=False): tiles stream through in chunks
  and are stitched in NumPy — the fallback when even the RESIDENT
  planes of a frame (3 f32 + Lab temporaries, ~0.5 GB/gigapixel·36)
  would not fit next to the tile working set.

The reference has no counterpart (it loads the whole frame always,
serial.cpp:22-25); cited as the scaling member of the restoration
family.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND


def tile_grid(extent: int, tile: int, core: int, overlap: int):
    """Start offsets of tiles and their core claims along one axis
    (host-stitch path: cores exactly partition [0, extent)).

    Returns (tile_starts, core_spans): for each tile i, the tile reads
    [tile_starts[i], tile_starts[i] + tile) of the image and its core
    claims [core_spans[i][0], core_spans[i][1]). Tiles are SHIFTED to
    stay fully inside the image (so every tile is dense image content,
    one jit shape), which grows the margin at the trailing edge; the
    leading/trailing frame borders keep margins < overlap, where there
    is no neighbor content anyway (the per-tile edge taper owns the
    frame border, as in the untiled pipeline)."""
    if extent <= tile:
        return [0], [(0, extent)]
    starts, cores = [], []
    for cy in range(0, extent, core):
        c1 = min(cy + core, extent)
        if cy >= c1:
            break
        t0 = min(max(cy - overlap, 0), extent - tile)
        starts.append(t0)
        cores.append((cy, c1))
    return starts, cores


def validate_tile_params(tile: int, overlap, psf_length: int):
    """Frame-independent --tile validation, shared with the CLI's
    directory mode (which checks ONCE before its per-frame loop).
    Returns (overlap, core)."""
    from fft_restoration_tpu.utils.padding import is_power_of_two

    if not is_power_of_two(tile):
        raise ValueError(f"tile must be a power of two, got {tile}")
    if overlap is None:
        overlap = max(2 * psf_length, 32)
    if overlap < 0:
        raise ValueError(f"tile overlap must be >= 0, got {overlap}")
    core = tile - 2 * overlap
    if core < 8:
        raise ValueError(
            f"tile {tile} too small for overlap {overlap} "
            f"(core {core} < 8); raise --tile or lower the overlap"
        )
    return overlap, core


def clamped_grid(extent: int, tile: int, core: int, overlap: int):
    """Uniform-size grid for the device-resident path: every core is
    exactly `core` long (a static dynamic_update_slice shape), with the
    trailing core clamped to end at `extent` — it overlaps its
    predecessor and overwrites part of it, which is valid restored
    content either way. Returns (tile_starts, core_starts)."""
    if extent <= tile:
        return [0], [0]
    t_starts, c_starts = [], []
    for cy in range(0, extent, core):
        c0 = min(cy, extent - core)
        if c_starts and c0 <= c_starts[-1]:
            break
        c_starts.append(c0)
        t_starts.append(min(max(c0 - overlap, 0), extent - tile))
        if c0 == extent - core:
            break
    return t_starts, c_starts


_DEVICE_FN_CACHE: dict = {}


def _device_tiled_fn(
    h: int,
    w: int,
    pad_h: int,
    pad_w: int,
    live_h: int,
    live_w: int,
    core_h: int,
    core_w: int,
    n_tiles: int,
    psf_length: int,
    fft_backend: str,
    filter_name: str,
    rl_iters: int,
    psf_type,
    white_balance: bool,
):
    """jit graph: (H, W, 3) uint8 frame + tile/core start vectors ->
    (H, W, 3) uint8 restored. The whole tiled restore — gather,
    taper, deconvolve, stitch, global normalize, Lab white balance,
    encode — is ONE device program; only u8 frames cross the host link.
    The PSF spectrum is loop-invariant, so XLA hoists its transform out
    of the tile loop."""
    from fft_restoration_tpu.models.edgetaper import edge_taper_planes
    from fft_restoration_tpu.models.pipeline import restore_planes
    from fft_restoration_tpu.ops.color import (
        apply_white_balance,
        bgr_to_lab,
        lab_to_bgr,
    )
    from fft_restoration_tpu.ops.psf import make_psf

    def fn(img_u8, t_y, t_x, c_y, c_x, angle, K):
        psf = make_psf(psf_type, psf_length, angle)
        zero = jnp.int32(0)

        def body(i, planes):
            y0, x0 = t_y[i], t_x[i]
            tile = jax.lax.dynamic_slice(
                img_u8, (y0, x0, zero), (live_h, live_w, 3)
            )
            x = jnp.moveaxis(tile, -1, 0).astype(jnp.float32) / 255.0
            x = jnp.pad(
                x, ((0, 0), (0, pad_h - live_h), (0, pad_w - live_w))
            )
            # taper every tile toward its own circular blur: the tile
            # boundary is an artificial cut through the scene, exactly
            # the wrap discontinuity the taper suppresses at borders
            x = edge_taper_planes(
                x, psf, (live_h, live_w), fft_backend=fft_backend
            )
            raw = restore_planes(
                x, psf, K, fft_backend=fft_backend,
                filter_name=filter_name, rl_iters=rl_iters,
                normalize=False,
            )
            cy0, cx0 = c_y[i], c_x[i]
            blk = jax.lax.dynamic_slice(
                raw, (zero, cy0 - y0, cx0 - x0), (3, core_h, core_w)
            )
            return jax.lax.dynamic_update_slice(
                planes, blk, (zero, cy0, cx0)
            )

        planes = jax.lax.fori_loop(
            0, n_tiles, body, jnp.zeros((3, h, w), jnp.float32)
        )
        if filter_name == "rl":
            planes = jnp.clip(planes, 0.0, 1.0)
        else:
            from fft_restoration_tpu.models.pipeline import (
                _minmax_normalize,
            )

            planes = _minmax_normalize(planes)
        merged = jnp.moveaxis(planes, 0, -1)
        if white_balance:
            orig = img_u8.astype(jnp.float32) / jnp.float32(255.0)
            merged = lab_to_bgr(
                apply_white_balance(bgr_to_lab(merged), bgr_to_lab(orig))
            )
        return jnp.clip(merged * 255.0, 0.0, 255.0).astype(jnp.uint8)

    return jax.jit(fn)


def _chunk_restore_fn(
    tile_h: int,
    tile_w: int,
    live_h: int,
    live_w: int,
    psf_length: int,
    fft_backend: str,
    filter_name: str,
    rl_iters: int,
    psf_type,
):
    """Host-stitch path: jit-compiled (B, 3, tile_h, tile_w) uint8 ->
    raw restored planes (fetched to the host per chunk)."""
    from fft_restoration_tpu.models.edgetaper import edge_taper_planes
    from fft_restoration_tpu.models.pipeline import restore_planes
    from fft_restoration_tpu.ops.psf import make_psf

    def fn(tiles_u8, angle, K):
        psf = make_psf(psf_type, psf_length, angle)
        x = tiles_u8.astype(jnp.float32) / jnp.float32(255.0)
        x = jnp.pad(
            x,
            (
                (0, 0),
                (0, 0),
                (0, tile_h - x.shape[-2]),
                (0, tile_w - x.shape[-1]),
            ),
        )
        x = edge_taper_planes(
            x, psf, (live_h, live_w), fft_backend=fft_backend
        )
        return restore_planes(
            x, psf, K, fft_backend=fft_backend, filter_name=filter_name,
            rl_iters=rl_iters, normalize=False,
        )

    return jax.jit(fn)


def tiled_restore_image(
    img_bgr: np.ndarray,
    psf_length: int,
    psf_angle: float,
    K: float = 0.01,
    *,
    tile: int = 1024,
    overlap: int | None = None,
    chunk: int = 16,
    fft_backend: str = DEFAULT_FFT_BACKEND,
    filter_name: str = "wiener",
    rl_iters: int = 10,
    psf_type="motion",
    white_balance: bool = True,
    device_stitch: bool = True,
    mesh=None,
) -> np.ndarray:
    """(H, W, 3) uint8 BGR of ANY size -> (H, W, 3) uint8 restored,
    with the transform working set bounded by the tile regardless of
    H and W.

    tile must be a power of two (the tile transform then pays zero pow2
    pad). overlap defaults to max(2*psf_length, 32) — the discarded
    margin between a tile's read extent and its stitched core; larger
    overlap = closer to the global restore, more redundant compute
    (read amplification = (tile/(tile-2*overlap))²).

    device_stitch=True (default) runs gather/stitch/normalize/WB on
    device and moves only u8 frames over the host link (module
    docstring); False streams raw tile planes back and stitches in
    NumPy — for frames whose resident planes would crowd out the tile
    working set.

    mesh: a 2D (batch, rows) jax.sharding.Mesh composes BOTH big-frame
    mechanisms: each chunk's tile stack is dispatched
    data-parallel over the 'batch' axis while every tile's FFT is
    row-sharded over 'rows' (all_to_all transposes) — the frame axis
    scales across memory domains exactly like the reference's
    distributed mode (reference fft/fft_mpi.cpp:89-100,284-307),
    with the tile grid bounding each domain's working set. Tiles come
    back RAW (normalize=False) and are stitched + normalized + white-
    balanced once globally on the host, the same single-stretch
    semantics as the jit host-stitch path. Implies host stitching.
    """
    img = np.asarray(img_bgr)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) BGR, got {img.shape}")
    overlap, core = validate_tile_params(tile, overlap, psf_length)
    h, w = img.shape[:2]
    th, tw = min(tile, h), min(tile, w)  # dense tile read extent
    pad_h, pad_w = 1 << (th - 1).bit_length(), 1 << (tw - 1).bit_length()
    if psf_length > min(pad_h, pad_w):
        raise ValueError(
            f"psf_length {psf_length} exceeds the tile DFT extent"
        )

    if mesh is not None:
        device_stitch = False

    if device_stitch:
        ys, cys = clamped_grid(h, tile, core, overlap)
        xs, cxs = clamped_grid(w, tile, core, overlap)
        core_h = h if h <= tile else core
        core_w = w if w <= tile else core
        fn_args = (
            h, w, pad_h, pad_w, th, tw, core_h, core_w,
            len(ys) * len(xs), psf_length, fft_backend,
            filter_name, rl_iters, psf_type, white_balance,
        )
        # same-shape frames (a directory of scans) reuse one jit fn
        # instead of re-tracing and re-compiling per frame. ndarray
        # kernels (--psf-file) key by their bytes: a tiled scan
        # directory reuses one compile for one kernel.
        psf_key = (
            psf_type
            if isinstance(psf_type, str)
            else (np.asarray(psf_type).tobytes(), np.asarray(psf_type).shape)
        )
        key = fn_args[:-2] + (psf_key, white_balance)
        if key not in _DEVICE_FN_CACHE:
            if len(_DEVICE_FN_CACHE) >= 8:
                _DEVICE_FN_CACHE.pop(next(iter(_DEVICE_FN_CACHE)))
            _DEVICE_FN_CACHE[key] = _device_tiled_fn(*fn_args)
        fn = _DEVICE_FN_CACHE[key]
        t_y = np.repeat(np.asarray(ys, np.int32), len(xs))
        t_x = np.tile(np.asarray(xs, np.int32), len(ys))
        c_y = np.repeat(np.asarray(cys, np.int32), len(xs))
        c_x = np.tile(np.asarray(cxs, np.int32), len(ys))
        out = fn(
            jnp.asarray(img), jnp.asarray(t_y), jnp.asarray(t_x),
            jnp.asarray(c_y), jnp.asarray(c_x),
            jnp.float32(psf_angle), jnp.float32(K),
        )
        return np.asarray(out)

    ys, ycores = tile_grid(h, tile, core, overlap)
    xs, xcores = tile_grid(w, tile, core, overlap)
    coords = [
        (y0, x0, yc, xc)
        for y0, yc in zip(ys, ycores)
        for x0, xc in zip(xs, xcores)
    ]

    if mesh is not None:
        from fft_restoration_tpu.oracle.psf import make_psf_oracle
        from fft_restoration_tpu.parallel.sharded_pipeline import (
            sharded_batched_restore_planes,
        )

        psf_arr = make_psf_oracle(psf_type, psf_length, psf_angle)

        def run_chunk(blk_u8):
            x = blk_u8.astype(np.float32) / np.float32(255.0)
            x = np.pad(
                x,
                ((0, 0), (0, 0), (0, pad_h - th), (0, pad_w - tw)),
            )
            # per-tile taper + RAW restore inside the shard_map body;
            # same math as _chunk_restore_fn, scheduled over the mesh
            return sharded_batched_restore_planes(
                x, psf_arr, K, mesh=mesh, fft_backend=fft_backend,
                filter_name=filter_name, edgetaper=True, rl_iters=rl_iters, normalize=False,
                live_hw=(th, tw),
            )
    else:
        fn = _chunk_restore_fn(
            pad_h, pad_w, th, tw, psf_length, fft_backend,
            filter_name, rl_iters, psf_type,
        )
        ang = jnp.float32(psf_angle)
        k = jnp.float32(K)

        def run_chunk(blk_u8):
            return np.asarray(fn(jnp.asarray(blk_u8), ang, k))

    # stream chunk-sized temporaries only: gather this chunk's tiles,
    # restore, stitch its cores, drop — peak host footprint is the
    # (3, h, w) planes buffer + one chunk, the point of this fallback
    planes = np.empty((3, h, w), np.float32)
    for i in range(0, len(coords), chunk):
        cc = coords[i : i + chunk]
        blk = np.stack(
            [
                np.moveaxis(img[y0 : y0 + th, x0 : x0 + tw], -1, 0)
                for y0, x0, _, _ in cc
            ]
        )
        if len(cc) < chunk:
            # pad the last chunk to the fixed batch (one compiled graph)
            blk = np.concatenate(
                [blk, np.repeat(blk[-1:], chunk - len(cc), axis=0)]
            )
        out = run_chunk(blk)
        for j, (y0, x0, (cy0, cy1), (cx0, cx1)) in enumerate(cc):
            planes[:, cy0:cy1, cx0:cx1] = out[
                j, :, cy0 - y0 : cy1 - y0, cx0 - x0 : cx1 - x0
            ]

    # ONE global stretch (the untiled pipeline's semantics, at frame
    # scope); RL tiles are already flux-calibrated in [0,1]
    if filter_name == "rl":
        planes = np.clip(planes, 0.0, 1.0)
    else:
        lo = planes.min(axis=(-2, -1), keepdims=True)
        hi = planes.max(axis=(-2, -1), keepdims=True)
        planes = (planes - lo) / np.where(hi > lo, hi - lo, 1.0)

    merged = np.moveaxis(planes, 0, -1)
    if white_balance:
        from fft_restoration_tpu.oracle.color import (
            apply_white_balance,
            bgr_to_lab,
            lab_to_bgr,
        )

        orig = img.astype(np.float32) / np.float32(255.0)
        merged = lab_to_bgr(
            apply_white_balance(bgr_to_lab(merged), bgr_to_lab(orig))
        )
    return np.clip(merged * 255.0, 0.0, 255.0).astype(np.uint8)
