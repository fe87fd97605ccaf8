"""CLI drivers — the reference's L4 layer as one binary.

Contract preserved: `<img-path> <psf-length> <psf-angle>` positionals
(/root/reference/README.md:10-13, serial.cpp:12-18). Where the reference
selects its implementation at compile time (`make MODE=...`,
Makefile:1-60) and ships six main()s, here `--mode` selects at runtime:

    oracle   ≙ serial   (NumPy oracle, the parity reference)
    jit      ≙ gpu/simd/openmp  (single-device fused XLA graph;
               --fft-backend picks the compute strategy)
    sharded  ≙ mpi/mpi_simd     (row-sharded mesh, all_to_all FFT;
               --devices ≙ mpirun -np N)

Like every non-serial reference driver (simd.cpp:66-99, mpi.cpp:79-127,
gpu.cpp:82-121), the CLI runs the serial oracle first, verifies at a
tolerance tier, and prints wall-clock + `[Speedup] x.xx`.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from fft_restoration_tpu.utils.verify import channels_equal

MODES = ("oracle", "jit", "sharded")

# HBM budget for one batched device call (see _restore_group chunking)
_BATCH_CHUNK_BYTES = 8 << 30


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fft_restoration_tpu",
        description="Frequency-domain motion-deblur (Wiener) on JAX/XLA.",
    )
    p.add_argument("img_path", help="input image (PNG)")
    p.add_argument("psf_length", type=int, help="motion blur length in px (>=1)")
    p.add_argument("psf_angle", type=float, help="motion blur angle in degrees")
    p.add_argument("-o", "--output", default=None, help="output PNG path")
    p.add_argument("--mode", choices=MODES, default="jit")
    from fft_restoration_tpu.ops.fft import DEFAULT_FFT_BACKEND, FFT_BACKENDS

    p.add_argument(
        "--fft-backend",
        choices=FFT_BACKENDS,
        default=DEFAULT_FFT_BACKEND,
        help="FFT compute strategy for jit/sharded modes (xla = jnp.fft, "
        "cuFFT on the GPU, the default; radix2/matmul/naive = hand-built "
        "jnp transforms)",
    )
    p.add_argument(
        "--filter",
        choices=("wiener", "inverse", "cls", "rl"),
        default="wiener",
        help="restoration filter: one-shot spectral (wiener/inverse/cls) "
        "or iterative Richardson-Lucy ('rl', --iters steps; jit and "
        "sharded modes)",
    )
    p.add_argument(
        "--iters",
        type=int,
        default=10,
        help="Richardson-Lucy iteration count (--filter rl)",
    )
    p.add_argument(
        "--psf-type",
        choices=("motion", "gaussian", "disk"),
        default="motion",
        help="PSF family: 'motion' (the reference's rotated line; "
        "psf_angle in degrees), 'gaussian' (isotropic; psf_angle is "
        "REUSED as sigma in px), 'disk' (defocus of diameter "
        "psf_length; psf_angle ignored). Every filter and mode is "
        "kernel-agnostic; the oracle verifies with the same kernel.",
    )
    p.add_argument(
        "--tile",
        type=int,
        default=0,
        metavar="N",
        help="tiled restoration for arbitrarily large frames: cover the "
        "image with overlapping pow2 NxN tiles, deconvolve them as "
        "batched stacks (each tile edge-tapered), stitch the cores, "
        "normalize/white-balance globally. Device memory stays bounded "
        "by the tile working set regardless of image size. Approximate "
        "vs the global restore (models/tiled.py docstring); 0 = off. "
        "Directory input restores per-frame (sizes need not match).",
    )
    p.add_argument(
        "--tile-overlap",
        type=int,
        default=None,
        metavar="M",
        help="discarded margin between a tile's read extent and its "
        "stitched core (default max(2*psf_length, 32))",
    )
    p.add_argument(
        "--auto-K",
        dest="auto_K",
        action="store_true",
        help="noise-adaptive regularization: estimate the frame's noise "
        "sigma (Immerkaer stencil, models/estimate.py) and set K to the "
        "measured noise-to-signal power ratio instead of the fixed -K "
        "(the reference hardcodes K=0.01). Directories estimate once "
        "per size-group from its first frame (per frame with --tile).",
    )
    p.add_argument(
        "--psf-file",
        default=None,
        metavar="PATH",
        help="load the PSF kernel from a file (.npy/.txt/.csv array or "
        "a grayscale image) instead of synthesizing one — the "
        "interchange surface for externally-estimated PSFs. "
        "Sum-normalized, zero-padded square; the psf-length/psf-angle "
        "positionals and --psf-type are ignored. Every filter and "
        "mode works; the oracle verifies with the same loaded kernel.",
    )
    p.add_argument(
        "--estimate-psf",
        action="store_true",
        help="blind mode: estimate the blur parameters of the selected "
        "--psf-type from the blurred image itself (models/estimate.py: "
        "cepstral peak for motion length/angle, cepstral ring isotropy "
        "for disk size, spectral log-MTF scan for gaussian sigma) and "
        "use them instead of the positionals (which are then ignored "
        "with a note). Directory inputs estimate from the first frame.",
    )
    p.add_argument(
        "--edgetaper",
        action="store_true",
        help="blend the frame toward its circular blur at the borders "
        "before deconvolving (suppresses wrap-discontinuity ringing on "
        "real photos; applied on BOTH the pipeline and the oracle side "
        "so verification still runs). All modes except the sharded "
        "2D-mesh directory batch.",
    )
    p.add_argument("-K", type=float, default=0.01, help="Wiener K (default 0.01)")
    p.add_argument(
        "--devices",
        type=int,
        default=None,
        help="mesh size for --mode sharded (default: all devices)",
    )
    p.add_argument("--no-white-balance", action="store_true")
    p.add_argument(
        "--no-verify",
        action="store_true",
        help="skip the serial-oracle differential verification",
    )
    p.add_argument(
        "--tier",
        choices=("l2", "inf", "gpu"),
        default="gpu",
        help="verification tolerance tier (reference: simd/mpi=l2, openmp=inf, gpu=gpu)",
    )
    p.add_argument(
        "--pad",
        choices=("pow2", "smooth"),
        default="pow2",
        help="DFT pad extents. 'pow2' = the reference contract "
        "(utils.hpp:40-47, up to 2x the pixels); 'smooth' = minimal "
        "odd*2^k extents (e.g. UHD "
        "3840x2160 restores at 3840x2304 instead of 4096x4096). "
        "Verification then compares against the oracle at the SAME "
        "extents (the restored output depends on the pad). jit and "
        "sharded modes; oracle mode ignores it with a note.",
    )
    p.add_argument(
        "--profile",
        nargs="?",
        const="phases",
        default=None,
        choices=("phases", "trace"),
        help="'phases': host-timed per-phase breakdown (reference phase "
        "taxonomy; each phase pays a host sync). 'trace': device-timeline "
        "profile via jax.profiler — per-op and per-phase times from the "
        "device's own clock, plus the device idle share (the cudaEvent-"
        "profiler analog, fft_gpu.cu:17-57)",
    )
    p.add_argument(
        "--reference",
        default=None,
        help="sharp ground-truth PNG; prints PSNR of the restoration "
        "against it (the prototype's compute_PSNR metric, "
        "others/fft_image_restoration.py:95-99)",
    )
    p.add_argument(
        "--show",
        action="store_true",
        help="render the restored image in the terminal (ANSI truecolor "
        "half-blocks) — the headless analog of the reference's "
        "imshow/waitKey display (serial.cpp:59-60); waits for Enter "
        "only on a TTY",
    )
    return p


def _oracle_channels(
    img: np.ndarray, length: int, angle: float, K: float, pad_to=None,
    edgetaper: bool = False, psf_type: str = "motion",
) -> np.ndarray:
    from fft_restoration_tpu.oracle.psf import make_psf_oracle
    from fft_restoration_tpu.oracle.serial import restore_channels

    imgf = img.astype(np.float32) / np.float32(255.0)
    psf = make_psf_oracle(psf_type, length, angle)
    return restore_channels(
        np.moveaxis(imgf, -1, 0), psf, K, pad_to=pad_to,
        edgetaper=edgetaper,
    )




def _apply_psf_estimate(args, img) -> None:
    """--estimate-psf: override the positional PSF params from the
    blind estimate matching --psf-type (models/estimate.py): cepstral
    peak for motion, cepstral ring for disk, spectral log-MTF scan for
    gaussian."""
    from fft_restoration_tpu.models import estimate as est

    if not isinstance(args.psf_type, str):
        print(
            "[Error] --estimate-psf estimates a PARAMETRIC family "
            "(motion/gaussian/disk); --psf-file kernels are already "
            "concrete"
        )
        raise SystemExit(2)

    backend = args.fft_backend
    if args.psf_type == "motion":
        length, angle, conf = est.estimate_motion_psf(
            img, fft_backend=backend
        )
        print(
            f"[INFO] estimated PSF: length={length} angle={angle:.1f} "
            f"(confidence z={conf:.1f}); positionals "
            f"{args.psf_length}/{args.psf_angle} ignored"
        )
        if conf < est._CONF_WARN:
            print(
                "[INFO] low cepstral confidence - the frame may not "
                "carry a linear motion blur"
            )
        args.psf_length, args.psf_angle = length, angle
    elif args.psf_type == "disk":
        size, conf = est.estimate_disk_psf(img, fft_backend=backend)
        print(
            f"[INFO] estimated PSF: disk size={size} (ring isotropy "
            f"z={conf:.1f}); positional {args.psf_length} ignored"
        )
        if conf < est._DISK_CONF_WARN:
            print(
                "[INFO] low ring-isotropy confidence - the frame may "
                "not carry a defocus (disk) blur"
            )
        args.psf_length = size
    else:  # gaussian
        try:
            sigma, conf = est.estimate_gaussian_psf(
                img, fft_backend=backend
            )
        except ValueError as e:
            print(f"[Error] cannot estimate a gaussian blur: {e}")
            raise SystemExit(2)
        size = est.gaussian_ksize(sigma)
        print(
            f"[INFO] estimated PSF: gaussian sigma={sigma:.2f} "
            f"size={size} (residual-ratio confidence {conf:.2f}); "
            f"positionals {args.psf_length}/{args.psf_angle} ignored"
        )
        if conf < est._GAUSS_CONF_WARN:
            print(
                "[INFO] low spectral-fit confidence - the frame's "
                "spectrum barely prefers this sigma over no blur "
                "(smooth scenes are intrinsically ambiguous)"
            )
        args.psf_length, args.psf_angle = size, sigma





def _compile_cache_dir() -> str | None:
    """Where this program keeps XLA's persistent compilation cache.

    None when JAX_COMPILATION_CACHE_DIR is set: JAX reads that variable
    itself, and the program sets no directory of its own. Otherwise a
    fixed path inside the checkout (`.jax_cache`, git-ignored) — the
    path is part of the cache key, so it must not move between runs."""
    import os

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache: the first compile of each
    pipeline shape costs seconds, so executables are cached across
    processes (see _compile_cache_dir for where; JAX's own threshold
    decides which compiles are worth an entry)."""
    import jax

    cache = _compile_cache_dir()
    if cache is not None:
        jax.config.update("jax_compilation_cache_dir", cache)


def _tile_mesh(args):
    """--tile --mode sharded: the 2D (batch, rows) mesh the tile stacks
    ride — tiles data-parallel over 'batch', each tile's FFT row-sharded
    over 'rows' (the frame axis scaled across memory domains, the
    reference's distributed-mode purpose, fft_mpi.cpp:89-100). None for
    jit mode (single-device tiled paths)."""
    if args.mode != "sharded":
        return None
    import jax

    from fft_restoration_tpu.parallel.mesh import make_mesh2d

    n_dev = args.devices or len(jax.devices())
    n_b = 2 if n_dev % 2 == 0 and n_dev >= 4 else 1
    return make_mesh2d(n_b, n_dev // n_b)


def _run_batch(args) -> int:
    """Directory mode: restore every PNG in img_path with the shared PSF.

    Same-sized frames go through the batched pipeline (one PSF FFT for
    the whole stack, models/batched.py) with the threaded native loader;
    odd-sized stragglers fall back to per-image restoration.
    """
    import os
    import time

    from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

    if args.mode == "oracle" or args.profile or args.reference:
        print(
            "[INFO] directory input runs the batched pipeline "
            "(jit, or 2D batch x rows mesh with --mode sharded); "
            "--profile/--reference and oracle mode are ignored"
        )

    paths = sorted(
        os.path.join(args.img_path, f)
        for f in os.listdir(args.img_path)
        if f.lower().endswith(
            (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".pgm", ".pnm",
             ".pbm", ".tif", ".tiff", ".webp", ".pfm", ".hdr", ".pic",
             ".sr", ".ras")
        )
        and "_restored" not in f
    )
    if not paths:
        print(f"[Error] no image files in {args.img_path!r}")
        return 1
    if args.estimate_psf:
        from fft_restoration_tpu.utils.imageio import imread as _imread

        try:
            _apply_psf_estimate(args, _imread(paths[0]))
        except (OSError, ValueError) as e:
            print(f"[Error] cannot estimate PSF from {paths[0]!r}: {e}")
            return 1
    out_dir = args.output or args.img_path
    os.makedirs(out_dir, exist_ok=True)

    # destination names: <stem>_restored.png, except when two inputs share
    # a stem across formats (car.webp + car.hdr) — those keep the extension
    # (car_webp_restored.png) so outputs never silently overwrite each other
    from collections import defaultdict as _dd

    _by_stem = _dd(list)
    for p in paths:
        _by_stem[os.path.basename(p).rsplit(".", 1)[0]].append(p)
    dst_map = {}
    _taken = set()
    for p in paths:  # sorted, so disambiguation is deterministic
        stem = os.path.basename(p).rsplit(".", 1)[0]
        name = (
            stem
            if len(_by_stem[stem]) == 1
            else os.path.basename(p).replace(".", "_")
        )
        base, k = name, 2
        while name in _taken:  # a.webp vs a.hdr vs a literal a_webp.png
            name, k = f"{base}_{k}", k + 1
        _taken.add(name)
        dst_map[p] = os.path.join(out_dir, name + "_restored.png")

    if args.tile:
        # tiled mode restores each frame independently (its tiles are
        # the batch; frame sizes need not match), so no size-grouping
        if args.mode == "oracle":
            print("[Error] --tile supports --mode jit or sharded "
                  "(the oracle is the untiled parity contract)")
            return 2
        from fft_restoration_tpu.models.tiled import (
            tiled_restore_image,
            validate_tile_params,
        )
        from fft_restoration_tpu.utils.imageio import imread, imwrite

        try:
            # frame-independent config errors fail ONCE up front (exit
            # 2, like the single-frame branch) instead of once per file
            validate_tile_params(
                args.tile, args.tile_overlap, args.psf_length
            )
        except ValueError as e:
            print(f"[Error] {e}")
            return 2

        mesh = _tile_mesh(args)  # None for --mode jit
        t0 = time.perf_counter()
        n_done = skipped = 0
        for p in paths:
            try:
                frame = imread(p)
                if args.auto_K:
                    from fft_restoration_tpu.models.estimate import (
                        estimate_noise_K,
                    )

                    _sigma, args.K = estimate_noise_K(frame)
                out = tiled_restore_image(
                    frame, args.psf_length, args.psf_angle, args.K,
                    tile=args.tile, overlap=args.tile_overlap,
                    fft_backend=args.fft_backend,
                    filter_name=args.filter, rl_iters=args.iters,
                    psf_type=args.psf_type,
                    white_balance=not args.no_white_balance,
                    mesh=mesh,
                )
                imwrite(dst_map[p], out)
                n_done += 1
            except (OSError, ValueError) as e:
                print(f"[Error] skipping {p!r}: {e}")
                skipped += 1
        ms = (time.perf_counter() - t0) * 1e3
        print(
            f"Restored {n_done} frames in {ms:.1f} ms "
            f"({ms / max(n_done, 1):.1f} ms/frame, tiled) -> {out_dir}"
            + (f" [{skipped} skipped]" if skipped else "")
        )
        return 0 if n_done else 1

    # group by frame size, skipping unreadable files
    import struct
    from collections import defaultdict

    from fft_restoration_tpu.utils.imageio import probe_size

    groups = defaultdict(list)
    skipped = 0
    for p in paths:
        try:
            h, w = probe_size(p)
        except (OSError, ValueError, struct.error) as e:
            print(f"[Error] skipping {p!r}: {e}")
            skipped += 1
            continue
        groups[(h, w)].append(p)
    if not groups:
        print(f"[Error] no readable image files in {args.img_path!r}")
        return 1

    t0 = time.perf_counter()
    n_done = 0
    if args.mode == "sharded":
        # singleton size-groups honor --mode sharded too (row-sharded
        # single-frame pipeline), not just the batched groups
        from fft_restoration_tpu.parallel.mesh import make_mesh
        from fft_restoration_tpu.parallel.sharded_pipeline import (
            ShardedWienerPipeline,
        )

        single = ShardedWienerPipeline(
            mesh=make_mesh(args.devices),
            fft_backend=args.fft_backend,
            filter_name=args.filter,
            white_balance=not args.no_white_balance,
            pad_mode=args.pad,
            edgetaper=args.edgetaper,
            rl_iters=args.iters,
            psf_type=args.psf_type,
        )
    else:
        single = WienerDeblurPipeline(
            fft_backend=args.fft_backend,
            filter_name=args.filter,
            white_balance=not args.no_white_balance,
            pad_mode=args.pad,
            rl_iters=args.iters,
            edgetaper=args.edgetaper,
            psf_type=args.psf_type,
        )
    for (h, w), group in groups.items():
        try:
            if args.auto_K:
                # one estimate per size-group, from its first frame (a
                # directory is typically one capture session, one noise
                # level; per-frame K would fragment the batched graph).
                # Costs one extra decode per GROUP — negligible next to
                # the group's own imread_batch pass.
                from fft_restoration_tpu.models.estimate import (
                    estimate_noise_K,
                )
                from fft_restoration_tpu.utils.imageio import imread

                sigma, args.K = estimate_noise_K(imread(group[0]))
                print(
                    f"[INFO] auto-K[{w}x{h}]: noise sigma {sigma:.4f} "
                    f"-> K {args.K:g}"
                )
            _restore_group(args, group, dst_map, single)
            n_done += len(group)
        except (OSError, ValueError, struct.error) as e:
            print(f"[Error] skipping {len(group)} frame(s) of size {w}x{h}: {e}")
            skipped += len(group)
    ms = (time.perf_counter() - t0) * 1e3
    print(
        f"Restored {n_done} frames in {ms:.1f} ms "
        f"({ms / max(n_done, 1):.1f} ms/frame) -> {out_dir}"
        + (f" [{skipped} skipped]" if skipped else "")
    )
    return 0


def _restore_group(args, group, dst_map, single, batched=None) -> None:
    """Restore one same-size group of frames (len>1 batched, else single)."""
    import os

    import numpy as np

    from fft_restoration_tpu.models.batched import BatchedWienerPipeline
    from fft_restoration_tpu.utils.imageio import (
        imread,
        imread_batch,
        imwrite,
        probe_size,
    )

    if batched is None:
        batched = BatchedWienerPipeline(
            fft_backend=args.fft_backend,
            filter_name=args.filter,
            white_balance=not args.no_white_balance,
            pad_mode=args.pad,
            rl_iters=args.iters,
            edgetaper=args.edgetaper,
            psf_type=args.psf_type,
        )

    _dst = dst_map.__getitem__

    # device-memory safety: a directory group is restored in chunks
    # bounded by the padded working set (~12 float32 plane-equivalents
    # per frame in flight through the batched graph), so arbitrarily
    # large directories never OOM the device. 2048^2 frames chunk at ~42.
    if len(group) > 1:
        from fft_restoration_tpu.models.pipeline import pad_extents

        h0, w0 = probe_size(group[0])
        hp0, wp0 = pad_extents(h0, w0, args.pad)
        frame_bytes = hp0 * wp0 * 4 * 12
        chunk = max(2, int(_BATCH_CHUNK_BYTES // frame_bytes))
        if len(group) > chunk:
            # chunks share ONE batched pipeline so the identical batched
            # graph compiles once, not once per chunk
            for i in range(0, len(group), chunk):
                _restore_group(
                    args, group[i : i + chunk], dst_map, single, batched
                )
            return

    if len(group) > 1:
        stack = imread_batch(group)
        if args.mode == "sharded":
            # 2D (batch, rows) mesh: images data-parallel, each image's
            # FFT row-sharded; taper/RL/per-frame WB all run ON the mesh
            # in one jit dispatch (parallel/sharded_pipeline.py)
            import jax

            from fft_restoration_tpu.oracle.psf import make_psf_oracle
            from fft_restoration_tpu.models.pipeline import pad_extents
            from fft_restoration_tpu.parallel.mesh import make_mesh2d
            from fft_restoration_tpu.parallel.sharded_pipeline import (
                sharded_batched_restore_images,
            )

            n_dev = args.devices or len(jax.devices())
            n_b = 2 if n_dev % 2 == 0 and n_dev >= 4 else 1
            h, w = stack.shape[1:3]
            hp, wp = pad_extents(h, w, args.pad)
            outs = sharded_batched_restore_images(
                stack,
                make_psf_oracle(
                    args.psf_type, args.psf_length, args.psf_angle
                ),
                args.K,
                mesh=make_mesh2d(n_b, n_dev // n_b),
                fft_backend=args.fft_backend,
                filter_name=args.filter,
                pad_hw=(hp, wp),
                edgetaper=args.edgetaper,
                rl_iters=args.iters,
                white_balance=not args.no_white_balance,
            )
        else:
            # whole batch INCLUDING per-frame white balance runs on
            # device (models/batched._batched_images_core) — the former
            # host-side NumPy color loop was ~100 ms/frame at 2048^2
            outs = batched.restore(
                stack, args.psf_length, args.psf_angle, args.K
            )
        for p, o in zip(group, outs):
            imwrite(_dst(p), o)
    else:
        out = single.restore(
            imread(group[0]), args.psf_length, args.psf_angle, args.K
        )
        imwrite(_dst(group[0]), out)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.psf_file is not None:
        # A loaded kernel replaces the synthesized family: psf_type
        # becomes the concrete array (make_psf/make_psf_oracle pass it
        # through) and psf_length its static extent.
        from fft_restoration_tpu.ops.psf import load_psf_file

        try:
            kernel = load_psf_file(args.psf_file)
        except (OSError, ValueError) as e:
            print(f"[Error] Cannot load PSF {args.psf_file!r}: {e}")
            return 2
        args.psf_type = kernel
        args.psf_length = kernel.shape[0]
    if args.psf_length < 1:
        print(f"[Error] psf-length must be >= 1, got {args.psf_length}")
        return 2
    _enable_compile_cache()

    from fft_restoration_tpu.utils.imageio import imread, imwrite

    if args.filter == "rl" and args.iters < 1:
        print("[Error] --iters must be >= 1 (got "
              f"{args.iters}: a 0-iteration RL loop would silently "
              "return the blurred input)")
        return 2

    total_start = time.perf_counter()

    import os

    if os.path.isdir(args.img_path):
        return _run_batch(args)

    try:
        img = imread(args.img_path)
    except (OSError, ValueError) as e:
        print(f"[Error] Cannot read image {args.img_path!r}: {e}")
        return 1

    if args.estimate_psf:
        _apply_psf_estimate(args, img)

    if args.auto_K:
        from fft_restoration_tpu.models.estimate import estimate_noise_K

        sigma, k = estimate_noise_K(img)
        print(
            f"[INFO] auto-K: noise sigma {sigma:.4f} -> K {k:g} "
            f"(was {args.K:g}); verification runs at the estimated K"
        )
        args.K = k

    from fft_restoration_tpu.models.pipeline import pad_extents

    if args.pad == "smooth" and args.mode == "oracle":
        print(
            "[INFO] oracle mode implements the reference's pow2 pad "
            "contract; --pad smooth is ignored"
        )
        args.pad = "pow2"
    hp, wp = pad_extents(img.shape[0], img.shape[1], args.pad)
    if args.psf_length > min(hp, wp):
        print(
            f"[Error] psf-length {args.psf_length} exceeds the "
            f"padded image ({hp}x{wp})"
        )
        return 2

    wb = not args.no_white_balance

    if args.tile:
        # Tiled restoration (models/tiled.py): device memory bounded by
        # the tile working set regardless of frame size. Approximate by
        # construction (tile-local deconvolution + per-tile taper) —
        # there is no oracle counterpart, so in-process verification is
        # vs the global pipeline in tests, not here.
        if args.mode == "oracle":
            print("[Error] --tile supports --mode jit or sharded "
                  "(the oracle is the untiled parity contract)")
            return 2
        if args.edgetaper:
            print(
                "[INFO] --tile tapers every tile by construction; "
                "--edgetaper is implied"
            )
        for flag, active in (
            ("--pad smooth", args.pad == "smooth"),
            ("--profile", bool(args.profile)),
        ):
            if active:
                print(f"[INFO] {flag} is not supported in tiled mode; ignored")
        from fft_restoration_tpu.models.tiled import tiled_restore_image

        mesh = _tile_mesh(args)  # None for --mode jit
        t0 = time.perf_counter()
        try:
            out = tiled_restore_image(
                img, args.psf_length, args.psf_angle, args.K,
                tile=args.tile, overlap=args.tile_overlap,
                fft_backend=args.fft_backend,
                filter_name=args.filter, rl_iters=args.iters,
                psf_type=args.psf_type, white_balance=wb, mesh=mesh,
            )
        except ValueError as e:
            print(f"[Error] {e}")
            return 2
        t1 = time.perf_counter()
        print(
            f"Deblurring 3 channels took(tiled"
            f"{'-sharded' if mesh is not None else ''}): "
            f"{(t1 - t0) * 1e3:.2f} ms"
        )
        print(
            "[INFO] tiled mode is an overlap-discard approximation of "
            "the global restore (models/tiled.py); whole-frame oracle "
            "verification not applicable"
        )
        if not args.no_verify and args.filter == "wiener":
            # Per-tile oracle anchor: the tiled output's compute
            # contract is tile-local taper+deconvolution, so verify
            # exactly that math — the grid's CENTER tile restored as a
            # standalone frame — against the serial oracle at the tile
            # extent, the same planes-vs-restore_channels contract the
            # untiled modes verify with (stitch-seam fidelity is
            # covered by the global-agreement tests in test_tiled.py).
            from fft_restoration_tpu.models.pipeline import (
                WienerDeblurPipeline,
            )
            from fft_restoration_tpu.models.tiled import (
                clamped_grid,
                validate_tile_params,
            )

            h_f, w_f = img.shape[:2]
            overlap_v, core_v = validate_tile_params(
                args.tile, args.tile_overlap, args.psf_length
            )
            th, tw = min(args.tile, h_f), min(args.tile, w_f)
            ys_g, _ = clamped_grid(h_f, args.tile, core_v, overlap_v)
            xs_g, _ = clamped_grid(w_f, args.tile, core_v, overlap_v)
            y0a, x0a = ys_g[len(ys_g) // 2], xs_g[len(xs_g) // 2]
            tile_u8 = img[y0a : y0a + th, x0a : x0a + tw]
            anchor = WienerDeblurPipeline(
                fft_backend=args.fft_backend,
                white_balance=wb,
                edgetaper=True,
                psf_type=args.psf_type,
            )
            _, ours_t = anchor.restore_with_planes(
                tile_u8, args.psf_length, args.psf_angle, args.K
            )
            t0 = time.perf_counter()
            oracle_t = _oracle_channels(
                tile_u8, args.psf_length, args.psf_angle, args.K,
                edgetaper=True, psf_type=args.psf_type,
            )
            t1 = time.perf_counter()
            print(
                f"[INFO] per-tile oracle anchor: center tile {th}x{tw} "
                f"at ({y0a},{x0a}), serial took {(t1 - t0) * 1e3:.2f} ms"
            )
            report = channels_equal(ours_t, oracle_t, "gpu")
            print(report)
            if not report.passed:
                return 3
    elif args.mode == "oracle":
        if args.filter != "wiener":
            print(
                f"[INFO] oracle mode implements wiener only; ignoring "
                f"--filter {args.filter}"
            )
        from fft_restoration_tpu.oracle.serial import restore_image

        t0 = time.perf_counter()
        out = restore_image(
            img, args.psf_length, args.psf_angle, args.K,
            edgetaper=args.edgetaper, psf_type=args.psf_type,
        )
        t1 = time.perf_counter()
        print(
            f"Deblurring 3 channels took(oracle): {(t1 - t0) * 1e3:.2f} ms"
        )
    else:
        if args.mode == "jit":
            from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline

            pipe = WienerDeblurPipeline(
                fft_backend=args.fft_backend,
                filter_name=args.filter,
                white_balance=wb,
                pad_mode=args.pad,
                rl_iters=args.iters,
                edgetaper=args.edgetaper,
                psf_type=args.psf_type,
            )
        else:
            from fft_restoration_tpu.parallel.mesh import make_mesh
            from fft_restoration_tpu.parallel.sharded_pipeline import (
                ShardedWienerPipeline,
            )

            pipe = ShardedWienerPipeline(
                mesh=make_mesh(args.devices),
                fft_backend=args.fft_backend,
                filter_name=args.filter,
                white_balance=wb,
                pad_mode=args.pad,
                edgetaper=args.edgetaper,
                rl_iters=args.iters,
                psf_type=args.psf_type,
            )

        # warm-up run (compile), then timed — the gpu.cpp:96-104 pattern.
        # restore_with_planes returns the verification planes from the
        # SAME device execution, so verifying costs no extra run.
        try:
            pipe.restore(img, args.psf_length, args.psf_angle, args.K)
        except ValueError as e:
            print(f"[Error] {e}")
            return 2
        t0 = time.perf_counter()
        out, ours = pipe.restore_with_planes(
            img, args.psf_length, args.psf_angle, args.K
        )
        t1 = time.perf_counter()
        mode_ms = (t1 - t0) * 1e3
        print(f"Deblurring 3 channels took({args.mode}): {mode_ms:.2f} ms")

        if args.profile == "trace":
            import jax.numpy as jnp

            from fft_restoration_tpu.utils.trace_profile import device_trace

            if hasattr(pipe, "_put"):  # sharded: place on the mesh
                imgf = pipe._put(img)
                fn = pipe._compiled(img.shape[0], img.shape[1], args.psf_length)
            else:
                # fresh non-donating compile: tracing re-runs fn on the
                # same input array, which a donated buffer forbids
                import functools

                import jax

                from fft_restoration_tpu.models.pipeline import _restore_core

                imgf = jnp.asarray(img.astype(np.float32) / np.float32(255.0))
                fn = jax.jit(
                    functools.partial(
                        _restore_core,
                        psf_length=args.psf_length,
                        fft_backend=args.fft_backend,
                        filter_name=args.filter,
                        white_balance=wb,
                        pad_mode=args.pad,
                        rl_iters=args.iters,
                        edgetaper=args.edgetaper,
                        psf_type=args.psf_type,
                    )
                )
            rep = device_trace(
                fn, (imgf, jnp.float32(args.psf_angle), jnp.float32(args.K))
            )
            print(rep.report())
        elif args.profile and args.filter == "wiener":
            if args.mode == "jit":
                from fft_restoration_tpu.models.pipeline import profile_phases

                _, prof = profile_phases(
                    img,
                    args.psf_length,
                    args.psf_angle,
                    args.K,
                    fft_backend=args.fft_backend,
                    white_balance=wb,
                    psf_type=args.psf_type,
                )
                print(prof.report())
            elif args.mode == "sharded":
                from fft_restoration_tpu.parallel.sharded_pipeline import (
                    profile_phases_sharded,
                )

                _, prof = profile_phases_sharded(
                    img,
                    args.psf_length,
                    args.psf_angle,
                    args.K,
                    mesh=pipe.mesh,
                    fft_backend=args.fft_backend,
                    psf_type=args.psf_type,
                )
                print(prof.report())

        if not args.no_verify and args.filter == "wiener":
            t0 = time.perf_counter()
            oracle = _oracle_channels(
                img, args.psf_length, args.psf_angle, args.K,
                pad_to=(hp, wp) if args.pad == "smooth" else None,
                edgetaper=args.edgetaper, psf_type=args.psf_type,
            )
            t1 = time.perf_counter()
            serial_ms = (t1 - t0) * 1e3
            print(f"Deblurring 3 channels took(serial): {serial_ms:.2f} ms")
            report = channels_equal(ours, oracle, args.tier)
            print(report)
            print(f"[Speedup] {serial_ms / mode_ms:.2f}x")
            if not report.passed:
                return 3

    if args.reference:
        from fft_restoration_tpu.utils.verify import psnr

        try:
            ref_img = imread(args.reference)
            print(
                f"PSNR vs reference: "
                f"{psnr(ref_img.astype(float), out.astype(float), peak=255.0):.2f} dB"
            )
        except (OSError, ValueError) as e:
            print(f"[Error] Cannot read reference {args.reference!r}: {e}")

    out_path = args.output or (
        args.img_path.rsplit(".", 1)[0] + f"_restored_{args.mode}.png"
    )
    imwrite(out_path, out)
    if args.show:
        from fft_restoration_tpu.utils.termview import show_image

        show_image(out, title=f"[show] {out_path}")
    total_ms = (time.perf_counter() - total_start) * 1e3
    print(f"Total program time: {total_ms:.2f} ms")
    print(f"[INFO] wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
