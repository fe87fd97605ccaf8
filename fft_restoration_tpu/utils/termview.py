"""Terminal image preview — the headless analog of the reference's
imshow/waitKey display step (/root/reference/serial.cpp:59-60).

The reference ends every driver with `cv::imshow` + `cv::waitKey(0)`.
An accelerator host is headless, so the idiomatic equivalent is an in-terminal
render: each character cell shows two vertical pixels via the upper
half block (U+2580) with 24-bit ANSI foreground (top pixel) and
background (bottom pixel) colors. `show_image` prints the render and,
on a TTY, waits for Enter — the waitKey(0) analog. Pure stdlib.
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = ["render_ansi", "show_image"]

_RESET = "\x1b[0m"


def _box_downsample(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Integer box-average downsample of (H, W, 3) uint8 to exactly
    (out_h, out_w, 3). Splits rows/cols into near-equal bins (the same
    partition np.array_split uses) and averages each bin."""
    h, w = img.shape[:2]
    acc = img.astype(np.float32)
    row_edges = np.linspace(0, h, out_h + 1).round().astype(int)
    col_edges = np.linspace(0, w, out_w + 1).round().astype(int)
    # cumulative-sum bin averaging: O(H*W) independent of output size
    csum = np.zeros((h + 1, w + 1, 3), np.float64)
    csum[1:, 1:] = acc.cumsum(0).cumsum(1)
    r0, r1 = row_edges[:-1], row_edges[1:]
    c0, c1 = col_edges[:-1], col_edges[1:]
    area = (r1 - r0)[:, None] * (c1 - c0)[None, :]
    area = np.maximum(area, 1)
    out = (
        csum[r1[:, None], c1[None, :]]
        - csum[r0[:, None], c1[None, :]]
        - csum[r1[:, None], c0[None, :]]
        + csum[r0[:, None], c0[None, :]]
    ) / area[..., None]
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def render_ansi(
    img_bgr: np.ndarray,
    max_cols: int = 100,
    max_lines: int = 28,
) -> str:
    """(H, W, 3) uint8 BGR image -> ANSI truecolor half-block string.

    Aspect-preserving fit into (max_lines text lines) x (max_cols
    columns); one text line covers two pixel rows. Gray (H, W) input is
    broadcast to three channels.
    """
    img = np.asarray(img_bgr)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    if img.ndim != 3 or img.shape[2] < 3:
        raise ValueError(f"need (H, W, 3) image, got {img.shape}")
    img = img[:, :, :3]
    if img.dtype != np.uint8:
        img = np.clip(
            np.asarray(img, np.float32) * 255.0 + 0.5, 0, 255
        ).astype(np.uint8)
    h, w = img.shape[:2]
    max_rows = 2 * max_lines
    scale = min(max_cols / w, max_rows / h, 1.0)
    out_w = max(1, round(w * scale))
    out_h = max(2, round(h * scale) & ~1)  # even: 2 pixel rows per line
    small = _box_downsample(img, out_h, out_w)
    rgb = small[:, :, ::-1]  # BGR -> RGB for the terminal
    lines = []
    for y in range(0, out_h, 2):
        top, bot = rgb[y], rgb[y + 1]
        cells = []
        prev = None
        for x in range(out_w):
            tr, tg, tb = (int(v) for v in top[x])
            br, bg, bb = (int(v) for v in bot[x])
            key = (tr, tg, tb, br, bg, bb)
            if key != prev:  # run-length elide repeated SGR sequences
                cells.append(
                    f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m"
                )
                prev = key
            cells.append("▀")
        lines.append("".join(cells) + _RESET)
    return "\n".join(lines)


def show_image(
    img_bgr: np.ndarray,
    title: str = "",
    file=None,
    wait: bool | None = None,
    max_cols: int = 100,
    max_lines: int = 28,
) -> None:
    """Print an ANSI preview; on a TTY, wait for Enter (waitKey(0)
    analog, /root/reference/serial.cpp:60). `wait=None` auto-detects
    (wait only when stdin is a TTY, so scripts never block)."""
    out = file if file is not None else sys.stdout
    if title:
        print(title, file=out)
    print(render_ansi(img_bgr, max_cols=max_cols, max_lines=max_lines), file=out)
    if wait is None:
        wait = sys.stdin.isatty() and out is sys.stdout
    if wait:
        try:
            input("[show] press Enter to continue...")
        except EOFError:
            pass
