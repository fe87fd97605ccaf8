"""Power-of-two padding helpers.

Counterpart of the reference's header-only utilities
(/root/reference/utils.hpp:27-52 — nextPowerOfTwo, autoPadToPowerOfTwo,
isPowerOfTwo). Pure shape logic runs on the host; the actual zero-pad is
done inside the jit graph (models/pipeline.py:_pad2d) so XLA can fuse it.
"""

from __future__ import annotations

import numpy as np


def is_power_of_two(n: int) -> bool:
    """True iff n is a positive power of two (utils.hpp:50-52)."""
    return n > 0 and (n & (n - 1)) == 0


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n (utils.hpp:27-31)."""
    p = 1
    while p < n:
        p <<= 1
    return p


# Odd factors of the "smooth" pad extents: per octave the reachable sizes
# are {1, 9/8, 5/4, 3/2, 15/8, 2}·2^k — worst-case pad waste 25% instead
# of pow2's 100%. Every one is a 2/3/5-smooth length, which cuFFT (and
# the matmul backend's four-step) transform at O(n log n).
_SMOOTH_ODD_FACTORS = (3, 5, 9, 15)


def next_smooth_size(n: int, min_q: int = 128) -> int:
    """Smallest s >= n of the form odd * 2^k with odd in {1,3,5,9,15}
    and 2^k >= min_q.

    Frames below min_q keep the pow2 pad (they are fast regardless). The
    reference has no counterpart — it always pads to pow2
    (utils.hpp:40-47) and pays up to 2x the pixels (e.g. UHD 2160 ->
    4096); its only non-pow2 path is the O(n^2) naive DFT
    (fft_serial.cpp:71-87).
    """
    best = next_power_of_two(n)
    for odd in _SMOOTH_ODD_FACTORS:
        q = min_q
        while odd * q < n:
            q <<= 1
        best = min(best, odd * q)
    return best


def pad_to_power_of_two(src: np.ndarray) -> np.ndarray:
    """Zero-pad the last two dims (H, W) up to the next powers of two.

    Host-side NumPy counterpart of autoPadToPowerOfTwo (utils.hpp:40-47):
    pads on the bottom/right only, constant 0.
    """
    h, w = src.shape[-2], src.shape[-1]
    nh, nw = next_power_of_two(h), next_power_of_two(w)
    if nh == h and nw == w:
        return src
    pad = [(0, 0)] * (src.ndim - 2) + [(0, nh - h), (0, nw - w)]
    return np.pad(src, pad, mode="constant")
