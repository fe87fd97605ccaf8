"""FFT backends behind one SoA (re, im) interface.

The reference hand-writes its FFT in every mode rather than calling
cuFFT/FFTW (SURVEY.md intro; reference fft/fft_serial.cpp:40-68 is the
scalar radix-2 core, fft_gpu.cu:108-148 the CUDA one). Here the default
is the vendor library: ``jnp.fft`` lowers to cuFFT on the GPU and to
pocketfft on the CPU, so no platform branch is needed.

Layout: **SoA (structure-of-arrays), split re/im float32 planes.** Every
function takes and returns a `(re, im)` pair — the same choice the
reference's AVX2 mode makes (fft_simd.cpp:14-26). The pair is kept at
the module boundary; the ``xla`` backend packs it into complex64 for
one library call and splits it again.

backends
--------
* ``xla``     — ``jnp.fft`` (cuFFT on the GPU), any length. The default
  (``DEFAULT_FFT_BACKEND``): fastest end to end on the H100 (PERF.md).
* ``radix2``  — iterative radix-2 Cooley-Tukey: bit-reversal realized as a
  log2(n)-dim reshape + axis-reversal transpose (pure data movement, no
  gather), then log2(n) vectorized butterfly stages over contiguous
  reshapes. Twiddles are exact float64-computed tables baked into the
  graph as float32 constants (the GPU reference also uses tables,
  fft_gpu.cu:206-212, unlike the CPU modes' drifting recurrence).
* ``matmul``  — Bailey four-step FFT: n = n1*n2, small DFT matrices
  applied as dense matmuls (4 real einsums per complex matmul, pinned to
  ``Precision.HIGHEST`` so TF32 never applies), twiddle elementwise in
  between. O(n*(n1+n2)) FLOPs in a constant number of matmul passes.
* ``naive``   — O(n^2) DFT-matrix matmul for arbitrary (non pow-2) n;
  counterpart of dft_naive_inplace (fft_serial.cpp:71-87), but as a
  single matmul instead of a scalar loop.

All backends operate over the LAST axis of float32 `(re, im)` arrays of
any equal leading batch shape, forward or inverse, and apply NO scaling
on the inverse (fft_serial.cpp:67) — callers scale explicitly.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from fft_restoration_tpu.utils.padding import is_power_of_two

FFT_BACKENDS = ("xla", "radix2", "matmul", "naive")

# The one default every entry point takes (library, CLI, server, tools).
DEFAULT_FFT_BACKEND = "xla"

_HIGHEST = jax.lax.Precision.HIGHEST

SoA = Tuple[jnp.ndarray, jnp.ndarray]


# ---------------------------------------------------------------------------
# twiddle / DFT-matrix tables (host-side float64, cast once to float32)


@functools.lru_cache(maxsize=None)
def _stage_twiddle_np(length: int, inverse: bool) -> tuple:
    """Exact twiddles (cos, sin) for w^k, k < length/2, one radix-2 stage."""
    sign = 1.0 if inverse else -1.0
    k = np.arange(length // 2, dtype=np.float64)
    ang = sign * 2.0 * math.pi * k / length
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_matrix_np(n: int, inverse: bool) -> tuple:
    """Dense DFT matrix W[k,t] = exp(sign*2pi*i*k*t/n) as (re, im) f32."""
    sign = 1.0 if inverse else -1.0
    k = np.arange(n, dtype=np.float64)
    ang = sign * 2.0 * math.pi * np.outer(k, k) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _four_step_twiddle_np(n1: int, n2: int, inverse: bool) -> tuple:
    """T[k1, j2] = exp(sign*2pi*i*k1*j2/(n1*n2)) as (re, im) f32."""
    n = n1 * n2
    sign = 1.0 if inverse else -1.0
    k1 = np.arange(n1, dtype=np.float64)
    j2 = np.arange(n2, dtype=np.float64)
    ang = sign * 2.0 * math.pi * np.outer(k1, j2) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _split_factors(n: int) -> tuple:
    """n = n1 * n2, as square as possible (minimal n1 + n2), for ANY
    composite n — the four-step works for every factorization, not just
    pow2 ones. Returns (n, 1) when n is prime (caller falls back to the
    naive DFT matmul). For pow2 n this reproduces the balanced pow2
    split; for smooth sizes (utils/padding.py next_smooth_size) it finds
    e.g. 3840 = 64*60."""
    best = (n, 1)
    d = int(math.isqrt(n))
    while d >= 2:
        if n % d == 0:
            best = (n // d, d)
            break
        d -= 1
    return best


# ---------------------------------------------------------------------------
# backends


def _bit_reverse_last_axis(x: jnp.ndarray) -> jnp.ndarray:
    """Bit-reversal permutation of the last axis via reshape + transpose.

    Equivalent to the swap loop at fft_serial.cpp:45-51 but expressed as
    pure data movement XLA lowers to one transpose copy (no gather).
    """
    n = x.shape[-1]
    m = n.bit_length() - 1
    lead = x.shape[:-1]
    y = x.reshape(lead + (2,) * m)
    axes = tuple(range(len(lead))) + tuple(
        len(lead) + m - 1 - i for i in range(m)
    )
    return y.transpose(axes).reshape(lead + (n,))


def _fft_radix2(re: jnp.ndarray, im: jnp.ndarray, inverse: bool) -> SoA:
    n = re.shape[-1]
    if n <= 1:
        return re, im
    lead = re.shape[:-1]
    re = _bit_reverse_last_axis(re)
    im = _bit_reverse_last_axis(im)
    length = 2
    while length <= n:
        half = length // 2
        wr_np, wi_np = _stage_twiddle_np(length, inverse)
        wr = jnp.asarray(wr_np)
        wi = jnp.asarray(wi_np)
        br = re.reshape(lead + (n // length, length))
        bi = im.reshape(lead + (n // length, length))
        ur, ui = br[..., :half], bi[..., :half]
        vr, vi = br[..., half:], bi[..., half:]
        # v * w, complex: (vr + i vi)(wr + i wi)
        tr = vr * wr - vi * wi
        ti = vr * wi + vi * wr
        re = jnp.concatenate([ur + tr, ur - tr], axis=-1).reshape(lead + (n,))
        im = jnp.concatenate([ui + ti, ui - ti], axis=-1).reshape(lead + (n,))
        length <<= 1
    return re, im


def _cmatmul_last(re, im, fr, fi):
    """(re + i im) @ (fr + i fi)^T over the last axis: out[..,k] =
    sum_t x[..,t] * F[k,t]. Four real einsums."""
    rr = jnp.einsum("...t,kt->...k", re, fr, precision=_HIGHEST)
    ii = jnp.einsum("...t,kt->...k", im, fi, precision=_HIGHEST)
    ri = jnp.einsum("...t,kt->...k", re, fi, precision=_HIGHEST)
    ir = jnp.einsum("...t,kt->...k", im, fr, precision=_HIGHEST)
    return rr - ii, ri + ir


def _fft_naive(re: jnp.ndarray, im: jnp.ndarray, inverse: bool) -> SoA:
    n = re.shape[-1]
    if n <= 1:
        return re, im
    fr_np, fi_np = _dft_matrix_np(n, inverse)
    return _cmatmul_last(re, im, jnp.asarray(fr_np), jnp.asarray(fi_np))


def _fft_matmul(re: jnp.ndarray, im: jnp.ndarray, inverse: bool) -> SoA:
    """Bailey four-step FFT over the last axis (any composite n).

    x[j1*n2 + j2] -> X[k1 + n1*k2]:
      A = F_{n1} applied over j1         (matmul)
      B = A * T[k1, j2]                  (elementwise)
      C = F_{n2} applied over j2         (matmul)
      X = transpose(C) flattened         (data movement)

    Prime n (no split) falls back to the dense DFT matmul.
    """
    n = re.shape[-1]
    if n <= 4:
        return _fft_naive(re, im, inverse)
    n1, n2 = _split_factors(n)
    if n2 == 1:  # prime length: no four-step split exists
        return _fft_naive(re, im, inverse)
    lead = re.shape[:-1]
    ar = re.reshape(lead + (n1, n2))
    ai = im.reshape(lead + (n1, n2))
    f1r_np, f1i_np = _dft_matrix_np(n1, inverse)
    f2r_np, f2i_np = _dft_matrix_np(n2, inverse)
    tr_np, ti_np = _four_step_twiddle_np(n1, n2, inverse)
    f1r, f1i = jnp.asarray(f1r_np), jnp.asarray(f1i_np)
    f2r, f2i = jnp.asarray(f2r_np), jnp.asarray(f2i_np)
    tr, ti = jnp.asarray(tr_np), jnp.asarray(ti_np)

    # F_{n1} over the j1 axis: contract (k,j) with a[..., j, t].
    def cm_first(ar, ai):
        rr = jnp.einsum("kj,...jt->...kt", f1r, ar, precision=_HIGHEST)
        ii = jnp.einsum("kj,...jt->...kt", f1i, ai, precision=_HIGHEST)
        ri = jnp.einsum("kj,...jt->...kt", f1i, ar, precision=_HIGHEST)
        ir = jnp.einsum("kj,...jt->...kt", f1r, ai, precision=_HIGHEST)
        return rr - ii, ri + ir

    ar, ai = cm_first(ar, ai)
    ar, ai = ar * tr - ai * ti, ar * ti + ai * tr
    ar, ai = _cmatmul_last(ar, ai, f2r, f2i)
    ar = jnp.swapaxes(ar, -1, -2)
    ai = jnp.swapaxes(ai, -1, -2)
    return ar.reshape(lead + (n,)), ai.reshape(lead + (n,))


def _fft_xla(re: jnp.ndarray, im: jnp.ndarray, inverse: bool, axes=(-1,)) -> SoA:
    """jnp.fft over `axes` (one cuFFT plan for all of them), unscaled."""
    if inverse:
        # unscaled inverse = conj(fft(conj(x))). XLA's IFFT applies its
        # 1/n as a separate full-array pass after cuFFT (a cuBLAS scal
        # kernel in the GPU trace); the negations here fuse into the
        # neighbouring elementwise fusions instead.
        y = jnp.fft.fftn(jax.lax.complex(re, -im), axes=axes)
        return jnp.real(y), -jnp.imag(y)
    y = jnp.fft.fftn(jax.lax.complex(re, im), axes=axes)
    return jnp.real(y), jnp.imag(y)


_BACKEND_FNS = {
    "xla": _fft_xla,
    "radix2": _fft_radix2,
    "matmul": _fft_matmul,
    "naive": _fft_naive,
}


def _as_planes(re, im) -> SoA:
    re = jnp.asarray(re, jnp.float32)
    im = jnp.asarray(im, jnp.float32)
    if re.shape != im.shape:
        raise ValueError(f"re/im shape mismatch: {re.shape} vs {im.shape}")
    return re, im


def _check_backend(backend: str) -> None:
    if backend not in _BACKEND_FNS:
        raise ValueError(f"unknown fft backend {backend!r}; one of {FFT_BACKENDS}")


def fft1d(re, im, inverse: bool = False, backend: str = DEFAULT_FFT_BACKEND) -> SoA:
    """1D DFT over the last axis of float32 (re, im) planes, unscaled inverse.

    Non-power-of-two lengths: 'xla' takes any n; 'matmul' runs its
    four-step on any composite n (naive DFT matmul only for primes);
    'radix2' falls back to the naive DFT matmul, mirroring
    transform_row_inplace's pow2 check (fft_serial.cpp:100-101).
    """
    re, im = _as_planes(re, im)
    _check_backend(backend)
    if backend == "radix2" and not is_power_of_two(re.shape[-1]):
        return _fft_naive(re, im, inverse)
    return _BACKEND_FNS[backend](re, im, inverse)


def fft2d(re, im, inverse: bool = False, backend: str = DEFAULT_FFT_BACKEND) -> SoA:
    """2D DFT over the last two axes, unscaled inverse.

    'xla' is one 2D library call. The hand-built backends run row pass
    -> transpose -> row pass -> transpose back, the same decomposition
    as my_dft2D (fft_serial.cpp:113-139) and the CUDA pipeline
    (fft_gpu.cu:214-240).
    """
    re, im = _as_planes(re, im)
    _check_backend(backend)
    if backend == "xla":
        return _fft_xla(re, im, inverse, axes=(-2, -1))
    re, im = fft1d(re, im, inverse, backend)
    re = jnp.swapaxes(re, -1, -2)
    im = jnp.swapaxes(im, -1, -2)
    re, im = fft1d(re, im, inverse, backend)
    return jnp.swapaxes(re, -1, -2), jnp.swapaxes(im, -1, -2)
