"""Phase profiler with the reference's phase taxonomy.

Recreates the reference's three ad-hoc timing mechanisms as one component:
  * RAII CpuTimer + g_timeAccum accumulator map
    (/root/reference/fft/fft_serial.cpp:17-35, printed at :249-258)
  * the CUDA cudaEvent 6-phase Profiler (/root/reference/fft/fft_gpu.cu:17-57)
  * whole-run wall clock getElapsedMs (/root/reference/utils.hpp:9-12)

Phase taxonomy preserved from fft_serial.cpp:158-236:
  Pre-process / FFT Image / FFT PSF / Wiener Filter / IFFT / Post-process.

On an accelerator, dispatch is async — a phase timer is only meaningful if the traced
value is materialized, so `Phase` takes an optional `block_on` pytree and
calls block_until_ready() on exit. For fully-fused jit pipelines (where
per-phase timing is impossible by design — XLA fuses the phases), use
`PhaseProfiler.wall()` around the whole call, which is what the drivers
report as `Deblurring 3 channels took(<mode>)`.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Iterator, Optional

PHASES = (
    "Pre-process",
    "FFT Image",
    "FFT PSF",
    "Wiener Filter",
    "IFFT",
    "Post-process",
)


def _block(tree: Any) -> None:
    import jax

    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()


class PhaseProfiler:
    """Accumulates per-phase milliseconds across calls (like g_timeAccum)."""

    def __init__(self, mode: str = "jit"):
        self.mode = mode
        self.accum_ms: "OrderedDict[str, float]" = OrderedDict()

    def clear(self) -> None:
        self.accum_ms.clear()

    @contextmanager
    def phase(self, name: str, block_on: Optional[Any] = None) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _block(block_on)
            ms = (time.perf_counter() - start) * 1e3
            key = f"{self.mode}: {name}"
            self.accum_ms[key] = self.accum_ms.get(key, 0.0) + ms

    @contextmanager
    def wall(self) -> Iterator[dict]:
        """Whole-run wall clock; result dict gets 'ms' on exit."""
        out: dict = {}
        start = time.perf_counter()
        try:
            yield out
        finally:
            out["ms"] = (time.perf_counter() - start) * 1e3

    def report(self) -> str:
        # Mirrors the accumulated-time table of fft_serial.cpp:249-258.
        lines = ["=== Accumulated Time ==="]
        total = 0.0
        for name, ms in sorted(self.accum_ms.items()):
            lines.append(f"{name} total: {ms:.3f} ms")
            total += ms
        lines.append(f"this round total: {total:.3f} ms")
        lines.append("=========================")
        return "\n".join(lines)


class Phase:
    """RAII-style phase timer (CpuTimer analog) bound to a PhaseProfiler."""

    def __init__(self, profiler: PhaseProfiler, name: str, block_on: Any = None):
        self._cm = profiler.phase(name, block_on)

    def __enter__(self):
        return self._cm.__enter__()

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


def elapsed_ms(start: float, end: float) -> float:
    """getElapsedMs analog (utils.hpp:9-12) over perf_counter timestamps."""
    return (end - start) * 1e3
