"""Device-timeline profiling via jax.profiler traces.

The host-sync phase profiler (utils/timing.py + models/pipeline.py
profile_phases) times each phase from the host. This module measures
what the reference's cudaEvent Profiler measures (reference
fft/fft_gpu.cu:17-57): time ON THE DEVICE.

It runs a jitted function under jax.profiler.trace, parses the emitted
trace.json.gz, and reduces the GPU lanes (process names
``/device:GPU:<n>``) to:

* device busy time: the UNION of the intervals in which any kernel runs
  on the device. Op and stream events nest and overlap on GPU traces, so
  a plain sum of durations can exceed the wall time;
* idle share: 1 - busy / window, where the window is the host wall time
  of the traced loop (dispatch of the first call to the end of the
  last);
* per-op totals, keyed by the HLO op each kernel belongs to;
* per-phase totals from the ``fphase_*`` named scopes of
  models/pipeline.py. A kernel's scope comes from the event's ``name``
  argument when that names a phase, else from the compiled HLO's op
  metadata for its ``hlo_op`` (a fusion spanning two phases counts in
  the phase of its root op).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field

_GPU_LANE = re.compile(r"/device:GPU:\d+")
_HLO_OP_NAME = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name="([^"]*)"')


@dataclass
class DeviceTraceReport:
    """Aggregated device-side timeline for n_iters executions."""

    n_iters: int
    device_busy_ms: float  # union of kernel intervals / n_iters
    device_span_ms: float  # (last end - first start) / n_iters
    window_ms: float = 0.0  # host wall time of the traced loop / n_iters
    ops_ms: dict = field(default_factory=dict)  # hlo op -> total ms (all iters)
    trace_dir: str = ""
    # reference phase taxonomy (fft_serial.cpp:249-258 / fft_gpu.cu:45-56)
    # per iteration, from the fphase_* named scopes; kernels outside any
    # scope land in 'unattributed'
    phases_ms: dict = field(default_factory=dict)

    @property
    def idle_share(self) -> float | None:
        if self.window_ms <= 0.0:
            return None
        return max(0.0, 1.0 - self.device_busy_ms / self.window_ms)

    def report(self, top: int = 12) -> str:
        if not self.ops_ms and self.device_busy_ms == 0.0:
            return (
                "no GPU lanes in the trace (CPU backend?) — device-"
                f"timeline profiling needs a GPU; trace at {self.trace_dir}"
            )
        idle = self.idle_share
        lines = [
            f"device timeline over {self.n_iters} iterations "
            f"(jax.profiler trace):",
            f"  device busy : {self.device_busy_ms:.3f} ms/iter",
            f"  device span : {self.device_span_ms:.3f} ms/iter",
            f"  host window : {self.window_ms:.3f} ms/iter",
            "  idle share  : "
            + ("not measured" if idle is None else f"{idle:.3f}"),
        ]
        if self.phases_ms:
            lines.append("  phases (ms/iter, reference taxonomy):")
            for name, ms in sorted(
                self.phases_ms.items(), key=lambda kv: -kv[1]
            ):
                lines.append(f"    {ms:10.3f} ms  {name}")
        lines.append("  top ops (total across iters):")
        for name, ms in sorted(self.ops_ms.items(), key=lambda kv: -kv[1])[:top]:
            lines.append(f"    {ms:10.3f} ms  {name[:80]}")
        if self.trace_dir:
            lines.append(f"  full trace (TensorBoard): {self.trace_dir}")
        return "\n".join(lines)


def _load_trace(trace_dir: str) -> dict:
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.trace.json.gz"))
    )
    if not paths:
        raise FileNotFoundError(f"no trace.json.gz under {trace_dir}")
    with gzip.open(paths[-1]) as f:
        return json.load(f)


def device_events(trace: dict) -> list:
    """Complete ('X') events on GPU device lanes."""
    ev = trace.get("traceEvents", [])
    gpu_pids = {
        e["pid"]
        for e in ev
        if e.get("ph") == "M"
        and e.get("name") == "process_name"
        and _GPU_LANE.search(str(e.get("args", {}).get("name", "")))
    }
    return [
        e
        for e in ev
        if e.get("ph") == "X" and e.get("pid") in gpu_pids and "dur" in e
    ]


def busy_us(events) -> float:
    """Length of the union of [ts, ts + dur) over events, in µs."""
    total = 0.0
    end = None
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def hlo_scopes(hlo_text: str) -> dict:
    """{hlo op name: op_name metadata} from a compiled module's text."""
    out = {}
    for line in hlo_text.splitlines():
        m = _HLO_OP_NAME.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def _scope_of(e, scopes: dict) -> str:
    """The event's named-scope path. The profiler's `name` argument holds
    the scope common to every op a kernel runs, so a fusion spanning two
    phases carries only their shared prefix; the compiled HLO's op_name
    for the fusion (its root op's scope) then decides."""
    args = e.get("args", {})
    name = str(args.get("name", ""))
    if "fphase_" in name:
        return name
    return str(
        scopes.get(args.get("hlo_op", ""), "") or name or args.get("tf_op", "")
    )


def phase_breakdown(events, n_iters: int = 1, scopes: dict | None = None) -> dict:
    """Bucket device kernel events into the reference's phase taxonomy
    via the fphase_* jax.named_scope labels models/pipeline.py wraps
    around each pipeline section. Returns {phase: busy ms per iter}
    (union of that phase's intervals); kernels outside any fphase scope
    aggregate under 'unattributed'. The reference prints this table on
    every run (fft_serial.cpp:249-258, fft_gpu.cu:45-56)."""
    scopes = scopes or {}
    groups = {}
    for e in events:
        scope = _scope_of(e, scopes)
        key = "unattributed"
        i = scope.find("fphase_")
        if i >= 0:
            key = scope[i + len("fphase_"):].split("/")[0].split(":")[0]
        groups.setdefault(key, []).append(e)
    return {k: busy_us(v) / 1e3 / n_iters for k, v in groups.items()}


def summarize(
    events, n_iters: int, window_us: float = 0.0, scopes: dict | None = None,
    trace_dir: str = "",
) -> DeviceTraceReport:
    """Reduce device events of n_iters executions to a report."""
    if events:
        start = min(e["ts"] for e in events)
        end = max(e["ts"] + e["dur"] for e in events)
        span_us = end - start
    else:
        span_us = 0.0
    ops = {}
    for e in events:
        key = str(e.get("args", {}).get("hlo_op") or e.get("name", ""))
        ops[key] = ops.get(key, 0.0) + e["dur"] / 1e3
    return DeviceTraceReport(
        n_iters=n_iters,
        device_busy_ms=busy_us(events) / 1e3 / n_iters,
        device_span_ms=span_us / 1e3 / n_iters,
        window_ms=window_us / 1e3 / n_iters,
        ops_ms=ops,
        trace_dir=trace_dir,
        phases_ms=phase_breakdown(events, n_iters, scopes),
    )


def device_trace(fn, args, n_iters: int = 10, trace_dir: str | None = None):
    """Run the jitted fn(*args) n_iters times under a profiler trace and
    reduce its GPU lanes. The warm-up call (compile) runs outside the
    trace. Returns a DeviceTraceReport."""
    import jax

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="fftr_trace_")
    jax.block_until_ready(fn(*args))
    scopes = hlo_scopes(fn.lower(*args).compile().as_text())
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            out = fn(*args)
        jax.block_until_ready(out)
        window_us = (time.perf_counter() - t0) * 1e6
    return summarize(
        device_events(_load_trace(trace_dir)), n_iters, window_us, scopes,
        trace_dir,
    )
