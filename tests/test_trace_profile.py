"""Device-timeline trace profiling: reduction unit tests on synthetic
GPU-shaped traces + the CPU path (no GPU lanes)."""

import gzip
import json
import os

import jax
import jax.numpy as jnp
import pytest

from fft_restoration_tpu.utils.trace_profile import (
    DeviceTraceReport,
    _load_trace,
    busy_us,
    device_events,
    device_trace,
    hlo_scopes,
    phase_breakdown,
    summarize,
)


def _write_trace(tmp_path, events):
    d = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    os.makedirs(d)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def _gpu_trace():
    """Two streams on GPU 0; a module-level event nests over the kernels
    of stream 1, and stream 2 overlaps stream 1 — as on a real trace."""
    return [
        {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 701, "name": "process_name", "args": {"name": "/host:CPU"}},
        {"ph": "X", "pid": 1, "tid": 13, "name": "jit_f", "ts": 100, "dur": 400},
        {"ph": "X", "pid": 1, "tid": 13, "name": "loop_pad_fusion", "ts": 100,
         "dur": 100, "args": {"hlo_op": "loop_pad_fusion", "name": "jit(f)/fphase_ingest_pad"}},
        {"ph": "X", "pid": 1, "tid": 13, "name": "regular_fft<2048>", "ts": 250,
         "dur": 150, "args": {"hlo_op": "fft.0.0"}},
        {"ph": "X", "pid": 1, "tid": 14, "name": "input_reduce_fusion", "ts": 350,
         "dur": 100, "args": {"hlo_op": "input_reduce_fusion"}},
        {"ph": "X", "pid": 1, "tid": 14, "name": "late_fusion", "ts": 800,
         "dur": 50, "args": {"hlo_op": "late_fusion"}},
        {"ph": "X", "pid": 701, "tid": 1, "name": "PjitFunction(f)", "ts": 0, "dur": 99999},
    ]


_HLO = """
HloModule jit_f
ENTRY %main {
  %loop_pad_fusion = f32[4,4]{1,0} fusion(%x), kind=kLoop, metadata={op_name="jit(f)/fphase_ingest_pad/pad"}
  %fft.0.0 = c64[4,4]{1,0} fft(%y), fft_type=FFT, metadata={op_name="jit(f)/fphase_fft_image/jit(fft)/fft" scheduling_name="fft.0.0"}
  ROOT %input_reduce_fusion = f32[] fusion(%z), kind=kInput, metadata={op_name="jit(f)/fphase_normalize/reduce_min"}
}
"""


def test_parse_trace_aggregates_device_ops(tmp_path):
    """Only GPU lanes count; host events are dropped."""
    evs = device_events(_load_trace(_write_trace(tmp_path, _gpu_trace())))
    assert {e["pid"] for e in evs} == {1}
    assert "PjitFunction(f)" not in {e["name"] for e in evs}
    rep = summarize([e for e in evs if "args" in e], n_iters=1)
    assert set(rep.ops_ms) == {
        "loop_pad_fusion", "fft.0.0", "input_reduce_fusion", "late_fusion"
    }


def test_other_device_and_cpu_lanes_are_not_gpu_lanes(tmp_path):
    events = [
        {"ph": "M", "pid": 3, "name": "process_name", "args": {"name": "/device:CUSTOM:0"}},
        {"ph": "M", "pid": 4, "name": "process_name", "args": {"name": "/host:CPU"}},
        {"ph": "X", "pid": 3, "name": "fusion.1", "ts": 0, "dur": 600},
        {"ph": "X", "pid": 4, "name": "fusion.2", "ts": 0, "dur": 600},
    ]
    assert device_events(_load_trace(_write_trace(tmp_path, events))) == []


def test_busy_is_union_not_sum():
    evs = [e for e in _gpu_trace() if e.get("pid") == 1 and e["ph"] == "X"]
    # sum of durations = 800 µs, but the union is [100, 500) + [800, 850)
    assert sum(e["dur"] for e in evs) == 800
    assert busy_us(evs) == pytest.approx(450.0)
    assert busy_us([]) == 0.0


def test_idle_share_against_window():
    evs = [e for e in _gpu_trace() if e.get("pid") == 1 and e["ph"] == "X"]
    rep = summarize(evs, n_iters=1, window_us=1000.0)
    assert rep.device_busy_ms == pytest.approx(0.45)
    assert rep.device_span_ms == pytest.approx(0.75)
    assert rep.idle_share == pytest.approx(0.55)
    assert "idle share  : 0.550" in rep.report()
    assert DeviceTraceReport(1, 0.0, 0.0).idle_share is None


def test_phase_breakdown_reads_name_then_hlo_metadata():
    evs = [
        e for e in _gpu_trace()
        if e.get("pid") == 1 and e["ph"] == "X" and "args" in e
    ]
    scopes = hlo_scopes(_HLO)
    assert scopes["fft.0.0"] == "jit(f)/fphase_fft_image/jit(fft)/fft"
    assert scopes["input_reduce_fusion"].startswith("jit(f)/fphase_normalize")
    ph = phase_breakdown(evs, n_iters=1, scopes=scopes)
    assert ph == pytest.approx({
        "ingest_pad": 0.1, "fft_image": 0.15, "normalize": 0.1,
        "unattributed": 0.05,
    })
    # without the HLO map only the event's own scope name is known
    assert set(phase_breakdown(evs, 1)) == {"ingest_pad", "unattributed"}


def test_fusion_spanning_phases_counts_in_its_root_phase():
    """The profiler names a fusion by the scope its ops share; the HLO
    op_name of the fusion root decides the phase."""
    ev = {"ph": "X", "pid": 1, "name": "loop_complex_fusion", "ts": 0,
          "dur": 40, "args": {"hlo_op": "loop_complex_fusion",
                              "name": "jit(_restore_core)"}}
    scopes = {"loop_complex_fusion": "jit(_restore_core)/fphase_ifft/complex"}
    assert phase_breakdown([ev], 1, scopes) == pytest.approx({"ifft": 0.04})
    assert phase_breakdown([ev], 1) == pytest.approx({"unattributed": 0.04})


def test_report_formats():
    rep = DeviceTraceReport(
        n_iters=10,
        device_busy_ms=2.5,
        device_span_ms=3.0,
        ops_ms={"fusion.1": 20.0, "custom-call.2": 5.0},
        trace_dir="/tmp/x",
    )
    text = rep.report()
    assert "2.500 ms/iter" in text
    assert "fusion.1" in text
    assert "idle share  : not measured" in text


def test_device_trace_cpu_reports_no_lanes(tmp_path):
    """On the CPU test backend there are no GPU lanes; the report says
    so instead of printing zeros."""
    f = jax.jit(lambda a: a * 2.0)
    x = jnp.ones((8, 8))
    rep = device_trace(f, (x,), n_iters=2, trace_dir=str(tmp_path / "tr"))
    assert rep.n_iters == 2
    assert rep.device_busy_ms == 0.0
    assert "no GPU lanes" in rep.report()
