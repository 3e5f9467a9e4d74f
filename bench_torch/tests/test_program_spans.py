"""The program's own spans (``tpuslam.*``) in a traced segment leave every
metric the harness reads as it is: the device operations, the harness's
spans, the idle gaps and their names, the breakdown."""

import json
import os
import tempfile
import types

import pytest
import torch

from benchlib import spec, trace

from tpuslam_torch.filters.ekf import EkfConfig
from tpuslam_torch.ops import ekf_cuda

#: The categories a profiler gives a span on the host: ``record_function``
#: and ``_RecordFunctionFast``'s.
HOST_CATS = ("user_annotation", "cpu_op")


def _harness_events(t0: float) -> list[dict]:
    """A 10 ms segment of two calls: kernels 1-3 and 6-7 ms, a copy at
    8 ms, the harness's entry and readback spans around them."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.segment",
           "ts": t0, "dur": 10_000.0}]
    for name, s, d in (("bench.inputs", 0.0, 400.0),
                       ("bench.entry", 400.0, 3_800.0),
                       ("bench.readback", 4_200.0, 800.0),
                       ("bench.entry", 5_000.0, 2_600.0),
                       ("bench.readback", 7_600.0, 2_400.0)):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "ts": t0 + s, "dur": d})
    for s, e, name, cat in ((1, 3, "void k_a<1>(float*)", "kernel"),
                            (6, 7, "void k_a<1>(float*)", "kernel"),
                            (8, 8.5, "Memcpy DtoH", "gpu_memcpy")):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": t0 + 1e3 * s,
                   "dur": 1e3 * (e - s)})
    return ev


def _program_events(t0: float) -> list[dict]:
    """The program's spans inside both entries, each rollout holding the
    midpoint of an idle gap, in every category a profiler may give them,
    a device-side copy of one included."""
    ev = []
    for cat in HOST_CATS:
        for name, s, d in (("tpuslam.ekf.rollout", 450.0, 3_700.0),
                           ("tpuslam.ekf.params", 500.0, 200.0),
                           ("tpuslam.ekf.launch", 750.0, 100.0),
                           ("tpuslam.ekf.rollout", 5_100.0, 2_450.0)):
            ev.append({"ph": "X", "cat": cat, "name": name, "ts": t0 + s,
                       "dur": d})
    ev.append({"ph": "X", "cat": "gpu_user_annotation",
               "name": "tpuslam.ekf.rollout", "ts": t0 + 1_000.0,
               "dur": 2_000.0})
    return ev


def _same_reading(a: trace.Trace, b: trace.Trace) -> None:
    assert a == b
    assert a.idle_gaps() == b.idle_gaps()
    assert a.breakdown() == b.breakdown()
    for name in ("device.idle_pct.ekf", "device.idle_pct.sweep",
                 "device.idle_pct.pf", "resample.device_us_per_step"):
        reader = spec.module("layer_metrics", name)
        ctx_a = types.SimpleNamespace(trace=a, traffic={"steps": 4})
        ctx_b = types.SimpleNamespace(trace=b, traffic={"steps": 4})
        assert reader.read(ctx_a) == reader.read(ctx_b)


def test_program_spans_change_no_reading_of_a_synthetic_trace():
    t0 = 2_000_000.0
    bare = trace.from_events(_harness_events(t0), calls=2)
    spanned = trace.from_events(
        _harness_events(t0) + _program_events(t0), calls=2)
    _same_reading(bare, spanned)
    assert spanned.idle_gaps() == [
        ("bench.readback", pytest.approx(0.003)),
        ("bench.readback", pytest.approx(0.0015)),
        ("bench.entry", pytest.approx(0.001)),
        ("bench.entry", pytest.approx(0.001))]
    assert spanned.kernel_times("k_a") == pytest.approx([0.002, 0.001])


def test_program_spans_change_no_reading_of_a_profiled_call():
    """A CPU profile of the EKF entry inside the harness's spans: the
    program's spans are in the trace, on the host, and the harness reads
    the same trace with them as without."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.segment"):
            for _ in range(2):
                with torch.profiler.record_function("bench.entry"):
                    ekf_cuda.ekf_fused_rollout(EkfConfig(), 11, 32, 4,
                                               device="cpu")
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    program = [e for e in events
               if str(e.get("name", "")).startswith("tpuslam.")]
    names = [e["name"] for e in program]
    assert names.count("tpuslam.ekf.rollout") == 2
    assert set(names) <= {"tpuslam.ekf.rollout", "tpuslam.ekf.truth_table"}
    assert all(e["cat"] in HOST_CATS for e in program)
    bare = [e for e in events if e not in program]
    got = trace.from_events(events, calls=2)
    _same_reading(got, trace.from_events(bare, calls=2))
    assert [n for n, _, _ in got.spans] == ["bench.entry"] * 2
