"""The metric arithmetic: a rate is all work over the window, the 95th
percentile is over all calls, the idle share comes from the trace."""

import statistics
import types

import pytest

from benchlib import loop, spec, stats, trace


def _ctx(durations, work=10.0, window=None, steps=4):
    t, recs = 0.0, []
    for d in durations:
        recs.append(loop.Record(t, t + 0.25 * d, t + d))
        t += d
    return types.SimpleNamespace(
        records=recs, window_s=window or t, work_per_call=work,
        traffic={"steps": steps}, setup_s=3.5, trace=None)


def test_rate_is_all_work_over_the_window():
    ctx = _ctx([0.1, 0.3, 0.2], work=1000.0, window=0.8)
    for name in ("ekf_steps_per_s", "pf_particle_steps_per_s"):
        got = spec.module("end_to_end", name).read(ctx)
        assert got == pytest.approx(3 * 1000.0 / 0.8)


def test_p95_is_over_all_calls():
    durations = [0.001 * (i + 1) for i in range(200)]
    got = spec.module("end_to_end", "call_ms_p95").read(_ctx(durations))
    want = 1e3 * statistics.quantiles(durations, n=100,
                                      method="inclusive")[94]
    assert got == pytest.approx(want)
    assert stats.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == \
        pytest.approx(4.8)


def test_host_clock_per_step_and_per_sweep():
    ctx = _ctx([0.4, 0.8], steps=4)
    per_step = spec.module("layer_metrics", "pf_cuda.host_us_per_step")
    assert per_step.read(ctx) == pytest.approx(1e6 * 0.3 / 8)
    per_sweep = spec.module("layer_metrics", "ekf_cuda.host_us_per_sweep")
    assert per_sweep.read(ctx) == pytest.approx(1e6 * 0.15)


def _events():
    """A synthetic chrome trace: a 10 ms segment, kernels busy 1-3 ms and
    2-4 ms (overlapping) and 6-7 ms, a copy 8-8.5 ms, host spans."""
    t0 = 1_000_000.0
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.segment",
           "ts": t0, "dur": 10_000.0},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.segment",
           "ts": t0, "dur": 10_000.0},
          {"ph": "X", "cat": "user_annotation", "name": "bench.entry",
           "ts": t0, "dur": 5_000.0},
          {"ph": "X", "cat": "user_annotation", "name": "bench.readback",
           "ts": t0 + 5_000.0, "dur": 5_000.0}]
    for s, e, name, cat in ((1, 3, "void k_a<1>(float*)", "kernel"),
                            (2, 4, "k_b", "kernel"),
                            (6, 7, "void k_a<1>(float*)", "kernel"),
                            (8, 8.5, "Memcpy DtoH", "gpu_memcpy"),
                            (12, 13, "k_late", "kernel")):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": t0 + 1e3 * s,
                   "dur": 1e3 * (e - s)})
    return ev


def test_idle_share_from_a_synthetic_trace():
    tr = trace.from_events(_events(), calls=2)
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s == pytest.approx(0.0045)
    idle = spec.module("layer_metrics", "device.idle_pct.pf")
    ctx = types.SimpleNamespace(trace=tr)
    assert idle.read(ctx) == pytest.approx(55.0)
    assert tr.kernel_times("k_a") == pytest.approx([0.002, 0.001])
    gaps = tr.idle_gaps()
    assert gaps[0] == ("bench.entry", pytest.approx(0.002))
    assert ("bench.readback", pytest.approx(0.0015)) in gaps
    assert sum(g for _, g in gaps) == pytest.approx(0.0055)
    br = tr.breakdown()
    assert br["device_ops"][0] == ["k_a<1>", pytest.approx(0.003)]
    assert len(br["device_ops"]) <= 10 and len(br["idle_gaps"]) <= 10


def test_no_trace_reads_nothing():
    ctx = types.SimpleNamespace(trace=None, traffic={"steps": 4})
    for name in ("device.idle_pct.ekf", "resample.device_us_per_step"):
        assert spec.module("layer_metrics", name).read(ctx) is None


def test_call_keys_take_any_seed():
    keys = {stats.call_key(s, i) for s in (0, -1, 2**31 + 5, 2**64 + 3)
            for i in range(3)}
    assert len(keys) == 12
    assert all(0 <= k < 2**63 for k in keys)
    assert stats.call_key(9, 1) == stats.call_key(9, 1)


@pytest.mark.parametrize("raw, short", [
    ("void (anonymous namespace)::ekf_rollout_kernel<1, false>(float const*, "
     "float*)", "ekf_rollout_kernel<1, false>"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4>(float*)",
     "at::native::cunn_SoftMaxForward<4>"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH"),
    ("pf_batch_kernel", "pf_batch_kernel")])
def test_kernel_names(raw, short):
    assert trace.short_name(raw) == short
