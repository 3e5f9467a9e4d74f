"""The ``pf_loc.wide_1024x10k`` cell at sizes the CPU runs in seconds (16
filters of 2,048 particles x 60 steps, where the gate fires): the
driver's inputs, readback and counts, a whole run's result line, the
check against the plain reference (the bfloat16 control and planted
faults come out not correct: the batched law's ``-log n`` restart in
place of the wide law's 0, the batched seed stride 7919 in place of
``wide_seed_step``, one step's estimates altered, and the gate that K5b
writes for the next step never firing or firing at twice its threshold),
K5b's roofline arithmetic, and the readers on a synthetic trace.

The seed-stride fault differs from the sound law only where ``B *
ceil(n / 1024)`` passes 7919 (1024 x 10,000 gives 10,240), so its test
runs 7,920 filters of 8 particles (63,360 particles a step; the gate of
8 particles never fires, so every step is before a resample)."""

import math
import types

import pytest
import torch

from benchlib import check, device, loop, spec, trace
from tpuslam_torch.ops import pf_batch_cuda

CPU = torch.device("cpu")
NAME = "pf_loc.wide_1024x10k"
TINY_TRAFFIC = {"filters": 16, "particles": 2048, "steps": 60}
TINY_CHECK = {"sample": 8, "keep_within": 3}


def tiny_cell(**traffic) -> spec.Cell:
    cell = spec.Cell(spec.load_spec(), NAME)
    cell.traffic.update({**TINY_TRAFFIC, **traffic})
    cell.check.update(TINY_CHECK)
    return cell


def _driver(seed=5, **traffic):
    cell = tiny_cell(**traffic)
    return cell, cell.driver().Driver(cell.config["scene"], cell.traffic,
                                      cell.check, seed, CPU)


def test_traffic_is_the_flagship_wide_run():
    cell = spec.Cell(spec.load_spec(), NAME)
    t = cell.traffic
    assert (t["driver"], t["filters"], t["particles"], t["steps"],
            t["pass2"]) == ("pf_batch_wide_rollout", 1024, 10000, 400,
                            "windowed")
    assert cell.config["scene"]["ess_threshold_frac"] == 0.01
    assert cell.config["scale"] == {k: t[k] for k in cell.config["scale"]}
    batched = spec.Cell(spec.load_spec(), "pf_loc.batched_8192x1000")
    assert cell.config["scene"] == batched.config["scene"]
    assert {m["name"] for m in cell.end_to_end} == {"call_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "pf_wide_cuda.host_us_per_step", "pf_wide.device_ops_per_step",
        "pf_wide.resample_device_us_per_step", "k5b_roofline",
        "device.idle_pct.wide"}


def test_inputs_readback_and_counts():
    _, d = _driver(2**33 + 17)
    noise, offs = d.inputs(0)
    assert noise.shape == (60, 16, 5, 2) and offs.shape == (60, 16)
    assert float(offs.min()) >= 0.0 and float(offs.max()) < 1.0
    # Fresh draws a call, the same draws for the same call.
    assert not torch.equal(offs, d.inputs(1)[1])
    noise, offs = d.inputs(2)
    assert torch.equal(noise, d.inputs(2)[0])
    out = d.entry((noise, offs))
    (rmse,) = d.readback(out)
    assert 0.0 < rmse < 1.0
    counts = d.counts(out)
    assert counts["fired"] == int(out[1].resampled.sum()) > 0
    # The CPU runs the plain twins, which launch nothing.
    assert counts["launches"] == dict.fromkeys(counts["launches"], 0)
    assert d.work_per_call == 16 * 2048 * 60


def test_result_line(run_module):
    cell = tiny_cell()
    result = run_module.measure(cell, 2**33 + 17, 0.2, False, CPU, None)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"call_ms_p95", "setup_s"}
    assert set(result["check"]) == set(cell.check["limits"])


def _kept(d, n=3):
    for i in range(n):
        _, inp, out, _ = loop.one_call(d, i)
        d.keep(i, inp, out)
    return d.kept_items()


def test_sound_passes_and_the_control_fails():
    cell, d = _driver()
    items = _kept(d)
    limits = cell.check["limits"]
    values = check.numbers(d, items)
    sound, _ = check.judge(values, limits)
    control, _ = check.judge(check.numbers(d, items, control=torch.bfloat16),
                             limits)
    assert sound and not control
    # Both of the wide law's own numbers had steps to compare.
    assert 0.0 < values["pre_resample_gap_m"] < 1e-4
    assert 0.0 < values["fired_lse_gap"]


def _restart_at_minus_log_n(monkeypatch):
    """A firing filter's log weights restart at ``-log n`` (the batched
    law's), not at 0: the normalizers shift by ``log n``, the weights do
    not."""
    real = pf_batch_cuda.wide_stats_rows

    def broken(cfg, seed, particles, log_w, z, bad, fire, *args, **kw):
        p, lw, lse, lse2, x_est, *gate = real(cfg, seed, particles, log_w,
                                              z, bad, fire, *args, **kw)
        shift = torch.where(fire, math.log(cfg.num_particles), 0.0)
        return (p, lw - shift[:, None], lse - shift, lse2 - 2.0 * shift,
                x_est, *gate)
    monkeypatch.setattr(pf_batch_cuda, "wide_stats_rows", broken)


def _batched_seed_stride(monkeypatch):
    monkeypatch.setattr(pf_batch_cuda, "wide_seed_step",
                        lambda cfg, batch: pf_batch_cuda.SEED_STEP)


def _altered(monkeypatch):
    """One step's estimates written with x and y swapped (every filter)."""
    real = pf_batch_cuda.pf_batch_wide_rollout

    def broken(*args, **kw):
        final, outs = real(*args, **kw)
        est = outs.x_est[outs.x_est.shape[0] // 2]
        est[..., :2] = est[..., :2].flip(-1).clone()
        return final, outs
    monkeypatch.setattr(pf_batch_cuda, "pf_batch_wide_rollout", broken)


def _gate(fire_of):
    """The next step's gate that K5b returns, its fire flags replaced by
    ``fire_of(cfg, bad, ess)``."""
    def plant(monkeypatch):
        real = pf_batch_cuda.wide_stats_rows

        def broken(cfg, *args, **kw):
            *out, (bad, ess, _) = real(cfg, *args, **kw)
            return (*out, (bad, ess, fire_of(cfg, bad, ess)))
        monkeypatch.setattr(pf_batch_cuda, "wide_stats_rows", broken)
    return plant


def _twice_the_threshold(cfg, bad, ess):
    return ~bad & (ess < 2.0 * cfg.num_particles * cfg.ess_threshold_frac)


#: Each fault and the traffic it runs on (the stride's needs a batch past
#: 7919 tiles: the module docstring).
FAULTS = {"restart_minus_log_n": (_restart_at_minus_log_n, {}),
          "seed_stride_7919": (_batched_seed_stride,
                               {"filters": 7920, "particles": 8}),
          "altered": (_altered, {}),
          "gate_never_fires": (_gate(lambda cfg, bad, ess:
                                     torch.zeros_like(bad)), {}),
          "gate_threshold_doubled": (_gate(_twice_the_threshold), {})}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_are_not_correct(fault, run_module, monkeypatch):
    plant, traffic = FAULTS[fault]
    # The sound program passes on the same traffic.
    sound = run_module.measure(tiny_cell(**traffic), 11, 0.05, False, CPU,
                               None)
    assert sound["correct"] is True
    plant(monkeypatch)
    result = run_module.measure(tiny_cell(**traffic), 11, 0.05, False, CPU,
                                None)
    assert result["correct"] is False


def test_k5b_roofline_by_hand():
    """1024 x 10,000 with 239 filters firing a step: 32 bytes a particle,
    28 in a firing filter, 72 a filter, over 3.35 TB/s, which is the
    0.0950 ms bound of K5b's own measurements (PERF.md); float32
    operations (240 a particle) bound it at 0.0367 ms only."""
    mod = spec.module("roofline", "k5b")
    traffic = {"filters": 1024, "particles": 10000, "steps": 400}
    least, by = mod.least_s(traffic, {"fired": 239 * 400}, device.PEAKS)
    want = (32 * 1024 * 10000 - 4 * 239 * 10000 + 72 * 1024) / 3.35e12
    assert by == "bytes" and least == pytest.approx(want)
    assert 1e3 * least == pytest.approx(0.0950, abs=5e-5)
    ops = 240 * 1024 * 10000 / device.PEAKS["f32_ops_per_s"]
    assert 1e3 * ops == pytest.approx(0.0367, abs=5e-5)
    reader = spec.module("layer_metrics", "k5b_roofline")
    assert 'roofline_share("k5b")' in open(reader.__file__).read()
    assert mod.KERNEL == "wide_stats_kernel"


def _synthetic():
    """Two calls of two steps each: inputs 0-1 ms (one op), entry 1-5 ms
    and readback 5-6 ms (K5a 1.5-1.6, the expand 1.6-1.8, K5b 1.8-2.8,
    K5a 3.0-3.1, the expand 3.1-3.3, K5b 3.3-4.3, the RMSE 5.2-5.4 ms),
    then the second call alike 6 ms later."""
    t0 = 1_000_000.0
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.segment",
           "ts": t0, "dur": 12_000.0}]
    for c in (0, 6):
        for name, s, e in (("bench.inputs", 0, 1), ("bench.entry", 1, 5),
                           ("bench.readback", 5, 6)):
            ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                       "ts": t0 + 1e3 * (s + c), "dur": 1e3 * (e - s)})
        for name, s, e in (
                ("rand", 0.2, 0.8), ("void wide_boundary_kernel(int)", 1.5,
                                     1.6),
                ("void expand_seg_kernel(float)", 1.6, 1.8),
                ("void wide_stats_kernel<1, true>(Buf)", 1.8, 2.8),
                ("void wide_boundary_kernel(int)", 3.0, 3.1),
                ("void expand_seg_kernel(float)", 3.1, 3.3),
                ("void wide_stats_kernel<1, true>(Buf)", 3.3, 4.3),
                ("mean", 5.2, 5.4)):
            ev.append({"ph": "X", "cat": "kernel", "name": name,
                       "ts": t0 + 1e3 * (s + c), "dur": 1e3 * (e - s)})
    return trace.from_events(ev, calls=2)


def test_readers_on_a_synthetic_trace():
    tr = _synthetic()
    cell = tiny_cell(steps=2)
    ctx = types.SimpleNamespace(trace=tr, counts={}, cell=cell,
                                traffic=cell.traffic)
    read = {m: spec.module("layer_metrics", m).read for m in (
        "pf_wide.device_ops_per_step", "pf_wide.resample_device_us_per_step",
        "device.idle_pct.wide")}
    # Seven ops a call in the entry and the readback, over two steps.
    assert read["pf_wide.device_ops_per_step"](ctx) == pytest.approx(3.5)
    # K5a 0.1 ms and the expand 0.2 ms a step.
    assert read["pf_wide.resample_device_us_per_step"](ctx) == \
        pytest.approx(300.0)
    assert read["device.idle_pct.wide"](ctx) == pytest.approx(
        100.0 * (1 - tr.busy_s / tr.window_s))
    assert tr.kernel_times("wide_stats_kernel") == pytest.approx(
        [1e-3] * 4)
    host = spec.module("layer_metrics", "pf_wide_cuda.host_us_per_step")
    recs = [loop.Record(0.0, 0.004, 0.005), loop.Record(0.005, 0.007, 0.01)]
    assert host.read(types.SimpleNamespace(
        records=recs, traffic={"steps": 2})) == pytest.approx(1e6 * 0.003 / 2)


def test_readers_without_a_trace_read_nothing():
    ctx = types.SimpleNamespace(trace=None, counts={}, cell=tiny_cell(),
                                traffic=tiny_cell().traffic)
    for m in ("pf_wide.device_ops_per_step",
              "pf_wide.resample_device_us_per_step", "device.idle_pct.wide"):
        assert spec.module("layer_metrics", m).read(ctx) is None
