"""The ``graph_large.solve_10k`` cell at a size the CPU runs in seconds
(200 poses, 20 landmarks, window 30, 4 scenes a call): the driver's
set-up, inputs and readback, the reference's own scene against the
program's, a whole run's result line, the check against the plain
reference (the bfloat16 control and three planted faults come out not
correct: the odometry chain dropped, one GN pass fewer, the scan model's
bearings mirrored), the solve's roofline counts against a hand count, and
the readers on a synthetic trace."""

import math
import types

import pytest
import torch

from benchlib import calls, check, device, loop, spec, trace
from reference import graph as ref
from tpuslam_torch.models import scan_sensor
from tpuslam_torch.slam import large

CPU = torch.device("cpu")
NAME = "graph_large.solve_10k"
TINY_SCENE = {"poses": 200, "landmarks": 20, "window": 30}
TINY_TRAFFIC = {"scenes": 4}
TINY_CHECK = {"keep_within": 3}


def tiny_cell() -> spec.Cell:
    cell = spec.Cell(spec.load_spec(), NAME)
    cell.config["scene"].update(TINY_SCENE)
    cell.traffic.update(TINY_TRAFFIC)
    cell.check.update(TINY_CHECK)
    return cell


def _driver(seed=5):
    cell = tiny_cell()
    return cell, cell.driver().Driver(cell.config["scene"], cell.traffic,
                                      cell.check, seed, CPU)


def test_set_up_inputs_and_readback():
    cell, d = _driver(2**33 + 17)
    s, t1, lms = 4, 200, 20
    assert d.work_per_call == s * t1
    assert d.edges.t_b.shape == d.edges.valid.shape
    assert d.edges.t_b.shape[0] == s
    n_valid = d.edges.valid.sum(dim=1)
    # Padded to the longest list: its valid slots come first.
    assert int(n_valid.max()) == d.edges.t_b.shape[1]
    for row, n in zip(d.edges.valid, n_valid.tolist()):
        assert bool(row[:n].all()) and not bool(row[n:].any())
    inp = d.inputs(0)
    assert inp.poses.shape == (s, t1, 3)
    assert inp.rel_odom.shape == (s, t1 - 1, 3)
    assert all(f.shape == (s, t1, lms) for f in inp.obs)
    # The visibility is the map's: the edges' times see their landmark.
    e = d.edges
    assert bool(inp.obs.valid[torch.arange(s)[:, None], e.t_b, e.lm][
        e.valid].all())
    # Fresh noise a call, the same noise for the same call.
    assert not torch.equal(inp.poses, d.inputs(1).poses)
    assert torch.equal(inp.obs.dist, d.inputs(0).obs.dist)
    out = d.entry(inp)
    rmse, iters = d.readback(out)
    assert 0.0 < rmse < 10.0 and 1.0 <= iters <= 10.0
    counts = d.counts(out)
    assert counts["scenes"] == s and counts["super_blocks"] == 7
    assert counts["block"] == 90
    assert counts["resolves"] == int(out.result.gn_iters.sum())
    assert counts["passes"] == int(out.result.gn_iters.max())
    assert counts["syncs"] == counts["passes"] + 1
    assert len(counts["host_ms_calls"]) == 1
    assert 0.0 < counts["host_ms_calls"][0]


def test_the_reference_draws_the_programs_scene():
    """The reference's float64 scene from the run's draws against the
    program's float32 one: the same course, odometry and sightings to
    float32 rounding, the same visibility away from a tie."""
    _, d = _driver(2**33 + 17)
    noise = d._noise(d._scene_key(0, 1))
    truth, odo, obs = d._scene(1, noise)
    sc = ref.scene(d.scene, *d.maps[1], *noise)
    torch.testing.assert_close(sc["truth"], truth.double(), rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(sc["odometry"], odo.double(), rtol=0,
                               atol=1e-4)
    assert torch.equal(sc["obs"]["valid"] | sc["tie"],
                       obs.valid | sc["tie"])
    assert int(obs.valid.sum()) > 100
    v = obs.valid
    for name in ("dist", "bearing", "orient"):
        torch.testing.assert_close(sc["obs"][name][v],
                                   getattr(obs, name)[v].double(), rtol=0,
                                   atol=1e-4)


def test_the_check_draws_a_kept_call_again():
    _, d = _driver()
    inp = d.inputs(3)
    d.keep(3, inp, d.entry(inp))
    (item,) = d.kept_items()
    assert item[0] == 3 and item[1] is None
    for s in range(4):
        _, odo, obs = d._scene(s, d._noise(d._scene_key(3, s)))
        assert torch.equal(odo, inp.poses[s])
        assert torch.equal(obs.bearing, inp.obs.bearing[s])


def test_result_line(run_module):
    result = run_module.measure(tiny_cell(), 2**33 + 17, 0.5, False, CPU,
                                None)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"call_ms_p95", "setup_s"}
    assert set(result["check"]) == set(tiny_cell().check["limits"])


def _kept(d, n=3):
    for i in range(n):
        _, inp, out, _ = loop.one_call(d, i)
        d.keep(i, inp, out)
    return d.kept_items()


def test_sound_passes_and_the_control_fails():
    cell, d = _driver()
    items = _kept(d)
    limits = cell.check["limits"]
    sound, _ = check.judge(check.numbers(d, items), limits)
    control, _ = check.judge(check.numbers(d, items, control=torch.bfloat16),
                             limits)
    assert sound and not control


def _no_odometry(monkeypatch):
    real = large.graph_solve_banded

    def broken(*args, **kw):
        return real(*args, **{**kw, "rel_odom": None})
    monkeypatch.setattr(large, "graph_solve_banded", broken)


def _one_pass_fewer(monkeypatch):
    """The lockstep loop stops one pass before its stop rule does."""
    real = large._gn_loop

    def broken(step, poses_init, tol, max_iters, stall_ratio):
        res = real(step, poses_init, tol, max_iters, stall_ratio)
        return real(step, poses_init, tol, int(res.gn_iters.max()) - 1,
                    stall_ratio)
    monkeypatch.setattr(large, "_gn_loop", broken)


def _bearing_mirrored(monkeypatch):
    """The port's scan model reads each bearing mirrored about the
    heading: a fault in the scene the program solves, which the
    reference, drawing its own, does not share."""
    real = scan_sensor.scan_true

    def broken(*args, **kw):
        true = real(*args, **kw)
        return true._replace(bearing=math.pi - true.bearing)
    monkeypatch.setattr(scan_sensor, "scan_true", broken)


@pytest.mark.parametrize("plant", [_no_odometry, _one_pass_fewer,
                                   _bearing_mirrored],
                         ids=["no_odometry", "one_pass_fewer",
                              "bearing_mirrored"])
def test_planted_faults_are_not_correct(plant, run_module, monkeypatch):
    plant(monkeypatch)
    result = run_module.measure(tiny_cell(), 11, 0.2, False, CPU, None)
    assert result["correct"] is False


def test_roofline_by_hand():
    """BASELINE config 5's chain: M = 120, N = 250; 32 scenes and 160
    resolves (five GN iterations a scene)."""
    mod = spec.module("roofline", "graph_large")
    counts = {"scenes": 32, "resolves": 160, "super_blocks": 250,
              "block": 120}
    least, _ = mod.least_s({}, counts, device.PEAKS)
    m3 = 120 ** 3
    factor_ops = 250 * (2 * m3 + 2 * m3 + m3 / 3 + m3 + 2 * m3)
    assert factor_ops == pytest.approx(3.168e9)
    resolve_bytes = 3 * 250 * 120 * 120 * 4
    assert resolve_bytes == 43_200_000
    want = (32 * factor_ops / device.PEAKS["f32_ops_per_s"]
            + 160 * resolve_bytes / device.PEAKS["hbm_bytes_per_s"])
    assert least == pytest.approx(want)
    assert 1e3 * least == pytest.approx(3.576, abs=1e-3)


def _synthetic():
    """Two calls: inputs 0-1 ms (one op), entry 1-5 ms and readback 5-6 ms
    (ops 1.5-2, 2.5-3.5, 3-4 ms and 5.2-5.4 ms), then inputs 6-7 ms (one
    op), entry 7-9 and readback 9-10 ms (ops 7.5-8.5 and 9.1-9.2 ms)."""
    t0 = 1_000_000.0
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.segment",
           "ts": t0, "dur": 10_000.0}]
    for name, s, e in (("bench.inputs", 0, 1), ("bench.entry", 1, 5),
                       ("bench.readback", 5, 6), ("bench.inputs", 6, 7),
                       ("bench.entry", 7, 9), ("bench.readback", 9, 10)):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "ts": t0 + 1e3 * s, "dur": 1e3 * (e - s)})
    for s, e in ((0.2, 0.8), (1.5, 2), (2.5, 3.5), (3, 4), (5.2, 5.4),
                 (6.2, 6.8), (7.5, 8.5), (9.1, 9.2)):
        ev.append({"ph": "X", "cat": "kernel", "name": "k", "ts": t0 + 1e3 * s,
                   "dur": 1e3 * (e - s)})
    return trace.from_events(ev, calls=2)


def test_readers_on_a_synthetic_trace():
    tr = _synthetic()
    wins = calls.windows(tr)
    assert wins == [pytest.approx((0.001, 0.006)),
                    pytest.approx((0.007, 0.010))]
    assert [len(calls.ops_in(tr, w)) for w in wins] == [4, 2]
    assert calls.busy_s(tr, wins[1]) == pytest.approx(0.0011)
    cell = tiny_cell()
    counts = {"scenes": 4, "resolves": 16, "super_blocks": 7, "block": 90,
              "syncs": 6}
    ctx = types.SimpleNamespace(trace=tr, counts=counts, cell=cell,
                                traffic=cell.traffic, records=[None] * 2)
    counts["host_ms_calls"] = [40.0, 2.0, 3.0, 30.0]
    read = {m: spec.module("layer_metrics", m).read for m in (
        "graph_large.device_ops_per_call", "graph_large.solve_roofline",
        "graph_large.host_syncs_per_call", "graph_large.host_ms_per_call",
        "device.idle_pct.graph")}
    assert read["graph_large.device_ops_per_call"](ctx) == 3.0
    least, _ = spec.module("roofline", "graph_large").least_s(
        cell.traffic, counts, device.PEAKS)
    assert read["graph_large.solve_roofline"](ctx) == pytest.approx(
        100.0 * least / 0.0011)
    assert read["graph_large.host_syncs_per_call"](ctx) == 6
    # The window's two calls: not the warm-up's, nor the traced one's.
    assert read["graph_large.host_ms_per_call"](ctx) == 2.5
    assert read["device.idle_pct.graph"](ctx) == pytest.approx(
        100.0 * (1 - tr.busy_s / tr.window_s))


def test_readers_without_the_programs_counts_read_nothing():
    """A program without the scene axis's counters (the parent's) gives
    its counts no ``syncs``, ``resolves`` or ``host_ms_calls``: the
    readers read None."""
    ctx = types.SimpleNamespace(trace=None, counts={}, cell=tiny_cell(),
                                traffic={})
    for m in ("graph_large.device_ops_per_call",
              "graph_large.solve_roofline",
              "graph_large.host_syncs_per_call",
              "graph_large.host_ms_per_call", "device.idle_pct.graph"):
        assert spec.module("layer_metrics", m).read(ctx) is None


def test_config_is_bench_graph_large():
    """``bench_graph_large``'s GraphConfig and scene (bench.py:191-231)."""
    cfg = spec.Cell(spec.load_spec(), NAME).config
    scene = cfg["scene"]
    assert (scene["poses"], scene["landmarks"], scene["window"]) == (
        10000, 1000, 40)
    assert scene["radius_frac"] * scene["poses"] == pytest.approx(3000.0)
    assert scene["delta_tol_per_pose"] * scene["poses"] == pytest.approx(
        0.01)
    assert scene["scan"] == {
        "range_m": 15.0, "angle_rad": math.radians(80.0), "dist_gain": 0.05,
        "dir_sigma": math.radians(2.0), "orient_sigma": math.radians(2.0)}
    assert (scene["max_gn_iters"], scene["exact_jacobians"],
            scene["odom_noise"], scene["solver"], scene["stall_ratio"]) == (
        10, True, 0.1, "tridiag", 0.5)
    assert scene["odom_info"] == [100.0] * 3
    assert cfg["reduced"] == [] and cfg["precision"] == "float32"
    assert set(cfg["assumed"]) == {"scenes", "frozen_omega"}
