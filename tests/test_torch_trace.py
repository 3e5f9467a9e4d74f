"""The program's spans (``utils/profiling.py::span``): recorded only while
a profiler records, named ``tpuslam.<layer>.<part>``, nested by call
structure, and leaving every output as it is.  CPU only: the plain paths
run the same loops and spans as the card's."""

import collections

import pytest
import torch

from tpuslam_torch.filters.ekf import EkfConfig
from tpuslam_torch.filters.pf import PfConfig
from tpuslam_torch.ops import (_build, ekf_cuda, pf_batch_cuda, pf_cuda,
                               resample_cuda)
from tpuslam_torch.slam import large
from tpuslam_torch.slam.graph import GraphConfig
from tpuslam_torch.utils import profiling

STEPS = 5


def _profiled(fn):
    """``(fn(), events)`` with ``fn`` run under a CPU profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    return out, list(prof.events())


def _named(events, name):
    return sorted((e for e in events if e.name == name),
                  key=lambda e: e.time_range.start)


def _ancestors(event):
    names, e = [], event.cpu_parent
    while e is not None:
        names.append(e.name)
        e = e.cpu_parent
    return names


def _flat(out):
    """Every tensor of a nested output, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for part in out for t in _flat(part)]
    return []


def _ekf():
    return ekf_cuda.ekf_fused_rollout(EkfConfig(), 2**40 + 7, 64, STEPS,
                                      with_nees=True, device="cpu")


def _pf_batch():
    cfg = PfConfig(num_particles=32, weight_mode="log")
    return pf_batch_cuda.pf_batch_rollout(
        cfg, torch.Generator().manual_seed(3), 4, STEPS, device="cpu")


def _pf_wide(pass2="windowed"):
    cfg = PfConfig(num_particles=40, weight_mode="log",
                   ess_threshold_frac=0.5)
    return pf_batch_cuda.pf_batch_wide_rollout(
        cfg, torch.Generator().manual_seed(4), 3, STEPS, device="cpu",
        pass2=pass2)


def _pf_fused(method="merge"):
    cfg = PfConfig(num_particles=64, weight_mode="log",
                   resample_method=method)
    return pf_cuda.pf_fused_rollout(cfg, torch.Generator().manual_seed(5),
                                    STEPS, device="cpu")


def _graph_large():
    """Two 60-pose scenes in one lockstep large solve (factor reuse), on
    one torch thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = GraphConfig(max_times=60, num_landmarks=8, max_gn_iters=10,
                          exact_jacobians=True)
        scenes = [large.make_large_scene(cfg, torch.Generator().manual_seed(s),
                                         60, 8, radius=18.0, odom_noise=0.1,
                                         device="cpu") for s in range(2)]
        poses = torch.stack([po for _, po, _ in scenes])
        obs = type(scenes[0][2])(*(torch.stack(f) for f in
                                   zip(*(o for _, _, o in scenes))))
        lists = [large.window_pairs_device(o.valid, 10, 2000)
                 for _, _, o in scenes]
        e = max(int(n) for _, n in lists)
        edges = large.EdgeList(*(torch.stack([f[:e] for f in fields])
                                 for fields in zip(*(el for el, _ in lists))))
        rel = poses[:, 1:] - poses[:, :-1]
        rel[..., 2] = torch.remainder(rel[..., 2] + torch.pi, 2 * torch.pi
                                      ) - torch.pi
        return large.graph_solve_banded(
            cfg, poses, obs, edges, band=10, rel_odom=rel,
            odom_info=(100.0,) * 3, solver="tridiag", stall_ratio=0.5,
            delta_tol=6e-5)
    finally:
        torch.set_num_threads(before)


def test_span_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    off = profiling.span("tpuslam.ekf.rollout")
    assert off is profiling.span("tpuslam.pf.step")
    with off as entered:
        assert entered is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.span("tpuslam.pf.step") is not off


def test_ekf_rollout_records_one_span():
    _, events = _profiled(_ekf)
    assert len(_named(events, "tpuslam.ekf.rollout")) == 1
    # The plain path launches nothing: no parameters or launch span.
    assert not _named(events, "tpuslam.ekf.launch")


def test_truth_table_span_only_where_the_table_is_built():
    cfg = EkfConfig()
    _build._CACHE.pop(("ekf_truth", cfg, 7, torch.device("cpu")), None)
    built, events = _profiled(lambda: ekf_cuda.truth_table(cfg, 7, "cpu"))
    assert len(_named(events, "tpuslam.ekf.truth_table")) == 1
    kept, events = _profiled(lambda: ekf_cuda.truth_table(cfg, 7, "cpu"))
    assert kept is built
    assert not _named(events, "tpuslam.ekf.truth_table")


def _check_loop(events, layer, steps):
    """One ``rollout``, one ``prepare`` inside it that ends before the
    first ``step``, and ``steps`` steps inside the rollout, in order."""
    (rollout,) = _named(events, f"tpuslam.{layer}.rollout")
    (prepare,) = _named(events, f"tpuslam.{layer}.prepare")
    step = _named(events, f"tpuslam.{layer}.step")
    assert len(step) == steps
    assert prepare.cpu_parent.name == rollout.name
    assert prepare.time_range.end <= step[0].time_range.start
    for e in step:
        assert e.cpu_parent.name == rollout.name
        assert rollout.time_range.start <= e.time_range.start
        assert e.time_range.end <= rollout.time_range.end
    for a, b in zip(step, step[1:]):
        assert a.time_range.end <= b.time_range.start
    return step


def test_pf_batch_rollout_spans():
    _, events = _profiled(_pf_batch)
    _check_loop(events, "pf_batch", STEPS)


@pytest.mark.parametrize("pass2", ["windowed", "compressed"])
def test_pf_wide_rollout_spans(pass2):
    """One rollout, one prepare, a step a step, and in each step one
    resample span (K5a and the segmented expand) inside it."""
    _, events = _profiled(lambda: _pf_wide(pass2))
    steps = _check_loop(events, "pf_wide", STEPS)
    resample = _named(events, "tpuslam.pf_wide.resample")
    assert len(resample) == STEPS
    for e, step in zip(resample, steps):
        assert _ancestors(e)[:2] == ["tpuslam.pf_wide.step",
                                     "tpuslam.pf_wide.rollout"]
        assert step.time_range.start <= e.time_range.start
        assert e.time_range.end <= step.time_range.end


#: The wide step's kernel wrappers by module, each one ``_build.launch``
#: of the form named beside it on a card (``tests/test_torch_pf_card.py``
#: counts those launches there).
WIDE_WRAPPERS = {
    "windowed": [(pf_batch_cuda, "wide_boundary", "wide_boundary"),
                 (resample_cuda, "resample_expand_seg",
                  "resample_expand_seg"),
                 (pf_batch_cuda, "wide_stats_rows", "wide_stats")],
    "compressed": [(pf_batch_cuda, "wide_boundary", "wide_boundary"),
                   (resample_cuda, "compact_particles_seg", "compact_seg"),
                   (resample_cuda, "expand_compressed_seg",
                    "expand_compressed_seg"),
                   (pf_batch_cuda, "wide_stats_rows", "wide_stats")]}


@pytest.mark.parametrize("pass2", ["windowed", "compressed"])
def test_pf_wide_step_is_one_launch_of_each_form(pass2, monkeypatch):
    """Each wide step calls each of its kernels' wrappers once, the
    resample's inside ``tpuslam.pf_wide.resample``: ``STEPS`` launches of
    each form a rollout, and none of the other pass B's."""
    calls = collections.Counter()
    for module, name, form in set(WIDE_WRAPPERS["windowed"]
                                  + WIDE_WRAPPERS["compressed"]):
        real = getattr(module, name)

        def counted(*args, _real=real, _form=form, **kw):
            calls[_form] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(module, name, counted)
    _pf_wide(pass2)
    assert calls == {form: STEPS for _, _, form in WIDE_WRAPPERS[pass2]}


@pytest.mark.parametrize("method", ["merge", "search"])
def test_pf_fused_rollout_spans(method):
    _, events = _profiled(lambda: _pf_fused(method))
    _check_loop(events, "pf", STEPS)
    resample = _named(events, "tpuslam.pf.resample")
    assert len(resample) == STEPS
    for e in resample:
        assert _ancestors(e)[:2] == ["tpuslam.pf.step", "tpuslam.pf.rollout"]


@pytest.mark.parametrize("run", [_ekf, _pf_batch, _pf_fused, _graph_large,
                                 _pf_wide],
                         ids=["ekf", "pf_batch", "pf_fused", "graph_large",
                              "pf_wide"])
def test_outputs_equal_with_the_profiler_on_and_off(run):
    off = _flat(run())
    on, events = _profiled(run)
    assert any(e.name.startswith(profiling.SPAN_PREFIX) for e in events)
    on = _flat(on)
    assert len(on) == len(off) > 0
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_span_totals_count_and_self_time():
    _, events = _profiled(_pf_batch)
    got = profiling.span_totals(events)
    assert {k: v["count"] for k, v in got.items()} == {
        "tpuslam.pf_batch.rollout": 1, "tpuslam.pf_batch.prepare": 1,
        "tpuslam.pf_batch.step": STEPS}
    rollout = got["tpuslam.pf_batch.rollout"]
    inside = (got["tpuslam.pf_batch.prepare"]["total_ms"]
              + got["tpuslam.pf_batch.step"]["total_ms"])
    assert rollout["self_ms"] == pytest.approx(rollout["total_ms"] - inside,
                                               abs=1e-9)
    for row in got.values():
        assert 0.0 <= row["self_ms"] <= row["total_ms"]
    # No child spans: self time is all of it.
    step = got["tpuslam.pf_batch.step"]
    assert step["self_ms"] == pytest.approx(step["total_ms"])
    assert list(got)[0] == "tpuslam.pf_batch.rollout"


def test_graph_large_spans_and_host_reads():
    """One ``solve``; inside it the grouping, the terms and the factor in
    that order, then a ``pass`` a lockstep GN pass, each but the last
    followed by its ``cond`` (the cap ends the loop without one); the
    host reads are the grouping's and the conditions', at most the passes
    plus 2."""
    syncs, passes = large.sync_count, large.gn_passes
    res, events = _profiled(_graph_large)
    n_passes = large.gn_passes - passes
    assert n_passes == int(res.gn_iters.max()) >= 2
    (solve,) = _named(events, "tpuslam.graph_large.solve")
    stages = [_named(events, f"tpuslam.graph_large.{part}")
              for part in ("scatter", "terms", "factor")]
    assert [len(st) for st in stages] == [1, 1, 1]
    steps = _named(events, "tpuslam.graph_large.pass")
    conds = _named(events, "tpuslam.graph_large.cond")
    assert len(steps) == n_passes
    assert len(conds) == (n_passes if n_passes < 10 else n_passes - 1)
    order = [st[0] for st in stages] + [e for pair in zip(steps, conds)
                                        for e in pair]
    for e in order:
        assert e.cpu_parent.name == solve.name
    for a, b in zip(order, order[1:]):
        assert a.time_range.end <= b.time_range.start
    host_reads = large.sync_count - syncs
    assert host_reads == 1 + len(conds) <= n_passes + 2
