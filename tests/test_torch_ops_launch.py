"""The port's one launch path on the CPU: ``ops/_build``'s launch helper,
plan cache and launch counters, and the C entries' interface.

No kernel runs here.  The ``stand_in`` fixture puts a library in place of
the kernel library whose every entry records its name and arguments and
returns a settable code, so the wrappers' launch parts run on CPU tensors
and are held to the arguments and plans they hand the C entries.  The
C entries' parameter lists are read from ``csrc/`` and held to the
``argtypes`` that ``_build`` declares.  This module imports no JAX.
"""

import collections
import ctypes
import math
import re

import pytest
import torch

from tpuslam_torch.filters import EkfConfig
from tpuslam_torch.filters import pf as tpf
from tpuslam_torch.ops import _build, ekf_cuda, pf_cuda
from tpuslam_torch.ops import pf_batch_cuda as pb

CFG = EkfConfig()
OTHER_CFG = EkfConfig(dt=0.05, radius_m=7.5, yaw_rate=math.radians(14.0),
                      q_std=(0.2, 0.15, math.radians(0.5)), r_std=(0.5, 0.7),
                      q_act_std=(0.3, 0.1, 0.01), r_act_std=(1.5, 0.5),
                      x0=(7.5, 0.0, 1.2), p0_std=(0.02, 0.03, 0.4))
PF_CFG = tpf.PfConfig(num_particles=1000, weight_mode="log")
PF_OTHER = tpf.PfConfig(num_particles=77, dt=0.05, yaw_rate=math.radians(14.0),
                        landmarks=((1.5, -2.0), (3.25, 4.0), (-6.0, 0.5)),
                        q_std=(0.1, 0.2, math.radians(3.0)), r_std=(0.4, 0.7),
                        ess_threshold_frac=0.3, weight_mode="log")
TWO_WORD_SEED = (0x1234ABCD << 32) | 0x9E37
H100_SMS = 132
CPU = torch.device("cpu")
PF_KERNELS = ("K2", "K4", "K5b")
#: Each PF kernel's cache kind and launch form, and its C entry.
PF_ENTRY = {"K2": ("pf_step", "tpuslam_pf_step"),
            "K4": ("pf_batch_step", "tpuslam_pf_batch_step"),
            "K5b": ("wide_stats", "tpuslam_wide_stats")}


class _StandInLibrary:
    """A kernel library whose every C entry records its name and arguments
    in ``calls``, launches nothing and returns ``rc`` (0: accepted)."""

    def __init__(self):
        self.calls = []
        self.rc = 0

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.rc

        entry.__name__ = name
        return entry


@pytest.fixture
def stand_in(monkeypatch):
    """The kernels' launch path on the CPU: ``_build``'s cache and counters
    empty, and a :class:`_StandInLibrary` in place of the kernel library;
    the CUDA stream and device queries answer for the CPU device (index
    None; stream 77), the SM count for an H100's 132."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "_CACHE", {})
    monkeypatch.setattr(_build, "builds", collections.Counter())
    monkeypatch.setattr(_build, "launches", collections.Counter())
    monkeypatch.setattr(ekf_cuda, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(_build, "cuda_library", lambda device: lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 77, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    return lib


def plan_and_parent(kernel, cfg, n_steps):
    """The plan a launch of ``kernel`` takes on the CPU device, and the
    struct its launch filled on every call before plans, with the per-call
    fields zeroed."""
    if kernel == "K1":
        return (ekf_cuda._plan(cfg, n_steps, CPU),
                ekf_cuda._EkfParams(batch=0, n_steps=n_steps,
                                    **ekf_cuda._constants(cfg)))
    n, n_lm, c = cfg.num_particles, len(cfg.landmarks), pf_cuda._constants(cfg)
    if kernel == "K2":
        return pf_cuda._plan(cfg, CPU), pf_cuda._PfParams(
            n=n, key0=0, key1=0, n_lm=n_lm, flag=0.0, **c)
    if kernel == "K4":
        return pb._batch_plan(cfg, CPU), pb._PfBatchParams(
            n=n, n_lm=n_lm, neg_log_n=-math.log(float(n)),
            ess_min=n * cfg.ess_threshold_frac, key0=0, key1=0, **c)
    return pb._wide_plan(cfg, CPU), pb._WideParams(
        n=n, b=0, n_lm=n_lm, key0=0, key1=0, **c)


def _launch_pf(kernel, cfg, seed, batch=3, flag=0.0):
    """One launch of a PF kernel through its wrapper's launch on zero CPU
    tensors (Philox mode; K5b in its fused form)."""
    n, n_lm = cfg.num_particles, len(cfg.landmarks)
    if kernel == "K2":
        return pf_cuda._launch(cfg, seed, flag, torch.zeros(3, n),
                               torch.zeros(n), torch.zeros(n_lm, 2), 1, None,
                               True, None, None)
    lw, vec = torch.zeros(batch, n), torch.zeros(batch)
    p, z = torch.zeros(3, batch, n), torch.zeros(batch, n_lm, 2)
    if kernel == "K4":
        return pb._launch_batch(cfg, seed, p, lw, vec, vec, z, 1, None, None,
                                pb._batch_rows(batch, n, CPU, False))
    flags = torch.zeros(batch, dtype=torch.bool)
    return pb._launch_wide_stats(cfg, seed, p, lw, z, flags, flags,
                                 torch.zeros(batch, dtype=torch.int32), p, 1,
                                 None)


@pytest.mark.parametrize("kernel", PF_KERNELS)
def test_pf_plan_built_once_per_cfg_and_device(stand_in, kernel):
    """A PF kernel's plan is cached by (cfg, device), whatever the batch,
    the seed or K2's flag: two configurations, two builds, one launch
    counted a call."""
    kind, entry = PF_ENTRY[kernel]
    calls = 0
    for cfg in (PF_CFG, PF_OTHER):
        for batch, seed, flag in ((3, 1, 0.0), (5, 2, 1.0),
                                  (3, TWO_WORD_SEED, 0.0)):
            _launch_pf(kernel, cfg, seed, batch, flag)
            calls += 1
    assert _build.builds[kind] == 2
    assert _build.launches[kind] == calls
    assert [name for name, _ in stand_in.calls] == [entry] * calls


@pytest.mark.parametrize("kernel", PF_KERNELS)
def test_pf_launch_passes_the_per_call_words(stand_in, kernel):
    """Each PF launch passes the plan's template, the seed's two words
    (K2 also its flag, K5b its batch) and the current stream as the C
    entry's arguments, and leaves the template as it was built."""
    plan, _ = plan_and_parent(kernel, PF_CFG, None)
    template = bytes(plan.params)
    for batch, seed, flag in ((3, TWO_WORD_SEED, 1.0), (5, 7, 0.0)):
        _launch_pf(kernel, PF_CFG, seed, batch, flag)
        _, args = stand_in.calls[-1]
        lo, hi = seed & 0xFFFFFFFF, seed >> 32
        if kernel == "K2":
            assert args[7:12] == (plan.params_ptr, lo, hi, flag, 1)
            assert args[12] == 1 and args[-1] == 77
        elif kernel == "K4":
            assert args[1:] == (plan.params_ptr, lo, hi, batch, 1, 77)
        else:
            assert args[1:] == (plan.params_ptr, lo, hi, batch, 1, 1, 77)
        assert bytes(plan.params) == template


@pytest.mark.parametrize("kernel", ("K1",) + PF_KERNELS + ("ticket",))
def test_error_return_raises_naming_the_entry(stand_in, kernel):
    """A non-zero return from a C entry raises a ``RuntimeError`` that
    names the entry, and the launch is not counted."""
    stand_in.rc = 700
    if kernel == "ticket":
        with pytest.raises(RuntimeError, match="tpuslam_pf_step_ticket"):
            pf_cuda.ticket_count("cpu")
        return
    name = "tpuslam_ekf_rollout" if kernel == "K1" else PF_ENTRY[kernel][1]
    with pytest.raises(RuntimeError, match=f"{name} launch failed: CUDA "
                                           "error 700"):
        if kernel == "K1":
            ekf_cuda._launch(CFG, 1, 8, 4, 1, False, None, CPU)
        else:
            _launch_pf(kernel, PF_CFG, 1)
    assert not _build.launches


@pytest.mark.parametrize("index", [0, 1])
def test_launch_guards_only_a_device_that_is_not_current(monkeypatch,
                                                         index):
    """With device 0 current, a launch on device 0 calls its entry
    directly and one on device 1 calls it inside device 1's guard; either
    way on that device's current raw stream, counted once."""
    current, events = [0], []

    class Guard:
        def __init__(self, idx):
            self.idx = idx

        def __enter__(self):
            events.append(("enter", self.idx))
            current.append(self.idx)

        def __exit__(self, *exc):
            current.pop()
            events.append(("exit", self.idx))

    def entry(*args):
        events.append(("call", current[-1], args))
        return 0

    monkeypatch.setattr(_build, "launches", collections.Counter())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[-1])
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda idx: 100 + idx, raising=False)
    _build.launch("pf_step", entry, index, 5, None)
    call = ("call", index, (5, None, 100 + index))
    assert events == ([call] if index == 0 else
                      [("enter", 1), call, ("exit", 1)])
    assert _build.launches == {"pf_step": 1}


def test_a_captured_graph_counts_its_launches_at_each_replay(monkeypatch):
    """The launches made while a CUDA graph is captured ran nowhere: the
    capture returns them and takes them off the count, and each replay
    counts them again."""
    captures = []

    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    class Capture:
        def __init__(self, graph, stream):
            captures.append((graph, stream))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def fn(x):
        _build.launches["thomas_factor"] += 1
        _build.launches["compact"] += 2
        return x + 1

    monkeypatch.setattr(_build, "launches",
                        collections.Counter({"pf_step": 1}))
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    graph = Graph()
    out, held = _build.capture(graph, "stream", fn, 1)
    assert out == 2 and captures == [(graph, "stream")]
    assert held == {"thomas_factor": 1, "compact": 2}
    assert _build.launches == {"pf_step": 1}
    for _ in range(2):
        _build.replay(graph, held)
    assert graph.replays == 2
    assert _build.launches == {"pf_step": 1, "thomas_factor": 2,
                               "compact": 4}


def _extern_c_entries():
    """Every ``extern "C"`` entry in ``csrc/``: ``{name: [(type, param)]}``."""
    entries = {}
    for path in sorted(_build.CSRC_DIR.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\((.*?)\)\s*\{',
                                       path.read_text(), re.S):
            words = [p.split() for p in params.split(",")]
            entries[name] = [(" ".join(w[:-1]), w[-1]) for w in words]
    return entries


ENTRIES = _extern_c_entries()
#: The entries that copy into host memory rather than launch: the device
#: reads (the two counters that return to 0, the quotients' fallback
#: counts) and the occupancy queries (K6's resident clusters among them).
HOST_ENTRIES = {"tpuslam_pf_step_ticket", "tpuslam_resample_arrivals",
                "tpuslam_thomas_clusters"} | {
    f"tpuslam_occupancy_{src}" for src in _build.OCCUPANCY_SOURCES} | set(
    _build.DIV_FALLBACK_ENTRIES.values())
_SCALARS = {"long long": ctypes.c_longlong, "uint32_t": ctypes.c_uint32,
            "int": ctypes.c_int, "unsigned int": ctypes.c_uint,
            "float": ctypes.c_float, "char*": ctypes.c_char_p}


def _declared():
    class Functions:
        def __getattr__(self, name):
            fn = type("Function", (), {})()
            setattr(self, name, fn)
            return fn

    return _build._declare(Functions())


def test_every_entry_is_declared():
    assert set(vars(_declared())) == set(ENTRIES)
    assert HOST_ENTRIES <= set(ENTRIES)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_rollout_entry_mirrors_declared_argtypes(entry):
    """Each C entry's parameters, in order, are the ``argtypes`` that
    ``_build`` declares for it.  A launch ends with the stream, which the
    helper passes last, and takes every pointer as ``c_void_p`` (the
    wrappers pass ``data_ptr()`` ints and ``None``); only the entries that
    copy into host memory take pointers to their types.  A scalar is its
    type.  An entry that takes a parameter template takes the seed's two
    words after it, low word first."""
    params = ENTRIES[entry]
    names = [name for _, name in params]
    fn = getattr(_declared(), entry)
    assert fn.restype is ctypes.c_int
    assert len(fn.argtypes) == len(params)
    assert (names[-1] == "stream") == (entry not in HOST_ENTRIES)
    for (ctype, name), declared in zip(params, fn.argtypes):
        base = ctype.replace("const ", "")
        if not base.endswith("*"):
            assert declared is _SCALARS[base], name
        elif entry in HOST_ENTRIES:
            assert declared is ctypes.POINTER(_SCALARS[base[:-1]]), name
        else:
            assert declared is ctypes.c_void_p, name
    if "params" in names:
        i = names.index("seed_lo")
        assert names.index("params") < i and names[i + 1] == "seed_hi"
    if entry == "tpuslam_ekf_rollout":
        assert names == ["tbl", "normals", "state", "cov", "err", "params",
                         "batch", "seed_lo", "seed_hi", "mode", "with_nees",
                         "lanes", "stream"]
