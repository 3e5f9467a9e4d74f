"""The kernels' least times reproduce the bounds of the port's own
measurements at their shapes: K1 60.899 ms at 8,388,608 x 1600 (float32
operations), K2b 0.0200 ms at 2,097,152 and K4 0.0784 ms at 8192 x 1000
(bytes)."""

import pytest

from benchlib import device, spec

PEAKS = device.PEAKS


def _least(kernel, traffic, counts=None):
    return spec.module("roofline", kernel).least_s(traffic, counts or {},
                                                   PEAKS)


def test_k1():
    t, by = _least("k1", {"rollouts": 8388608, "steps": 1600,
                          "noise": True, "nees": False})
    assert 1e3 * t == pytest.approx(60.899, abs=5e-4) and by == "f32 ops"
    t_nees, _ = _least("k1", {"rollouts": 8388608, "steps": 1600,
                              "noise": True, "nees": True})
    assert t_nees == pytest.approx(t * 316 / 304)


def test_k2b():
    t, by = _least("k2b", {"particles": 2097152})
    assert 1e3 * t == pytest.approx(0.0200, abs=5e-5) and by == "bytes"


def test_k4():
    t, by = _least("k4", {"filters": 8192, "particles": 1000, "steps": 400},
                   {"fired": 400 * 1601})
    assert 1e3 * t == pytest.approx(0.0784, abs=5e-5) and by == "bytes"


def test_metrics_name_their_kernels():
    for kernel in ("k1", "k2b", "k4"):
        reader = spec.module("layer_metrics", f"{kernel}_roofline")
        assert f'roofline_share("{kernel}")' in open(reader.__file__).read()
