"""The fused EKF rollout's plain path, and its noise math, against the JAX
package on the CPU.

The CUDA kernel itself runs only on a card (``chip_smoke.py`` holds it to
this plain path there); here the plain path is held to the Pallas kernel
run in interpret mode, as ``tests/test_ops.py`` runs it, and to a chain
of the JAX package's ``ekf_step_with_noise``.  Tolerances are stated per
test.
"""

import ctypes
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.filters as jf
import tpuslam.ops.fastmath as jfm
from tpuslam.ops import ekf_fused_rollout as jax_rollout
from tpuslam.ops import ekf_fused_sweeps as jax_sweeps
import tpuslam_torch.ops.fastmath as tfm
from tpuslam_torch.filters import EkfConfig
from tpuslam_torch.ops import _build, ekf_cuda
from tpuslam_torch.ops import (ekf_fused_rollout, ekf_fused_rollout_plain,
                               ekf_fused_sweeps)

CFG = EkfConfig()
JCFG = jf.EkfConfig()


def _assert_final_close(got, want, atol):
    for name in ("x_true", "x_dr", "x_hat", "cov"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=atol, err_msg=name)


def _yaw_gap(a, b):
    return np.abs(np.remainder(a - b + np.pi, 2 * np.pi) - np.pi)


# --- fastmath -------------------------------------------------------------

def test_sincos_turns_matches_jax():
    u = np.linspace(0.0, 1.0, 20001, endpoint=False, dtype=np.float32)
    got = tfm.sincos_turns(torch.from_numpy(u))
    want = jfm.sincos_turns(jnp.asarray(u))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7)


def test_sincos_rad_matches_jax_and_builtin(rng):
    theta = rng.uniform(-20.0, 20.0, 20001).astype(np.float32)
    got = tfm.sincos_rad(torch.from_numpy(theta))
    want = jfm.sincos_rad(jnp.asarray(theta))
    for g, w, exact in zip(got, want, (np.cos(theta), np.sin(theta))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7)
        # The polynomial is within 2e-7 of the true value, plus the fold's
        # rounding of theta / (2 pi) at |theta| <= 20 (~1e-6).
        np.testing.assert_allclose(g.numpy(), exact, atol=2e-6)


def test_normals_from_bits_matches_jax_formula(rng):
    b1 = rng.integers(0, 2 ** 32, 50000, dtype=np.uint32)
    b2 = rng.integers(0, 2 ** 32, 50000, dtype=np.uint32)
    got = tfm.normals_from_bits(torch.from_numpy(b1.astype(np.int64)),
                                torch.from_numpy(b2.view(np.int32)))
    # The JAX package's map from bits to a Box-Muller pair
    # (tpuslam/ops/fastmath.py::normals).
    u1 = (jax.lax.shift_right_logical(jnp.asarray(b1), jnp.uint32(8))
          .astype(jnp.float32) + 0.5) * (1.0 / (1 << 24))
    u2 = jax.lax.shift_right_logical(jnp.asarray(b2), jnp.uint32(8)) \
        .astype(jnp.float32) * (1.0 / (1 << 24))
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    c, s = jfm.sincos_turns(u2)
    # log/sqrt of two libraries: a few ulp of r (<= 5.6) times the trig.
    for g, w in zip(got, (r * c, r * s)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6)


@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expected):
    """Philox4x32-10 against the known-answer vectors of its authors'
    Random123 library, as Python ints and as int64 tensors."""
    assert tfm.philox4x32(*counter, *key) == expected
    words = tfm.philox4x32(*(torch.tensor([c]) for c in counter), *key)
    assert tuple(int(w) for w in words) == expected


def test_philox_normals_are_standard():
    idx = torch.arange(40000, dtype=torch.int64)
    a = tfm.philox4x32(idx, 3, 0, 0, 12345, 0)
    n = torch.cat(tfm.normals_from_bits(a[0], a[1])
                  + tfm.normals_from_bits(a[2], a[3])).double()
    # 160000 draws: the mean's standard error is 0.0025.
    assert abs(float(n.mean())) < 0.0125
    assert abs(float(n.std()) - 1.0) < 0.01
    assert abs(float((n ** 4).mean()) - 3.0) < 0.1


# --- the fused rollout's plain path ----------------------------------------

def test_plain_matches_pallas_interpret_noise_free():
    """Noise off: the plain path equals the Pallas kernel (interpret mode)
    to 1e-6 after 25 steps."""
    got, err = ekf_fused_rollout(CFG, 0, batch=8, n_steps=25,
                                 noise_on=False, device="cpu")
    want, jerr = jax_rollout(JCFG, 0, batch=8, n_steps=25, tile_b=8,
                             noise_on=False, interpret=True)
    _assert_final_close(got, want, atol=1e-6)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-6)


def test_plain_matches_pallas_interpret_with_nees():
    got, err, nees = ekf_fused_rollout(CFG, 0, batch=8, n_steps=10,
                                       noise_on=False, with_nees=True,
                                       device="cpu")
    want, jerr, jnees = jax_rollout(JCFG, 0, batch=8, n_steps=10, tile_b=8,
                                    noise_on=False, interpret=True,
                                    with_nees=True)
    assert nees.shape == (8,)
    _assert_final_close(got, want, atol=1e-6)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-6)
    np.testing.assert_allclose(nees.numpy(), np.asarray(jnees), atol=1e-6)


def test_sweeps_match_pallas_interpret():
    final, rmse = ekf_fused_sweeps(CFG, 0, n_sweeps=3, batch=8, n_steps=5,
                                   noise_on=False, device="cpu")
    jfinal, jrmse = jax_sweeps(JCFG, 0, n_sweeps=3, batch=8, n_steps=5,
                               tile_b=8, noise_on=False, interpret=True)
    assert rmse.shape == (3,) and final.x_hat.shape == (24, 3)
    _assert_final_close(final, jfinal, atol=1e-6)
    np.testing.assert_allclose(rmse.numpy(), np.asarray(jrmse), atol=1e-6)


def test_injected_normals_match_jax_step_chain(rng):
    """Noise on, the same normals into the plain path and into a chain of
    the JAX package's ekf_step_with_noise; atol 1e-4 after 64 steps, from
    the polynomial sincos (about 2e-7 a call) against builtin trig.  The
    two place the x_dr yaw wrap differently, so that yaw is compared
    modulo 2 pi."""
    b, n = 8, 64
    normals = rng.normal(size=(n, 5, b)).astype(np.float32)
    final, err, nees = ekf_fused_rollout(
        CFG, 0, b, n, normals=torch.from_numpy(normals), with_nees=True,
        device="cpu")
    obs = np.swapaxes(normals[:, :2], 1, 2) * np.float32(CFG.r_act_std)
    dr = np.swapaxes(normals[:, 2:], 1, 2) * np.asarray(CFG.q_act_std,
                                                        np.float32)

    def body(s, noise):
        s, _ = jf.ekf_step_with_noise(JCFG, s, noise[0], noise[1])
        return s, s

    jfinal, traj = jax.jit(lambda o, d: jax.lax.scan(
        body, jf.ekf_init(JCFG, (b,)), (o, d)))(obs, dr)
    for name in ("x_true", "x_hat", "cov"):
        np.testing.assert_allclose(getattr(final, name).numpy(),
                                   np.asarray(getattr(jfinal, name)),
                                   atol=1e-4, err_msg=name)
    x_dr, jx_dr = final.x_dr.numpy(), np.asarray(jfinal.x_dr)
    np.testing.assert_allclose(x_dr[:, :2], jx_dr[:, :2], atol=1e-4)
    assert _yaw_gap(x_dr[:, 2], jx_dr[:, 2]).max() < 1e-4
    # The accumulators: posterior squared error and 2x2-block NEES.
    d = np.asarray(traj.x_hat)[..., :2] - np.asarray(traj.x_true)[..., :2]
    p = np.asarray(traj.cov, np.float64)[..., :2, :2]
    sol = np.linalg.solve(p, d[..., None].astype(np.float64))[..., 0]
    np.testing.assert_allclose(err.numpy(), (d ** 2).sum(-1).sum(0),
                               rtol=1e-4)
    np.testing.assert_allclose(nees.numpy(), (d * sol).sum(-1).sum(0),
                               rtol=1e-3)


def test_philox_stream_independent_of_batch_size():
    """Rollout i draws the same noise in any batch: the counter is the
    rollout index, so a ragged batch changes nothing."""
    small, e_small = ekf_fused_rollout(CFG, 77, 5, 12, device="cpu")
    large, e_large = ekf_fused_rollout(CFG, 77, 9, 12, device="cpu")
    for a, b in zip(small, large):
        assert torch.equal(a, b[:5])
    assert torch.equal(e_small, e_large[:5])
    other, _ = ekf_fused_rollout(CFG, 78, 5, 12, device="cpu")
    assert not torch.equal(other.x_hat, small.x_hat)


def test_cuda_request_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the kernel path is chip_smoke's")
    with pytest.raises(RuntimeError, match="CUDA"):
        ekf_fused_rollout(CFG, 0, 8, 4, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ekf_fused_sweeps(CFG, 0, 2, 8, 4, device="cuda")


@pytest.mark.parametrize("fn", [ekf_fused_rollout, ekf_fused_rollout_plain,
                                ekf_fused_sweeps])
def test_device_is_required(fn):
    """No default device: leaving it out is an error, not the CPU path."""
    with pytest.raises(TypeError, match="device"):
        fn(CFG, 0, 8, 4, 2) if fn is ekf_fused_sweeps else fn(CFG, 0, 8, 4)


@pytest.mark.parametrize("kwargs,match", [
    ({"batch": 0}, "positive"),
    ({"n_steps": 0}, "positive"),
    ({"normals": torch.zeros(4, 5, 8), "noise_on": False}, "noise_on"),
    ({"normals": torch.zeros(4, 5, 7)}, "shape"),
    ({"normals": torch.zeros(4, 5, 8, dtype=torch.float64)}, "dtype"),
])
def test_rejects_bad_arguments(kwargs, match):
    args = dict(batch=8, n_steps=4, device="cpu")
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        ekf_fused_rollout(CFG, 0, **args)
    with pytest.raises(ValueError, match=match):
        ekf_fused_rollout_plain(CFG, 0, **args)


# --- the kernel's interface, checked without a card --------------------------

def test_params_struct_mirrors_cuda_source():
    src = (_build.CSRC_DIR / "ekf_rollout.cu").read_text()
    body = re.search(r"struct EkfParams \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"(\w+)\s*[,;]", body)
    assert names == [f[0] for f in ekf_cuda._EkfParams._fields_]
    assert ctypes.sizeof(ekf_cuda._EkfParams) == 8 + 4 + 4 + 4 + 18 * 4 + 4


def test_build_flags_and_sources():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags
    for path in sorted(_build.CSRC_DIR.glob("*.cu*")):
        code = re.sub(r"//[^\n]*", "", path.read_text())
        assert "M_PI" not in code and "double" not in code, path.name
        # Every floating literal carries the f suffix (no double literal
        # promotes an expression).
        literals = re.findall(r"(?<![\w.])(\d+\.\d*(?:e[-+]?\d+)?|0x[\da-f.]+"
                              r"p[-+]?\d+)(\w?)", code, re.I)
        assert all(suffix == "f" for _, suffix in literals), path.name
    assert _build.BUILD_DIR.name == "build"
    assert math.isclose(ekf_cuda._constants(CFG)["vdt"], CFG.vel * CFG.dt)


def test_build_refuses_outside_a_source_checkout(tmp_path, monkeypatch):
    """An installed copy has no repository root: building there raises
    instead of writing into the interpreter's tree."""
    _build._check_checkout()
    monkeypatch.setattr(_build, "_PKG_DIR", tmp_path / "tpuslam_torch")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="source checkout"):
        _build.load_library()
    assert not (tmp_path / "build").exists()
