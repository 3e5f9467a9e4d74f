"""The batched EKF slice of the port as a whole.

* The port never imports JAX or the JAX package (checked in a fresh
  interpreter and in the sources).
* Models, filter and metrics together give the JAX package's metrics on
  the same noise (float32, atol 1e-5 after 50 steps).
* The entry point keeps its contract on the CPU; the fused path with
  Philox noise lands in the reference's bands.
* Timing refuses to run without a card.
"""

import ast
import math
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.filters as jf
import tpuslam.metrics as jm
import tpuslam_torch
import tpuslam_torch.filters as tf
import tpuslam_torch.metrics as tm
from tpuslam_torch.entry import entry
from tpuslam_torch.ops import ekf_fused_rollout
from tpuslam_torch.utils import steps_per_second, timed

PKG_DIR = pathlib.Path(tpuslam_torch.__file__).parent


def test_import_keeps_jax_out():
    code = (
        "import sys\n"
        "import tpuslam_torch, tpuslam_torch.entry, tpuslam_torch.convert\n"
        "import tpuslam_torch.utils, tpuslam_torch.ops.ekf_cuda\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpuslam')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=PKG_DIR.parent)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_neither_jax_nor_tpuslam():
    for path in PKG_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "tpuslam"), (path, name)


def test_slice_metrics_match_jax(rng):
    """Observation, filter and metrics end to end on the same noise."""
    b, n = 16, 50
    cfg, jcfg = tf.EkfConfig(), jf.EkfConfig()
    obs = (rng.normal(size=(n, b, 2)) * cfg.r_act_std).astype(np.float32)
    dr = (rng.normal(size=(n, b, 3)) * cfg.q_act_std).astype(np.float32)

    state = tf.ekf_init(cfg, (b,))
    outs = []
    for i in range(n):
        state, out = tf.ekf_step_with_noise(
            cfg, state, torch.from_numpy(obs[i]), torch.from_numpy(dr[i]))
        outs.append(out)
    outs = tf.EkfOut(*(torch.stack(f, dim=1) for f in zip(*outs)))
    got = tm.summarize_rollouts(outs.x_pre, outs.x_true, outs.cov)

    def body(s, noise):
        return jf.ekf_step_with_noise(jcfg, s, noise[0], noise[1])

    _, jouts = jax.jit(lambda o, d: jax.lax.scan(
        body, jf.ekf_init(jcfg, (b,)), (o, d)))(obs, dr)
    jouts = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), jouts)
    want = jm.summarize_rollouts(jouts.x_pre, jouts.x_true, jouts.cov)

    np.testing.assert_allclose(outs.x_pre.numpy(), np.asarray(jouts.x_pre),
                               atol=1e-5)
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, err_msg=key)
    assert not bool(got["diverged"].any())


def test_entry_contract_on_cpu():
    fn, args = entry(device="cpu")
    out = fn(*args)
    assert out.shape == () and out.device.type == "cpu"
    assert math.isfinite(float(out)) and 0.0 < float(out) < 2.0


def test_fused_philox_noise_in_bands():
    """The fused path with its own Philox noise: per-rollout posterior
    RMSE and NEES in the bands the chip check uses (0.25-0.50 m,
    0.7-2.5)."""
    n = 400
    _, err, nees = ekf_fused_rollout(tf.EkfConfig(), 12345, 1024, n,
                                     with_nees=True, device="cpu")
    rmse = float(torch.sqrt(err / n).mean())
    mean_nees = float((nees / n).mean())
    assert 0.25 < rmse < 0.50, rmse
    assert 0.7 < mean_nees < 2.5, mean_nees


def test_timing_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; timing is measured on the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        timed(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        steps_per_second(lambda: None, work_items=1)
