"""The check decides ``correct``: the control (the reference in bfloat16 in
the program's place) fails it, and so does a run whose timed path is
broken underneath: a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced.  Each cell at a
small size on the CPU, the card's look skipped, under the cell's own
limits (the sound run passes them: ``test_run.py``).  The altered answer
is an EKF rollout's final pose moved by 0.05 m, or one step's PF
estimates written with x and y swapped."""

import dataclasses

import pytest
import torch

from benchlib import check, loop
from tiny import TINY, tiny_cell
from tpuslam_torch.ops import ekf_cuda, pf_batch_cuda, pf_cuda

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails(name):
    cell = tiny_cell(name)
    driver = cell.driver().Driver(cell.config["scene"], cell.traffic,
                                  cell.check, 5, CPU)
    for i in range(cell.check["keep_within"]):
        _, inp, out, _ = loop.one_call(driver, i)
        driver.keep(i, inp, out)
    items = driver.kept_items()
    sound, _ = check.judge(check.numbers(driver, items),
                           cell.check["limits"])
    control, _ = check.judge(
        check.numbers(driver, items, control=torch.bfloat16),
        cell.check["limits"])
    assert sound and not control


def _ekf_faults(monkeypatch, fault):
    real = ekf_cuda.ekf_fused_rollout

    def broken(cfg, seed, batch, n_steps, *args, **kw):
        if fault == "unchanged":
            return real(cfg, seed, batch, 1, *args, **kw)
        if fault == "half":
            final, *errs = real(cfg, seed, batch // 2, n_steps, *args, **kw)

            def pad(t):
                return torch.cat([t, torch.zeros_like(t)])
            return (type(final)(*map(pad, final)), *map(pad, errs))
        final, *errs = real(cfg, seed, batch, n_steps, *args, **kw)
        final.x_hat[batch // 3, 0] += 0.05
        return (final, *errs)
    monkeypatch.setattr(ekf_cuda, "ekf_fused_rollout", broken)


def _swap_xy(est: torch.Tensor) -> None:
    """One step's estimates written with x and y swapped (every filter)."""
    est[..., :2] = est[..., :2].flip(-1).clone()


def _pf_faults(monkeypatch, fault):
    real_step, real_rollout = pf_cuda.pf_step_rows, pf_cuda.pf_fused_rollout

    def broken_step(cfg, seed, flag, p_rows, lw, *args, **kw):
        p_out, lw_out, stats = real_step(cfg, seed, flag, p_rows, lw, *args,
                                         **kw)
        if fault == "unchanged":
            return p_rows, lw_out, stats
        half = p_rows.shape[-1] // 2
        p_out[:, half:], lw_out[half:] = p_rows[:, half:], lw[half:]
        return p_out, lw_out, stats

    def broken_rollout(*args, **kw):
        final, (x_true, x_est) = real_rollout(*args, **kw)
        _swap_xy(x_est[x_est.shape[0] // 2])
        return final, (x_true, x_est)
    if fault == "altered":
        monkeypatch.setattr(pf_cuda, "pf_fused_rollout", broken_rollout)
    else:
        monkeypatch.setattr(pf_cuda, "pf_step_rows", broken_step)


def _batch_faults(monkeypatch, fault):
    real_step = pf_batch_cuda.pf_batch_step_rows
    real_rollout = pf_batch_cuda.pf_batch_rollout

    def broken_step(cfg, seed, particles, log_w, lse, lse2, *args, out,
                    **kw):
        real_step(cfg, seed, particles, log_w, lse, lse2, *args, out=out,
                  **kw)
        keep = slice(None) if fault == "unchanged" else slice(
            log_w.shape[0] // 2, None)
        out.particles[:, keep] = particles[:, keep]
        out.log_w[keep], out.lse[keep] = log_w[keep], lse[keep]
        out.lse2[keep] = lse2[keep]
        return out

    def broken_rollout(*args, **kw):
        final, outs = real_rollout(*args, **kw)
        _swap_xy(outs.x_est[outs.x_est.shape[0] // 2])
        return final, outs
    if fault == "altered":
        monkeypatch.setattr(pf_batch_cuda, "pf_batch_rollout", broken_rollout)
    else:
        monkeypatch.setattr(pf_batch_cuda, "pf_batch_step_rows", broken_step)


PLANT = {"ekf_mc.flagship": _ekf_faults, "ekf_mc.sweep_8192": _ekf_faults,
         "pf_loc.single_2m": _pf_faults,
         "pf_loc.batched_8192x1000": _batch_faults}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", sorted(TINY))
def test_broken_path_is_not_correct(name, fault, run_module, monkeypatch):
    PLANT[name](monkeypatch, fault)
    result = run_module.measure(tiny_cell(name), 11, 0.2, False, CPU, None)
    assert result["correct"] is False


def test_dataclass_fields_are_the_scene():
    # The program's configs are built from the scene's keys alone.
    from tpuslam_torch.filters.ekf import EkfConfig
    scene = tiny_cell("ekf_mc.flagship").config["scene"]
    assert set(scene) == {f.name for f in dataclasses.fields(EkfConfig)}
