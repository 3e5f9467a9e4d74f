"""Driver of the EKF Monte-Carlo sweep: one call is one
``ekf_fused_rollout`` of ``rollouts x steps`` with the call's Philox key,
then the sweep's RMSE (and mean NEES) reduced on the device and read back.

Traffic keys: ``rollouts``, ``steps``, ``noise`` (bool), ``nees`` (bool).
The check compares the final poses, covariances, summed squared errors and
(with ``nees``) summed NEES of ``sample`` rollouts of each kept call,
drawn from the seed, with :mod:`reference.ekf`.
"""

from __future__ import annotations

import torch

from benchlib.check import largest
from benchlib.keep import KeptCalls
from benchlib.stats import call_key, rng
from reference import ekf as ref

from tpuslam_torch.filters.ekf import EkfConfig
from tpuslam_torch.ops import ekf_cuda


def program_config(scene: dict) -> EkfConfig:
    return EkfConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in scene.items()})


class Driver(KeptCalls):
    def __init__(self, scene: dict, traffic: dict, check: dict, seed: int,
                 device: torch.device):
        super().__init__(seed, check)
        self.scene, self.check, self.seed = scene, check, seed
        self.device = device
        self.cfg = program_config(scene)
        self.rollouts, self.steps = traffic["rollouts"], traffic["steps"]
        self.noise, self.nees = traffic["noise"], traffic["nees"]
        self.work_per_call = self.rollouts * self.steps

    def inputs(self, i: int) -> int:
        return call_key(self.seed, i)

    def warmup_inputs(self) -> int:
        return call_key(self.seed, 0, tag=3)

    def entry(self, key: int):
        return ekf_cuda.ekf_fused_rollout(
            self.cfg, key, self.rollouts, self.steps, noise_on=self.noise,
            with_nees=self.nees, device=self.device)

    def readback(self, out) -> list[float]:
        parts = [torch.sqrt(out[1].mean() / self.steps)]
        if self.nees:
            parts.append((out[2] / self.steps).mean())
        return torch.stack(parts).tolist()

    def counts(self, out) -> dict:
        return {}

    def _sample(self, i: int) -> torch.Tensor:
        n = min(self.check["sample"], self.rollouts)
        idx = sorted(rng(self.seed, i, 2).sample(range(self.rollouts), n))
        return torch.tensor(idx, dtype=torch.int64, device=self.device)

    def answer(self, item) -> dict:
        i, _, out = item
        idx = self._sample(i)
        final = out[0]
        got = {"x_true": final.x_true[idx], "x_dr": final.x_dr[idx],
               "x_hat": final.x_hat[idx], "cov": final.cov[idx],
               "sq_err": out[1][idx]}
        if self.nees:
            got["nees"] = out[2][idx]
        return got

    def reference(self, item, dtype: torch.dtype) -> dict:
        i, key, _ = item
        want = ref.rollouts(self.scene, key, self._sample(i), self.steps,
                            self.noise, dtype)
        return {k: v.to(torch.float32) for k, v in want.items()}

    def compare(self, got: dict, want: dict) -> dict:
        pose, yaw = [], []
        for name in ("x_true", "x_dr", "x_hat"):
            d = got[name].to(torch.float32) - want[name]
            pose.append(d[:, :2].abs().amax())
            yaw.append(ref.wrap(d[:, 2]).abs().amax())
        cov_scale = want["cov"].abs().amax(dim=(1, 2))
        out = {
            "pose_gap_m": torch.stack(pose).amax(),
            "yaw_gap_rad": torch.stack(yaw).amax(),
            "cov_gap_rel": ((got["cov"] - want["cov"]).abs().amax(dim=(1, 2))
                            / cov_scale).amax(),
            "sq_err_gap_rel": ((got["sq_err"] - want["sq_err"]).abs()
                               / want["sq_err"]).amax()}
        if self.nees:
            out["nees_gap_rel"] = ((got["nees"] - want["nees"]).abs()
                                   / want["nees"].abs()).amax()
        return {k: largest(v) for k, v in out.items()}
