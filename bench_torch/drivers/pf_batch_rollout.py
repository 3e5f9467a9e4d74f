"""Driver of batched PF localisation: one call is one ``pf_batch_rollout``
of ``filters`` independent filters of ``particles`` each for ``steps``
(one K4 launch a step), on the call's observation noise, then the sweep's
RMSE over every filter and step reduced on the device and read back.

Traffic keys: ``filters``, ``particles``, ``steps``.  The call's scaled
observation noise ``(T, B, L, 2)`` comes from a generator on the device
keyed by the call; the comb offsets and the particle noise are the
kernel's own Philox draws.  The check runs :mod:`reference.pf`'s batched
law on ``sample`` filters of each kept call, drawn from the seed, and
compares their estimate trajectories and final weighted clouds.
"""

from __future__ import annotations

import torch

from benchlib.pfcheck import cloud_mean, gaps, pf_fields
from benchlib.keep import KeptCalls
from benchlib.stats import call_key, rng
from reference import pf as ref

from tpuslam_torch.filters.pf import PfConfig
from tpuslam_torch.ops import pf_batch_cuda


class Driver(KeptCalls):
    def __init__(self, scene: dict, traffic: dict, check: dict, seed: int,
                 device: torch.device):
        super().__init__(seed, check)
        self.scene, self.check, self.seed = scene, check, seed
        self.device = device
        self.b, self.n = traffic["filters"], traffic["particles"]
        self.steps = traffic["steps"]
        self.cfg = PfConfig(num_particles=self.n, **pf_fields(scene))
        self.work_per_call = self.b * self.n * self.steps
        self.r_std = torch.tensor(scene["r_std"], dtype=torch.float32,
                                  device=device)

    def _draw(self, key: int) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed(key)
        shape = (self.steps, self.b, len(self.cfg.landmarks), 2)
        return torch.randn(shape, generator=g, dtype=torch.float32,
                           device=self.device) * self.r_std

    def inputs(self, i: int) -> torch.Tensor:
        return self._draw(call_key(self.seed, i))

    def warmup_inputs(self) -> torch.Tensor:
        return self._draw(call_key(self.seed, 0, tag=3))

    def entry(self, noise: torch.Tensor):
        return pf_batch_cuda.pf_batch_rollout(
            self.cfg, None, self.b, self.steps, device=self.device,
            obs_noise=noise)

    def readback(self, out) -> list[float]:
        _, outs = out
        d = outs.x_est[..., :2] - outs.x_true[:, None, :2]
        return [float(torch.sqrt(d.square().sum(dim=-1).mean()).item())]

    def counts(self, out) -> dict:
        """The firing filters summed over the steps (K4's resample work)."""
        return {"fired": int(out[1].resampled.sum().item())}

    def _sample(self, i: int) -> torch.Tensor:
        m = min(self.check["sample"], self.b)
        idx = sorted(rng(self.seed, i, 2).sample(range(self.b), m))
        return torch.tensor(idx, dtype=torch.int64, device=self.device)

    def answer(self, item) -> dict:
        i, _, (final, outs) = item
        f = self._sample(i)
        particles = final.particles[:, f].permute(1, 2, 0)  # (F, n, 3)
        w = torch.softmax(final.log_w[f].to(torch.float64), dim=-1)
        return {"x_est": outs.x_est[:, f], "mean": cloud_mean(particles, w)}

    def reference(self, item, dtype: torch.dtype) -> dict:
        i, noise, _ = item
        f = self._sample(i)
        out = ref.filters(self.scene, "batched", self.n, f, self.steps,
                          noise[:, f], None, dtype)
        w = torch.softmax(out["log_w"].to(torch.float64), dim=-1)
        return {"x_est": out["x_est"], "x_true": out["x_true"],
                "mean": cloud_mean(out["particles"], w)}

    def compare(self, got: dict, want: dict) -> dict:
        return gaps(got, want)
