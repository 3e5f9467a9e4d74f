"""Driver of single-filter PF localisation: one call is one
``pf_fused_rollout`` of ``particles x steps`` (log weights, the merge
resample on the device's gate, the MAP estimate) on the call's comb
offsets and observation noise, then the rollout's RMSE against the truth
reduced on the device and read back.

Traffic keys: ``particles``, ``steps``.  The call's offsets ``(T,)`` and
scaled observation noise ``(T, L, 2)`` come from a generator on the
device keyed by the call.  The check runs :mod:`reference.pf`'s single law
on the same inputs and compares the estimate trajectory and the final
weighted particle cloud.
"""

from __future__ import annotations

import torch

from benchlib.pfcheck import cloud_mean, gaps, pf_fields
from benchlib.keep import KeptCalls
from benchlib.stats import call_key
from reference import pf as ref

from tpuslam_torch.filters.pf import PfConfig
from tpuslam_torch.ops import pf_cuda


class Driver(KeptCalls):
    def __init__(self, scene: dict, traffic: dict, check: dict, seed: int,
                 device: torch.device):
        super().__init__(seed, check)
        self.scene, self.check, self.seed = scene, check, seed
        self.device = device
        self.n, self.steps = traffic["particles"], traffic["steps"]
        self.cfg = PfConfig(num_particles=self.n, **pf_fields(scene))
        self.work_per_call = self.n * self.steps
        self.r_std = torch.tensor(scene["r_std"], dtype=torch.float32,
                                  device=device)

    def _draw(self, key: int):
        g = torch.Generator(device=self.device)
        g.manual_seed(key)
        f32 = dict(dtype=torch.float32, device=self.device)
        offs = torch.rand((self.steps,), generator=g, **f32)
        noise = torch.randn((self.steps, len(self.cfg.landmarks), 2),
                            generator=g, **f32) * self.r_std
        return offs, noise

    def inputs(self, i: int):
        return self._draw(call_key(self.seed, i))

    def warmup_inputs(self):
        return self._draw(call_key(self.seed, 0, tag=3))

    def entry(self, inp):
        offs, noise = inp
        return pf_cuda.pf_fused_rollout(self.cfg, None, self.steps,
                                        device=self.device, offs=offs,
                                        obs_noise=noise)

    def readback(self, out) -> list[float]:
        _, (x_true, x_est) = out
        d = x_est[:, :2] - x_true[:, :2]
        return [float(torch.sqrt(d.square().sum(dim=-1).mean()).item())]

    def counts(self, out) -> dict:
        return {}

    def answer(self, item) -> dict:
        _, _, (final, (_, x_est)) = item
        return {"x_est": x_est[:, None],
                "mean": cloud_mean(final.particles, final.weights)[None]}

    def reference(self, item, dtype: torch.dtype) -> dict:
        _, (offs, noise), _ = item
        filt = torch.zeros(1, dtype=torch.int64, device=self.device)
        out = ref.filters(self.scene, "single", self.n, filt, self.steps,
                          noise[:, None], offs, dtype)
        w = torch.softmax(out["log_w"].to(torch.float64), dim=-1)
        return {"x_est": out["x_est"], "x_true": out["x_true"],
                "mean": cloud_mean(out["particles"], w)}

    def compare(self, got: dict, want: dict) -> dict:
        return gaps(got, want)
