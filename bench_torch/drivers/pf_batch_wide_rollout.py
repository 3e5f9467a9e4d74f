"""Driver of the wide particle filter: one call is one
``pf_batch_wide_rollout`` of ``filters`` independent filters of
``particles`` each for ``steps`` (a step: the ESS gate, K5a, the
segmented expand of ``pass2``, K5b; the gate of the first step in
``(B,)`` torch ops, of each later one written by the K5b before it), on
the call's comb offsets and observation noise, then the sweep's RMSE over
every filter and step reduced on the device and read back.

Traffic keys: ``filters``, ``particles``, ``steps``, ``pass2``.  The
call's scaled observation noise ``(T, B, L, 2)`` and comb offsets
``(T, B)`` come from a generator on the device keyed by the call, outside
the call's time; the particle noise is K5b's own Philox draw.  The check
runs :mod:`reference.pf_wide` on ``sample`` filters of each kept call,
drawn from the seed, and compares their estimate trajectories and final
weighted clouds (:func:`benchlib.pfcheck.gaps`), their estimates before
either side's first resample, their normalizers on the steps where both
resampled, and how often each side's gate fired (:meth:`Driver.compare`).
"""

from __future__ import annotations

import math
import sys

import torch

from benchlib.keep import KeptCalls
from benchlib.pfcheck import cloud_mean, gaps, pf_fields
from benchlib.stats import call_key, rng
from reference import pf_wide as ref

from tpuslam_torch.filters.pf import PfConfig
from tpuslam_torch.ops import _build, pf_batch_cuda

#: The launch forms of a wide step, either pass B's.
WIDE_FORMS = ("wide_boundary", "resample_expand_seg", "compact_seg",
              "expand_compressed_seg", "wide_stats")


class Driver(KeptCalls):
    def __init__(self, scene: dict, traffic: dict, check: dict, seed: int,
                 device: torch.device):
        super().__init__(seed, check)
        self.scene, self.check, self.seed = scene, check, seed
        self.device = device
        self.b, self.n = traffic["filters"], traffic["particles"]
        self.steps, self.pass2 = traffic["steps"], traffic["pass2"]
        self.cfg = PfConfig(num_particles=self.n, **pf_fields(scene))
        self.work_per_call = self.b * self.n * self.steps
        self.r_std = torch.tensor(scene["r_std"], dtype=torch.float32,
                                  device=device)
        self.launches_before = None

    def _draw(self, key: int):
        g = torch.Generator(device=self.device)
        g.manual_seed(key)
        f32 = dict(dtype=torch.float32, device=self.device)
        noise = torch.randn((self.steps, self.b, len(self.cfg.landmarks), 2),
                            generator=g, **f32) * self.r_std
        offs = torch.rand((self.steps, self.b), generator=g, **f32)
        return noise, offs

    def inputs(self, i: int):
        # The program's launch counts before the call, for counts().
        launches = getattr(_build, "launches", None)
        self.launches_before = (None if launches is None
                                else {f: launches[f] for f in WIDE_FORMS})
        return self._draw(call_key(self.seed, i))

    def warmup_inputs(self):
        return self._draw(call_key(self.seed, 0, tag=3))

    def entry(self, inp):
        noise, offs = inp
        return pf_batch_cuda.pf_batch_wide_rollout(
            self.cfg, None, self.b, self.steps, device=self.device,
            obs_noise=noise, offs=offs, pass2=self.pass2)

    def readback(self, out) -> list[float]:
        _, outs = out
        d = outs.x_est[..., :2] - outs.x_true[:, None, :2]
        return [float(torch.sqrt(d.square().sum(dim=-1).mean()).item())]

    def counts(self, out) -> dict:
        """The call's firing filter-steps (``fired``) and its launches of
        each wide form (``launches``, None where the program does not
        count launches by form); printed to standard error."""
        got = {"fired": int(out[1].resampled.sum().item()), "launches": None}
        launches = getattr(_build, "launches", None)
        if launches is not None and self.launches_before is not None:
            got["launches"] = {f: launches[f] - self.launches_before[f]
                               for f in WIDE_FORMS}
        print(f"traced call: {got['fired']} firing filter-steps of "
              f"{self.b * self.steps}; launches {got['launches']}",
              file=sys.stderr)
        return got

    def _sample(self, i: int) -> torch.Tensor:
        m = min(self.check["sample"], self.b)
        idx = sorted(rng(self.seed, i, 2).sample(range(self.b), m))
        return torch.tensor(idx, dtype=torch.int64, device=self.device)

    def answer(self, item) -> dict:
        i, _, (final, outs) = item
        f = self._sample(i)
        particles = final.particles[:, f].permute(1, 2, 0)  # (F, n, 3)
        w = torch.softmax(final.log_w[f].to(torch.float64), dim=-1)
        return {"x_est": outs.x_est[:, f], "mean": cloud_mean(particles, w),
                "fired": outs.resampled[:, f], "lse": outs.lse[:, f]}

    def reference(self, item, dtype: torch.dtype) -> dict:
        i, (noise, offs), _ = item
        f = self._sample(i)
        out = ref.filters(self.scene, self.n, self.b, f, self.steps,
                          noise[:, f], offs[:, f], dtype)
        w = torch.softmax(out["log_w"].to(torch.float64), dim=-1)
        return {"x_est": out["x_est"], "x_true": out["x_true"],
                "mean": cloud_mean(out["particles"], w),
                "fired": out["fired"], "lse": out["lse"]}

    def compare(self, got: dict, want: dict) -> dict:
        """:func:`~benchlib.pfcheck.gaps`, and three numbers of the wide
        law that the estimates alone do not pin:

        * ``pre_resample_gap_m``: the median over the filters of each
          one's largest estimate gap on the steps before either side
          first resamples it.  Until then nothing but rounding parts the
          two (float32: about 1e-6 m), so a fault in the predict, the
          weight or the Philox key (the seed's stride a step) moves every
          filter by the cloud's spread.  The median, because two
          particles' log weights a rounding apart make one filter's MAP
          a coin flip now and then.
        * ``fired_lse_gap``: the mean gap of the normalizers over the
          steps on which both resampled a filter.  There both restarted
          their log weights at 0, so each normalizer is that step's
          log-likelihoods alone; two draws of one posterior part by about
          0.07, a restart at ``-log n`` by ``log n``.
        * ``fired_share_gap``: the program's firing filter-steps less the
          reference's, in absolute value, over the sampled filter-steps.
          Both gates fire on the same law, so the two shares part only as
          two draws of one posterior do; a gate with another threshold,
          or one that never fires, parts them by a share of the steps.

        The first two read 0 where they have no step to compare.
        """
        out = gaps(got, want)
        fired, ref_fired = got["fired"].cpu(), want["fired"].cpu()
        either = fired | ref_fired
        first = torch.where(either.any(0), either.int().argmax(0),
                            either.shape[0])
        before = torch.arange(either.shape[0])[:, None] < first
        d = torch.linalg.vector_norm(
            (got["x_est"] - want["x_est"])[..., :2].to(torch.float64),
            dim=-1).cpu()
        worst = torch.where(before, d, 0.0).max(dim=0).values
        out["pre_resample_gap_m"] = (math.inf if bool(d.isnan().any())
                                     else float(worst.median()))
        dl = (got["lse"] - want["lse"]).to(torch.float64).abs().cpu()
        both = fired & ref_fired
        gap = float(dl[both].mean()) if bool(both.any()) else 0.0
        out["fired_lse_gap"] = math.inf if math.isnan(gap) else gap
        out["fired_share_gap"] = abs(
            int(fired.sum()) - int(ref_fired.sum())) / fired.numel()
        return out

