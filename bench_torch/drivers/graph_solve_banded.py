"""Driver of large-scale graph SLAM: one call is one ``graph_solve_banded``
of ``scenes`` scenes in lockstep (the factor-reuse path: the super-block
Thomas chain factored once, a resolve a Gauss-Newton pass), then the mean
position RMSE against truth and the mean GN iterations read back.

Traffic keys: ``scenes``.  The configuration's scene gives the sizes
(``poses``, ``landmarks``, ``window``) and the solver's settings.  At
set-up each scene's map (landmark annulus offsets and angular slots) is
drawn from the seed on the device, and its edge list built once with
``window_pairs_device`` and padded to one length.  A call's inputs,
outside its time, are every scene's fresh odometry drift and scan noise,
each scene from a generator on the device keyed by the call and the
scene, so the check can draw one scene again.  The check runs
:mod:`reference.graph` on ``sample`` scenes of each kept call, drawn from
the seed: it draws each scene again from the same draws with its own
course, scan and odometry (taking the program's visibility only at a
tie), solves it, and compares poses and RMSE against its own true course,
which the readback's RMSE uses too.
"""

from __future__ import annotations

import time
import typing

import torch

from benchlib.check import largest
from benchlib.keep import KeptCalls
from benchlib.stats import call_key, rng
from reference import graph as ref

from tpuslam_torch.core.angles import wrap_angle
from tpuslam_torch.models.scan_sensor import ScanConfig
from tpuslam_torch.slam import large
from tpuslam_torch.slam.graph import GraphConfig, GraphObservations

#: Tags of the keys a run draws besides its calls' (``benchlib.stats``).
MAP_TAG, SCENE_TAG = 4, 16


class Inputs(typing.NamedTuple):
    poses: torch.Tensor  # (S, T1, 3) the odometry, the initial guess
    obs: GraphObservations  # (S, T1, L)
    rel_odom: torch.Tensor  # (S, T1-1, 3)


class Call(typing.NamedTuple):
    result: large.BandedSolveResult
    syncs: int  # the large solve's host reads in the call
    passes: int  # its lockstep GN passes


def _rel(poses: torch.Tensor) -> torch.Tensor:
    rel = poses[..., 1:, :] - poses[..., :-1, :]
    return torch.cat([rel[..., :2], wrap_angle(rel[..., 2:])], dim=-1)


class Driver(KeptCalls):
    def __init__(self, scene: dict, traffic: dict, check: dict, seed: int,
                 device: torch.device):
        super().__init__(seed, check)
        self.scene, self.check, self.seed = scene, check, seed
        self.device = device
        self.n_s = traffic["scenes"]
        self.t1, self.n_lm = scene["poses"], scene["landmarks"]
        self.window = scene["window"]
        self.radius = scene["radius_frac"] * self.t1
        self.tol = scene["delta_tol_per_pose"] * self.t1
        self.cfg = GraphConfig(
            max_times=self.t1, num_landmarks=self.n_lm,
            scan=ScanConfig(**scene["scan"]), anchor=scene["anchor"],
            max_gn_iters=scene["max_gn_iters"],
            exact_jacobians=scene["exact_jacobians"])
        self.work_per_call = self.n_s * self.t1
        self.host_ms: list[float] = []  # each call's, in order
        self.maps = [self._map(s) for s in range(self.n_s)]
        self.truth = ref.course(self.t1, self.radius, device)
        # The visibility, and so the edges, does not depend on the noise.
        noise = self._noise(call_key(seed, 0, MAP_TAG + 1))
        self.edges = self._edges([self._scene(s, noise)[2].valid
                                  for s in range(self.n_s)])

    def _map(self, s: int):
        """Scene s's landmark radius offsets and angular slots."""
        g = torch.Generator(device=self.device)
        g.manual_seed(call_key(self.seed, s, MAP_TAG))
        off = self.scene["lm_offset_m"]
        offsets = (torch.rand(self.n_lm, generator=g, device=self.device)
                   * (2.0 * off) - off)
        return offsets, torch.randperm(self.n_lm, generator=g,
                                       device=self.device)

    def _noise(self, key: int):
        """One scene's ``(scan normals (T1, L, 3), odometry normals (T1,
        3))`` under ``key``."""
        g = torch.Generator(device=self.device)
        g.manual_seed(key)
        scan = torch.randn((self.t1, self.n_lm, 3), generator=g,
                           device=self.device)
        return scan, torch.randn((self.t1, 3), generator=g,
                                 device=self.device)

    def _scene(self, s: int, noise):
        """``(truth, odometry, observations)`` of scene s on its map."""
        return large.make_large_scene_with_noise(
            self.cfg, self.t1, self.n_lm, *self.maps[s], *noise,
            radius=self.radius, odom_noise=self.scene["odom_noise"])

    def _edges(self, visible: list) -> large.EdgeList:
        """Every scene's windowed edges from its ``(T1, L)`` visibility,
        padded with invalid slots to the longest list."""
        lists, counts = [], []
        cap = 8 * self.window * self.t1
        for valid in visible:
            el, n = large.window_pairs_device(valid, self.window, cap)
            lists.append(el)
            counts.append(n)
        counts = torch.stack(counts).tolist()
        if max(counts) > cap:
            raise ValueError(f"a scene has {max(counts)} edges, more than "
                             f"the {cap} slots")
        e = max(counts)
        return large.EdgeList(*(torch.stack([f[:e] for f in fields])
                                for fields in zip(*lists)))

    def _scene_key(self, i: int, s: int) -> int:
        return call_key(self.seed, i, SCENE_TAG + s)

    def _inputs(self, i: int) -> Inputs:
        poses, fields = [], []
        for s in range(self.n_s):
            _, odo, obs = self._scene(s, self._noise(self._scene_key(i, s)))
            poses.append(odo)
            fields.append(obs)
        poses = torch.stack(poses)
        obs = GraphObservations(*(torch.stack(f) for f in zip(*fields)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the draws stay outside
        return Inputs(poses, obs, _rel(poses))

    def inputs(self, i: int) -> Inputs:
        return self._inputs(i)

    def warmup_inputs(self) -> Inputs:
        return self._inputs(-1)

    def entry(self, inp: Inputs) -> Call:
        syncs = getattr(large, "sync_count", 0)
        passes = getattr(large, "gn_passes", 0)
        wait = getattr(large, "sync_wait_s", None)
        t0 = time.perf_counter()
        res = large.graph_solve_banded(
            self.cfg, inp.poses, inp.obs, self.edges, band=self.window,
            rel_odom=inp.rel_odom, odom_info=tuple(self.scene["odom_info"]),
            solver=self.scene["solver"], stall_ratio=self.scene["stall_ratio"],
            delta_tol=self.tol)
        if wait is not None:
            self.host_ms.append(1e3 * ((time.perf_counter() - t0)
                                       - (large.sync_wait_s - wait)))
        return Call(res, getattr(large, "sync_count", 0) - syncs,
                    getattr(large, "gn_passes", 0) - passes)

    def _rmse(self, poses: torch.Tensor) -> torch.Tensor:
        d = poses[..., :2].to(torch.float64) - self.truth[:, :2]
        return d.square().sum(dim=-1).mean(dim=-1).sqrt()

    def readback(self, out: Call) -> list[float]:
        res = out.result
        return torch.stack([self._rmse(res.poses).mean(),
                            res.gn_iters.to(torch.float64).mean()]).tolist()

    def keep(self, i: int, inp, out) -> None:
        # A call's inputs are drawn again from its key for the check.
        super().keep(i, None, out)

    def counts(self, out: Call) -> dict:
        """Scenes, the resolves they needed (their GN iterations), the
        lockstep passes and the host reads of the call, the Thomas chain's
        super-blocks a scene and their size, and, where the program counts
        the time it waits in its reads, each call's host milliseconds in
        the entry outside them, in the order the calls ran."""
        counts = {"scenes": self.n_s,
                  "resolves": int(out.result.gn_iters.sum().item()),
                  "passes": out.passes, "syncs": out.syncs,
                  "super_blocks": -(-self.t1 // self.window),
                  "block": 3 * self.window}
        if self.host_ms:
            counts["host_ms_calls"] = list(self.host_ms)
        return counts

    def _sample(self, i: int) -> list[int]:
        m = min(self.check["sample"], self.n_s)
        return sorted(rng(self.seed, i, 2).sample(range(self.n_s), m))

    def answer(self, item) -> dict:
        i, _, out = item
        f = torch.tensor(self._sample(i), device=self.device)
        return {"poses": out.result.poses[f].to(torch.float64)}

    def reference(self, item, dtype: torch.dtype) -> dict:
        """The sampled scenes drawn and solved by :mod:`reference.graph`,
        in float64, from the call's draws; at a tie the program's
        visibility.  A ``dtype`` below float32 (the control) rounds the
        edge terms, H and b through it."""
        i = item[0]
        via = dtype if torch.finfo(dtype).bits < 32 else None
        poses = []
        for s in self._sample(i):
            noise = self._noise(self._scene_key(i, s))
            sc = ref.scene(self.scene, *self.maps[s], *noise)
            obs = sc["obs"]
            obs["valid"] = torch.where(sc["tie"], self._scene(s, noise)[2]
                                       .valid, obs["valid"])
            want = ref.solve(self._ref_scene(), sc["odometry"], obs,
                             sc["rel_odom"], self.window, via)
            poses.append(want["poses"])
        return {"poses": torch.stack(poses)}

    def _ref_scene(self) -> dict:
        return {**self.scene, "delta_tol": self.tol}

    def compare(self, got: dict, want: dict) -> dict:
        """The widest position and yaw gaps over the sampled scenes' poses
        and the widest relative gap of a scene's RMSE against the
        reference's true course."""
        d = got["poses"] - want["poses"]
        r_got, r_want = self._rmse(got["poses"]), self._rmse(want["poses"])
        return {
            "pose_gap_m": largest(torch.linalg.vector_norm(d[..., :2],
                                                           dim=-1)),
            "yaw_gap_rad": largest(ref.wrap(d[..., 2]).abs()),
            "rmse_gap_rel": largest((r_got - r_want).abs() / r_want)}

