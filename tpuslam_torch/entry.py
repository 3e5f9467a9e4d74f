"""Entry point: one batched EKF rollout from a seed, on a given device.

Twin of ``__graft_entry__.py::entry()``, with the same contract:
``fn(seed) -> scalar`` position RMSE of a batched EKF rollout from that
seed.  The caller names the device: on a CUDA device ``fn`` launches the
fused rollout kernel at 65536 rollouts x 32 steps; on the CPU the same
call runs the kernel's plain torch version.
"""

from __future__ import annotations

import torch

from tpuslam_torch.filters.ekf import EkfConfig
from tpuslam_torch.ops.ekf_cuda import ekf_fused_rollout

BATCH = 65536
N_STEPS = 32


def entry(device: torch.device | str):
    """Return ``(fn, example_args)`` for a rollout on ``device``."""
    cfg = EkfConfig()

    def fn(seed: int) -> torch.Tensor:
        _, err = ekf_fused_rollout(cfg, seed, batch=BATCH, n_steps=N_STEPS,
                                   device=device)
        return torch.sqrt(torch.mean(err) / N_STEPS)

    return fn, (1,)
