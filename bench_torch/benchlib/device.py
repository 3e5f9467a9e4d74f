"""The card a run measures: the refusal to run without one, its name and
power limit, and NVIDIA's published peaks of the H100 that roofline
shares are taken against."""

from __future__ import annotations

import shutil
import subprocess

import torch

#: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W: float32
#: outside the tensor cores and HBM3 bandwidth.  32-bit integer results:
#: 64 a clock an SM (CUDA C++ Programming Guide, arithmetic instruction
#: throughput, compute capability 9.0) on 132 SMs at the 1.98 GHz that the
#: float32 rate implies.
PEAKS = {"f32_ops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12,
         "int32_ops_per_s": 64 * 132 * 1.98e9, "power_w": 700.0}


class NoDevice(RuntimeError):
    """The run asked for more CUDA devices than the machine has."""


def require(chips: int) -> torch.device:
    """The first CUDA device, or :class:`NoDevice` where fewer than
    ``chips`` are visible: a time on the CPU is no device time."""
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    have = torch.cuda.device_count()
    if have < chips:
        raise NoDevice(f"{have} CUDA devices, the cell asks for {chips}")
    return torch.device("cuda", 0)


def power_limit_w() -> float | None:
    """The card's power limit from ``nvidia-smi``, or None where it
    cannot be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (subprocess.SubprocessError, ValueError, IndexError, OSError):
        return None


def describe(chips: int) -> dict:
    """The result line's ``device`` object (the peak is read later)."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
